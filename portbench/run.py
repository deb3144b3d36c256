#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on this machine's card.

    python3 portbench/run.py --workload wm_train --seed 7 --seconds 20 --trace 0

from the root of a checkout.  The cells, configurations, traffic mixes and
metrics are those of ``BENCHMARK.json``.  With ``--trace 0`` the result's
metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and
``breakdown`` with ``--trace 1``), its last key ``compared``: each number
that decided ``correct`` beside its limit, which also close standard error.

Exits with a nonzero code and prints no result when there is no card, or
fewer than the cell asks for, or when JAX or the JAX package was loaded.
The kernel build and Triton's cache live under ``build/`` in the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _metrics(spec, res, trace):
    from portbench.harness.cell import p95
    from portbench.harness.spec import load_json, reader

    workload = res["cell"]["name"]
    win = res["window"]
    if not trace:
        values = {
            "train_samples_per_s": win["steps"] * res["traffic"]["batch"] / win["seconds"],
            "step_p95_ms": p95(win["intervals_ms"]),
            "peak_mem_gib": res["peak_bytes"] / 2 ** 30,
            "setup_s": res["setup_s"],
        }
        wanted = spec.end_to_end(workload)
    else:
        peaks = load_json(Path(__file__).resolve().parent / "harness" / "peaks.json")
        ctx = dict(res, peak=peaks.get(res["device_kind"]))
        values = {}
        wanted = spec.per_layer(workload)
        for m in wanted:
            v = reader(m["name"])(ctx)
            if v is not None:
                values[m["name"]] = v
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in wanted if m["name"] in values}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness.spec import Spec

    spec = Spec()
    cell = spec.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell asks for {cell['chips']} card(s); this machine has {n} "
              "that CUDA can use", file=sys.stderr)
        return 2

    from portbench.harness import cell as cell_mod

    res = cell_mod.run(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                       t_start=T_START)
    leaked = sorted(set(res["leaked"]) | set(cell_mod.forbidden_modules()))
    if leaked:
        print(f"portbench: modules loaded that the benchmark must not load: {leaked}",
              file=sys.stderr)
        return 3
    res["device_kind"] = torch.cuda.get_device_name(0)
    res["power_limit"] = _power_limit()
    device = {"platform": "gpu", "kind": res["device_kind"], "count": cell["chips"],
              "memory_peak_bytes": int(res["peak_bytes"])}
    out = {"correct": res["correct"], "attempted": res["window"]["steps"],
           "failed": res["window"]["failed"], "metrics": _metrics(spec, res, args.trace),
           "device": device}
    traced = res["traced"]
    if args.trace:
        if traced is None:
            print("portbench: the profiler kept no device event in the traced slice",
                  file=sys.stderr)
            return 4
        device["busy_s"] = traced["busy_s"]
        device["window_s"] = traced["window_s"]
        out["breakdown"] = {"device_ops": traced["device_ops"], "idle_gaps": traced["idle_gaps"]}
    out["power_limit"] = res["power_limit"]
    out["compared"] = res["compared"]
    win = res["window"]
    print(f"portbench: set-up phases {res['phases']}; window {win['steps']} steps in "
          f"{win['seconds']:.4f} s, step median {statistics.median(win['intervals_ms']):.4f} "
          f"ms, mean {statistics.fmean(win['intervals_ms']):.4f} ms, max "
          f"{max(win['intervals_ms']):.4f} ms", file=sys.stderr)
    for name, c in res["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
