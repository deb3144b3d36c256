#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, for one
training cell, in one process on the card:

- ``program``: the program's first steps against the reference, on each
  of ``--seeds`` (the same set-up and first steps as a run, no window);
  on each of ``--control-seeds`` (a mix whose batches are made from the
  seed alone, such as ``pool``), against the reference:
- ``control``: the reference computed with float8 products (e4m3 operands,
  e5m2 gradients) in the program's place, against the float32 reference;
- ``half_batch``: the reference trained on the first half of each batch,
  against the whole batch's;
- ``bf16``: the reference with bfloat16 products, the configuration's own
  precision, against the float32 reference: a second witness beside the
  program;
- ``frozen``: the reference that returns its state unchanged (Adam at a
  rate of 0, no first moment), against the reference.

    python3 portbench/readings.py --workload wm_train --seeds 1,2,3 \\
        --control-seeds 1,2,3 --out readings_wm_train.jsonl

Prints one JSON line per reading.  The benchmark's own runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def readings(workload, seeds, control_seeds, device="cuda", overrides=None, emit=print):
    import torch

    from portbench.harness import cell, correct
    from portbench.harness.spec import Spec, program as load_program
    from portbench.harness.traffic import make_feed
    from portbench.reference.fp8 import bf16, fp8

    spec = Spec()
    c = spec.cell(workload)
    cfg = (overrides or {}).get("config") or spec.config(c["config"])
    traffic = (overrides or {}).get("traffic") or spec.traffic(c["traffic"])
    dev = torch.device(device)
    out = []

    def record(kind, seed, got, ref, t0):
        rec = {"workload": workload, "kind": kind, "seed": seed,
               **correct.numbers(got, ref), **correct.details(got, ref),
               "seconds": time.perf_counter() - t0}
        out.append(rec)
        emit(json.dumps(rec))

    program = load_program(cfg["program"])
    for seed in seeds:
        t0 = time.perf_counter()
        prog, feed, got = cell.set_up(torch, cfg, traffic, seed, dev)
        first = feed.reference_batches(cell.FIRST_STEPS)
        cell.free(torch, prog, feed)
        del prog
        ref = program.reference_readings(torch, cfg, seed, first, dev)
        record("program", seed, got, ref, t0)
    half = slice(0, traffic["batch"] // 2)
    for seed in control_seeds:
        feed = make_feed(torch, traffic, cfg, seed, dev)
        first = feed.reference_batches(cell.FIRST_STEPS)
        feed.close()
        t0 = time.perf_counter()
        ref = program.reference_readings(torch, cfg, seed, first, dev)
        for kind, kw in (("control", {"mm": fp8}), ("half_batch", {"rows": half}),
                         ("bf16", {"mm": bf16}), ("frozen", {"lr": 0.0})):
            got = program.reference_readings(torch, cfg, seed, first, dev, **kw)
            if kind == "frozen":
                # a state left unchanged holds no first moment: its gradient reads 0
                got["grad_norms"] = dict.fromkeys(got["grad_norms"], 0.0)
                got["first_grads"] = {k: torch.zeros_like(g) for k, g in got["first_grads"].items()}
            record(kind, seed, got, ref, t0)
            t0 = time.perf_counter()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    sink = open(args.out, "a") if args.out else None

    def emit(line):
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    readings(args.workload, seeds, control, emit=emit)


if __name__ == "__main__":
    main()
