#!/usr/bin/env python3
"""Where a benchmark cell's captured step spends its device time, by region
of the program (``blendjax_torch.obs.regions``).  Needs one CUDA card.

    python3 probes/regions.py --workload wm_train --seed 7 [--root DIR]
        [--batch N] [--eager-steps 8] [--out build/regions]

Builds the cell's program as ``portbench/run.py`` does (weights and batches
from the seed), from the package under ``--root`` (default: this checkout;
a parent commit's copy to compare with).  Then:

1. The first eager warm-up, then the second under ``torch.profiler`` (CPU
   and CUDA): its wall time with the profile's parse and, where the
   program has region ranges, ``kernel_table`` (in ``<out>/<tag>.<workload>.table.json``).
2. The capture and two settling replays, then the benchmark's traced slice
   (``portbench/harness/profile.py``'s pattern: a long spin, a guard step,
   a marker spin, 10 steps, a marker spin).  Over the device ops between
   the markers: the time a step by kernel class as the benchmark counts
   it (every CUDA event, so a device annotation would count too), the
   annotations among them, each replay's op count and name sequence (its
   SHA-1, and the first replay's names in ``<out>/<tag>.<workload>.names.json``), the
   longest idle gaps by host op, and, with ranges and a table, ``split``'s
   time a step by region and class, what it could not place, and the host
   time a step in the ``train.*`` dispatch ranges; a program with
   ``counters()`` (the DeepSeekMoE layers' ``moe.Balance``) has them read
   after the idle-card steps.
3. Five steps each on an idle card under the profiler: the dispatch
   ranges' host time when no launch waits for room in the queue; ten with
   no profiler, each call's host time; and the host time of entering and
   leaving one region range with no profiler (a million times).
4. The captured step freed, ``--eager-steps`` eager steps
   (``capture=False``) with no profiler, each timed alone to a
   ``torch.cuda.synchronize()``: as the process's first work, before any
   profiler ran, and again at its end.

Prints one JSON line and writes it to ``<out>/<tag>.<workload>.json``.  With
``--annotations`` it first reports which kind of profiler range puts an
event of its own on the device: ``record_function`` (a user annotation)
and the function range that ``region`` opens.
"""

import argparse
import gc
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ap = argparse.ArgumentParser()
ap.add_argument("--workload", required=True)
ap.add_argument("--seed", type=int, required=True)
ap.add_argument("--root", default=str(HERE))
ap.add_argument("--tag", default="change")
ap.add_argument("--batch", type=int, default=None, help="rows a step in place of the cell's")
ap.add_argument("--eager-steps", type=int, default=8)
ap.add_argument("--annotations", action="store_true")
ap.add_argument("--out", default=str(HERE / "build" / "regions"))
args = ap.parse_args()
root = Path(args.root).resolve()
sys.path.insert(0, str(root))
os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("probes/regions.py: CUDA is not available")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the attribution reads the profile whichever tree runs the step
regions = _load(HERE / "blendjax_torch" / "obs" / "regions.py", "probe_regions")
from portbench.harness import profile as bench_profile  # noqa: E402
from portbench.harness import traffic as traffic_mod  # noqa: E402
from portbench.harness.spec import Spec, program as load_program  # noqa: E402

ACTS = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
out = {"tag": args.tag, "workload": args.workload, "seed": args.seed,
       "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip(),
       "torch": torch.__version__, "cuda": torch.version.cuda}
has_ranges = (root / "blendjax_torch" / "obs" / "regions.py").exists()


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _device(events):
    return [e for e in events if e.device_type == DeviceType.CUDA]


if args.annotations:
    a = torch.randn(256, 256, device="cuda")
    kinds = {}
    for kind, enter in (("record_function", record_function),
                        ("function_range", torch._C._profiler._RecordFunctionFast)):
        with profile(activities=ACTS) as prof:
            with enter("probe.range"):
                (a @ a).sum()
            torch.cuda.synchronize()
        kinds[kind] = sorted({e.name for e in _device(prof.events())
                              if e.name == "probe.range"
                              or getattr(e, "is_user_annotation", False)})
    out["device_events_of_ranges"] = kinds

spec = Spec()
cell = spec.cell(args.workload)
cfg, traffic = spec.config(cell["config"]), dict(spec.traffic(cell["traffic"]))
if args.batch:
    traffic["batch"] = args.batch
out["batch"], out["seq_len"] = traffic["batch"], traffic["seq_len"]
program = load_program(cfg["program"])
device = torch.device("cuda")
torch.cuda.init()
params = program.make_weights(cfg, args.seed, device)
feed = traffic_mod.make_feed(torch, traffic, cfg, args.seed, device)
prog = program.Program(torch, cfg, traffic, params, device)
del params

from blendjax_torch.models.train import make_train_step  # noqa: E402

eager = make_train_step(prog.loss_fn, capture=False)


def _eager_ms(n):
    """``n`` eager steps on the program's state, each timed alone, after
    two untimed ones; the allocator's cache emptied after."""
    def one():
        prog.state, _ = eager(prog.state, next(feed))

    for _ in range(2):
        one()
    times = [_sync_time(one) * 1e3 for _ in range(n)]
    gc.collect()
    torch.cuda.empty_cache()
    return times


# 0. eager steps before any profiler has run in the process
out["eager_ms"] = _eager_ms(args.eager_steps)
out["eager_ms_median"] = statistics.median(out["eager_ms"])

# 1. the eager warm-ups, the second profiled in either tree
out["warmup1_s"] = _sync_time(lambda: prog.step(next(feed)))
t0 = time.perf_counter()
with profile(activities=ACTS) as prof:
    prog.step(next(feed))
    torch.cuda.synchronize()
t1 = time.perf_counter()
events = list(prof.events())
t2 = time.perf_counter()
out["warmup2_profiled_s"], out["parse_s"] = t1 - t0, t2 - t1
table = None
if has_ranges:
    table = regions.kernel_table(events)
    out["table_s"] = time.perf_counter() - t2
    out["table_ops"] = len(table)
    out["table_unlinked"] = sum(r is None for _, r in table)
    by = {}
    for _, r in table:
        by[str(r)] = by.get(str(r), 0) + 1
    out["table_ops_by_region"] = by
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.tag}.{args.workload}.table.json"), "w") as f:
        json.dump(table, f)
del prof, events

# 2. the capture, two settling replays, the traced slice
out["capture_s"] = _sync_time(lambda: prog.step(next(feed)))
for _ in range(2):
    prog.step(next(feed))
steps = 10
torch.cuda.synchronize()
with profile(activities=ACTS) as prof:
    torch.cuda._sleep(bench_profile.ABSORB_CYCLES)
    prog.step(next(feed))
    torch.cuda._sleep(bench_profile.MARK_CYCLES)
    for _ in range(steps):
        prog.step(next(feed))
    torch.cuda._sleep(bench_profile.MARK_CYCLES)
    torch.cuda.synchronize()
events = list(prof.events())
dev = _device(events)
marks = sorted((e for e in dev if "spin_kernel" in e.name and e.time_range.elapsed_us() < 1e3),
               key=lambda e: e.time_range.start)[-2:]
lo, hi = marks[0].time_range.end, marks[1].time_range.start
inside = [e for e in dev if e.time_range.start >= lo and e.time_range.end <= hi
          and bench_profile.kernel_class(e.name) != "marker"]
by_class = {}
for e in inside:
    c = by_class.setdefault(bench_profile.kernel_class(e.name), [0.0, 0])
    c[0] += e.time_range.elapsed_us() / 1e3 / steps
    c[1] += 1 / steps
out["by_class_ms"] = by_class
out["non_matmul_ms"] = sum(v[0] for k, v in by_class.items()
                           if k not in ("gemm", "flash_fwd", "flash_bwd"))
spans = [(e.time_range.start, e.time_range.end) for e in inside]
out["device_ms"] = bench_profile._union_seconds(spans) * 1e3 / steps
out["annotations_on_device"] = sorted({e.name for e in inside
                                       if getattr(e, "is_user_annotation", False)})
host = [(e.time_range.start, e.time_range.end, e.name) for e in events
        if e.device_type == DeviceType.CPU and e.time_range.end > lo and e.time_range.start < hi]
gaps = sorted(bench_profile._gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:10]
out["idle_gaps"] = [[bench_profile._host_at(host, g), (g[1] - g[0]) / 1e6] for g in gaps]

launch = {e.id: e for e in events if e.device_type == DeviceType.CPU
          and e.name.startswith("cudaGraphLaunch")}
graphs = {}
for e in sorted(inside, key=lambda e: e.time_range.start):
    if e.id in launch and not getattr(e, "is_user_annotation", False):
        graphs.setdefault(e.id, []).append(e.name)
seqs = list(graphs.values())
out["replays"] = len(seqs)
out["replay_ops"] = sorted({len(s) for s in seqs})
out["replays_equal"] = all(s == seqs[0] for s in seqs)
out["replay_sha1"] = hashlib.sha1("\n".join(seqs[0]).encode()).hexdigest() if seqs else None
os.makedirs(args.out, exist_ok=True)
with open(os.path.join(args.out, f"{args.tag}.{args.workload}.names.json"), "w") as f:
    json.dump(seqs[0] if seqs else [], f)

if table is not None:
    n, split = regions.split(events, table, lo, hi, classify=bench_profile.kernel_class)
    out["split_steps"] = n
    out["table_matches_replay"] = [name for name, _ in table] == (seqs[0] if seqs else None)
    out["by_region_ms"] = {f"{r}|{c}": [s * 1e3, k] for (r, c), (s, k) in sorted(
        split.items(), key=lambda kv: -kv[1][0])}
    other = {}
    for (r, c), (s, _) in split.items():
        if c not in ("gemm", "flash_fwd", "flash_bwd"):
            other[str(r)] = other.get(str(r), 0.0) + s * 1e3
    part = {"norm": ["seqformer.norm"], "attention": ["seqformer.attention"],
            "mlp": ["seqformer.mlp"], "adam": ["train.adam", "train.zero_grad"]}
    parts = {k: sum(other.get(r, 0.0) for r in rs) for k, rs in part.items()}
    parts["rest"] = sum(v for r, v in other.items() if not any(r in rs for rs in part.values()))
    out["nonmatmul_parts_ms"] = parts
    out["nonmatmul_other_ms"] = other
    out["parts_sum_ms"] = sum(parts.values())
    out["unplaced_ms"] = sum(s for (r, _), (s, _) in split.items() if r == regions.UNPLACED) * 1e3
    out["unplaced_pct_of_device"] = 100 * out["unplaced_ms"] / out["device_ms"]
    # the host window: from the first marker's launch to the second's
    launches = {e.id: e for e in events if e.device_type == DeviceType.CPU
                and e.name.startswith("cudaLaunchKernel")}
    h_lo, h_hi = (launches[m.id].time_range.start if m.id in launches else t
                  for m, t in zip(marks, (lo, hi)))
    host_ms = {}
    for e in events:
        if e.name in regions.DISPATCH and h_lo <= e.time_range.start < h_hi:
            host_ms[e.name] = host_ms.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    out["host_ms"] = host_ms
    out["host_ms_total"] = sum(host_ms.values())
    _, by_kernel = regions.split(events, table, lo, hi, classify=lambda name: name)
    top = {}
    for (r, name), (s, k) in by_kernel.items():
        top.setdefault(str(r), []).append([s * 1e3, k, name[:90]])
    out["top_ops_ms"] = {r: sorted(v, reverse=True)[:6] for r, v in top.items()}
del prof, events, dev, inside, host

# the dispatch's own host time: steps each run on an idle card, so that no
# launch waits for room in the queue
with profile(activities=ACTS) as prof:
    for _ in range(5):
        prog.step(next(feed))
        torch.cuda.synchronize()
idle = {}
for e in prof.events():
    if e.name in regions.DISPATCH:
        idle.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
out["dispatch_idle_ms"] = {k: statistics.median(v) for k, v in idle.items()}
del prof
# and with no profiler: the host time of a call on an idle card
host = []
for _ in range(10):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prog.step(next(feed))
    host.append((time.perf_counter() - t0) * 1e3)
torch.cuda.synchronize()
out["call_host_ms"] = statistics.median(host)
if hasattr(prog, "counters"):
    out["counters"] = prog.counters()  # the DeepSeekMoE layers' (moe.Balance.read)
if has_ranges:
    region = sys.modules["blendjax_torch.obs.regions"].region
    n = 1_000_000
    t0 = time.perf_counter()
    for _ in range(n):
        with region("seqformer.norm"):
            pass
    out["region_off_ns"] = (time.perf_counter() - t0) / n * 1e9

# 3. eager steps again, the captured step freed, after the profilers
prog._step = None
gc.collect()
torch.cuda.empty_cache()
out["eager_after_ms"] = _eager_ms(args.eager_steps)
out["eager_after_ms_median"] = statistics.median(out["eager_after_ms"])
out["profiler_on_after"] = torch.autograd._profiler_enabled()
out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
with open(os.path.join(args.out, f"{args.tag}.{args.workload}.json"), "w") as f:
    json.dump(out, f)
print(json.dumps(out), flush=True)
