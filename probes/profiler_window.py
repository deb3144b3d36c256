#!/usr/bin/env python3
"""How often torch.profiler misses a kernel that the train step launched,
with and without ``chip_smoke.PROFILE_WARMUP_STEPS`` warm-up steps (traced
and discarded) before the profiled ones.  Needs one CUDA card.

    python3 probes/profiler_window.py [--sessions 60]

Runs the ``train`` phase's eager step (the detector at ``MAIN_SHAPE``, the
``decode_u8`` kernel first in every step) under
``chip_smoke._device_profile`` (whose marker spins, after a guard step,
bound the counted steps), ``PROFILED_STEPS`` steps per profiler session,
in turns without a warm-up and with ``PROFILE_WARMUP_STEPS``.  In
each session it holds the profiler's count of ``decode_u8_kernel`` runs
against what the wrapper's launch counter added after the warm-up, as the
smoke's check does, and prints, per arm, the sessions whose counts differ.
Exits nonzero if any session with the warm-up differs.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from blendjax_torch import datagen  # noqa: E402
from blendjax_torch.models.train import make_train_step  # noqa: E402
from blendjax_torch.ops import _build, image  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--sessions", type=int, default=60, help="profiler sessions per arm")
args = ap.parse_args()
if not torch.cuda.is_available():
    sys.exit("probes/profiler_window.py: CUDA is not available")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(card, sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
_build.load_library()

dg = torch.Generator(device="cuda").manual_seed(1)
target = torch.rand((cs.MAIN_SHAPE[0], 8, 2), generator=dg, device="cuda")
batches = [{"image": torch.randint(0, 256, cs.MAIN_SHAPE, dtype=torch.uint8, device="cuda",
                                   generator=dg), "xy": target} for _ in range(5)]
state = datagen.make_state(torch.Generator(device="cuda").manual_seed(0))
step = make_train_step(datagen.make_loss(), capture=False)
for batch in batches:  # warm: the first steps pay the kernels' and cuDNN's set-up
    state, loss = step(state, batch)
float(loss)

emitted = cs.emit
cs.emit = lambda obj: None  # the profile's own record, once per session
warmup = cs.PROFILE_WARMUP_STEPS
result = {m: {"sessions": 0, "differ": 0, "seen": [], "counted": []} for m in (0, warmup)}
for i in range(args.sessions):
    for m in (0, warmup) if i % 2 == 0 else (warmup, 0):
        cs.PROFILE_WARMUP_STEPS = m
        more = iter(batches)
        before = {}

        def profiled_step():
            global state
            state, loss = step(state, next(more))
            float(loss)

        prof = cs._device_profile(torch, profiled_step, cs.PROFILED_STEPS, 1.0, "probe", "eager",
                                  on_active=lambda: before.update(
                                      n=image.decode_frames_cuda.launches))
        seen = sum(n for k, n in prof["runs"].items() if "decode_u8_kernel" in k)
        counted = image.decode_frames_cuda.launches - before["n"]
        r = result[m]
        r["sessions"] += 1
        r["differ"] += seen != counted
        r["seen"].append(seen)
        r["counted"].append(counted)
cs.emit = emitted
cs.PROFILE_WARMUP_STEPS = warmup
for m, r in result.items():
    cs.emit({"phase": "profiler_window", "warmup_steps": m, "sessions": r["sessions"],
             "sessions_differ": r["differ"], "min_seen": min(r["seen"]),
             "max_seen": max(r["seen"]), "counted": sorted(set(r["counted"])), "card": card})
print(json.dumps({"ok": result[warmup]["differ"] == 0}))
sys.exit(0 if result[warmup]["differ"] == 0 else 1)
