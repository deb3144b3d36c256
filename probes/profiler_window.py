#!/usr/bin/env python3
"""How often torch.profiler misses a kernel that the train step launched,
with and without ``chip_smoke.PROFILE_MARGIN_S`` of empty capture window
around the profiled steps.  Needs one CUDA card.

    python3 probes/profiler_window.py [--sessions 60]

Runs the ``train`` phase's eager step (the detector at ``MAIN_SHAPE``, the
``decode_u8`` kernel first in every step) under
``chip_smoke._device_profile``, ``PROFILED_STEPS`` steps per profiler
session, in turns of margin 0 and margin ``PROFILE_MARGIN_S``.  In each
session it holds the profiler's count of ``decode_u8_kernel`` runs against
what the wrapper's launch counter added, as the smoke's check does, and
prints, per margin, the sessions whose counts differ.  Exits nonzero if any
session with the margin differs.
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
ap.add_argument("--sessions", type=int, default=60, help="profiler sessions per margin")
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
                                   generator=dg), "xy": target} for _ in range(4)]
state = datagen.make_state(torch.Generator(device="cuda").manual_seed(0))
step = make_train_step(datagen.make_loss(), capture=False)
for batch in batches:  # warm: the first steps pay the kernels' and cuDNN's set-up
    state, loss = step(state, batch)
float(loss)

emitted = cs.emit
cs.emit = lambda obj: None  # the profile's own record, once per session
margin = cs.PROFILE_MARGIN_S
result = {m: {"sessions": 0, "differ": 0, "seen": [], "counted": []} for m in (0.0, margin)}
for i in range(args.sessions):
    for m in (0.0, margin) if i % 2 == 0 else (margin, 0.0):
        cs.PROFILE_MARGIN_S = m
        more = iter(batches)
        before = image.decode_frames_cuda.launches

        def profiled_step():
            global state
            state, loss = step(state, next(more))
            float(loss)

        prof = cs._device_profile(torch, profiled_step, cs.PROFILED_STEPS, 1.0, "probe", "eager")
        seen = sum(n for k, n in prof["runs"].items() if "decode_u8_kernel" in k)
        counted = image.decode_frames_cuda.launches - before
        r = result[m]
        r["sessions"] += 1
        r["differ"] += seen != counted
        r["seen"].append(seen)
        r["counted"].append(counted)
cs.emit = emitted
for m, r in result.items():
    cs.emit({"phase": "profiler_window", "margin_s": m, "sessions": r["sessions"],
             "sessions_differ": r["differ"], "min_seen": min(r["seen"]),
             "max_seen": max(r["seen"]), "counted": sorted(set(r["counted"])), "card": card})
print(json.dumps({"ok": result[margin]["differ"] == 0}))
sys.exit(0 if result[margin]["differ"] == 0 else 1)
