#!/usr/bin/env python3
"""The decode kernel's checks and times and the densityopt phase of
``chip_smoke.py`` alone, without the smoke's other phases.  Needs one CUDA
card and the CUDA toolkit.

    python3 probes/densityopt.py

Builds the kernels, runs ``chip_smoke.kernel_phase`` (K1 against its plain
version on every smoke case, its times at the datagen and densityopt
shapes) and ``chip_smoke.densityopt_phase`` (4 supershape producers under
the fake Blender, the loop, its eager/captured replays and the card
against the CPU), printing the card's name and power limit and the
phases' JSON lines.  Exits nonzero on a failed check, as the smoke does.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from blendjax_torch import btt  # noqa: E402
from blendjax_torch.ops import _build, image  # noqa: E402

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(card, torch.__version__, torch.version.cuda, flush=True)
t0 = time.perf_counter()
_build.load_library()
cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
hbm = cs.peak_rate(cs.HBM_PEAK, card.split(",")[0])
with cs.smi_window("kernel"):
    cs.kernel_phase(torch, image, hbm)
with cs.smi_window("densityopt"):
    n = cs.densityopt_phase(torch, btt, image)
cs.emit({"densityopt_launches": n, "seconds": time.perf_counter() - t0})
