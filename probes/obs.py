#!/usr/bin/env python3
"""The obs phase of ``chip_smoke.py`` alone, without the smoke's other
phases.  Needs one CUDA card.

    python3 probes/obs.py

Builds the kernels (the traced feed's step decodes with K1), then runs
``chip_smoke.obs_phase``: the traced full-width feed and its chrome trace
(``obs_feed``), the fences (``obs_fence``) and the traced RL pool's merged
span trace (``obs_spans``), printing the card's name and power limit, the
versions and the phase's JSON lines.  Exits nonzero on a failed check, as
the smoke does.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from blendjax_torch import btt, control, datagen  # noqa: E402
from blendjax_torch.models import policy  # noqa: E402
from blendjax_torch.ops import _build, image  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("probes/obs.py: CUDA is not available")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(card, sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
cs.CARD = card
t0 = time.perf_counter()
_build.load_library()
cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
t0 = time.perf_counter()
launches = cs.obs_phase(torch, btt, datagen, image, control, policy,
                        cs.peak_rate(cs.BF16_PEAK, card.split(",")[0]))
cs.emit({"phase": "probe_seconds", "seconds": time.perf_counter() - t0,
         "launches": {"decode_u8": launches}})
