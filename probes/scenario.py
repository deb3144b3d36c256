#!/usr/bin/env python3
"""The scenario phase of ``chip_smoke.py`` alone, without the smoke's other
phases.  Needs one CUDA card.

    python3 probes/scenario.py

Runs ``chip_smoke.scenario_phase``: a ``FleetSet(ctrl=True)`` of 3 x 2 echo
producers (lite, lite, rich) behind ``ActorLearner(scenarios=, curriculum=,
fanin_min_ready=1, device="cuda")`` (``scenario_run``), the fan-in's arms and
the pool-level ready-first ratio (``scenario_fanin``), a strata-drawn update
on the card against the CPU (``scenario_strata``), a cut resumed mid-
curriculum (``scenario_ha``) and a SIGKILLed producer's scenario following
its respawn (``scenario_chaos``), printing the card's name and power limit,
the versions, and the phase's JSON lines.  The phase reaches no kernel, so
none is built.  Exits nonzero on a failed check, as the smoke does.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from blendjax_torch import btt  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("probes/scenario.py: CUDA is not available")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(card, sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
cs.CARD = card
t0 = time.perf_counter()
cs.scenario_phase(torch, btt)
cs.emit({"phase": "probe_seconds", "seconds": time.perf_counter() - t0})
