#!/usr/bin/env python3
"""The serve_fleet phase of ``chip_smoke.py`` alone, without the smoke's
other phases.  Needs one CUDA card.

    python3 probes/serve_fleet.py

Runs ``chip_smoke.serve_fleet_phase``: 3 flagship replica processes on the
card behind the gateway (``fleet_boot``, ``gateway_scale``), the sharded
gateway (``gateway_sharded``), a replica SIGKILLed under the watchdog
(``gateway_chaos``), the canary controller (``canary``), the autoscaler
(``autoscale``) and a live replay reshard (``reshard``), printing the
card's name and power limit, the versions, and the phase's JSON lines.
The phase reaches no kernel, so none is built.  Exits nonzero on a failed
check, as the smoke does.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from blendjax_torch import serve  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("probes/serve_fleet.py: CUDA is not available")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(card, sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
cs.CARD = card
torch.cuda.init()
t0 = time.perf_counter()
cs.serve_fleet_phase(torch, serve)
cs.emit({"phase": "probe_seconds", "seconds": time.perf_counter() - t0})
