#!/usr/bin/env python3
"""The replay_service and flywheel phases of ``chip_smoke.py`` alone,
without the smoke's other phases.  Needs one CUDA card and ``g++``.

    python3 probes/flywheel.py                   # both phases
    python3 probes/flywheel.py replay_service    # one of them
    python3 probes/flywheel.py flywheel

Builds the native shared-memory ring (the shard processes and ShmRPC map
it), then runs ``chip_smoke.replay_service_phase`` (2 shard processes at
the reference replay benchmark's shape: ``replay_shard_x``,
``replay_degraded_x``, the SIGKILLed shard restored and re-admitted) and
``chip_smoke.flywheel_phase`` (the actor-learner over the shards
publishing to a subscribed policy server, then the flagship's float and
int8 swaps), the latter after ``chip_smoke.actor_learner_phase``, whose
env-steps/s it is reported beside.  Prints the card's name and power limit,
the versions, and the phases' JSON lines; exits nonzero on a failed check,
as the smoke does.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from blendjax_torch import btt, control, serve  # noqa: E402
from blendjax_torch.models import seqformer  # noqa: E402
from blendjax_torch.native import ring  # noqa: E402

phases = sys.argv[1:] or ["replay_service", "flywheel"]
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(card, sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
cs.CARD = card
t0 = time.perf_counter()
ring.build_library()
cs.emit({"phase": "build", "ring_seconds": time.perf_counter() - t0})
if "replay_service" in phases:
    cs.replay_service_phase(torch)
if "flywheel" in phases:
    al_rates = cs.actor_learner_phase(torch, btt, control, None)
    cs.flywheel_phase(torch, btt, control, seqformer, serve, al_rates)
cs.emit({"phases": phases, "seconds": time.perf_counter() - t0})
