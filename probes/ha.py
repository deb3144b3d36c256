#!/usr/bin/env python3
"""The ha phase of ``chip_smoke.py`` alone, without the smoke's other
phases.  Needs one CUDA card and the CUDA toolkit.

    python3 probes/ha.py

Builds the kernels, then runs ``chip_smoke.ha_phase``: the full-width
detector and the flagship SeqFormer resumed in place from a checkpoint
(``ha_resume``), the actor-learner with its checkpointer and
``ckpt_overhead_x`` (``ha_al``), and the kill/respawn drill with
``learner_recovery_s`` (``ha_drill``), printing the card's name and power
limit, the versions, and the phase's JSON lines.  Exits nonzero on a failed
check, as the smoke does.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from blendjax_torch import btt, control, datagen, worldmodel  # noqa: E402
from blendjax_torch.btb import pendulum  # noqa: E402
from blendjax_torch.models import seqformer  # noqa: E402
from blendjax_torch.ops import _build, image  # noqa: E402
from blendjax_torch.ops import flash_attention as flash  # noqa: E402

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(card, sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
cs.CARD = card
t0 = time.perf_counter()
_build.load_library()
cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
launches = cs.ha_phase(torch, btt, control, datagen, image, seqformer, flash, worldmodel,
                       pendulum)
cs.emit({"ha_launches": launches, "seconds": time.perf_counter() - t0})
