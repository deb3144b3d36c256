#!/usr/bin/env python3
"""The transport phase of ``chip_smoke.py`` alone, without the smoke's
other phases.  Needs one CUDA card, the CUDA toolkit and ``g++``.

    python3 probes/transport.py

Builds the kernels (K1 decodes every datagen batch) and the native
shared-memory ring, then runs ``chip_smoke.transport_phase``: the datagen
stream over tcp, shm and ipc, and the flagship served over ZMQ and over
ShmRPC to clients in a child process, printing the card's name and power
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
from blendjax_torch import btt, datagen, serve  # noqa: E402
from blendjax_torch.models import seqformer  # noqa: E402
from blendjax_torch.native import ring  # noqa: E402
from blendjax_torch.ops import _build, image  # noqa: E402

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(card, sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
cs.CARD = card
t0 = time.perf_counter()
ring.build_library()
ring_s = time.perf_counter() - t0
_build.load_library()
cs.emit({"phase": "build", "ring_seconds": ring_s, "seconds": time.perf_counter() - t0})
launches = cs.transport_phase(torch, btt, datagen, image, seqformer, serve)
cs.emit({"datagen_shm_launches": launches, "seconds": time.perf_counter() - t0})
