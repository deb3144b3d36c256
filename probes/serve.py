#!/usr/bin/env python3
"""The serving phases of ``chip_smoke.py`` alone, without the smoke's other
phases.  Needs one CUDA card and the CUDA toolkit.

    python3 probes/serve.py

Builds the kernels, then runs ``chip_smoke.quant_phase`` (the int8
products on the card against the CPU's int64 ones, timed beside f32),
``serve_phase`` at the flagship width and at the serve benchmark's own,
``dream_phase`` on a fresh seeded flagship world model (the smoke dreams
with its world-model phase's trained one) and ``infer_int8_phase``,
printing the card's name and power limit, the versions, and the phases'
JSON lines.  Exits nonzero on a failed check, as the smoke does.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from blendjax_torch import btt, datagen, serve, worldmodel  # noqa: E402
from blendjax_torch.btb import pendulum  # noqa: E402
from blendjax_torch.models import layers, seqformer  # noqa: E402
from blendjax_torch.models.train import TrainState  # noqa: E402
from blendjax_torch.ops import _build, image, quant  # noqa: E402

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(card, sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
cs.CARD = card
cs.HBM_RATE = cs.peak_rate(cs.HBM_PEAK, card.split(",")[0])
t0 = time.perf_counter()
_build.load_library()
cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
cs.quant_phase(torch, quant, layers)
with cs.smi_window("serve"):
    cs.serve_phase(torch, seqformer, serve, cs.SERVE, "serve")
cs.serve_phase(torch, seqformer, serve, cs.SERVE_SMALL, "serve_small")
params = seqformer.init(torch.Generator(device="cuda").manual_seed(0),
                        max_len=cs.SEQ["seq_len"], device="cuda",
                        **{k: cs.SEQ[k] for k in ("obs_dim", "d_model", "n_heads", "n_layers")})
cs.dream_phase(torch, seqformer, worldmodel, quant, pendulum, TrainState.create(params))
n = cs.infer_int8_phase(torch, btt, datagen, image)
cs.emit({"infer_int8_launches": n, "seconds": time.perf_counter() - t0})
