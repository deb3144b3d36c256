#!/usr/bin/env python3
"""The moe, dp, ring, rl_dp and pipe phases of ``chip_smoke.py`` alone,
without the smoke's other phases.  Needs one CUDA card.

    python3 probes/parallel.py [moe] [dp] [ring] [rl_dp] [pipe]

Builds the kernels (``ops/_build.py``: K1 for the dp ranks' losses, K2-K4
for the MoE flagship and the ring; not for ``pipe`` alone, which launches
none), then runs ``chip_smoke.moe_phase`` (the flagship
SeqFormer with 8 experts, top-2: the routed arms with sort and scatter
dispatch and the dense mixture, each 8 Adam steps eager and captured in
turns through K2-K4; sort against scatter on the card; the card against
the CPU on a small f32 MoE model) and ``chip_smoke.dp_phase`` (2 rank
processes on ``cuda:0`` over gloo: each rank's stream shard into the
data-parallel detector step with K1 in its loss, the held DP and TP steps
against one process's), ``chip_smoke.ring_phase`` (2 rank processes over
``{"seq": 2}``: the bf16 ring_flash, zigzag_flash, ulysses_flash and
windowed schemes through K2-K4 against one process's kernels on the whole
sequence, the f32 plain ring, the flagship SeqFormer's ring_flash step) and
``chip_smoke.rl_dp_phase`` (2 rank processes over ``{"data": 2}``, each
owning 2 cartpole producers: the held sharded update, ``ActorLearner(mesh=)``
and ``train_reinforce(mesh=)``) and ``chip_smoke.pipe_phase`` (the SPMD
GPipe and 1F1B pipeline in 2 rank processes over ``{"pipe": 2}``, the MPMD
stage fleets, the kill drill and the pipeline learner), printing the card's
name and power limit, the versions, and the phases' JSON lines.  With no
argument all five run.
Exits nonzero on a failed check, as the smoke does.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from blendjax_torch import worldmodel  # noqa: E402
from blendjax_torch.btb import pendulum  # noqa: E402
from blendjax_torch.models import seqformer  # noqa: E402
from blendjax_torch.models.train import TrainState  # noqa: E402
from blendjax_torch.ops import _build, image  # noqa: E402
from blendjax_torch.ops import flash_attention as flash  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("probes/parallel.py: CUDA is not available")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(card, sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
cs.CARD = card
phases = sys.argv[1:] or ["moe", "dp", "ring", "rl_dp", "pipe"]
t0 = time.perf_counter()
if set(phases) - {"rl_dp", "pipe"}:
    _build.load_library()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
if "moe" in phases:
    launched, routes = cs.moe_phase(torch, seqformer, flash, worldmodel, pendulum, TrainState)
    cs.emit({"phase": "moe_launches", **launched, "launches_by_route": routes})
if "dp" in phases:
    cs.emit({"phase": "dp_launches", "decode_u8": cs.dp_phase(torch)})
if "ring" in phases:
    launched, routes, ln_launched, ring_failures = cs.ring_phase(torch)
    cs.emit({"phase": "ring_launches", **launched, "launches_by_route": routes,
             "layer_norm": ln_launched})
if "rl_dp" in phases:
    cs.rl_dp_phase(torch)
if "pipe" in phases:
    from blendjax_torch.native import ring

    ring.build_library()  # the stages' ShmRPC rings, built first as the smoke does
    here, ranks = cs.pipe_phase(torch, image, flash)
    cs.emit({"phase": "pipe_launches", **here, "ranks": ranks})
cs.emit({"phase": "probe_seconds", "seconds": time.perf_counter() - t0})
if "ring" in phases:
    cs.check(not ring_failures, "; ".join(ring_failures))
