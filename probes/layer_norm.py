#!/usr/bin/env python3
"""K5, the layer norm kernels, alone: ``chip_smoke.py``'s layer_norm phase
without the smoke's other phases.  Needs one CUDA card and the CUDA toolkit.

    python3 probes/layer_norm.py [--ptxas] [--no-time] [--out build/layer_norm]

Builds the kernels (with ``--ptxas``, first compiles each of
``csrc/layer_norm_{fwd,bwd}.cu`` alone with ``nvcc -Xptxas -v``, in
parallel as the build does, and prints each kernel's registers, shared
memory and spills to ``<out>/<source>.ptxas.txt``, and each
file's seconds), then runs ``chip_smoke.layer_norm_phase`` (both passes
against their plain versions, the backward bit-equal over two runs),
``chip_smoke.layer_norm_time_phase`` (unless ``--no-time``: each pass's
time beside its byte bound, its plain pass and ``F.layer_norm``) and
``chip_smoke.layer_norm_engagement`` (a seqformer_big train step's capture
counted by the launch counters), printing the card's name and power limit
and the phases' JSON lines.  Exits nonzero on a failed check, as the smoke
does.
"""

import argparse
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
from blendjax_torch.ops import _build  # noqa: E402
from blendjax_torch.ops import layer_norm as ln  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--ptxas", action="store_true",
                help="write nvcc -Xptxas -v reports of both sources to --out")
ap.add_argument("--no-time", action="store_true", help="checks and counts only")
ap.add_argument("--out", default="build/layer_norm", help="directory of the ptxas reports")
args = ap.parse_args()

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(card, torch.__version__, torch.version.cuda, flush=True)
cs.CARD = card
t0 = time.perf_counter()
if args.ptxas:
    out = _build.BUILD_DIR / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in ("layer_norm_fwd", "layer_norm_bwd"):
        procs[stem] = (time.perf_counter(), subprocess.Popen(
            ["nvcc", *_build.CUDA_FLAGS, "-Xptxas", "-v", "-c", str(_build.CSRC / f"{stem}.cu"),
             "-o", str(out / f"{stem}.o")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for stem, (start, proc) in procs.items():
        text = proc.communicate()[0]
        seconds = time.perf_counter() - start
        report = os.path.join(args.out, f"{stem}.ptxas.txt")
        os.makedirs(args.out, exist_ok=True)
        with open(report, "w") as f:
            f.write(text)
        cs.emit({"phase": "ptxas", "source": f"{stem}.cu", "rc": proc.returncode,
                 "seconds": seconds, "output": report})
    t0 = time.perf_counter()
_build.load_library()
cs.emit({"phase": "build", "sources": _build.SOURCES, "seconds": time.perf_counter() - t0})
hbm = cs.peak_rate(cs.HBM_PEAK, card.split(",")[0])
cs.layer_norm_phase(torch, ln)
if not args.no_time:
    with cs.smi_window("layer_norm_time"):
        cs.layer_norm_time_phase(torch, ln, hbm)
cs.layer_norm_engagement(torch, ln, seqformer, worldmodel, pendulum, TrainState)
cs.emit({"phase": "layer_norm_probe", "seconds": time.perf_counter() - t0, "ok": True})
