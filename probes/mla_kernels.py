#!/usr/bin/env python3
"""Latent attention's K2-K4 instance (q/k 192, v 128), K5's RMS mode, the
held experts' grouped products and the Moonlight-16B-A3B train step,
alone: ``chip_smoke.py``'s mla_kernels and moonlight_step phases without
the smoke's other phases.  Needs one CUDA card and the CUDA toolkit.

    python3 probes/mla_kernels.py [--ptxas] [--no-time]

Builds the kernels (with ``--ptxas``, first compiles ``csrc/flash_fwd_tc.cu``,
``csrc/flash_bwd_tc.cu`` and ``csrc/layer_norm_{fwd,bwd}.cu`` alone with
``nvcc -Xptxas -v`` and prints each kernel's registers, shared memory and
spills), then runs ``chip_smoke.mla_flash_phase`` and
``chip_smoke.rms_norm_phase`` and ``chip_smoke.grouped_phase`` (each pass
against its plain version), unless ``--no-time``
``chip_smoke.mla_kernels_time_phase``, and ``chip_smoke.moonlight_step_phase``,
printing the card's name and power limit and
the phases' JSON lines.  Exits nonzero on a failed check, as the smoke
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
from blendjax_torch.btb import pendulum  # noqa: E402
from blendjax_torch.models import moe, seqformer  # noqa: E402
from blendjax_torch.models.train import TrainState  # noqa: E402
from blendjax_torch.ops import _build  # noqa: E402
from blendjax_torch.ops import flash_attention as flash  # noqa: E402
from blendjax_torch.ops import layer_norm as ln  # noqa: E402

SOURCES = ("flash_fwd_tc", "flash_bwd_tc", "layer_norm_fwd", "layer_norm_bwd")

ap = argparse.ArgumentParser()
ap.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v of the sources")
ap.add_argument("--no-time", action="store_true", help="no kernel times")
args = ap.parse_args()

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(card, torch.__version__, torch.version.cuda, flush=True)
cs.CARD = card
if args.ptxas:
    out = _build.BUILD_DIR / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    procs = {stem: subprocess.Popen(
        ["nvcc", *_build.CUDA_FLAGS, "-Xptxas", "-v", "-c", str(_build.CSRC / f"{stem}.cu"),
         "-o", str(out / f"{stem}.o")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for stem in SOURCES}
    for stem, proc in procs.items():
        text = proc.communicate()[0]
        keep = [line for line in text.splitlines()
                if "Used" in line or "spill" in line or "Compiling entry" in line
                or "error" in line]
        print(f"== {stem} (exit {proc.returncode})", *keep, sep="\n", flush=True)
t0 = time.perf_counter()
_build.load_library()
cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
name = card.split(",")[0]
hbm, flops_peak = cs.peak_rate(cs.HBM_PEAK, name), cs.peak_rate(cs.BF16_PEAK, name)
cs.mla_flash_phase(torch, flash)
cs.rms_norm_phase(torch, ln)
cs.grouped_phase(torch, moe)
if not args.no_time:
    with cs.smi_window("mla_kernels_time"):
        cs.mla_kernels_time_phase(torch, flash, ln, moe, hbm, flops_peak)
with cs.smi_window("moonlight_step"):
    cs.moonlight_step_phase(torch, seqformer, flash, ln, pendulum, TrainState)
