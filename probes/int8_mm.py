#!/usr/bin/env python3
"""Operand layouts of ``torch._int_mm`` on the card, at the flagship's
decode shapes: which layout of the int8 weight the library runs fast.
Needs one CUDA card.

    python3 probes/int8_mm.py

For m = 1, 8, 16 activation rows (zero-padded to 32, as
``ops/quant.py::int8_matmul`` pads them) against the (k, n) int8 weights of
the flagship's projections, times in turns (CUDA events, the L2 flushed):
``row`` (the weight row-major), ``col`` (the same weight held
column-major, as the quantizers store it: the port's route through
``int8_matmul``), ``col_copy`` (that transpose copied inside every call) and
``f32`` (the float product of the same values).  Every int8 route is
checked equal to ``row``.  Prints the card's name and power limit and one
JSON line per shape.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from blendjax_torch.ops import quant  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(card, torch.__version__, torch.version.cuda, flush=True)
g = torch.Generator(device="cuda").manual_seed(0)
flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
for m in (1, 8, 16):
    for k, n in ((1024, 1024), (1024, 4096), (4096, 1024)):
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda", generator=g)
        b = torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda", generator=g)
        ap = torch.nn.functional.pad(a, (0, 0, 0, 32 - m))
        b_col = b.t().contiguous().t()
        routes = {
            "row": lambda: torch._int_mm(ap, b)[:m],
            "col": lambda: quant.int8_matmul(a, b_col),
            "col_copy": lambda: torch._int_mm(ap, b.t().contiguous().t())[:m],
        }
        ref = routes["row"]()
        for name, fn in routes.items():
            cs.check(torch.equal(fn(), ref), f"{name} == row at ({m}, {k}, {n})")
        af, bf = a.float(), b.float()
        routes["f32"] = lambda: af @ bf
        times = {name: [] for name in routes}
        for turn in range(2):
            for name in (list(routes) if turn == 0 else list(routes)[::-1]):
                times[name].append(cs.time_ms(torch, routes[name], reps=30, flush=flush))
        cs.emit({"shape": [m, k, n], "ms": times, "card": card})
