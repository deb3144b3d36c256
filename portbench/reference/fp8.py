"""Lower-precision products for the reference.  Float8 for the control: each operand rounded to float8
e4m3 under a per-tensor scale on the way in, and each gradient that flows
back through it to e5m2, as float8 training computes.  Passed as ``mm`` to
:mod:`portbench.reference.seqformer`, it puts the reference in the
program's place one precision below the configuration's bfloat16."""

from __future__ import annotations

import torch

_FORMATS = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def _round(x, fmt):
    if x.numel() == 0:
        return x
    dtype, top = _FORMATS[fmt]
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, "e4m3")

    @staticmethod
    def backward(ctx, g):
        return _round(g, "e5m2")


def fp8(x):
    return _Fp8.apply(x)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16(x):
    """Operands and their gradients rounded to bfloat16: the configuration's
    own precision, a witness beside the program."""
    return _Bf16.apply(x)
