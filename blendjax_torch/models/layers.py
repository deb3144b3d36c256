"""Minimal functional NN layers on plain tensors.

Parameters are ``{name: tensor}`` dicts with ``init``/``apply`` functions,
as in ``blendjax.models.layers``.  The public layout stays the JAX
package's — activations NHWC, dense weights ``(in, out)`` — so the port
and the reference compare like with like; conv kernels are stored OIHW,
PyTorch's layout (:mod:`blendjax_torch.models.convert` transposes HWIO).
Compute dtype is a parameter: weights are cast inside the forward, so
bf16 compute over f32 parameters leaves the gradients in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def conv_init(in_ch, out_ch, ksize=3, *, generator, device="cuda"):
    """He-normal conv kernel (OIHW) + zero bias."""
    fan_in = ksize * ksize * in_ch
    w = torch.randn((out_ch, in_ch, ksize, ksize), generator=generator,
                    device=device) * math.sqrt(2.0 / fan_in)
    return {"w": w, "b": torch.zeros((out_ch,), device=device)}


def same_padding(size, ksize, stride):
    """``(before, after)`` padding of XLA's ``SAME`` along one axis: the
    output has ``ceil(size / stride)`` positions and the odd pad goes
    after.  With stride 2 and k=3 that is (0, 1) for even sizes and (1, 1)
    for odd ones — which torch's symmetric ``padding=1`` gets wrong."""
    out = -(-size // stride)
    total = max((out - 1) * stride + ksize - size, 0)
    return total // 2, total - total // 2


def conv_apply(p, x, stride=1, dtype=None):
    """SAME-padded conv over NHWC ``x`` with an OIHW kernel; the bias is
    added in the compute dtype, as the reference adds it."""
    dtype = dtype or x.dtype
    w = p["w"].to(dtype)
    k = w.shape[-1]
    xc = x.to(dtype).permute(0, 3, 1, 2)  # NCHW view of NHWC memory
    h0, h1 = same_padding(xc.shape[2], k, stride)
    w0, w1 = same_padding(xc.shape[3], k, stride)
    xc = F.pad(xc, (w0, w1, h0, h1))
    out = F.conv2d(xc, w, stride=stride).permute(0, 2, 3, 1)
    return out + p["b"].to(dtype)


def dense_init(d_in, d_out, *, generator, device="cuda"):
    """He-normal dense weight, kept ``(in, out)`` as in the reference
    (``x @ w``, not ``nn.Linear``'s ``(out, in)``), + zero bias."""
    w = torch.randn((d_in, d_out), generator=generator, device=device) * math.sqrt(
        2.0 / d_in
    )
    return {"w": w, "b": torch.zeros((d_out,), device=device)}


def dense_apply(p, x, dtype=None):
    dtype = dtype or x.dtype
    return x.to(dtype) @ p["w"].to(dtype) + p["b"].to(dtype)


def gelu(x):
    """GELU with the tanh approximation, ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


def rope_table(positions, dh, base=10000.0):
    """Rotary-embedding cos/sin tables, each ``(len(positions), dh // 2)``
    f32, for integer ``positions`` at per-head dim ``dh`` (even)."""
    half = dh // 2
    exponent = -torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(base, dtype=torch.float32, device=positions.device),
                      exponent)
    ang = positions.to(torch.float32)[:, None] * freqs[None]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """Rotate (B, T, H, Dh) (or (B, H, Dh) single-position) q/k by the
    tables from :func:`rope_table`: the head dim splits into two halves
    (not interleaved pairs), rotated in f32 and cast back."""
    single = x.ndim == 3
    if single:
        x = x[:, None]
    x32 = x.to(torch.float32)
    x1, x2 = torch.chunk(x32, 2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)
    return out[:, 0] if single else out
