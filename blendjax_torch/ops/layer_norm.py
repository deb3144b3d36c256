"""Layer norm: the SeqFormer's f32 layer norm over the last axis (eps 1e-6,
the population variance, the result cast back to the input's dtype), as one
hand-written CUDA kernel forward and one backward (K5, ``csrc/layer_norm_fwd.cu``
and ``csrc/layer_norm_bwd.cu``).

The RMS mode (RMSNorm: no mean, no bias, ``y = x * rsqrt(mean(x^2) +
eps) * scale``, the norms of MLA and DeepSeekMoE blocks) runs on the same
kernels, forward and backward: :func:`rms_norm_fwd_plain`,
:func:`rms_norm_fwd_cuda`, :func:`rms_norm_bwd_plain`,
:func:`rms_norm_bwd_cuda` and :class:`RMSNorm`, with the eps the caller
gives (the LayerNorm keeps 1e-6).

Two passes, each with a plain PyTorch version and a CUDA kernel for
Hopper:

- forward: :func:`layer_norm_fwd_plain`, :func:`layer_norm_fwd_cuda`:
  y, and the per-row f32 mean and rstd the backward reuses;
- backward: :func:`layer_norm_bwd_plain` (the closed form),
  :func:`layer_norm_bwd_cuda`: dx in the input's dtype, dscale and dbias in
  f32.

:class:`LayerNorm` is the autograd function over the kernels; it saves
the input as it came (the bf16 residual, not an f32 copy), the two
statistics and the scale.  The plain forward alone is also the composition
of tensor ops that autograd differentiates op by op: the CPU's route and
the DTensor's (``seqformer._ln_apply``).  The closed-form plain backward
is the kernel's reference, in the tests and on the card.

The kernels replace no Pallas kernel: the JAX
package leaves its layer norm (``blendjax/models/seqformer.py::_ln_apply``)
to XLA, which fuses it.  A layer norm is bound by bytes, and the plain
composition makes a full f32 pass over device memory for each of its ops,
forward and backward; the kernels move each byte once per pass (one warp a
row, the row in registers, the column sums of the backward in per-block
partials summed in a fixed order, so gradients repeat bit for bit).

:func:`kernel_route` raises for what has no kernel: a dtype other than
float32 and bfloat16, or a width that is not a multiple of 32
from 32 to 4,096.  A CUDA tensor goes to the kernel or raises; there is no
fallback.
"""

from __future__ import annotations

import ctypes

import torch

from blendjax_torch.utils import launches

EPS = 1e-6
#: the kernels' dtype codes
KINDS = {torch.float32: 0, torch.bfloat16: 1}
#: widths the kernels take: multiples of 32 up to this
MAX_WIDTH = 4096


def kernel_route(dtype, d):
    """Raise ValueError unless the kernels take rows of ``dtype`` and width
    ``d``; a dispatch on what the input is, not a fallback."""
    if dtype not in KINDS:
        raise ValueError(f"the layer norm kernels take float32 or bfloat16, not {dtype}")
    if d % 32 or not 32 <= d <= MAX_WIDTH:
        raise ValueError(f"the layer norm kernels take widths that are multiples of 32 "
                         f"from 32 to {MAX_WIDTH}, not {d}")


# -- plain passes --------------------------------------------------------------


def layer_norm_fwd_plain(x, scale, bias, eps=EPS):
    """(y in x's dtype, mean, rstd (x.shape[:-1], f32)): the normalised x32
    times scale plus bias, in f32."""
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    rstd = torch.rsqrt(var + eps)
    out = (x32 - mu) * rstd
    return (out * scale + bias).to(x.dtype), mu.squeeze(-1), rstd.squeeze(-1)


def layer_norm_bwd_plain(dy, x, mean, rstd, scale):
    """The closed-form backward: with xhat = (x - mean) * rstd and g = dy *
    scale, dx = rstd * (g - mean(g) - xhat * mean(g * xhat)) in x's dtype,
    dscale = sum over rows of dy * xhat and dbias of dy, in f32."""
    d = x.shape[-1]
    x32, dy32 = x.reshape(-1, d).float(), dy.reshape(-1, d).float()
    mu, rs = mean.reshape(-1, 1), rstd.reshape(-1, 1)
    xhat = (x32 - mu) * rs
    g = dy32 * scale.float()
    dx = rs * (g - g.mean(-1, keepdim=True) - xhat * (g * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype).reshape(x.shape), (dy32 * xhat).sum(0), dy32.sum(0)


# -- CUDA kernels ----------------------------------------------------------------


def _library():
    from blendjax_torch.ops._build import load_library

    lib = load_library()
    if not hasattr(lib, "_bjx_ln_typed"):
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.bjx_layer_norm_fwd.argtypes = [p] * 6 + [ll, i, f, i, p]
        lib.bjx_layer_norm_bwd_blocks.argtypes = [i, i, ll, ctypes.POINTER(i)]
        lib.bjx_layer_norm_bwd.argtypes = [p] * 9 + [ll, i, i, i, p]
        lib.bjx_rms_norm_fwd.argtypes = [p] * 4 + [ll, i, f, i, p]
        lib.bjx_rms_norm_bwd_blocks.argtypes = [i, i, ll, ctypes.POINTER(i)]
        lib.bjx_rms_norm_bwd.argtypes = [p] * 7 + [ll, i, i, i, p]
        for fn in (lib.bjx_layer_norm_fwd, lib.bjx_layer_norm_bwd_blocks,
                   lib.bjx_layer_norm_bwd, lib.bjx_rms_norm_fwd, lib.bjx_rms_norm_bwd_blocks,
                   lib.bjx_rms_norm_bwd):
            fn.restype = ctypes.c_int
        lib._bjx_ln_typed = True
    return lib


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def _rows(x, name):
    """x as contiguous (rows, d) with a 16-byte aligned base, after the
    route check."""
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        raise ValueError(f"{name} needs CUDA tensors")
    d = x.shape[-1]
    kernel_route(x.dtype, d)
    x2 = x.reshape(-1, d).contiguous()
    return x2 if x2.data_ptr() % 16 == 0 else x2.clone()


def _param(t, x, d, name):
    if t.shape != (d,) or t.device != x.device or t.dtype != torch.float32:
        raise ValueError(f"{name}: scale and bias must be float32 ({d},) on {x.device}")
    return t.contiguous()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def layer_norm_fwd_cuda(x, scale, bias, eps=EPS):
    """Launch the forward kernel; same contract as
    :func:`layer_norm_fwd_plain`.  :attr:`launches` counts launches."""
    x2 = _rows(x, "layer_norm_fwd_cuda")
    rows, d = x2.shape
    scale = _param(scale, x, d, "layer_norm_fwd_cuda")
    bias = _param(bias, x, d, "layer_norm_fwd_cuda")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if rows == 0:
        return y, mean, rstd
    kind = KINDS[x.dtype]
    with torch.cuda.device(x.device):
        err = _library().bjx_layer_norm_fwd(
            x2.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), rows, d, float(eps), kind, _stream(x))
    _raise_on(err, "layer_norm_fwd")
    layer_norm_fwd_cuda.launches += 1
    return y, mean, rstd


def layer_norm_bwd_cuda(dy, x, mean, rstd, scale):
    """Launch the backward kernel and its partial sums (one launch
    counted); same contract as :func:`layer_norm_bwd_plain`.
    :attr:`launches` counts launches."""
    x2 = _rows(x, "layer_norm_bwd_cuda")
    rows, d = x2.shape
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"layer_norm_bwd_cuda: dy {tuple(dy.shape)} {dy.dtype} does not "
                         f"match x {tuple(x.shape)} {x.dtype}")
    dy2 = _rows(dy, "layer_norm_bwd_cuda")
    stats = []
    for t in (mean, rstd):
        if t.dtype != torch.float32 or t.device != x.device or t.numel() != rows:
            raise ValueError(f"layer_norm_bwd_cuda: mean and rstd must be float32 with "
                             f"{rows} values on {x.device}")
        stats.append(t.reshape(rows).contiguous())
    scale = _param(scale, x, d, "layer_norm_bwd_cuda")
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    dbias = torch.empty_like(dscale)
    if rows == 0:
        return dx, dscale.zero_(), dbias.zero_()
    kind, blocks = KINDS[x.dtype], ctypes.c_int(0)
    with torch.cuda.device(x.device):
        _raise_on(_library().bjx_layer_norm_bwd_blocks(kind, d, rows, ctypes.byref(blocks)),
                  "layer_norm_bwd")
        # the kernel's blocks each write a partial row of dscale and of dbias
        partial = torch.empty((blocks.value, 2, d), dtype=torch.float32, device=x.device)
        err = _library().bjx_layer_norm_bwd(
            dy2.data_ptr(), x2.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
            scale.data_ptr(), dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), rows, d, kind, blocks.value, _stream(x))
    _raise_on(err, "layer_norm_bwd")
    layer_norm_bwd_cuda.launches += 1
    return dx, dscale, dbias


def rms_norm_fwd_plain(x, scale, eps):
    """(y in x's dtype, rstd (x.shape[:-1], f32)): x32 * rsqrt(mean(x32^2)
    + eps) * scale, in f32."""
    x32 = x.to(torch.float32)
    rstd = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * rstd * scale).to(x.dtype), rstd.squeeze(-1)


def rms_norm_bwd_plain(dy, x, rstd, scale):
    """The closed-form backward of the RMS mode: with xhat = x * rstd and g
    = dy * scale, dx = rstd * (g - xhat * mean(g * xhat)) in x's dtype, and
    dscale = sum over rows of dy * xhat in f32."""
    d = x.shape[-1]
    x32, dy32 = x.reshape(-1, d).float(), dy.reshape(-1, d).float()
    rs = rstd.reshape(-1, 1)
    xhat = x32 * rs
    g = dy32 * scale.float()
    dx = rs * (g - xhat * (g * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype).reshape(x.shape), (dy32 * xhat).sum(0)


def rms_norm_fwd_cuda(x, scale, eps):
    """Launch the forward kernel in its RMS mode; same contract as
    :func:`rms_norm_fwd_plain`.  :attr:`launches` counts launches."""
    x2 = _rows(x, "rms_norm_fwd_cuda")
    rows, d = x2.shape
    scale = _param(scale, x, d, "rms_norm_fwd_cuda")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if rows == 0:
        return y, rstd
    with torch.cuda.device(x.device):
        err = _library().bjx_rms_norm_fwd(x2.data_ptr(), scale.data_ptr(), y.data_ptr(),
                                          rstd.data_ptr(), rows, d, float(eps), KINDS[x.dtype],
                                          _stream(x))
    _raise_on(err, "rms_norm_fwd")
    rms_norm_fwd_cuda.launches += 1
    return y, rstd


def rms_norm_bwd_cuda(dy, x, rstd, scale):
    """Launch the backward kernel in its RMS mode and its partial sums (one
    launch counted); same contract as :func:`rms_norm_bwd_plain`.
    :attr:`launches` counts launches."""
    x2 = _rows(x, "rms_norm_bwd_cuda")
    rows, d = x2.shape
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rms_norm_bwd_cuda: dy {tuple(dy.shape)} {dy.dtype} does not "
                         f"match x {tuple(x.shape)} {x.dtype}")
    dy2 = _rows(dy, "rms_norm_bwd_cuda")
    if rstd.dtype != torch.float32 or rstd.device != x.device or rstd.numel() != rows:
        raise ValueError(f"rms_norm_bwd_cuda: rstd must be float32 with {rows} values on "
                         f"{x.device}")
    rstd = rstd.reshape(rows).contiguous()
    scale = _param(scale, x, d, "rms_norm_bwd_cuda")
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    if rows == 0:
        return dx, dscale.zero_()
    kind, blocks = KINDS[x.dtype], ctypes.c_int(0)
    with torch.cuda.device(x.device):
        _raise_on(_library().bjx_rms_norm_bwd_blocks(kind, d, rows, ctypes.byref(blocks)),
                  "rms_norm_bwd")
        partial = torch.empty((blocks.value, d), dtype=torch.float32, device=x.device)
        err = _library().bjx_rms_norm_bwd(
            dy2.data_ptr(), x2.data_ptr(), rstd.data_ptr(), scale.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), dscale.data_ptr(), rows, d, kind, blocks.value, _stream(x))
    _raise_on(err, "rms_norm_bwd")
    rms_norm_bwd_cuda.launches += 1
    return dx, dscale


for _fn in (layer_norm_fwd_cuda, layer_norm_bwd_cuda, rms_norm_fwd_cuda, rms_norm_bwd_cuda):
    launches.counted(_fn)
del _fn


class LayerNorm(torch.autograd.Function):
    """x (..., d), scale and bias (d,) -> y (..., d) in x's dtype, through
    the kernels: CUDA tensors only (a CPU tensor takes the plain forward,
    which autograd differentiates, in ``seqformer._ln_apply``)."""

    @staticmethod
    def forward(ctx, x, scale, bias):
        y, mean, rstd = layer_norm_fwd_cuda(x, scale, bias)
        ctx.save_for_backward(x, mean, rstd, scale)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd, scale = ctx.saved_tensors
        return layer_norm_bwd_cuda(dy.to(x.dtype), x, mean, rstd, scale)


class RMSNorm(torch.autograd.Function):
    """x (..., d), scale (d,) -> y (..., d) in x's dtype, through the
    kernels' RMS mode: CUDA tensors only (a CPU tensor takes
    :func:`rms_norm_fwd_plain`, which autograd differentiates)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        y, rstd = rms_norm_fwd_cuda(x, scale, eps)
        ctx.save_for_backward(x, rstd, scale)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, rstd, scale = ctx.saved_tensors
        return (*rms_norm_bwd_cuda(dy.to(x.dtype), x, rstd, scale), None)
