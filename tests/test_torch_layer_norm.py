"""The layer norm of ``blendjax_torch.ops.layer_norm`` on the CPU: the plain
forward and the closed-form backward against autograd of the SeqFormer's
``_ln_apply`` (the composition of tensor ops a CPU tensor takes) and
against ``jax.vjp`` of the JAX package's ``_ln_apply``; the route check
the CUDA wrappers run; and the autograd function's refusal of a CPU
tensor (it runs the kernels alone).  The kernels themselves are held to the plain passes on the card
(tests/test_torch_layer_norm_cuda.py, chip_smoke.py).

Tolerances.  float32: the closed form, autograd's op-by-op chain and XLA
round at different places and sum the rows' means in different orders, so
dx is held to atol = rtol 2e-6 (the largest gap seen is 2.2e-7), and the
column sums dscale and dbias, over up to 300 rows, to atol = rtol 5e-5
(6.5e-6 seen, against XLA's sums).  bfloat16: dx is rounded to bf16 by
each, so a value can fall one bf16 ulp apart: atol = rtol 2e-2
(test_layer_norm_matches_jax's bf16 limit); dscale and dbias stay f32 sums
of the same bf16 inputs and keep the float32 limits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax.models import seqformer as jseq
from blendjax_torch.models import seqformer as tseq
from blendjax_torch.ops import layer_norm as ln

F32_DX, F32_SUM, BF16_DX = 2e-6, 5e-5, 2e-2


def _inputs(rows, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, d)) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal((rows, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, dy, scale, bias


def _f32(t):
    return np.asarray(t.detach().to(torch.float32).numpy()) if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _autograd(x, dy, scale, bias):
    """dx, dscale, dbias by autograd of the SeqFormer's _ln_apply."""
    x = x.clone().requires_grad_(True)
    s, b = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    y = tseq._ln_apply({"scale": s, "bias": b}, x)
    return torch.autograd.grad(y, (x, s, b), dy)


def _jax_vjp(x, dy, scale, bias, dtype):
    """dx, dscale, dbias by jax.vjp of the JAX package's _ln_apply."""
    jdt = getattr(jnp, dtype)

    def f(xj, s, b):
        return jseq._ln_apply({"scale": s, "bias": b}, xj)

    _, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias))
    return vjp(jnp.asarray(dy, jdt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64, 128, 1024])
@pytest.mark.parametrize("rows", [1, 7, 300])
def test_closed_form_backward_matches_autograd_and_jax(dtype, d, rows):
    x_np, dy_np, s_np, b_np = _inputs(rows, d, seed=rows * 10_000 + d)
    tdt = getattr(torch, dtype)
    x, dy = torch.from_numpy(x_np).to(tdt), torch.from_numpy(dy_np).to(tdt)
    scale, bias = torch.from_numpy(s_np), torch.from_numpy(b_np)
    _, mean, rstd = ln.layer_norm_fwd_plain(x, scale, bias)
    got = ln.layer_norm_bwd_plain(dy, x, mean, rstd, scale)
    assert got[0].dtype == tdt and got[1].dtype == got[2].dtype == torch.float32
    dx_tol = F32_DX if dtype == "float32" else BF16_DX
    for want in (_autograd(x, dy, scale, bias), _jax_vjp(x_np, dy_np, s_np, b_np, dtype)):
        np.testing.assert_allclose(_f32(got[0]), _f32(want[0]), atol=dx_tol, rtol=dx_tol)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(_f32(g), _f32(w), atol=F32_SUM, rtol=F32_SUM)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_is_the_composition(dtype):
    """The CPU route of _ln_apply and the plain forward give today's
    composition bit for bit, and its statistics."""
    x_np, _, s_np, b_np = _inputs(12, 64, seed=3)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(x_np).to(tdt).reshape(3, 4, 64)
    scale, bias = torch.from_numpy(s_np), torch.from_numpy(b_np)
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    want = ((x32 - mu) * torch.rsqrt(var + 1e-6) * scale + bias).to(tdt)
    p = {"scale": scale, "bias": bias}
    assert torch.equal(tseq._ln_apply(p, x), want)
    y, mean, rstd = ln.layer_norm_fwd_plain(x, scale, bias)
    assert torch.equal(y, want) and mean.shape == rstd.shape == (3, 4)
    assert torch.equal(mean, mu.squeeze(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_function_refuses_cpu_tensors(dtype):
    """LayerNorm runs the kernels alone: a CPU tensor, which _ln_apply
    sends to the plain forward, is refused rather than computed another
    way."""
    x = torch.zeros(2, 5, 128, dtype=getattr(torch, dtype), requires_grad=True)
    scale, bias = torch.ones(128, requires_grad=True), torch.zeros(128, requires_grad=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ln.LayerNorm.apply(x, scale, bias)


@pytest.mark.parametrize("dtype, d", [(torch.float64, 1024), (torch.bfloat16, 48),
                                      (torch.bfloat16, 8192), (torch.float32, 16),
                                      (torch.float16, 1024)])
def test_kernel_route_raises_without_a_kernel(dtype, d):
    with pytest.raises(ValueError, match="layer norm kernels take"):
        ln.kernel_route(dtype, d)


@pytest.mark.parametrize("dtype, d", [(torch.float32, 32), (torch.bfloat16, 64),
                                      (torch.bfloat16, 1024), (torch.float32, 4064),
                                      (torch.bfloat16, 4096)])
def test_kernel_route_takes_the_widths(dtype, d):
    ln.kernel_route(dtype, d)


def test_cuda_wrappers_refuse_cpu_tensors():
    x, dy = torch.zeros(3, 64), torch.zeros(3, 64)
    scale, bias = torch.ones(64), torch.zeros(64)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ln.layer_norm_fwd_cuda(x, scale, bias)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ln.layer_norm_bwd_cuda(dy, x, torch.zeros(3), torch.ones(3), scale)
