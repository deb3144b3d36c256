"""K5, the layer norm kernels, on the card: each pass against its plain
version at the benchmark cells' rows (131,072 x 1,024 bf16), a decode
step's (16 x 1,024 bf16) and a small model's (4,096 x 128 f32); the
backward's gradients bit-identical over two runs; the autograd function
and the SeqFormer's norm through the kernels.  Needs an NVIDIA card: every
test skips without one.  Run on the card:

    python -m pytest tests/test_torch_layer_norm_cuda.py -q

Tolerances (chip_smoke.py's LN_* limits, with their reasons): y and dx in
bf16 within 1e-5 plus two bf16 ulps of the plain value; in f32, y, mean
and rstd within rtol 1e-5 and dx within 5e-5 of (1 + |plain|); dscale and
dbias within 1e-6 of the sum of their terms' magnitudes."""

import pytest
import torch

from blendjax_torch.models import seqformer
from blendjax_torch.ops import layer_norm as ln

pytestmark = pytest.mark.cuda

CASES = [((131072, 1024), torch.bfloat16), ((16, 1024), torch.bfloat16),
         ((4096, 128), torch.float32)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


def _inputs(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    scale = 1 + 0.1 * torch.randn(shape[-1], generator=g, device="cuda")
    bias = 0.1 * torch.randn(shape[-1], generator=g, device="cuda")
    return x, dy, scale, bias


def _assert_close(got, want, rtol):
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        mag = want.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
        allowed = 1e-5 + 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7)
    else:
        allowed = rtol * (1 + want.float().abs())
    assert bool(torch.isfinite(got).all()) and bool((err <= allowed).all()), err.max().item()


@pytest.mark.parametrize("shape, dtype", CASES)
def test_forward_matches_plain(card, shape, dtype):
    x, _, scale, bias = _inputs(shape, dtype, 0)
    got = ln.layer_norm_fwd_cuda(x, scale, bias)
    for g, w in zip(got, ln.layer_norm_fwd_plain(x, scale, bias)):
        assert g.dtype == w.dtype and g.shape == w.shape
        _assert_close(g, w, 1e-5)


@pytest.mark.parametrize("shape, dtype", CASES)
def test_backward_matches_plain_and_repeats(card, shape, dtype):
    x, dy, scale, bias = _inputs(shape, dtype, 1)
    _, mean, rstd = ln.layer_norm_fwd_cuda(x, scale, bias)
    got = ln.layer_norm_bwd_cuda(dy, x, mean, rstd, scale)
    again = ln.layer_norm_bwd_cuda(dy, x, mean, rstd, scale)
    dx, dscale, dbias = ln.layer_norm_bwd_plain(dy, x, mean, rstd, scale)
    _assert_close(got[0], dx, 5e-5)
    xhat = (x.float() - mean[:, None]) * rstd[:, None]
    for g, w, terms in ((got[1], dscale, dy.float() * xhat), (got[2], dbias, dy.float())):
        assert g.dtype == torch.float32
        assert bool(((g - w).abs() <= 1e-6 * terms.abs().sum(0) + 1e-6).all())
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_seqformer_norm_goes_through_the_kernels(card):
    """The SeqFormer's norm on a CUDA tensor launches the forward kernel,
    its backward the backward kernel, and both agree with the composition
    autograd differentiates."""
    x, dy, scale, bias = _inputs((4, 64, 1024), torch.bfloat16, 2)
    p = {"scale": scale.clone().requires_grad_(True), "bias": bias.clone().requires_grad_(True)}
    xg = x.clone().requires_grad_(True)
    fwd, bwd = ln.layer_norm_fwd_cuda.launches, ln.layer_norm_bwd_cuda.launches
    y = seqformer._ln_apply(p, xg)
    got = torch.autograd.grad(y, (xg, p["scale"], p["bias"]), dy)
    assert (ln.layer_norm_fwd_cuda.launches - fwd, ln.layer_norm_bwd_cuda.launches - bwd) == (1, 1)
    xr = x.clone().requires_grad_(True)
    sr, br = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    yr = ln.layer_norm_fwd_plain(xr, sr, br)[0]
    want = torch.autograd.grad(yr, (xr, sr, br), dy)
    _assert_close(y, yr, 1e-5)
    _assert_close(got[0], want[0], 5e-5)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-4)


def test_route_raises_on_a_cuda_tensor_without_a_kernel(card):
    scale, bias = torch.ones(48, device=card), torch.zeros(48, device=card)
    with pytest.raises(ValueError, match="layer norm kernels take"):
        ln.layer_norm_fwd_cuda(torch.zeros(3, 48, device=card), scale, bias)
    with pytest.raises(ValueError, match="layer norm kernels take"):
        ln.layer_norm_fwd_cuda(torch.zeros(3, 64, device=card, dtype=torch.float64),
                               torch.ones(64, device=card), torch.zeros(64, device=card))
