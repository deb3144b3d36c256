"""The port's flash attention against the JAX package's: the plain forward,
dQ and dK/dV passes against ``_flash_fwd_impl``/``_dq_pass``/``_dkv_pass``
(Pallas in interpret mode, as tests/test_flash_attention.py runs it),
``flash_attention``'s values and gradients through the autograd function
against the reference's ``custom_vjp``, and the same ValueErrors.  The same
seeded numpy inputs go to both.

Tolerances (atol = rtol) are tests/test_flash_attention.py's: float32
forward and lse 2e-5, gradients 5e-5, GQA gradients 1e-4; bfloat16
forward 2e-2 and gradients 5e-2.  The CUDA kernels are held against these
plain passes on the card by chip_smoke.py; the arithmetic of the
tensor-core kernels (bf16 operands, P and dS as bf16 hi + lo pairs) is
emulated here in plain PyTorch and held against the Pallas passes at the
f32 limits."""

import importlib
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax_torch.ops import flash_attention as tflash

jflash = importlib.import_module("blendjax.ops.flash_attention")

F32_FWD, F32_GRAD, GQA_GRAD = 2e-5, 5e-5, 1e-4
BF16_FWD, BF16_GRAD = 2e-2, 5e-2

# id: (b, tq, tk, h, h_kv, d, dtype, causal, window, q_offset, out_dtype, block_q, block_kv)
CASES = {
    "causal": (2, 128, 128, 4, 4, 32, "float32", True, None, 0, None, 64, 64),
    "non-causal": (2, 128, 128, 4, 4, 32, "float32", False, None, 0, None, 64, 64),
    "window-48": (2, 128, 128, 4, 4, 32, "float32", True, 48, 0, None, 64, 32),
    "gqa-4q-2kv": (2, 128, 128, 4, 2, 16, "float32", True, None, 0, None, 64, 32),
    "t96-blocks-32": (2, 96, 96, 2, 2, 16, "float32", True, None, 0, None, 32, 32),
    "q-offset-64": (2, 64, 128, 2, 2, 16, "float32", True, None, 64, None, 64, 64),
    "q-offset-128-window-160": (1, 128, 128, 2, 2, 16, "float32", True, 160, 128, None,
                                64, 64),
    "q-offset-256-window-48-no-row-sees": (1, 128, 128, 2, 2, 16, "float32", True, 48,
                                           256, None, 64, 64),
    "bf16-in-f32-out": (2, 128, 128, 2, 2, 32, "bfloat16", True, None, 0, "float32",
                        64, 64),
}


def _randn(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":  # values exactly representable in bf16 for both
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


def _j(x, dtype="float32"):
    return jnp.asarray(x, getattr(jnp, dtype))


def _t(x, dtype="float32"):
    return torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, tol, what):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_passes_match_the_pallas_passes(case):
    """Forward (O and lse), dQ and dK/dV on the same inputs; the backward
    passes get the reference forward's lse and delta."""
    b, tq, tk, h, h_kv, d, dtype, causal, window, q_offset, out_dtype, bq, bkv = CASES[case]
    rng = np.random.default_rng(len(case))
    q, do = _randn(rng, (b, tq, h, d), dtype), _randn(rng, (b, tq, h, d), dtype)
    k, v = _randn(rng, (b, tk, h_kv, d), dtype), _randn(rng, (b, tk, h_kv, d), dtype)
    scale = 1.0 / d ** 0.5
    heads = (h, h_kv) if h != h_kv else None
    jout = getattr(jnp, out_dtype) if out_dtype else None
    tout = getattr(torch, out_dtype) if out_dtype else None
    kw = dict(window=window, q_offset=q_offset)

    jo, (jqf, jkf, jvf, jof, jlse) = jflash._flash_fwd_impl(
        _j(q, dtype), _j(k, dtype), _j(v, dtype), causal, scale, bq, bkv, True,
        out_dtype=jout, **kw)
    to, (tqf, tkf, tvf, tof, tlse) = tflash._flash_fwd_impl(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), causal, scale, bq, bkv,
        out_dtype=tout, **kw)
    fwd_tol = BF16_FWD if dtype == "bfloat16" and out_dtype is None else F32_FWD
    assert to.dtype == getattr(torch, out_dtype or dtype) and tuple(to.shape) == jo.shape
    _close(to, jo, fwd_tol, "O")
    assert tuple(tlse.shape) == jlse.shape == (b * h, tq, 1)
    _close(tlse, jlse, F32_FWD, "lse")

    jdof = jflash._flat(_j(do, dtype))
    jdelta = (jdof.astype(jnp.float32) * jof.astype(jnp.float32)).sum(-1, keepdims=True)
    tdof, tdelta, tlse_ref = tflash._flat(_t(do, dtype)), _t(jdelta), _t(jlse)
    grad_tol = {"bfloat16": BF16_GRAD}.get(dtype, GQA_GRAD if heads else F32_GRAD)
    jdq = jflash._dq_pass(jqf, jkf, jvf, jdof, jlse, jdelta, causal, scale, bq, bkv, True,
                          heads=heads, **kw)
    tdq = tflash._dq_pass(tqf, tkf, tvf, tdof, tlse_ref, tdelta, causal, scale, bq, bkv,
                          heads=heads, **kw)
    _close(tdq, jdq, grad_tol, "dQ")
    pdt = jnp.float32 if heads else None
    jdk, jdv = jflash._dkv_pass(jqf, jkf, jvf, jdof, jlse, jdelta, causal, scale, bq, bkv,
                                True, heads=heads, out_dtype=pdt, **kw)
    tdk, tdv = tflash._dkv_pass(tqf, tkf, tvf, tdof, tlse_ref, tdelta, causal, scale, bq,
                                bkv, heads=heads,
                                out_dtype=torch.float32 if heads else None, **kw)
    assert tuple(tdk.shape) == jdk.shape == (b * h, tk, d)  # per q head under GQA
    _close(tdk, jdk, grad_tol, "dK")
    _close(tdv, jdv, grad_tol, "dV")


LOG2E = 1.4426950408889634


def _split(x):
    """x = hi + lo in bf16 terms, as f32: hi = bf16_rn(x), lo = bf16_rn(x - hi)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _tensor_core_backward(qf, kf, vf, dof, lse, delta, causal, scale, window, q_offset,
                          heads):
    """(dQ, dK, dV) as csrc/flash_bwd_tc.cu computes them, in plain PyTorch:
    bf16 operands, whose products are exact in f32; S and dP as one f32
    product each; P = exp2((S * scale - lse) * log2 e); P and dS split into
    bf16 hi + lo, both into one f32 sum."""
    bh, tq, _ = qf.shape
    q, do = qf.float(), dof.float()
    k = tflash._expand_kv(kf, bh, heads).float()
    v = tflash._expand_kv(vf, bh, heads).float()
    for x in (q, do, k, v):
        assert torch.equal(x, x.to(torch.bfloat16).float()), "inputs must be bf16-exact"
    keep = tflash._visible(tq, kf.shape[1], causal, window, q_offset, qf.device)
    p = torch.exp2((torch.matmul(q, k.transpose(-1, -2)) * scale - lse) * LOG2E)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - delta) * scale
    (p_hi, p_lo), (ds_hi, ds_lo) = _split(p), _split(ds)
    dq = torch.matmul(ds_hi, k) + torch.matmul(ds_lo, k)
    dk = torch.matmul(ds_hi.transpose(-1, -2), q) + torch.matmul(ds_lo.transpose(-1, -2), q)
    dv = torch.matmul(p_hi.transpose(-1, -2), do) + torch.matmul(p_lo.transpose(-1, -2), do)
    return dq, dk, dv


# the cases of the tensor-core route: CASES' f32 ones, their inputs rounded
# to bf16 values, and a ragged T = 17
TC_CASES = dict({k: v for k, v in CASES.items() if v[6] == "float32"},
                t17=(2, 17, 17, 2, 2, 32, "float32", True, None, 0, None, 17, 17))

#: the forward kernel's kv tile (csrc/flash_fwd_tc.cu's kRows)
TC_TILE = 64


def _tensor_core_forward(qf, kf, vf, causal, scale, window, q_offset, heads):
    """(O in f32, lse) as csrc/flash_fwd_tc.cu computes them, in plain
    PyTorch: bf16 operands, whose products are exact in f32; S one f32
    product per 64-column kv tile, scaled, masked to -1e30; the running max
    from -1e30, P = exp2((s - m) log2 e) with masked entries 0, alpha =
    exp2((m_old - m_new) log2 e) rescaling O and l; l the sum of the f32 P;
    P V as bf16 hi + lo into one f32 sum.  A kv tile no row of a q tile
    sees changes nothing (alpha = 1, P = 0), so every tile is visited."""
    bh, tq, d = qf.shape
    tk = kf.shape[1]
    q = qf.float()
    k = tflash._expand_kv(kf, bh, heads).float()
    v = tflash._expand_kv(vf, bh, heads).float()
    for x in (q, k, v):
        assert torch.equal(x, x.to(torch.bfloat16).float()), "inputs must be bf16-exact"
    keep = tflash._visible(tq, tk, causal, window, q_offset, qf.device)
    m = torch.full((bh, tq, 1), -1e30)
    l = torch.zeros((bh, tq, 1))
    acc = torch.zeros((bh, tq, d))
    for c0 in range(0, tk, TC_TILE):
        kt, vt = k[:, c0:c0 + TC_TILE], v[:, c0:c0 + TC_TILE]
        s = torch.matmul(q, kt.transpose(-1, -2)) * scale
        if keep is not None:
            s = torch.where(keep[:, c0:c0 + TC_TILE], s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2((s - m_new) * LOG2E)
        if keep is not None:
            p = torch.where(keep[:, c0:c0 + TC_TILE], p, torch.zeros_like(p))
        alpha = torch.exp2((m - m_new) * LOG2E)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi, p_lo = _split(p)
        acc = acc * alpha + torch.matmul(p_hi, vt) + torch.matmul(p_lo, vt)
        m = m_new
    safe = torch.where(l == 0, torch.ones_like(l), l)
    return acc / safe, m + torch.log(safe)


@pytest.mark.parametrize("case", list(TC_CASES))
def test_tensor_core_forward_matches_the_pallas_forward(case):
    """The forward's 64-column tiles, running max, exp2 and bf16 hi + lo
    P V keep O and lse within the reference's f32 forward limit: the
    emulation on bf16 inputs against ``_flash_fwd_impl`` with f32 outputs,
    atol = rtol 2e-5."""
    b, tq, tk, h, h_kv, d, _, causal, window, q_offset, _, bq, bkv = TC_CASES[case]
    rng = np.random.default_rng(11 + len(case))
    q = _randn(rng, (b, tq, h, d), "bfloat16")
    k, v = (_randn(rng, (b, tk, h_kv, d), "bfloat16") for _ in range(2))
    scale = 1.0 / d ** 0.5
    heads = (h, h_kv) if h != h_kv else None
    kw = dict(window=window, q_offset=q_offset)
    jo, (*_, jlse) = jflash._flash_fwd_impl(
        _j(q, "bfloat16"), _j(k, "bfloat16"), _j(v, "bfloat16"), causal, scale, bq, bkv,
        True, out_dtype=jnp.float32, **kw)
    to, tlse = _tensor_core_forward(
        *(tflash._flat(_t(x, "bfloat16")) for x in (q, k, v)), causal, scale, window,
        q_offset, heads)
    _close(tflash._unflat(to, b, h), jo, F32_FWD, "O")
    _close(tlse, jlse, F32_FWD, "lse")


@pytest.mark.parametrize("case", list(TC_CASES))
def test_tensor_core_arithmetic_matches_the_pallas_passes(case):
    """The bf16 hi + lo split keeps the gradients within the reference's
    f32 limits: the emulation on bf16-exact inputs against ``_dq_pass`` and
    ``_dkv_pass`` with f32 outputs, atol = rtol 5e-5 (1e-4 under GQA)."""
    b, tq, tk, h, h_kv, d, _, causal, window, q_offset, _, bq, bkv = TC_CASES[case]
    rng = np.random.default_rng(7 + len(case))
    q, do = _randn(rng, (b, tq, h, d), "bfloat16"), _randn(rng, (b, tq, h, d), "bfloat16")
    k = _randn(rng, (b, tk, h_kv, d), "bfloat16")
    v = _randn(rng, (b, tk, h_kv, d), "bfloat16")
    scale = 1.0 / d ** 0.5
    heads = (h, h_kv) if h != h_kv else None
    kw = dict(window=window, q_offset=q_offset)
    _, (jqf, jkf, jvf, jof, jlse) = jflash._flash_fwd_impl(
        _j(q), _j(k), _j(v), causal, scale, bq, bkv, True, **kw)
    jdof = jflash._flat(_j(do))
    jdelta = (jdof * jof).sum(-1, keepdims=True)
    jdq = jflash._dq_pass(jqf, jkf, jvf, jdof, jlse, jdelta, causal, scale, bq, bkv, True,
                          heads=heads, **kw)
    jdk, jdv = jflash._dkv_pass(jqf, jkf, jvf, jdof, jlse, jdelta, causal, scale, bq, bkv,
                                True, heads=heads, out_dtype=jnp.float32, **kw)
    tdq, tdk, tdv = _tensor_core_backward(
        *(tflash._flat(_t(x, "bfloat16")) for x in (q, k, v, do)), _t(jlse), _t(jdelta),
        causal, scale, window, q_offset, heads)
    tol = GQA_GRAD if heads else F32_GRAD
    _close(tdq, jdq, tol, "dQ")
    _close(tdk, jdk, tol, "dK")
    _close(tdv, jdv, tol, "dV")


@pytest.mark.parametrize("d", tflash.KERNEL_HEAD_DIMS)
def test_backward_route_by_dtype_and_head_dim(d):
    assert tflash.kernel_route(torch.bfloat16, d) == "tc"
    assert tflash.kernel_route(torch.float32, d) == "f32"
    # asked for explicitly: bf16 may take the CUDA-core kernels, f32 never the tensor cores
    assert tflash.kernel_route(torch.bfloat16, d, "f32") == "f32"
    with pytest.raises(ValueError, match="takes bfloat16"):
        tflash.kernel_route(torch.float32, d, "tc")
    with pytest.raises(ValueError, match="is not 'tc' or 'f32'"):
        tflash.kernel_route(torch.bfloat16, d, "tf32")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tflash.kernel_route(torch.float16, d)
    for bad in (d // 2 + 1, d * 2 + 1):
        with pytest.raises(ValueError, match="has no kernel"):
            tflash.kernel_route(torch.bfloat16, bad)


# pass -> the number of input tensors its C entry point reads (q first)
PASSES = {"fwd": 3, "dq": 4, "dkv": 4}


@pytest.mark.parametrize("name", list(PASSES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_every_pass_takes_its_entry_point_by_route(monkeypatch, name, dtype):
    """The forward, dQ and dK/dV wrappers share one route: bf16 inputs
    reach ``bjx_flash_<pass>_tc`` with TMA-ready (16-byte aligned) copies,
    f32 inputs and ``route="f32"`` the CUDA-core ``bjx_flash_<pass>``
    untouched, and ``route="tc"`` with f32 inputs raises.  The kernel
    library is a stand-in: nothing is built or launched."""
    lib = types.SimpleNamespace(**{f"bjx_flash_{name}{sfx}": sfx or "f32"
                                   for sfx in ("", "_tc")})
    monkeypatch.setattr(tflash, "_library", lambda: lib)
    dt = getattr(torch, dtype)
    buf = torch.zeros(2 * 64 * 16 + 8, dtype=dt)
    shifted = buf[1:2049].view(2, 64, 16)
    tensors = (shifted,) * PASSES[name]
    assert "route" in inspect.signature(getattr(tflash, f"flash_{name}_cuda")).parameters
    entry, route, staged = tflash._entry(name, tensors, None)
    if dtype == "bfloat16":
        assert (entry, route) == ("_tc", "tc")
        assert all(t.data_ptr() % 16 == 0 and torch.equal(t, shifted) for t in staged)
        entry, route, staged = tflash._entry(name, tensors, "f32")
    else:
        with pytest.raises(ValueError, match="takes bfloat16"):
            tflash._entry(name, tensors, "tc")
    assert (entry, route) == ("f32", "f32")
    assert all(t is shifted for t in staged)


def test_tma_staging_copies_only_a_misaligned_base():
    buf = torch.arange(2 * 64 * 16 + 8, dtype=torch.bfloat16)
    aligned, shifted = buf[:2048].view(2, 64, 16), buf[1:2049].view(2, 64, 16)
    assert aligned.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 != 0
    assert tflash._tma_ready(aligned) is aligned
    staged = tflash._tma_ready(shifted)
    assert staged.data_ptr() % 16 == 0 and torch.equal(staged, shifted)


def test_a_row_that_sees_no_column_gives_zero_and_minus_1e30():
    rng = np.random.default_rng(0)
    q, k, v = (_t(_randn(rng, (1, 128, 2, 16), "float32")) for _ in range(3))
    out, (*_, lse) = tflash._flash_fwd_impl(q, k, v, True, 0.25, 64, 64, window=48,
                                            q_offset=256)
    assert torch.count_nonzero(out) == 0
    assert bool((lse == -1e30).all())


# (b, t, h, h_kv, d, dtype, causal, window, scale, blocks, tol)
GRAD_CASES = {
    "f32-causal": (2, 128, 4, 4, 32, "float32", True, None, None, (64, 64), F32_GRAD),
    "f32-non-causal": (2, 128, 4, 4, 32, "float32", False, None, None, (64, 32), F32_GRAD),
    "gqa-window-48": (2, 128, 4, 2, 16, "float32", True, 48, None, (64, 32), GQA_GRAD),
    "bf16-scale-0.25": (2, 128, 2, 2, 32, "bfloat16", True, None, 0.25, (64, 64), BF16_GRAD),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_values_and_gradients_match_custom_vjp(case):
    b, t, h, h_kv, d, dtype, causal, window, scale, (bq, bkv), tol = GRAD_CASES[case]
    rng = np.random.default_rng(1)
    q = _randn(rng, (b, t, h, d), dtype)
    k, v = (_randn(rng, (b, t, h_kv, d), dtype) for _ in range(2))

    def jloss(q, k, v):
        out = jflash.flash_attention(q, k, v, causal, scale, bq, bkv, True, window)
        return (out.astype(jnp.float32) ** 2).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        _j(q, dtype), _j(k, dtype), _j(v, dtype))
    tq, tk, tv = (_t(x, dtype).requires_grad_(True) for x in (q, k, v))
    tout = tflash.flash_attention(tq, tk, tv, causal, scale, bq, bkv, window)
    (tout.float() ** 2).sum().backward()
    assert tout.dtype == getattr(torch, dtype)
    _close(tout, jout, BF16_FWD if dtype == "bfloat16" else F32_FWD, "out")
    for name, tg, jg in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        assert tuple(tg.shape) == jg.shape and tg.dtype == getattr(torch, dtype)
        _close(tg, jg, tol, f"d{name}")


def test_backward_reuses_the_saved_forward(monkeypatch):
    """One forward pass per attention call: the backward takes O and lse
    from the forward instead of recomputing them."""
    calls = []
    fwd = tflash.flash_fwd_plain
    monkeypatch.setattr(tflash, "flash_fwd_plain",
                        lambda *a, **k: calls.append(1) or fwd(*a, **k))
    x = torch.randn(1, 64, 2, 16, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    tflash.flash_attention(x, x, x, True, None, 64, 64).sum().backward()
    assert len(calls) == 1 and x.grad is not None


def test_auto_tiles_and_the_window_closure_match_the_reference():
    rng = np.random.default_rng(2)
    for t, window in ((160, None), (17, None), (128, 48)):
        q = _randn(rng, (1, t, 2, 16), "float32")
        jattn = jflash.make_flash_attention(causal=True, block_q="auto", block_kv="auto",
                                            interpret=True, window=window)
        tattn = tflash.make_flash_attention(causal=True, block_q="auto", block_kv="auto",
                                            window=window)
        _close(tattn(_t(q), _t(q), _t(q)), jattn(_j(q), _j(q), _j(q)), F32_FWD, f"T={t}")


def test_grid_helpers_equal_the_reference():
    for t in (512, 160, 96, 20, 17, 128):
        assert tflash.flash_block_size(t) == jflash.flash_block_size(t)
    for args in ((6, 64, 64, 96), (6, 64, 64, 10_000), (4, 32, 64, 5), (8, 64, 32, 1)):
        assert tflash._kv_window_steps(*args) == jflash._kv_window_steps(*args)
        assert tflash._q_window_steps(*args) == jflash._q_window_steps(*args)
    for i in range(6):
        for q_offset in (0, 64, 256):
            args = (i, 64, 32, 48, q_offset)
            assert tflash._kv_base(*args) == int(jflash._kv_base(*args))
            assert tflash._q_base(*args) == int(jflash._q_base(*args))
    assert tflash._kv_head_map(4, 4) is None and jflash._kv_head_map(4, 4) is None
    tmap, jmap = tflash._kv_head_map(8, 2), jflash._kv_head_map(8, 2)
    assert [tmap(bh) for bh in range(24)] == [int(jmap(bh)) for bh in range(24)]


def _qkv(t=64, h=4, h_kv=4, tk=None):
    z = np.zeros((1, t, h, 16), np.float32)
    zk = np.zeros((1, tk or t, h_kv, 16), np.float32)
    return z, zk


ERRORS = {
    "block_q does not divide": (lambda m, z, zk, a: m.flash_attention(
        *a(z, zk, zk), True, None, 48, 64, **({"interpret": True} if m is jflash else {})),
        "must divide block_q=48", (64, 4, 4, None)),
    "window needs causal": (lambda m, z, zk, a: m.flash_attention(
        *a(z, zk, zk), False, None, 64, 64, *((True,) if m is jflash else ()), 8),
        "requires causal", (64, 4, 4, None)),
    "window below 1": (lambda m, z, zk, a: m.make_flash_attention(causal=True, window=0),
                       "window must be >= 1", (64, 4, 4, None)),
    "window overshoot": (lambda m, z, zk, a: m._flash_fwd_impl(
        *a(z, zk, zk), True, 0.25, 64, 64, *((True,) if m is jflash else ()), window=8),
        "requires Tk == Tq", (64, 4, 4, 128)),
    "indivisible heads": (lambda m, z, zk, a: m.flash_attention(
        *a(z, zk, zk), True, None, 64, 64, **({"interpret": True} if m is jflash else {})),
        "multiple of kv heads", (64, 4, 3, None)),
    "v heads differ from k": (lambda m, z, zk, a: m._flash_fwd_impl(
        *a(z, zk, zk[:, :, :1]), True, 0.25, 64, 64, *((True,) if m is jflash else ())),
        "k has 2 heads but v has 1", (64, 4, 2, None)),
    "ragged length beyond one tile": (lambda m, z, zk, a: m.make_flash_attention(
        causal=True, block_q="auto", block_kv="auto",
        **({"interpret": True} if m is jflash else {}))(*a(z, zk, zk)),
        "pad to a 32-multiple", (161, 2, 2, None)),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_same_value_errors_as_the_reference(case):
    fn, match, (t, h, h_kv, tk) = ERRORS[case]
    z, zk = _qkv(t, h, h_kv, tk)
    with pytest.raises(ValueError, match=match):
        fn(jflash, z, zk, lambda *xs: [jnp.asarray(x) for x in xs])
    with pytest.raises(ValueError, match=match):
        fn(tflash, z, zk, lambda *xs: [torch.from_numpy(x) for x in xs])


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    lse = torch.zeros(2, 64, 1)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(2, 64, 16, dtype=dtype)
        calls = (
            (tflash.flash_fwd_cuda, (x, x, x, True, 0.25)),
            (tflash.flash_dq_cuda, (x, x, x, x, lse, lse, True, 0.25)),
            (tflash.flash_dkv_cuda, (x, x, x, x, lse, lse, True, 0.25)),
        )
        for fn, args in calls:
            before = fn.launches
            by_route = dict(getattr(fn, "launches_by_route", {}))
            with pytest.raises(ValueError, match="needs CUDA tensors"):
                fn(*args)
            assert fn.launches == before
            assert getattr(fn, "launches_by_route", {}) == by_route
    for fn in (tflash.flash_fwd_cuda, tflash.flash_dq_cuda, tflash.flash_dkv_cuda):
        assert set(fn.launches_by_route) == {"tc", "f32"}
