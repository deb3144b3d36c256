"""The port's sequence-parallel attention against the JAX package's: the
twins of the 12 tests of ``tests/test_ring_attention.py``, all 41 cases,
on the same meshes (``{"seq": 8}``, ``{"data": 2, "seq": 4}``, ``{"seq":
4}``, ``{"seq": 2}``) and inputs.  The port runs in 8 real gloo ranks
(``helpers/torch_ranks.py``), started once for the module, each rank
holding its block of q/k/v; the JAX side runs here on the 8 host devices,
its Pallas passes in interpret mode.  Each test assembles the ranks'
blocks and holds them to the JAX package's ``make_ring_attention`` and to
single-device ``full_attention``.

Tolerances are the reference's: values within 2e-5, gradients within
5e-4 (windowed gradients 5e-5 absolute and relative), bf16 within 2e-2 of
f32 attention.  The traffic test counts the port's rotations
(``parallel/p2p.py``) where the reference reads the compiled HLO's
collective-permutes: a window of 1 makes none.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blendjax.ops.flash_attention import flash_attention as jflash
from blendjax.parallel import make_mesh as jmake_mesh
from blendjax.parallel.ring_attention import _window_ring_deltas as jdeltas
from blendjax.parallel.ring_attention import full_attention as jfull
from blendjax.parallel.ring_attention import make_ring_attention as jring
from blendjax_torch.parallel.ring_attention import _window_ring_deltas
from helpers import torch_parallel_ranks
from helpers.time_limit import time_limit
from helpers.torch_ranks import Ranks

B, S, H, D = 2, 32, 8, 16
VALUES, GRADS, BF16 = 2e-5, 5e-4, 2e-2


def _normal(seed, *shapes):
    keys = jax.random.split(jax.random.PRNGKey(seed), len(shapes))
    return tuple(np.asarray(jax.random.normal(k, s, jnp.float32)) for k, s in zip(keys, shapes))


QKV = _normal(7, (B, S, H, D), (B, S, H, D), (B, S, H, D))
CASES = {
    "qkv": QKV,
    "ulysses_flash_qkv": _normal(5, *[(2, 128, 4, 16)] * 3),
    "traffic_qkv": _normal(3, *[(1, 32, 8, 16)] * 3),
    "gqa_kv": _normal(5, (2, 32, 2, 16), (2, 32, 2, 16)),
    "ulysses_gqa_qkv": _normal(6, (2, 64, 8, 16), (2, 64, 2, 16), (2, 64, 2, 16)),
}


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(torch_parallel_ranks.ring_attention_cases, 8, CASES)
    try:
        yield r
    finally:
        r.close()


def _assemble(out, like, key="out", index=None):
    """The global array from the ranks' blocks (every block written)."""
    whole = np.full(like.shape, np.nan, np.float32)
    for rec in out.values():
        if rec is None:
            continue
        (r0, r1), (c0, c1) = rec["where"]["rows"], rec["where"]["cols"]
        whole[r0:r1, c0:c1] = rec[key] if index is None else rec[key][index]
    assert not np.isnan(whole).any()
    return whole


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol)


def _jgrads(attn, qkv):
    def loss(q, k, v):
        return (attn(q, k, v).astype(jnp.float32) ** 2).sum()

    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in qkv))


def _holds(out, qkv, jax_attn, ref_attn, atol, grad_atol=None, rtol=0.0):
    got = _assemble(out, qkv[0])
    _close(got, jax.jit(jax_attn)(*qkv), atol, rtol)
    _close(got, ref_attn(*qkv), atol, rtol)
    if grad_atol is not None:
        want_j = jax.jit(lambda *a: _jgrads(jax_attn, a))(*qkv)
        want_r = _jgrads(ref_attn, qkv)
        for i in range(3):
            g = _assemble(out, qkv[i], "grads", i)
            _close(g, want_j[i], grad_atol, rtol)
            _close(g, want_r[i], grad_atol, rtol)


@pytest.mark.parametrize("impl", ["ring", "ring_flash", "zigzag_flash", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
@time_limit(150)
def test_matches_full_attention(ranks, impl, causal):
    out = ranks.result(("full", impl, causal), 140)
    if impl == "zigzag_flash" and not causal:
        with pytest.raises(ValueError, match="CAUSAL"):
            jring(jmake_mesh({"seq": 8}), causal=causal, impl=impl)
        assert all("ValueError" in rec["error"] and "CAUSAL" in rec["error"]
                   for rec in out.values())
        return
    _holds(out, QKV, jring(jmake_mesh({"seq": 8}), causal=causal, impl=impl),
           functools.partial(jfull, causal=causal), VALUES)


@pytest.mark.parametrize("impl", ["ring", "ring_flash", "zigzag_flash", "ulysses"])
@time_limit(150)
def test_gradients_match(ranks, impl):
    out = ranks.result(("grad", impl), 140)
    _holds(out, QKV, jring(jmake_mesh({"seq": 8}), causal=True, impl=impl),
           functools.partial(jfull, causal=True), VALUES, GRADS)


@pytest.mark.parametrize("impl", ["ring", "ring_flash", "zigzag_flash", "ulysses"])
@time_limit(150)
def test_composes_with_data_parallel(ranks, impl):
    out = ranks.result(("dp", impl), 140)
    mesh = jmake_mesh({"data": 2, "seq": 4})
    _holds(out, QKV, jring(mesh, causal=True, impl=impl, batch_axis="data"),
           functools.partial(jfull, causal=True), VALUES)


@time_limit(120)
def test_uneven_heads_rejected(ranks):
    out = ranks.result("uneven_heads", 110)
    for rec in out.values():
        assert "ulysses needs q's head count (6) divisible" in rec["error"]
    bad = jnp.zeros((B, S, 6, D))
    with pytest.raises(Exception):
        jax.jit(jring(jmake_mesh({"seq": 8}), impl="ulysses"))(bad, bad, bad)


@time_limit(150)
def test_ulysses_with_flash_inner_matches_full(ranks):
    out = ranks.result("ulysses_flash", 140)
    qkv = CASES["ulysses_flash_qkv"]
    inner = functools.partial(jflash, block_q=32, block_kv=32, interpret=True)
    attn = jring(jmake_mesh({"seq": 4}), impl="ulysses", causal=True, inner_attn=inner)
    got = _assemble(out, qkv[0])
    _close(got, attn(*qkv), 2e-5, 2e-5)
    _close(got, jfull(*qkv, causal=True), 2e-5, 2e-5)


def _bf16_case(ranks, impl):
    """bf16 inputs, f32 partials: within 2e-2 of f32 attention."""
    out = ranks.result(("bf16", impl), 140)
    got = _assemble(out, QKV[0])
    bf = [jnp.asarray(x).astype(jnp.bfloat16) for x in QKV]
    jgot = np.asarray(jax.jit(jring(jmake_mesh({"seq": 8}), causal=True, impl=impl))(*bf),
                      np.float32)
    want = jfull(*(x.astype(jnp.float32) for x in bf), causal=True)
    _close(got, want, BF16)
    _close(jgot, want, BF16)
    _close(got, jgot, BF16)


@time_limit(150)
def test_ring_flash_bf16_accumulates_in_f32(ranks):
    _bf16_case(ranks, "ring_flash")


@time_limit(150)
def test_zigzag_flash_bf16_accumulates_in_f32(ranks):
    _bf16_case(ranks, "zigzag_flash")


@pytest.mark.parametrize("impl", ["ring", "ring_flash", "ulysses"])
@pytest.mark.parametrize("window", [1, 3, 4, 7, 1000])
@time_limit(150)
def test_sliding_window_matches_full(ranks, impl, window):
    out = ranks.result(("window", impl, window), 140)
    _holds(out, QKV, jring(jmake_mesh({"seq": 8}), causal=True, impl=impl, window=window),
           functools.partial(jfull, causal=True, window=window), VALUES)


@pytest.mark.parametrize("impl", ["ring", "ring_flash"])
@time_limit(150)
def test_sliding_window_gradients_match(ranks, impl):
    out = ranks.result(("window_grad", impl), 140)
    _holds(out, QKV, jring(jmake_mesh({"seq": 8}), causal=True, impl=impl, window=7),
           functools.partial(jfull, causal=True, window=7), 5e-5, 5e-5, rtol=5e-5)


@time_limit(150)
def test_sliding_window_ring_traffic_scales_with_window(ranks):
    for args, want in (((1, 4, 8), 0), ((2, 4, 8), 1), ((5, 4, 8), 1), ((6, 4, 8), 2),
                       ((10**6, 4, 8), 7)):
        assert _window_ring_deltas(*args) == jdeltas(*args) == want
    out = ranks.result("traffic", 140)
    # W = 1: no rotation in the forward or the backward, on any rank
    assert [rec["rotations"] for rec in out.values()] == [0] * 8
    qkv = CASES["traffic_qkv"]
    _holds(out, qkv, jring(jmake_mesh({"seq": 8}), causal=True, impl="ring_flash", window=1),
           functools.partial(jfull, causal=True, window=1), VALUES, GRADS)


@pytest.mark.parametrize("impl", ["ring_flash", "zigzag_flash"])
@time_limit(120)
def test_ring_flash_rejects_gqa(ranks, impl):
    out = ranks.result(("gqa", impl), 110)
    for rec in out.values():
        assert rec["error"].startswith("ValueError") and "GQA" in rec["error"]
    q = jnp.asarray(QKV[0])
    k, v = (jnp.asarray(x) for x in CASES["gqa_kv"])
    with pytest.raises(ValueError, match="GQA"):
        jax.jit(jring(jmake_mesh({"seq": 8}), causal=True, impl=impl))(q, k, v)


@time_limit(120)
def test_ulysses_supports_gqa(ranks):
    out = ranks.result("ulysses_gqa", 110)
    qkv = CASES["ulysses_gqa_qkv"]
    _holds(out, qkv, jring(jmake_mesh({"seq": 2}), causal=True, impl="ulysses"),
           functools.partial(jfull, causal=True), VALUES)
