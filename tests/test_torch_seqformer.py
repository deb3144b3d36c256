"""The port's SeqFormer training path against the JAX package's: the same
seeded numpy inputs and the same JAX-initialized parameters (carried across
by ``params_from_jax``) through ``blendjax.models.seqformer`` and
``blendjax_torch.models.seqformer``, with full attention and with the flash
passes (Pallas in interpret mode on the JAX side); plus the pieces the
model is built from — ``full_attention``, rope, the layer norm — and one
Adam step.

Tolerances.  float32: outputs atol = rtol 2e-5 (the flash forward's),
losses rtol 1e-5 (tests/test_seqformer.py's), gradients atol 2e-5 and rtol
1e-4 (test_seqformer.py's atol; rtol for the frameworks' different
summation orders), parameters after a step atol 1e-5.  bfloat16: atol =
rtol 5e-2 on outputs and 2e-2 on losses — bf16 keeps about three
significant digits and the two frameworks round at different places (in
the einsums, the softmax and the residual adds); the flash tests' bf16
gradient tolerance is 5e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from blendjax.models import layers as jlayers
from blendjax.models import seqformer as jseq
from blendjax.models.train import TrainState as JTrainState
from blendjax.models.train import make_train_step as jmake_train_step
from blendjax.ops.flash_attention import make_flash_attention as jmake_flash
from blendjax.parallel.ring_attention import full_attention as jfull
from blendjax_torch.models import layers as tlayers
from blendjax_torch.models import seqformer as tseq
from blendjax_torch.models.convert import params_from_jax, params_to_jax
from blendjax_torch.models.train import TrainState, make_train_step
from blendjax_torch.ops.flash_attention import make_flash_attention as tmake_flash
from blendjax_torch.parallel.ring_attention import full_attention as tfull

OBS, B, T = 6, 2, 64
CFG = dict(obs_dim=OBS, d_model=64, n_heads=4, n_layers=2, max_len=T)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_params(pos="learned", n_kv_heads=None):
    tree = jseq.init(jax.random.PRNGKey(0), pos_encoding=pos, n_kv_heads=n_kv_heads, **CFG)
    return jax.tree.map(np.asarray, tree)


def _episode(seed=1):
    return np.random.default_rng(seed).standard_normal((B, T + 1, OBS)).astype(np.float32)


def _attn(kind):
    if kind == "full":
        return None, None
    return (jmake_flash(causal=True, block_q=64, block_kv=64, interpret=True),
            tmake_flash(causal=True, block_q=64, block_kv=64))


# (pos, n_kv_heads, attention, dtype): every value of each axis, every pair
# of pos x attention and of gqa x attention
MODEL_CASES = [
    ("learned", None, "full", "float32"),
    ("learned", None, "flash", "float32"),
    ("learned", 2, "flash", "bfloat16"),
    ("learned", 2, "full", "bfloat16"),
    ("rope", None, "full", "bfloat16"),
    ("rope", None, "flash", "bfloat16"),
    ("rope", 2, "full", "float32"),
    ("rope", 2, "flash", "float32"),
]


@pytest.mark.parametrize("pos,n_kv_heads,attn,dtype", MODEL_CASES)
def test_apply_and_losses_match_jax(pos, n_kv_heads, attn, dtype):
    tree = _jax_params(pos, n_kv_heads)
    params = params_from_jax(tree, device="cpu")
    ep = _episode()
    jattn, tattn = _attn(attn)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jbatch = jseq.make_episode_batch(jnp.asarray(ep))
    tbatch = tseq.make_episode_batch(_t(ep))

    ref = jseq.apply(tree, jbatch["obs"], attn_fn=jattn, compute_dtype=jdt)
    out = tseq.apply(params, tbatch["obs"], attn_fn=tattn, compute_dtype=tdt)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape == (B, T, OBS)
    ref_loss = jseq.loss_fn(tree, jbatch, attn_fn=jattn, compute_dtype=jdt)
    loss = tseq.loss_fn(params, tbatch, attn_fn=tattn, compute_dtype=tdt)
    ep_loss = tseq.episode_loss_fn(params, {"episode": _t(ep)}, attn_fn=tattn,
                                   compute_dtype=tdt)
    assert float(ep_loss) == float(loss)
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    else:
        np.testing.assert_allclose(_np(out), _np(ref), atol=5e-2, rtol=5e-2)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-2)


@pytest.mark.parametrize("pos,n_kv_heads,attn", [("learned", None, "full"),
                                                 ("rope", 2, "flash")])
def test_gradients_match_jax(pos, n_kv_heads, attn):
    tree = _jax_params(pos, n_kv_heads)
    ep = _episode()
    jattn, tattn = _attn(attn)
    jgrads = jax.grad(jseq.episode_loss_fn)(
        tree, {"episode": jnp.asarray(ep)}, attn_fn=jattn, compute_dtype=jnp.float32)
    params = {k: v.requires_grad_(True) for k, v in params_from_jax(tree, device="cpu").items()}
    tseq.episode_loss_fn(params, {"episode": _t(ep)}, attn_fn=tattn,
                         compute_dtype=torch.float32).backward()
    grads = params_to_jax({k: v.grad for k, v in params.items()})
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(jgrads)]
    assert jax.tree.structure(grads) == jax.tree.structure(jax.tree.map(np.asarray, jgrads))
    for path, a, b in zip(paths, jax.tree.leaves(grads), jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, rtol=1e-4, err_msg=path)


def test_one_adam_step_matches_optax():
    """Loss and parameters after one Adam(3e-4) step, float32, flash.  The
    k-projection bias is left out of the parameter check: softmax is
    invariant to it, so its gradient is zero up to rounding, and Adam's
    first step (about lr * sign(g)) turns that rounding into +-lr."""
    tree = _jax_params("learned", 2)
    jattn, tattn = _attn("flash")
    ep = _episode()
    opt = optax.adam(3e-4)

    def jloss(p, b):
        return jseq.episode_loss_fn(p, b, attn_fn=jattn, compute_dtype=jnp.float32)

    jstep = jmake_train_step(jloss, opt, donate=False)
    jstate, jl = jstep(JTrainState.create(jax.tree.map(jnp.asarray, tree), opt),
                       {"episode": jnp.asarray(ep)})
    state = TrainState.create(params_from_jax(tree, device="cpu"), lr=3e-4)
    step = make_train_step(lambda p, b: tseq.episode_loss_fn(
        p, b, attn_fn=tattn, compute_dtype=torch.float32))
    state, loss = step(state, {"episode": _t(ep)})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert state.step == 1
    got = params_to_jax(state.params)
    want = jax.tree.map(np.asarray, jstate.params)
    for i in range(CFG["n_layers"]):
        for tr in (got, want):
            del tr["blocks"][i]["wk"]["b"]
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(want)]
    for path, a, b in zip(paths, jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=path)


def test_train_state_takes_the_learning_rate():
    p = {"w": torch.zeros(2)}
    assert TrainState.create(p).optimizer.param_groups[0]["lr"] == 1e-3
    assert TrainState.create(p, lr=1e-4).optimizer.param_groups[0]["lr"] == 1e-4


@pytest.mark.parametrize("pos,n_kv_heads", [("learned", None), ("rope", 2)])
def test_params_round_trip_and_init_layout(pos, n_kv_heads):
    """The converter carries the SeqFormer tree across unchanged (head-major
    3-D projections, the block list, no ``pos`` under rope), and the port's
    init gives the same paths and shapes."""
    tree = _jax_params(pos, n_kv_heads)
    params = params_from_jax(tree, device="cpu")
    assert params["blocks.0.wk.w"].shape == (64, n_kv_heads or 4, 16)
    assert params["blocks.1.wo.w"].shape == (4, 16, 64)
    assert ("pos" in params) == (pos == "learned")
    back = params_to_jax(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    mine = tseq.init(torch.Generator().manual_seed(0), pos_encoding=pos,
                     n_kv_heads=n_kv_heads, device="cpu", **CFG)
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in params.items()}


def test_moe_params_are_refused_by_name():
    with pytest.raises(ValueError, match="ROADMAP Queue 1, item 7"):
        tseq.init(torch.Generator(), n_experts=4, device="cpu")
    params = tseq.init(torch.Generator().manual_seed(0), device="cpu", **CFG)
    params["blocks.1.moe.gate.w"] = torch.zeros(64, 2)  # a JAX MoE block's leaf
    with pytest.raises(ValueError, match="models/moe.py"):
        tseq.apply(params, torch.zeros(1, 4, OBS))


def test_train_flops_matches_reference():
    for args in [(8, 512, 32, 1024, 8, 8), (2, 64, 8, 128, 4, 2), (4, 16, 6, 32, 4, 2, 96)]:
        assert tseq.train_flops(*args) == jseq.train_flops(*args)


# (dtype, causal, window, h_kv, scale, q_offset, k_offset)
ATTN_CASES = [
    ("float32", True, None, 4, None, 0, 0),
    ("float32", False, None, 4, None, 0, 0),
    ("float32", True, 5, 2, None, 0, 0),
    ("float32", True, None, 1, 0.3, 16, 8),
    ("bfloat16", True, None, 4, None, 0, 0),
    ("bfloat16", True, 7, 2, None, 0, 0),
]


@pytest.mark.parametrize("dtype,causal,window,h_kv,scale,q_offset,k_offset", ATTN_CASES)
def test_full_attention_matches_jax(dtype, causal, window, h_kv, scale, q_offset, k_offset):
    rng = np.random.default_rng(3)
    # head dim 32: 1/sqrt(32) is not exact in bf16, so the cast of the
    # default scale to q's dtype matters
    q = rng.standard_normal((2, 24, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, h_kv, 32)).astype(np.float32) for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset,
              k_offset=k_offset)
    ref = jfull(*(jnp.asarray(x, jdt) for x in (q, k, v)), **kw)
    out = tfull(*(_t(x, tdt) for x in (q, k, v)), **kw)
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)


def test_rope_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    pos = np.arange(12) + 1000
    jc, js = jlayers.rope_table(jnp.asarray(pos), 16)
    tc, ts = tlayers.rope_table(torch.from_numpy(pos), 16)
    np.testing.assert_allclose(_np(tc), _np(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(ts), _np(js), atol=1e-6, rtol=0)
    for dtype, tol in (("float32", 1e-6), ("bfloat16", 1e-2)):
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        ref = jlayers.apply_rope(jnp.asarray(x, jdt), jc, js)
        out = tlayers.apply_rope(_t(x, tdt), tc, ts)
        assert out.dtype == tdt
        np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)
    single = tlayers.apply_rope(_t(x[:, 0]), tc[:1], ts[:1])
    np.testing.assert_allclose(_np(single), _np(jlayers.apply_rope(
        jnp.asarray(x[:, 0]), jc[:1], js[:1])), atol=1e-6, rtol=0)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 7, 32)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 2e-2)):
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        ref = jseq._ln_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x, jdt))
        out = tseq._ln_apply({k: _t(v) for k, v in p.items()}, _t(x, tdt))
        assert out.dtype == tdt
        np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)
