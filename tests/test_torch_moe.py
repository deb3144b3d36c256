"""The port's mixture of experts against the JAX package's: the routed layer
(``blendjax_torch.models.moe``) and the MoE SeqFormer, on numpy-seeded
inputs with the reference's parameters carried across by
``params_from_jax``; plus the twins of ``tests/test_moe.py``'s single-device
cases, run on the port.

Tolerances: assignment rows, slots and masks exactly equal; values and
gradients in float32 within 1e-5 (atol; rtol 1e-5 where magnitudes vary),
the frameworks summing in other orders; the sort and scatter dispatches
within ``tests/test_moe.py``'s 1e-6 of each other."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax.models import moe as jmoe
from blendjax.models import seqformer as jseq
from blendjax.ops.quant import quantize_seqformer as jquantize
from blendjax_torch.models import moe as tmoe
from blendjax_torch.models import seqformer as tseq
from blendjax_torch.models.convert import params_from_jax, params_to_jax
from blendjax_torch.models.train import TrainState, make_train_step
from blendjax_torch.ops.quant import quantize_seqformer as tquantize

OBS, B, T = 6, 4, 16
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _jax_params(n_experts=4, **kw):
    cfg = dict(obs_dim=OBS, d_model=32, n_heads=4, n_layers=2, max_len=64)
    cfg.update(kw)
    return jax.device_get(jseq.init(jax.random.PRNGKey(0), n_experts=n_experts, **cfg))


def _params(n_experts=4):
    return params_from_jax(_jax_params(n_experts), device="cpu")


def _moe_block(params, i=0):
    pre = f"blocks.{i}.moe."
    return {"gate": {"w": params[pre + "gate.w"], "b": params[pre + "gate.b"]},
            **{n: params[pre + n] for n in ("w1", "b1", "w2", "b2")}}


def _episode(seed=1):
    return np.random.default_rng(seed).standard_normal((B, T + 1, OBS)).astype(np.float32)


def _batches(seed=1):
    ep = _episode(seed)
    return ({"obs": _t(ep[:, :-1]), "target": _t(ep[:, 1:])},
            {"obs": jnp.asarray(ep[:, :-1]), "target": jnp.asarray(ep[:, 1:])})


def _probs(seed, n, e):
    logits = np.random.default_rng(seed).standard_normal((n, e)).astype(np.float32)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


# -- the twins of tests/test_moe.py (single device) ---------------------------


def test_route_topk_slots_and_capacity():
    """All tokens prefer expert 0 with capacity 2: exactly the first two
    first-choice assignments win slots; second choices fill expert 1."""
    n, e = 4, 3
    probs = torch.tensor([[0.7, 0.2, 0.1]]).repeat(n, 1)
    dispatch, combine, keep = tmoe.route_topk(probs, k=2, capacity=2)
    assert dispatch.shape == (2 * n, e, 2)
    assert keep.tolist()[:4] == [True, True, False, False]
    assert dispatch[0, 0, 0] == 1 and dispatch[1, 0, 1] == 1
    assert dispatch[2].sum() == 0 and dispatch[3].sum() == 0
    assert keep.tolist()[4:] == [True, True, False, False]
    assert dispatch[4, 1, 0] == 1 and dispatch[5, 1, 1] == 1
    np.testing.assert_allclose(float(combine[0, 0, 0]), 0.7 / 0.9, rtol=1e-6)
    np.testing.assert_allclose(float(combine[4, 1, 0]), 0.2 / 0.9, rtol=1e-6)


def test_topk_equals_dense_at_full_k():
    """k = n_experts with ample capacity renormalizes to the full softmax:
    the routed output equals the dense mixture."""
    params = _params(n_experts=4)
    obs = _batches()[0]["obs"]
    dense = tseq.apply(params, obs, compute_dtype=torch.float32, moe_impl="dense")
    routed = tseq.apply(params, obs, compute_dtype=torch.float32, moe_impl="topk",
                        moe_k=4, moe_capacity_factor=4.0)
    np.testing.assert_allclose(_np(dense), _np(routed), atol=1e-4)


def test_dropped_tokens_contribute_nothing():
    """Every token on one expert with room for the first three: the
    dropped tokens' MoE output rows are exactly zero."""
    d, f, e = 8, 16, 4
    g = torch.Generator().manual_seed(0)
    p = {"gate": {"w": torch.zeros(d, e), "b": torch.tensor([10.0, 0.0, 0.0, 0.0])},
         "w1": torch.randn((e, d, f), generator=g) * 0.1, "b1": torch.ones(e, f) * 0.1,
         "w2": torch.randn((e, f, d), generator=g) * 0.1, "b2": torch.ones(e, d) * 0.1}
    x = torch.randn((1, 12, d), generator=g)
    y, aux = tmoe.moe_apply_topk(p, x, torch.float32, k=1, capacity_factor=1.0)
    flat = _np(y[0])
    assert np.abs(flat[:3]).sum() > 0
    np.testing.assert_array_equal(flat[3:], 0.0)
    np.testing.assert_allclose(float(aux["dispatch_fraction"]), 3 / 12)
    assert np.isfinite(float(aux["aux_loss"]))


def test_aux_loss_uniform_vs_collapsed():
    n, e = 64, 4
    uniform = torch.full((n, e), 1.0 / e)
    collapsed = torch.tensor([[0.97, 0.01, 0.01, 0.01]]).repeat(n, 1)
    lo = float(tmoe.load_balance_loss(uniform, uniform.argmax(-1)))
    hi = float(tmoe.load_balance_loss(collapsed, collapsed.argmax(-1)))
    assert hi > lo
    np.testing.assert_allclose(lo, 1.0, rtol=1e-6)


def test_routed_training_decreases_loss():
    state = TrainState.create(_params(n_experts=4), lr=1e-2)
    step = make_train_step(functools.partial(
        tseq.loss_fn, compute_dtype=torch.float32, moe_impl="topk", moe_k=2,
        moe_aux_weight=0.01))
    batch = _batches()[0]
    losses = []
    for _ in range(10):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9


@pytest.mark.parametrize("k,capacity_factor", [(1, 1.0), (2, 1.25), (2, 0.5), (3, 4.0)])
def test_sort_dispatch_matches_scatter(k, capacity_factor):
    """Sort and scatter dispatch implement one routing policy: equal
    outputs, dispatch fraction and gradients under capacity pressure and
    over-provisioning alike."""
    p = _moe_block(_params())
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((B, T, 32)).astype(np.float32))

    def run(dispatch):
        leaves = {n: (v.clone().requires_grad_(True) if isinstance(v, torch.Tensor) else
                      {m: w.clone().requires_grad_(True) for m, w in v.items()})
                  for n, v in p.items()}
        y, aux = tmoe.moe_apply_topk(leaves, x, torch.float32, k=k,
                                     capacity_factor=capacity_factor, dispatch=dispatch)
        (torch.mean(y * y) + 0.01 * aux["aux_loss"]).backward()
        grads = [leaves["gate"]["w"].grad, leaves["gate"]["b"].grad] + [
            leaves[n].grad for n in ("w1", "b1", "w2", "b2")]
        return y, aux, grads

    y_sc, aux_sc, g_sc = run("scatter")
    y_so, aux_so, g_so = run("sort")
    np.testing.assert_allclose(_np(y_sc), _np(y_so), atol=1e-6)
    assert float(aux_sc["dispatch_fraction"]) == float(aux_so["dispatch_fraction"])
    for a, b in zip(g_sc, g_so):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)


# -- the port against the JAX package ------------------------------------------


def test_topk_ties_take_the_lower_expert_first():
    """A uniform router is all ties: the assignment rows equal the
    reference's (``jax.lax.top_k`` puts the lower index first)."""
    probs = np.full((6, 4), 0.25, np.float32)
    probs[3] = [0.1, 0.4, 0.4, 0.1]
    got = tmoe.topk_assignments(_t(probs), 2, 2)
    want = jmoe.topk_assignments(jnp.asarray(probs), 2, 2)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(_np(got[3]), np.asarray(want[3]), atol=ATOL)


@pytest.mark.parametrize("k,capacity", [(1, 3), (2, 4), (2, 9), (3, 2)])
def test_assignments_and_routes_match_reference(k, capacity):
    probs = _probs(k * 10 + capacity, 24, 5)
    idx, pos, keep, gate_w = tmoe.topk_assignments(_t(probs), k, capacity)
    jidx, jpos, jkeep, jgate_w = jmoe.topk_assignments(jnp.asarray(probs), k, capacity)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(_np(gate_w), np.asarray(jgate_w), atol=ATOL)
    got = tmoe.route_topk(_t(probs), k, capacity)
    want = jmoe.route_topk(jnp.asarray(probs), k, capacity)
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert tmoe.expert_capacity(24, 5, k, 1.3) == jmoe.expert_capacity(24, 5, k, 1.3)


@pytest.mark.parametrize("dispatch", ["sort", "scatter"])
@pytest.mark.parametrize("k,capacity_factor", [(2, 1.25), (2, 0.5), (1, 1.0)])
def test_moe_apply_topk_and_grads_match_reference(dispatch, k, capacity_factor):
    tree = _jax_params()
    jp = tree["blocks"][0]["moe"]
    p = _moe_block(params_from_jax(tree, device="cpu"))
    x = np.random.default_rng(5).standard_normal((B, T, 32)).astype(np.float32)

    def jloss(p_, x_):
        y, aux = jmoe.moe_apply_topk(p_, x_, jnp.float32, k=k,
                                     capacity_factor=capacity_factor, dispatch=dispatch)
        return jnp.mean(y * jnp.cos(y)) + 0.01 * aux["aux_loss"], (y, aux)

    (jl, (jy, jaux)), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))

    leaves = {"gate": {m: w.clone().requires_grad_(True) for m, w in p["gate"].items()},
              **{n: p[n].clone().requires_grad_(True) for n in ("w1", "b1", "w2", "b2")}}
    xt = _t(x).requires_grad_(True)
    y, aux = tmoe.moe_apply_topk(leaves, xt, torch.float32, k=k,
                                 capacity_factor=capacity_factor, dispatch=dispatch)
    loss = torch.mean(y * torch.cos(y)) + 0.01 * aux["aux_loss"]
    loss.backward()
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=ATOL)
    assert float(aux["dispatch_fraction"]) == float(jaux["dispatch_fraction"])
    np.testing.assert_allclose(float(aux["aux_loss"].detach()), float(jaux["aux_loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5, atol=ATOL)
    for m in ("w", "b"):
        np.testing.assert_allclose(_np(leaves["gate"][m].grad), np.asarray(jg["gate"][m]),
                                   atol=ATOL)
    for n in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(_np(leaves[n].grad), np.asarray(jg[n]), atol=ATOL)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jgx), atol=ATOL)


def test_moe_params_cross_both_ways_and_quantize_keeps_them_float():
    tree = _jax_params()
    params = params_from_jax(tree, device="cpu")
    assert params["blocks.0.moe.w1"].shape == (4, 32, 128)
    assert params["blocks.1.moe.w2"].shape == (4, 128, 32)
    assert params["blocks.0.moe.gate.w"].shape == (32, 4)
    assert not any(".mlp." in k for k in params)
    back = params_to_jax(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    mine = tseq.init(torch.Generator().manual_seed(0), obs_dim=OBS, d_model=32, n_heads=4,
                     n_layers=2, max_len=64, n_experts=4, device="cpu")
    ref_init = jseq.init(jax.random.PRNGKey(0), obs_dim=OBS, d_model=32, n_heads=4,
                         n_layers=2, max_len=64, n_experts=4)["blocks"][1]["moe"]
    ref_order = [f"{k}.{m}" if isinstance(v, dict) else k
                 for k, v in ref_init.items() for m in (v if isinstance(v, dict) else [None])]
    # the reference's leaf names, in its init order
    assert [k[len("blocks.1.moe."):] for k in mine if k.startswith("blocks.1.moe.")] == ref_order
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    q = tquantize(params)
    jq = jax.device_get(jquantize(tree))
    for n in ("gate.w", "gate.b", "w1", "b1", "w2", "b2"):
        key = f"blocks.0.moe.{n}"
        assert q[key].dtype == torch.float32
        node = jq["blocks"][0]["moe"]
        for part in n.split("."):
            node = node[part]
        np.testing.assert_array_equal(q[key].numpy(), np.asarray(node))
    assert q["blocks.0.wq.w_q"].dtype == torch.int8


@pytest.mark.parametrize("moe_impl,dispatch", [("dense", "sort"), ("topk", "sort"),
                                               ("topk", "scatter")])
def test_seqformer_moe_loss_and_grads_match_reference(moe_impl, dispatch):
    tree = _jax_params()
    params = {k: v.requires_grad_(True) for k, v in params_from_jax(tree, device="cpu").items()}
    tb, jb = _batches()
    kw = dict(compute_dtype=torch.float32, moe_impl=moe_impl, moe_k=2,
              moe_capacity_factor=1.0, moe_aux_weight=0.05, moe_dispatch=dispatch)
    jkw = dict(kw, compute_dtype=jnp.float32)
    loss = tseq.loss_fn(params, tb, **kw)
    loss.backward()
    jl, jg = jax.value_and_grad(functools.partial(jseq.loss_fn, **jkw))(tree, jb)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    got = params_to_jax({k: v.grad for k, v in params.items()})
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        node = got
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_allclose(node, np.asarray(want), atol=ATOL, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def test_moe_stats_and_train_flops_match_reference():
    tree = _jax_params()
    params = params_from_jax(tree, device="cpu")
    tb, jb = _batches()
    for cf in (0.5, 1.25):
        got = tseq.moe_stats(params, tb, compute_dtype=torch.float32, moe_capacity_factor=cf)
        want = jseq.moe_stats(tree, jb, compute_dtype=jnp.float32, moe_capacity_factor=cf)
        assert float(got["dispatch_fraction"]) == pytest.approx(
            float(want["dispatch_fraction"]), abs=1e-7)
        np.testing.assert_allclose(float(got["aux_loss"]), float(want["aux_loss"]), rtol=1e-6)
    assert float(tseq.moe_stats(params, tb, compute_dtype=torch.float32,
                                moe_capacity_factor=0.5)["dispatch_fraction"]) < 1
    with pytest.raises(ValueError, match="n_experts > 0"):
        tseq.moe_stats(params_from_jax(_jax_params(n_experts=0), device="cpu"), tb)
    for args, kw in [((8, 512, 32, 1024, 8, 8), dict(n_experts=8, moe_impl="topk")),
                     ((8, 512, 32, 1024, 8, 8), dict(n_experts=8, moe_impl="dense")),
                     ((2, 64, 8, 128, 4, 2, 96), dict(n_experts=4, moe_impl="topk", moe_k=3,
                                                      moe_capacity_factor=0.7)),
                     ((2, 64, 8, 128, 4, 2), dict())]:
        assert tseq.train_flops(*args, **kw) == jseq.train_flops(*args, **kw)


@pytest.mark.parametrize("moe_impl", ["dense", "topk"])
def test_moe_decode_and_rollout_match_reference(moe_impl):
    tree = _jax_params()
    params = params_from_jax(tree, device="cpu")
    ep = _episode(4)
    kw = dict(compute_dtype=torch.float32, moe_impl=moe_impl, moe_k=2,
              moe_capacity_factor=1.0)
    jkw = dict(kw, compute_dtype=jnp.float32)
    got = tseq.rollout(params, _t(ep[:, :6]), 5, **kw)
    want = jseq.rollout(tree, jnp.asarray(ep[:, :6]), 5, **jkw)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL, rtol=1e-5)
    cache = tseq.init_cache(params, B, dtype=torch.float32, length=8)
    jcache = jseq.init_cache(tree, B, dtype=jnp.float32, length=8)
    for t in range(4):
        pred, cache = tseq.decode_step(params, cache, _t(ep[:, t]), **kw)
        jpred, jcache = jseq.decode_step(tree, jcache, jnp.asarray(ep[:, t]), **jkw)
        np.testing.assert_allclose(_np(pred), np.asarray(jpred), atol=ATOL, rtol=1e-5)
    # the incremental decode agrees with the teacher-forced forward: routing
    # is drop-free there (the forward's own capacity made drop-free too)
    full = tseq.apply(params, _t(ep[:, :4]), compute_dtype=torch.float32, moe_impl=moe_impl,
                      moe_capacity_factor=2.0)
    np.testing.assert_allclose(_np(pred), _np(full[:, -1]), atol=ATOL, rtol=1e-5)
