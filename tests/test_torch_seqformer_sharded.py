"""The port's sequence-sharded SeqFormer step against the JAX package's:
the twins of ``tests/test_seqformer.py``'s
``test_sharded_step_matches_single_device`` (its five cases, on ``{"data":
2, "seq": 2, "model": 2}``), the packaged step trained end to end
(``tests/test_seqformer.py:135``) and ``test_train_step_ulysses_flash_parity``, and of ``tests/test_moe.py``'s
``test_sharded_routed_step_matches_single_device`` (``{"data": 2, "seq": 2,
"expert": 2}``, top-2 at capacity factor 2.0, no drop).  The port runs
``make_seqformer_train_step`` in 8 real gloo ranks
(``helpers/torch_ranks.py``), started once for the module; the JAX side
runs here, both single-device and sharded over the 8 host devices.

Tolerances are the reference's: the loss within 1e-5 relative and every
parameter within 1e-5 after one SGD(0.1) step in f32 (SGD keeps the update
linear in the gradient); the packaged bf16 step's first loss within 2e-2 of
the JAX package's, and its losses falling; ulysses against ulysses_flash
within 5e-3 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from blendjax.models import seqformer as jseq
from blendjax.models.train import TrainState as JTrainState
from blendjax.models.train import make_train_step as jmake_train_step
from blendjax.parallel import make_mesh as jmake_mesh
from blendjax.parallel import make_ring_attention as jring
from blendjax.parallel import make_seqformer_train_step as jmake_seqformer_step
from blendjax.parallel import seqformer_rules as jrules
from blendjax.parallel.sharding import make_sharded_train_step as jmake_sharded
from blendjax_torch.models.convert import params_from_jax
from helpers import torch_parallel_ranks
from helpers.time_limit import time_limit
from helpers.torch_ranks import Ranks

OBS, B, T = 6, 4, 16
PARITY = [(0, "ring"), (0, "ulysses"), (4, "ring"), (4, "ring_flash"), (0, "zigzag_flash")]


def _params(n_experts=0, **kw):
    cfg = dict(obs_dim=OBS, d_model=32, n_heads=4, n_layers=2, n_experts=n_experts, max_len=64)
    cfg.update(kw)
    return jax.device_get(jseq.init(jax.random.PRNGKey(0), **cfg))


def _batch():
    seq = jax.random.normal(jax.random.PRNGKey(1), (B, T + 1, OBS), jnp.float32)
    return {k: np.asarray(v) for k, v in jseq.make_episode_batch(seq).items()}


_EPISODES = np.random.default_rng(0).standard_normal((4, 65, 4)).astype(np.float32)
CASES = {
    "parity_cases": PARITY,
    "params": {0: _params(0), 4: _params(4)},
    "batch": _batch(),
    "ulysses_params": _params(0, obs_dim=4, d_model=16, n_heads=2, n_layers=1),
    "ulysses_batch": {k: np.asarray(v) for k, v in jseq.make_episode_batch(_EPISODES).items()},
    "moe_params": _params(4),
    "moe_batch": _batch(),
}


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(torch_parallel_ranks.seqformer_sharded_cases, 8, CASES)
    try:
        yield r
    finally:
        r.close()


def _sgd_steps(tree, batch, sharded_loss=None, mesh=None, rules=None, **loss_kwargs):
    """One SGD(0.1) step in f32: single device, or sharded over ``mesh``."""
    opt = optax.sgd(0.1)
    params = jax.tree.map(jnp.asarray, tree)
    loss = functools.partial(jseq.loss_fn, compute_dtype=jnp.float32, **loss_kwargs)
    if mesh is None:
        step = jmake_train_step(loss, opt, donate=False)
        state, value = step(JTrainState.create(params, opt), batch)
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P

        init_sharded, step = jmake_sharded(functools.partial(loss, attn_fn=sharded_loss), opt,
                                           mesh, rules=rules)
        state, value = step(init_sharded(params),
                            jax.device_put(batch, NamedSharding(mesh, P("data", "seq", None))))
    return float(value), params_from_jax(jax.device_get(state.params), device="cpu")


def _held(rec, loss, params):
    np.testing.assert_allclose(rec["losses"][0], loss, rtol=1e-5)
    assert set(rec["params"]) == set(params)
    for k, v in params.items():
        np.testing.assert_allclose(rec["params"][k], v.numpy(), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("n_experts,attn_impl", PARITY)
@time_limit(240)
def test_sharded_step_matches_single_device(ranks, n_experts, attn_impl):
    out = ranks.result(("parity", n_experts, attn_impl), 230)
    tree, batch = CASES["params"][n_experts], CASES["batch"]
    mesh = jmake_mesh({"data": 2, "seq": 2, "model": 2})
    attn = jring(mesh, causal=True, impl=attn_impl, batch_axis="data",
                 head_axis="model" if attn_impl == "ring" else None)
    want = _sgd_steps(tree, batch)
    want_sharded = _sgd_steps(tree, batch, attn, mesh, jrules("model"))
    for rec in out.values():
        _held(rec, *want)
        _held(rec, *want_sharded)


@time_limit(240)
def test_packaged_step_end_to_end(ranks):
    """``make_seqformer_train_step`` as packaged (bf16, Adam(1e-2), ring)
    trains to a lower loss, from the JAX package's first loss."""
    out = ranks.result("packaged", 230)
    init_sharded, step, sharding = jmake_seqformer_step(
        optax.adam(1e-2), jmake_mesh({"data": 2, "seq": 2, "model": 2}))
    state = init_sharded(jax.tree.map(jnp.asarray, CASES["params"][4]))
    _, jloss = step(state, jax.device_put(CASES["batch"], sharding))
    for rec in out.values():
        losses = rec["losses"]
        assert len(losses) == 8 and np.isfinite(losses).all() and losses[-1] < losses[0]
        np.testing.assert_allclose(losses[0], float(jloss), rtol=2e-2)
        assert losses == out[0]["losses"]


@time_limit(240)
def test_train_step_ulysses_flash_parity(ranks):
    out = {impl: ranks.result(("ulysses_flash_parity", impl), 230)
           for impl in ("ulysses", "ulysses_flash")}
    jlosses = {}
    mesh = jmake_mesh({"data": 2, "seq": 2, "model": 1})
    for impl in ("ulysses", "ulysses_flash"):
        init_sharded, step, sharding = jmake_seqformer_step(optax.adam(1e-3), mesh,
                                                            attn_impl=impl)
        state = init_sharded(jax.tree.map(jnp.array, CASES["ulysses_params"]))
        _, loss = step(state, jax.device_put(CASES["ulysses_batch"], sharding))
        jlosses[impl] = float(loss)
    for rank in range(4):
        got = {impl: out[impl][rank]["losses"][0] for impl in out}
        assert got["ulysses"] == pytest.approx(got["ulysses_flash"], rel=5e-3)
        for impl in got:
            assert got[impl] == pytest.approx(jlosses[impl], rel=5e-3)
    assert all(out[impl][rank] is None for impl in out for rank in range(4, 8))


@time_limit(240)
def test_sharded_routed_step_matches_single_device(ranks):
    """The twin of ``tests/test_moe.py::test_sharded_routed_step_matches_single_device``:
    routing over the global token set, no token dropped at capacity factor
    2.0, the load-balance loss's fractions all-reduced."""
    out = ranks.result("moe", 230)
    tree, batch = CASES["moe_params"], CASES["moe_batch"]
    kw = dict(moe_impl="topk", moe_k=2, moe_capacity_factor=2.0, moe_aux_weight=0.01)
    mesh = jmake_mesh({"data": 2, "seq": 2, "expert": 2})
    want = _sgd_steps(tree, batch, **kw)
    want_sharded = _sgd_steps(tree, batch, jring(mesh, causal=True, batch_axis="data"), mesh,
                              jrules(model_axis="expert", expert_axis="expert"), **kw)
    for rec in out.values():
        _held(rec, *want)
        _held(rec, *want_sharded)
