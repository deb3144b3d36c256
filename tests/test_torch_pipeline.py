"""The port's SPMD pipeline against the JAX package's: the twins of the 13
cases of ``tests/test_pipeline.py``, on the same meshes (``{"pipe": 4}``,
``{"pipe": 2, "data": 4}``, ``{"pipe": 2}``, ``{"pipe": 1, "data": 8}``)
and inputs.  The port runs in 8 real gloo ranks (``helpers/torch_ranks.py``,
one exclusive set, started once for the module), each rank a stage; the
JAX side runs here on the 8 host devices.  Each test holds the port's
outputs, losses and gradients to the JAX package's ``make_pipeline`` /
``make_pipeline_train`` on the same stacked parameters (carried by
``params_from_jax``) and to the sequential model, within the reference's
tolerances: outputs 1e-5, the forward's gradients 1e-4 relative with 1e-3
absolute, the training step's loss 1e-5 relative and gradients 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as JP

from blendjax.models.layers import dense_apply, dense_init, gelu
from blendjax.parallel import make_mesh as jmake_mesh
from blendjax.parallel.pipeline import make_pipeline as jmake_pipeline
from blendjax.parallel.pipeline import make_pipeline_train as jmake_pipeline_train
from blendjax.parallel.pipeline import stack_stage_params as jstack
from blendjax.parallel.pipeline import unstack_stage_params as junstack
from blendjax_torch.parallel import microbatch
from helpers import torch_parallel_ranks
from helpers.time_limit import time_limit
from helpers.torch_ranks import Ranks

D, D_IN, D_OUT = 16, 6, 3


def stage_fn(p, x):
    return x + gelu(dense_apply(p["fc"], x, dtype=jnp.float32))


def _stages(n, key=0):
    keys = jax.random.split(jax.random.PRNGKey(key), n)
    return [{"fc": dense_init(k, D, D)} for k in keys]


def _sequential(stages, x):
    for p in stages:
        x = stage_fn(p, x)
    return x


def _in_proj(pp, mb):
    return mb @ pp["w"]


def _out_proj(pp, y):
    return y @ pp["w"]


def _mse(pred, tgt):
    return jnp.mean((pred - tgt) ** 2)


def _train_setup(n_stages, n_micro, mb=3):
    ks = jax.random.split(jax.random.PRNGKey(7), 4)
    stages = _stages(n_stages)
    proj = (
        {"w": jax.random.normal(ks[0], (D_IN, D), jnp.float32) * 0.3},
        {"w": jax.random.normal(ks[1], (D, D_OUT), jnp.float32) * 0.3},
    )
    x = jax.random.normal(ks[2], (n_micro, mb, D_IN), jnp.float32)
    tgt = jax.random.normal(ks[3], (n_micro, mb, D_OUT), jnp.float32)
    return stages, proj, x, tgt


def _sequential_train_loss(stacked, proj, x, tgt, n_stages):
    stages = junstack(stacked, n_stages)

    def one(mb, t):
        h = _in_proj(proj[0], mb)
        for p in stages:
            h = stage_fn(p, h)
        return _mse(_out_proj(proj[1], h), t)

    return jnp.mean(jax.vmap(one)(x, tgt))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _x(m):
    return jax.random.normal(jax.random.PRNGKey(1), (m, 3, D), jnp.float32)


LEARN = {"head": dense_init(jax.random.PRNGKey(9), D, 2),
         "x": jax.random.normal(jax.random.PRNGKey(2), (8, 4, D), jnp.float32),
         "y": jax.random.normal(jax.random.PRNGKey(3), (8, 4, 2), jnp.float32)}
ARGS = {
    "stages4": _np(_stages(4)),
    "stages2": _np(_stages(2)),
    "x": {m: np.asarray(_x(m)) for m in (4, 7)},
    "x_dp": np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 8, D), jnp.float32)),
    "learn": _np(LEARN),
    "train": {m: _np(_train_setup(4, m)) for m in (4, 7)},
    "converge": _np(_train_setup(2, 6)),
}


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(torch_parallel_ranks.pipeline_cases, 8, ARGS)
    try:
        yield r
    finally:
        r.close()


def _live(out):
    return [rec for rec in out.values() if rec is not None]


@pytest.mark.parametrize("n_micro", [4, 7])
@time_limit(120)
def test_matches_sequential(ranks, n_micro):
    out = _live(ranks.result(("fwd", n_micro), 110))
    assert len(out) == 4
    stages, x = _stages(4), _x(n_micro)
    want = np.asarray(_sequential(stages, x))
    jgot = np.asarray(jax.jit(jmake_pipeline(stage_fn, jmake_mesh({"pipe": 4})))(
        jstack(stages), x))
    for rec in out:  # every stage holds the whole output
        np.testing.assert_allclose(rec["y"], want, atol=1e-5)
        np.testing.assert_allclose(rec["y"], jgot, atol=1e-5)


@time_limit(120)
def test_gradients_match_sequential(ranks):
    out = _live(ranks.result("grad", 110))
    stages, x = _stages(4), _x(4)
    apply = jmake_pipeline(stage_fn, jmake_mesh({"pipe": 4}))
    g_pipe = jax.jit(jax.grad(lambda p: (apply(p, x) ** 2).sum()))(jstack(stages))
    g_seq = jax.grad(lambda ps: (_sequential(ps, x) ** 2).sum())(stages)
    assert sorted(rec["row"] for rec in out) == [0, 1, 2, 3]
    for rec in out:
        i = rec["row"]
        assert rec["other_rows_zero"]  # a rank's backward reaches its own stage only
        for want in (g_seq[i]["fc"]["w"], junstack(g_pipe, 4)[i]["fc"]["w"]):
            np.testing.assert_allclose(rec["w"], np.asarray(want), rtol=1e-4, atol=1e-3)


@time_limit(120)
def test_composes_with_data_parallel(ranks):
    out = _live(ranks.result("dp", 110))
    assert len(out) == 8
    mesh = jmake_mesh({"pipe": 2, "data": 4})
    stages = _stages(2)
    x = jnp.asarray(ARGS["x_dp"])
    want = np.asarray(_sequential(stages, x))
    jgot = np.asarray(jax.jit(jmake_pipeline(stage_fn, mesh, x_spec=JP(None, "data")))(
        jstack(stages), jax.device_put(x, NamedSharding(mesh, JP(None, "data")))))
    got = np.full(want.shape, np.nan, np.float32)
    for rec in out:
        assert rec["placements"] == ["Replicate()", "Shard(dim=1)"]
        r0, r1 = rec["rows"]
        got[:, r0:r1] = rec["y"]
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, jgot, atol=1e-5)


@time_limit(120)
def test_wrong_stage_count_rejected(ranks):
    out = _live(ranks.result("wrong_count", 110))
    assert len(out) == 4
    for rec in out:
        assert "ValueError" in rec["error"] and "stages" in rec["error"]
    apply = jmake_pipeline(stage_fn, jmake_mesh({"pipe": 4}))
    with pytest.raises(ValueError, match="stages"):
        apply(jstack(_stages(2)), jnp.zeros((4, 3, D)))


@time_limit(120)
def test_pipelined_training_learns(ranks):
    """Both packages train the pipelined stack and a head with Adam(1e-2)
    for 15 steps, loss for loss."""
    out = _live(ranks.result("learn", 110))
    apply = jmake_pipeline(stage_fn, jmake_mesh({"pipe": 4}))
    params = {"stages": jstack(_stages(4)), "head": LEARN["head"]}

    def loss_fn(p):
        h = apply(p["stages"], LEARN["x"])
        return jnp.mean((dense_apply(p["head"], h, dtype=jnp.float32) - LEARN["y"]) ** 2)

    opt = optax.adam(1e-2)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    jlosses = []
    for _ in range(15):
        params, opt_state, loss = step(params, opt_state)
        jlosses.append(float(loss))
    for rec in out:
        assert rec["losses"] == out[0]["losses"]
        assert rec["losses"][-1] < rec["losses"][0] * 0.7
        np.testing.assert_allclose(rec["losses"], jlosses, rtol=1e-4)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("n_micro", [4, 7])
@time_limit(120)
def test_train_loss_and_grads_match_sequential(ranks, schedule, n_micro):
    """Both schedules give the sequential loss and gradients, and the JAX
    package's, on every rank (the projections' gradients whole on each,
    each stage's on its rank)."""
    out = _live(ranks.result(("train", schedule, n_micro), 110))
    n = 4
    stages, proj, x, tgt = _train_setup(n, n_micro)
    stacked = jstack(stages)
    train = jmake_pipeline_train(stage_fn, _mse, jmake_mesh({"pipe": n}), schedule=schedule,
                                 in_proj=_in_proj, out_proj=_out_proj)
    jloss, (jgs, jgp) = jax.jit(train)(stacked, proj, x, tgt)
    ref_loss, (ref_gs, ref_gp) = jax.value_and_grad(_sequential_train_loss, argnums=(0, 1))(
        stacked, proj, x, tgt, n)
    assert sorted(rec["row"] for rec in out) == list(range(n))
    for rec in out:
        i = rec["row"]
        for loss, gs, gp in ((ref_loss, ref_gs, ref_gp), (jloss, jgs, jgp)):
            np.testing.assert_allclose(rec["loss"], float(loss), rtol=1e-5)
            for leaf in ("w", "b"):
                np.testing.assert_allclose(rec["stage_grads"][f"fc.{leaf}"],
                                           np.asarray(gs["fc"][leaf][i]), rtol=1e-4, atol=1e-4)
            for got, want in zip(rec["proj_grads"], gp):
                np.testing.assert_allclose(got["w"], np.asarray(want["w"]), rtol=1e-4,
                                           atol=1e-4)


@time_limit(120)
def test_1f1b_gradient_descent_converges(ranks):
    """The 1F1B step drives Adam(3e-2) on 2 stages: the loss halves, as the
    JAX package's does, loss for loss."""
    out = _live(ranks.result("converge", 110))
    assert len(out) == 2
    stages, proj, x, tgt = _train_setup(2, 6)
    params = {"stages": jstack(stages), "proj": proj}
    train = jmake_pipeline_train(stage_fn, _mse, jmake_mesh({"pipe": 2}), schedule="1f1b",
                                 in_proj=_in_proj, out_proj=_out_proj)
    opt = optax.adam(3e-2)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        loss, (gs, gp) = train(params["stages"], params["proj"], x, tgt)
        updates, opt_state = opt.update({"stages": gs, "proj": gp}, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    jlosses = []
    for _ in range(20):
        params, opt_state, loss = step(params, opt_state)
        jlosses.append(float(loss))
    for rec in out:
        assert rec["losses"][-1] < rec["losses"][0] * 0.5
        np.testing.assert_allclose(rec["losses"], jlosses, rtol=1e-4)


@time_limit(120)
def test_pipeline_train_rejects_tiny_axis(ranks):
    out = _live(ranks.result("tiny", 110))
    assert len(out) == 8
    for rec in out:
        assert "ValueError" in rec["error"] and "pipe" in rec["error"]
    with pytest.raises(ValueError, match="pipe"):
        jmake_pipeline_train(stage_fn, _mse, jmake_mesh({"pipe": 1, "data": 8}))


def test_microbatch_helper():
    import torch

    for zeros in (np.zeros, torch.zeros):
        mb = microbatch({"a": zeros((8, 5))}, 4)
        assert tuple(mb["a"].shape) == (4, 2, 5)
        with pytest.raises(ValueError, match="divisible"):
            microbatch({"a": zeros((6, 5))}, 4)
