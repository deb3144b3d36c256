"""The port's meshes, sharding rules and sharded train step against the JAX
package's: the twins of ``tests/test_sharding.py``'s four cases (rule
matching, placement, the ``{"data": 4, "model": 2}`` DP x TP step and the
``{"data": 8}`` DP equivalence), and a ``{"model": 8}`` tensor-parallel step
on a replicated batch (the form the card runs).  The port runs in 8 real gloo ranks
(``helpers/torch_ranks.py``), started once for the module and running every
case; the JAX side runs here on the 8 host devices.  Each test waits for
its own case under its own limit.

Tolerance: losses and parameters within 1e-5 in float32 (the all-reduce
and the frameworks sum in other orders); rule specs and placements exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from blendjax.models import detector as jdet
from blendjax.parallel import data_sharding as jdata_sharding
from blendjax.parallel import detector_rules as jdetector_rules
from blendjax.parallel import make_mesh as jmake_mesh
from blendjax.parallel import make_sharded_train_step as jmake_sharded
from blendjax.parallel import param_specs as jparam_specs
from blendjax.parallel import replicated as jreplicated
from blendjax_torch.btt.prefetch import put_batch
from blendjax_torch.models import detector as tdet
from blendjax_torch.models.convert import params_from_jax
from blendjax_torch.models.train import TrainState, make_train_step
from blendjax_torch.parallel.mesh import P, placements
from helpers import torch_parallel_ranks
from helpers.time_limit import time_limit
from helpers.torch_ranks import Ranks

ATOL = 1e-5
R = repr(Replicate())


def S(dim):
    return repr(Shard(dim))


def _tree(key, **kw):
    return jax.device_get(jdet.init(jax.random.PRNGKey(key), **kw))


def _batch(seed, n, hw, k):
    rng = np.random.default_rng(seed)
    return (rng.random((n, hw, hw, 3), np.float32),
            rng.random((n, k, 2), np.float32))


CASES = {
    "rules_params": _tree(0, num_keypoints=2),
    "placement_params": _tree(0, num_keypoints=2, hidden=64),
    "dp_tp_params": _tree(0, num_keypoints=2, channels=(8,), hidden=32),
    "dp_tp_batch": (_batch(0, 16, 16, 2)[0], np.full((16, 2, 2), 0.5, np.float32)),
    "dp8_params": _tree(1, num_keypoints=1, channels=(4,), hidden=8),
    "dp8_batch": _batch(1, 8, 8, 1),
}


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(torch_parallel_ranks.sharding_cases, 8, CASES)
    try:
        yield r
    finally:
        r.close()


def _jax_steps(mesh, tree, image, xy, rules, lr, steps, sharding=None):
    loss = functools.partial(jdet.loss_fn, compute_dtype=jnp.float32)
    init_sharded, step = jmake_sharded(loss, optax.adam(lr), mesh, rules=rules)
    state = init_sharded(jax.tree.map(jnp.asarray, tree))
    sharding = sharding or jdata_sharding(mesh)
    batch = {"image": jax.device_put(image, sharding), "xy": jax.device_put(xy, sharding)}
    losses = []
    for _ in range(steps):
        state, loss_value = step(state, batch)
        losses.append(float(loss_value))
    return losses, params_from_jax(jax.device_get(state.params), device="cpu")


def _close_params(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), atol=ATOL, err_msg=k)


@time_limit(150)
def test_param_specs_rule_matching(ranks):
    tree = CASES["rules_params"]
    specs = ranks.result("rules", 140)
    jspecs = jparam_specs(tree, jdetector_rules())
    for rank_specs in specs.values():
        assert rank_specs["fc.w"] == (None, "model")
        assert rank_specs["fc.b"] == ("model",)
        assert rank_specs["head.w"] == ("model", None)
        assert rank_specs["convs.0.w"] == ()  # unmatched -> replicated
        for path, spec in rank_specs.items():
            node = jspecs
            for key in path.split("."):
                node = node[int(key)] if key.isdigit() else node[key]
            assert spec == tuple(node), path


@time_limit(60)
def test_shard_pytree_placement(ranks):
    tree = CASES["placement_params"]
    out = ranks.result("placement", 50)
    in_dim, out_dim = tree["fc"]["w"].shape
    for rec in out.values():
        assert rec["placements"] == [R, S(1)]
        assert rec["shape"] == (in_dim, out_dim)
        assert rec["local_shape"] == (in_dim, out_dim // 2)  # half the features each


@time_limit(90)
def test_sharded_train_step_dp_tp(ranks):
    out = ranks.result("dp_tp", 80)
    image, xy = CASES["dp_tp_batch"]
    losses, params = _jax_steps(jmake_mesh({"data": 4, "model": 2}), CASES["dp_tp_params"],
                                image, xy, jdetector_rules(), 1e-3, 2)
    for rec in out.values():
        assert np.isfinite(rec["losses"]).all()
        assert rec["step"] == 2
        assert "cannot capture" in rec["capture"]
        # params keep their TP placement through the update
        assert rec["placements"]["fc.w"] == [R, S(1)]
        assert rec["placements"]["head.w"] == [R, S(0)]
        assert rec["placements"]["convs.0.w"] == [R, R]
        np.testing.assert_allclose(rec["losses"], losses, atol=ATOL, rtol=ATOL)
        _close_params(rec["params"], params)


@time_limit(90)
def test_sharded_train_step_tp_on_a_replicated_batch(ranks):
    out = ranks.result("tp8", 80)
    image, xy = CASES["dp_tp_batch"]
    mesh = jmake_mesh({"model": 8})
    losses, params = _jax_steps(mesh, CASES["dp_tp_params"], image, xy, jdetector_rules(),
                                1e-3, 2, jreplicated(mesh))
    for rec in out.values():
        assert rec["step"] == 2
        assert rec["placements"]["fc.w"] == [S(1)]
        assert rec["placements"]["head.w"] == [S(0)]
        assert rec["placements"]["convs.0.w"] == [R]
        np.testing.assert_allclose(rec["losses"], losses, atol=ATOL, rtol=ATOL)
        _close_params(rec["params"], params)


@time_limit(90)
def test_dp_equivalence_with_single_device(ranks):
    out = ranks.result("dp8", 80)
    image, xy = CASES["dp8_batch"]
    tree = CASES["dp8_params"]
    losses, params = _jax_steps(jmake_mesh({"data": 8}), tree, image, xy, {}, 1e-1, 1)
    # the port's own single-process step on the whole batch
    state = TrainState.create(params_from_jax(tree, device="cpu"), lr=1e-1)
    step = make_train_step(functools.partial(tdet.loss_fn, compute_dtype=torch.float32))
    state, single = step(state, {"image": torch.from_numpy(image), "xy": torch.from_numpy(xy)})
    for rec in out.values():
        assert rec["placements"]["fc.w"] == [R]
        np.testing.assert_allclose(rec["losses"], losses, atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(rec["losses"][0], float(single), atol=ATOL, rtol=ATOL)
        _close_params(rec["params"], params)
        _close_params(rec["params"], {k: v.detach() for k, v in state.params.items()})


def test_placements_follow_the_spec_and_refusals_name_their_item():
    class Mesh:
        mesh_dim_names = ("data", "model")
        device_type = "cpu"

        @staticmethod
        def size(i):
            return (4, 2)[i]

    assert [repr(p) for p in placements(Mesh, P(None, "model"))] == [R, S(1)]
    assert [repr(p) for p in placements(Mesh, P("data"))] == [S(0), R]
    with pytest.raises(ValueError, match="names axis 'seq'"):
        placements(Mesh, P("seq"))

    class Sharding:
        mesh, spec = Mesh, P("data")
        placements = placements(Mesh, P("data"))

    # a one-rank world places a global batch: 6 rows do not divide over 4
    with pytest.raises(ValueError, match=r"batch of shape \(6, 3\) not shardable as "
                                         r"P\('data'\).*divisible by the mesh axes"):
        put_batch({"x": np.zeros((6, 3), np.float32)}, Sharding, device="cpu")

