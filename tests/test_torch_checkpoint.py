"""The port's checkpoints (``blendjax_torch.utils.checkpoint``) against the
reference's (``blendjax.utils.checkpoint``), on the CPU.

1. **The reference's cases** (``tests/test_checkpoint.py``) on the port:
   the pytree round trip, a resumed TrainState continuing bit for bit,
   structure mismatches, the manager's retention and latest step, an empty
   directory, interrupted ``.tmp`` saves, int8 and rope trees, the torn
   latest step counted, the retention race (20 races inside the test, each
   with its reader restoring continuously while the writer saves and
   unlinks), and ``backend='orbax'`` refused naming the npz backend.
2. **Across packages, both directions**: a detector, a small SeqFormer and
   a policy after 3 ``optax.adam`` steps in the reference load in the port
   equal leaf for leaf through ``convert``'s layouts, and the port's file
   loads in the reference's ``load_train_state``; then one more step on
   each side, held as ``test_torch_policy.py``'s ``_hold_step`` holds a
   step (at 1e-5), from the restored Adam state.
3. **In place**: a restore writes into the template's own tensors, so a
   captured step (stood in on the CPU) replays on with no new capture; a
   template whose Adam has no state yet gets its state tensors made by the
   restore, and then warms up and captures once.
"""

import functools
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from blendjax.models import detector as jdet
from blendjax.models import policy as jpol
from blendjax.models import seqformer as jseq
from blendjax.models.train import TrainState as JTrainState
from blendjax.models.train import make_train_step as jmake_train_step
from blendjax.ops.quant import quantize_seqformer as jquantize_seqformer
from blendjax.utils import checkpoint as jck
from blendjax_torch.models import convert
from blendjax_torch.models import detector as tdet
from blendjax_torch.models import policy as tpol
from blendjax_torch.models import seqformer as tseq
from blendjax_torch.models import train
from blendjax_torch.models.convert import params_from_jax, params_to_jax
from blendjax_torch.models.train import TrainState, make_train_step
from blendjax_torch.ops.quant import quantize_seqformer
from blendjax_torch.utils.checkpoint import (
    CheckpointManager,
    load_pytree,
    load_train_state,
    save_pytree,
    save_train_state,
)
from blendjax_torch.utils.timing import EventCounters
from test_torch_train import _stand_in_graphs, counted_kernel  # noqa: F401

LR = 1e-3
SENSITIVE = 1e-6  # test_torch_policy.py's
TINY = dict(num_keypoints=2, channels=(4,), hidden=8)


def _tiny_state(seed=0):
    tree = jax.tree.map(np.asarray, jdet.init(jax.random.PRNGKey(seed), **TINY))
    return TrainState.create(params_from_jax(tree, device="cpu"), lr=LR)


def _det_batch(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((n, 16, 16, 3), dtype=np.float32),
            "xy": rng.random((n, TINY["num_keypoints"], 2), dtype=np.float32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_loss(params, batch):
    return tdet.loss_fn(params, batch, compute_dtype=torch.float32)


def _leaves_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, i
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")


# -- 1. the reference's cases ---------------------------------------------------


def test_pytree_roundtrip(tmp_path):
    tree = {"a": np.arange(4.0), "b": [torch.ones((2, 3)), {"c": np.array(7)}], "n": None}
    path = tmp_path / "t.npz"
    save_pytree(path, tree)
    zeros = {"a": np.zeros(4), "b": [torch.zeros((2, 3)), {"c": np.array(0)}], "n": None}
    restored = load_pytree(path, zeros)
    np.testing.assert_array_equal(restored["a"], tree["a"])
    assert isinstance(restored["b"][0], torch.Tensor)
    assert torch.equal(restored["b"][0], tree["b"][0])
    np.testing.assert_array_equal(restored["b"][1]["c"], 7)
    assert restored["n"] is None
    # the reference reads the same file into its own structure
    ref = jck.load_pytree(path, {"a": jnp.zeros(4), "b": [jnp.zeros((2, 3)), {"c": jnp.array(0)}]})
    np.testing.assert_array_equal(ref["b"][1]["c"], 7)


def test_train_state_resume_continues_identically(tmp_path):
    state = _tiny_state()
    step = make_train_step(_port_loss)
    batch = _tb(_det_batch())
    for _ in range(3):
        state, _ = step(state, batch)
    path = tmp_path / "ck.npz"
    save_train_state(path, state)

    # resume into a fresh template: the next step must match bit for bit
    template = _tiny_state(seed=9)
    resumed = load_train_state(path, template)
    assert resumed is template and resumed.step == 3
    s1, l1 = step(state, batch)
    s2, l2 = make_train_step(_port_loss)(resumed, batch)
    assert float(l1) == float(l2)
    for k in s1.params:
        assert torch.equal(s1.params[k], s2.params[k]), k


def test_structure_mismatch_raises(tmp_path):
    path = tmp_path / "m.npz"
    save_pytree(path, {"a": np.ones(3)})
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(path, {"a": np.ones(3), "b": np.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        load_pytree(path, {"a": np.ones(4)})
    save_train_state(path, _tiny_state())
    wider = TrainState.create(params_from_jax(jax.tree.map(np.asarray, jdet.init(
        jax.random.PRNGKey(0), num_keypoints=2, channels=(4,), hidden=16)), device="cpu"))
    before = {k: v.clone() for k, v in wider.params.items()}
    with pytest.raises(ValueError, match="shape"):
        load_train_state(path, wider)
    # nothing was written before the mismatch was found
    assert all(torch.equal(before[k], wider.params[k]) for k in before)


def test_manager_save_restore_latest(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    state = _tiny_state()
    for step in (0, 5, 10):
        mgr.save(step, state)
    assert mgr.all_steps() == [5, 10]
    assert mgr.latest_step() == 10
    restored = mgr.restore(_tiny_state(seed=3))
    _leaves_equal(convert.train_state_arrays(restored), convert.train_state_arrays(state))
    restored5 = mgr.restore(_tiny_state(seed=3), step=5)
    assert convert.train_state_shapes(restored5) == convert.train_state_shapes(state)


def test_manager_empty_raises(tmp_path):
    mgr = CheckpointManager(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tiny_state())


def test_manager_ignores_interrupted_tmp_saves(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    state = _tiny_state()
    mgr.save(0, state)
    mgr.save(5, state)
    (tmp_path / "ckpt" / "step_00000010.npz.tmp").write_bytes(b"partial")
    assert mgr.all_steps() == [0, 5]
    assert mgr.latest_step() == 5
    mgr.restore(_tiny_state())
    mgr.save(12, state)
    assert mgr.all_steps() == [5, 12]


def test_quantized_and_rope_pytrees_roundtrip(tmp_path):
    """int8 weight leaves keep their dtype, a rope model's absent position
    table stays absent, and the restored params run the quantized forward;
    the reference's quantized tree loads in the port with its dtypes."""
    params = tseq.init(torch.Generator().manual_seed(0), obs_dim=4, d_model=32, n_heads=4,
                       n_layers=1, pos_encoding="rope", device="cpu")
    qparams = quantize_seqformer(params)
    path = tmp_path / "q.npz"
    save_pytree(path, qparams)
    restored = load_pytree(path, {k: torch.zeros_like(v) for k, v in qparams.items()})
    assert "pos" not in restored
    assert restored["blocks.0.wq.w_q"].dtype == torch.int8
    for k in qparams:
        assert torch.equal(restored[k], qparams[k]), k
    out = tseq.apply(restored, torch.zeros((1, 8, 4)), compute_dtype=torch.float32)
    assert out.shape == (1, 8, 4)

    jq = jquantize_seqformer(jax.device_get(jseq.init(
        jax.random.PRNGKey(0), obs_dim=4, d_model=32, n_heads=4, n_layers=1,
        pos_encoding="rope")))
    jck.save_pytree(tmp_path / "jq.npz", jq)
    target = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jq)
    got = load_pytree(tmp_path / "jq.npz", target)
    assert got["blocks"][0]["wq"]["w_q"].dtype == np.int8
    _leaves_equal(jax.tree.leaves(got), jax.tree.leaves(jq))


def test_manager_torn_latest_falls_back_counted(tmp_path):
    counters = EventCounters()
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=3, counters=counters)
    state = _tiny_state()
    mgr.save(1, state)
    mgr.save(2, state)
    with open(mgr._path(2), "r+b") as f:
        f.truncate(12)
    restored = mgr.restore(_tiny_state(seed=4))
    _leaves_equal(convert.train_state_arrays(restored), convert.train_state_arrays(state))
    assert mgr.restore_fallbacks == 1
    assert counters.get("ha_restore_fallbacks") == 1
    with pytest.raises(Exception):
        mgr.restore(_tiny_state(), step=2)  # explicit step: strict
    with open(mgr._path(1), "r+b") as f:
        f.truncate(12)
    with pytest.raises(RuntimeError, match="every checkpoint"):
        mgr.restore(_tiny_state())


#: writer/reader races run inside the retention-race test
RACES = 20


def test_manager_retention_racing_restore(tmp_path):
    """With ``max_to_keep=1`` every save unlinks the step a concurrent reader
    may have just listed.  The reference's restore gives up after 8
    re-lists, and its listing can come back empty between the rename of the
    new step and the unlink of the old one (``no checkpoints under ...``).
    The port's restore must never fail: 20 races, each a reader restoring
    continuously while the writer saves 39 steps, under a short switch
    interval."""
    state = _tiny_state()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for race in range(RACES):
            mgr = CheckpointManager(tmp_path / f"ckpt{race}", max_to_keep=1)
            mgr.save(0, state)
            errors, restores = [], [0]
            stop = threading.Event()

            def reader(mgr=mgr, errors=errors, restores=restores, stop=stop):
                template = _tiny_state(seed=1)
                try:
                    while not stop.is_set():
                        assert mgr.restore(template) is template
                        restores[0] += 1
                except Exception as exc:  # noqa: BLE001 - the assertion subject
                    errors.append(f"{type(exc).__name__}: {exc}")

            t = threading.Thread(target=reader, daemon=True)
            t.start()
            for step in range(1, 40):
                mgr.save(step, state)
            stop.set()
            t.join(timeout=30)
            assert not t.is_alive()
            assert errors == [], (race, errors)
            assert restores[0] > 0 and mgr.restore_fallbacks == 0
    finally:
        sys.setswitchinterval(switch)


def test_manager_orbax_refused_naming_npz(tmp_path):
    with pytest.raises(ValueError) as ei:
        CheckpointManager(tmp_path / "ockpt", backend="orbax")
    assert "backend='npz'" in str(ei.value)
    assert not (tmp_path / "ockpt").exists()


# -- 2. across packages -----------------------------------------------------------


def _det_case():
    batch = _det_batch()
    return (lambda key: jdet.init(key, **TINY),
            functools.partial(jdet.loss_fn, compute_dtype=jnp.float32),
            _port_loss, batch)


def _seq_case():
    cfg = dict(obs_dim=4, d_model=32, n_heads=4, n_layers=2, max_len=32)
    ep = np.random.default_rng(1).standard_normal((2, 17, 4)).astype(np.float32)
    return (lambda key: jseq.init(key, **cfg),
            functools.partial(jseq.episode_loss_fn, compute_dtype=jnp.float32),
            functools.partial(tseq.episode_loss_fn, compute_dtype=torch.float32),
            {"episode": ep})


def _policy_case():
    rng = np.random.default_rng(2)
    obs = rng.normal(0.0, 0.5, (64, 3)).astype(np.float32)
    actions = rng.integers(0, 2, 64).astype(np.int32)
    returns = rng.normal(0.0, 1.0, 64).astype(np.float32)

    def jloss(p, b):
        return jpol.reinforce_loss(p, b["obs"], b["actions"], b["returns"])

    def tloss(p, b):
        return tpol.reinforce_loss(p, b["obs"], b["actions"].long(), b["returns"])

    return (lambda key: jpol.init(key, 3, 2), jloss, tloss,
            {"obs": obs, "actions": actions, "returns": returns})


CASES = {"detector": _det_case, "seqformer": _seq_case, "policy": _policy_case}


def _jax_state(make, jloss, batch, seed, steps):
    opt = optax.adam(LR)
    state = JTrainState.create(make(jax.random.PRNGKey(seed)), opt)
    step = jmake_train_step(jloss, opt, donate=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(steps):
        state, _ = step(state, jb)
    return state, step, jb


def _port_state(make, seed):
    return TrainState.create(params_from_jax(jax.tree.map(np.asarray, make(
        jax.random.PRNGKey(seed))), device="cpu"), lr=LR)


def _port_grads(loss_fn, params, batch):
    ps = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(ps, batch)
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in ps.items()}


def _hold_resumed_step(got, jstate, port_grads, ref_grads):
    """``got`` (the port's params after one step from the restored state)
    against optax.adam applied from the restored reference state to the
    port's gradients (every element) and to the reference's (every element
    whose reference gradient is at least SENSITIVE), at 1e-5."""
    opt = optax.adam(LR)

    def optax_step(grads):
        updates, _ = opt.update(grads, jstate.opt_state, jstate.params)
        return jax.tree.leaves(jax.tree.map(np.asarray, optax.apply_updates(jstate.params,
                                                                            updates)))

    same = optax_step(jax.tree.map(jnp.asarray, params_to_jax(port_grads)))
    reference = optax_step(ref_grads)
    flat_rg = jax.tree.leaves(jax.tree.map(np.asarray, ref_grads))
    flat_got = jax.tree.leaves(params_to_jax(got))
    well_total = []
    for g, a, b, rg in zip(flat_got, same, reference, flat_rg):
        np.testing.assert_allclose(g, a, atol=1e-5)
        well = np.abs(rg) >= SENSITIVE
        well_total.append(well.ravel())
        np.testing.assert_allclose(g[well], b[well], atol=1e-5)
    assert np.concatenate(well_total).mean() > 0.9


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_file_loads_in_the_port_and_steps_on(case, tmp_path):
    make, jloss, tloss, batch = CASES[case]()
    jstate, jstep, jb = _jax_state(make, jloss, batch, seed=0, steps=3)
    path = tmp_path / "ref.npz"
    jck.save_train_state(path, jstate)

    port = load_train_state(path, _port_state(make, seed=7))
    assert port.step == 3
    _leaves_equal(convert.train_state_arrays(port), jax.tree.leaves(jstate))

    # one more step on each side, from the restored Adam state
    tb = _tb(batch)
    _, port_grads = _port_grads(tloss, port.params, tb)
    ref_loss, ref_grads = jax.value_and_grad(jloss)(jstate.params, jb)
    port, loss = make_train_step(tloss)(port, tb)
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-5)
    _hold_resumed_step(port.params, jstate, port_grads, ref_grads)
    assert port.step == 4
    assert all(float(s["step"]) == 4 for s in port.optimizer.state.values())


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_file_loads_in_the_reference_and_steps_on(case, tmp_path):
    make, jloss, tloss, batch = CASES[case]()
    port = _port_state(make, seed=0)
    step = make_train_step(tloss)
    tb = _tb(batch)
    for _ in range(3):
        port, _ = step(port, tb)
    path = tmp_path / "port.npz"
    save_train_state(path, port)

    template, jstep, jb = _jax_state(make, jloss, batch, seed=5, steps=0)
    jstate = jck.load_train_state(path, template)
    assert int(jstate.step) == 3 and int(jstate.opt_state[0].count) == 3
    _leaves_equal(jax.tree.leaves(jstate), convert.train_state_arrays(port))

    _, port_grads = _port_grads(tloss, port.params, tb)
    ref_loss, ref_grads = jax.value_and_grad(jloss)(jstate.params, jb)
    port, loss = step(port, tb)
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-5)
    _hold_resumed_step(port.params, jstate, port_grads, ref_grads)
    jnext, _ = jstep(jstate, jb)
    assert int(jnext.opt_state[0].count) == 4


def test_fresh_adam_saves_as_optax_init(tmp_path):
    """No step taken: ``count`` 0 and zero moments, as optax.adam's init."""
    make, _, _, _ = _det_case()
    save_train_state(tmp_path / "fresh.npz", _port_state(make, seed=0))
    ref = JTrainState.create(make(jax.random.PRNGKey(0)), optax.adam(LR))
    got = jck.load_train_state(tmp_path / "fresh.npz", ref)
    _leaves_equal(jax.tree.leaves(got), jax.tree.leaves(ref))
    assert np.asarray(jax.tree.leaves(got)[len(jax.tree.leaves(ref.params))]).dtype == np.int32


def test_layouts_that_cannot_be_written_raise():
    state = _tiny_state()
    make_train_step(_port_loss)(state, _tb(_det_batch()))
    first = next(iter(state.optimizer.state.values()))
    first["step"].fill_(7)
    with pytest.raises(ValueError, match="differs"):
        convert.train_state_arrays(state)
    sgd = TrainState(params=state.params, optimizer=torch.optim.SGD(
        list(state.params.values()), lr=0.1))
    with pytest.raises(ValueError, match="optax.adam"):
        convert.train_state_arrays(sgd)
    arrays = convert.train_state_arrays(_tiny_state())
    with pytest.raises(ValueError, match="leaves"):
        convert.load_train_state_arrays(_tiny_state(), arrays[:-1])


def _int8_state():
    """A TrainState with an int8 leaf beside a float one (Adam with no state)."""
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.random((3, 2), dtype=np.float32)).requires_grad_(),
              "w_q": torch.from_numpy(rng.integers(-127, 128, (3, 2), dtype=np.int8))}
    return TrainState(params=params, optimizer=torch.optim.Adam(params.values(), lr=LR))


def _retype(arrays, i, dtype):
    return [a.astype(dtype) if j == i else a for j, a in enumerate(arrays)]


@pytest.mark.parametrize("case", ["param_f64", "moment_f64", "float_into_int8",
                                  "float_count", "float_step"])
def test_leaves_of_another_dtype_raise_before_anything_is_written(case):
    """A leaf whose dtype differs from the tensor it lands in raises before
    any copy: a float64 file, a float leaf for an int8 weight, a float
    ``count`` or ``step``.  The template is left as it was."""
    if case == "float_into_int8":
        state = _int8_state()
        arrays = _retype(convert.train_state_arrays(state), 1, np.float32)
    else:
        state = _tiny_state(seed=2)
        make_train_step(_port_loss)(state, _tb(_det_batch()))
        arrays = convert.train_state_arrays(_tiny_state(seed=4))
        p = len(state.params)
        i = {"param_f64": 0, "moment_f64": p + 1, "float_count": p,
             "float_step": 3 * p + 1}[case]
        arrays = _retype(arrays, i, np.float64 if case.endswith("f64") else np.float32)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    adam_before = {id(p): {k: t.clone() for k, t in st.items()}
                   for p, st in state.optimizer.state.items()}
    with pytest.raises(ValueError, match="dtype"):
        convert.load_train_state_arrays(state, arrays)
    for k, v in state.params.items():
        assert torch.equal(v, before[k]), k
    after = {id(p): st for p, st in state.optimizer.state.items()}
    assert after.keys() == adam_before.keys()
    for key, st in adam_before.items():
        for k, t in st.items():
            assert torch.equal(after[key][k], t), k


def test_int8_leaves_keep_their_dtype_through_a_restore():
    """An int8 weight and its moments keep int8, as optax.adam's init makes
    them, and restore in place as int8."""
    state = _int8_state()
    arrays = convert.train_state_arrays(state)
    ref = optax.adam(LR).init({"w": jnp.zeros((3, 2)), "w_q": jnp.zeros((3, 2), jnp.int8)})
    assert [a.dtype for a in arrays[2:-1]] == [a.dtype for a in jax.tree.leaves(ref)]
    assert arrays[1].dtype == np.int8
    target = _int8_state()
    with torch.no_grad():
        target.params["w_q"].zero_()
    convert.load_train_state_arrays(target, arrays)
    assert target.params["w_q"].dtype == torch.int8
    assert torch.equal(target.params["w_q"], state.params["w_q"])


def test_jax_order_sorts_dict_keys_and_numbers_list_indices():
    names = ["convs.10.w", "convs.2.w", "head.w", "convs.2.b", "fc.w", "embed.b"]
    assert convert.jax_order(names) == ["convs.2.b", "convs.2.w", "convs.10.w", "embed.b",
                                        "fc.w", "head.w"]


# -- 3. in place ------------------------------------------------------------------


def test_restore_in_place_keeps_the_captured_graphs(monkeypatch, counted_kernel,  # noqa: F811
                                                    tmp_path):
    events = _stand_in_graphs(monkeypatch, counted_kernel)
    batch = _tb(_det_batch())
    eager_state = _tiny_state()
    eager = make_train_step(_port_loss, capture=False)
    for _ in range(4):
        eager_state, _ = eager(eager_state, batch)
    save_train_state(tmp_path / "ck.npz", eager_state)

    # a differently seeded state whose step is captured
    state = _tiny_state(seed=3)
    step = make_train_step(_port_loss)
    for _ in range(3):
        state, _ = step(state, batch)
    assert events == ["warm", "warm", ("capture", ((4, 16, 16, 3), (4, 2, 2)))]
    ptrs = {k: v.data_ptr() for k, v in state.params.items()}
    opt_tensors = dict(train._optimizer_tensors(state.optimizer))
    assert load_train_state(tmp_path / "ck.npz", state) is state
    assert {k: v.data_ptr() for k, v in state.params.items()} == ptrs
    now = train._optimizer_tensors(state.optimizer)
    assert all(now[k] is opt_tensors[k] for k in opt_tensors)

    events.clear()
    for _ in range(3):
        state, loss = step(state, batch)
        eager_state, ref = eager(eager_state, batch)
        assert float(loss) == float(ref)
    assert events == [] and len(step.graphs) == 1  # replays only, no new capture
    for k in state.params:
        assert torch.equal(state.params[k], eager_state.params[k]), k


def test_restore_into_a_fresh_adam_makes_its_state_first(monkeypatch, counted_kernel,  # noqa: F811
                                                         tmp_path):
    events = _stand_in_graphs(monkeypatch, counted_kernel)
    batch = _tb(_det_batch())
    eager_state = _tiny_state()
    eager = make_train_step(_port_loss, capture=False)
    for _ in range(2):
        eager_state, _ = eager(eager_state, batch)
    save_train_state(tmp_path / "ck.npz", eager_state)

    fresh = _tiny_state(seed=5)
    assert not fresh.optimizer.state
    load_train_state(tmp_path / "ck.npz", fresh)
    for p in fresh.params.values():
        st = fresh.optimizer.state[p]
        assert set(st) == {"step", "exp_avg", "exp_avg_sq"} and float(st["step"]) == 2
        assert st["step"].dtype == torch.float32 and st["step"].device.type == "cpu"
    made = dict(train._optimizer_tensors(fresh.optimizer))
    step = make_train_step(_port_loss)
    for _ in range(4):
        fresh, loss = step(fresh, batch)
        eager_state, ref = eager(eager_state, batch)
        assert float(loss) == float(ref)
    # the warm-ups and the one capture run over the tensors the restore made
    assert events == ["warm", "warm", ("capture", ((4, 16, 16, 3), (4, 2, 2)))]
    now = train._optimizer_tensors(fresh.optimizer)
    assert all(now[k] is made[k] for k in made)
    for k in fresh.params:
        assert torch.equal(fresh.params[k], eager_state.params[k]), k


def test_checkpoint_imports_without_torch():
    code = ("import json, sys\n"
            "import blendjax_torch.utils.checkpoint as c\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] == 'torch')))\n")
    import subprocess

    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
