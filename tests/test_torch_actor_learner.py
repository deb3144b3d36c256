"""The port's actor-learner (``blendjax_torch.models.actor_learner``,
``blendjax_torch.parallel.podracer``) against the reference's, on the CPU.

1. **Losses** — the single-fleet on-policy loss, the masked segment loss
   (all-ones mask, dead and padded rows, continuous) and the replay loss,
   taken from the reference's own learner, on the same seeded segments and
   params (carried over by ``params_from_jax``): each loss and its
   gradients within atol 1e-5.
2. **One update of each** against ``optax.adam(3e-3)``, held by
   ``tests/test_torch_policy.py``'s rule for Adam's first step near
   |g| ~ eps.
3. **SegmentFanIn** — ``assemble`` byte-equal to the reference's with
   ``mesh=None`` (every leaf and the mask) with live, dead and drained
   fleets; the reference's ``TestSegmentFanIn`` cases that run without a
   mesh; ``to_device`` on the CPU owns its copy before the arena recycles.
4. **run_offline** — on a uniform buffer filled identically in both
   packages, from the same params: 10 updates of 32, the first loss within
   1e-5, later losses and the final params within 1e-4 (observed on this
   CPU: the first loss 1.5e-8 apart, the largest later loss gap 2.3e-6,
   the largest parameter gap 4.1e-7).
5. **The snapshot contract** — the snapshot the actors sample from is a
   copy: published before update k+1, it still equals update k's params
   after update k+1 has run.
6. **Live** — the reference's three ``tests/test_actor_learner.py`` cases
   (lockstep; replay, then ``run_offline`` with the fleet gone;
   pipelined) on two of the port's echo producers
   (``tests/blender/torch_env.blend.py``, ``BLENDJAX_FAKE_BPY=1``) at the
   reference's criteria; its ``test_kill_one_fleet_keeps_training``
   without the mesh (two pools, fleet 1's producers killed, training goes
   on with its rows masked); and its re-admission case without the
   supervisor (the killed producer relaunched on its address, the pool's
   probes re-admit it, the learner restarts the fleet's actor).
7. **Refused arguments** name their ROADMAP item; the scenario plane's
   (``scenarios=``, ``curriculum=``, ``fanin_min_ready=``) are taken as the
   reference takes them (``tests/test_torch_scenario.py`` holds the plane
   itself).
"""

import inspect
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax.btt.chaos import kill_instance, wait_env_ready
from blendjax.models.actor_learner import ActorLearner as JActorLearner
from blendjax.parallel.podracer import SegmentFanIn as JSegmentFanIn
from blendjax.parallel.podracer import make_segment_loss as j_make_segment_loss
from blendjax.replay import ReplayBuffer as JReplayBuffer
from blendjax_torch.btt.envpool import EnvPool, launch_env_pool
from blendjax_torch.btt.faults import FaultPolicy
from blendjax_torch.btt.launcher import BlenderLauncher
from blendjax_torch.models.actor_learner import ActorLearner, fleet_seed
from blendjax_torch.models.convert import params_from_jax, params_to_jax
from blendjax_torch.models.train import TrainState, make_train_step
from blendjax_torch.parallel import SegmentFanIn, make_segment_loss, padded_size
from blendjax_torch.replay import ReplayBuffer
from blendjax_torch.utils.timing import EventCounters
from helpers import BLEND_SCRIPTS, FAKE_BLENDER
from test_torch_env import _free_block
from test_torch_policy import EPS, LR, SENSITIVE, _flat, _optax_step

ENV_SCRIPT = f"{BLEND_SCRIPTS}/torch_env.blend.py"
ATOL = 1e-5
T, N, D, A = 16, 8, 3, 2


def _ref_loss(step):
    """The loss function a reference learner's jitted step closes over."""
    return inspect.getclosurevars(step.__wrapped__).nonlocals["loss_fn"]


def _port_learner(tree, continuous=False, **kw):
    """A CPU learner whose params are the reference pytree ``tree``."""
    al = ActorLearner(None, D, A, continuous=continuous, device="cpu", **kw)
    al.load_checkpoint_state(TrainState.create(params_from_jax(tree, device="cpu"),
                                               lr=3e-3), {})
    return al


def _rollout(seed, continuous=False, t=T, n=N):
    rng = np.random.default_rng(seed)
    actions = (rng.standard_normal((t, n, A)).astype(np.float32) if continuous
               else rng.integers(0, A, (t, n)).astype(np.int32))
    return {"obs": rng.standard_normal((t, n, D)).astype(np.float32),
            "actions": actions,
            "rewards": rng.random((t, n)).astype(np.float32),
            "dones": rng.random((t, n)) < 0.1}


def _env_major(batch, mask):
    out = {k: np.ascontiguousarray(v.swapaxes(0, 1)) for k, v in batch.items()}
    dead = mask == 0
    for v in out.values():
        v[dead] = 0
    out["mask"] = mask
    return out


def _sampled(seed, continuous=False, b=64):
    rng = np.random.default_rng(seed)
    action = (rng.standard_normal((b, A)).astype(np.float32) if continuous
              else rng.integers(0, A, b).astype(np.int32))
    return {"obs": rng.standard_normal((b, D)).astype(np.float32), "action": action,
            "reward": rng.random(b).astype(np.float32),
            "is_weight": rng.uniform(0.2, 1.0, b).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.as_tensor(v).long() if v.dtype == np.int32 else torch.as_tensor(v)
            for k, v in batch.items()}


def _port_loss_and_grads(loss_fn, params, batch):
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(params, batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    return float(loss.detach()), grads


def _case(name):
    """(reference params, reference loss, port loss, batch) of a case."""
    continuous = name.endswith("continuous")
    ref = JActorLearner(None, obs_dim=D, num_actions=A, seed=3, continuous=continuous,
                        replay=JReplayBuffer(8))
    tree = jax.device_get(ref.state.params)
    port = _port_learner(tree, continuous=continuous, replay=ReplayBuffer(8))
    if name.startswith("on_policy"):
        batch = _rollout(5, continuous)
        return tree, _ref_loss(ref._step), port.loss_fn, batch
    if name.startswith("replay"):
        return tree, _ref_loss(ref._replay_step), port.replay_loss_fn, _sampled(6, continuous)
    mask = np.ones(N, np.float32)
    if name == "segment_dead_padded":
        mask[[2, 3, 7]] = 0.0  # a dead fleet's rows and a padding row
    batch = _env_major(_rollout(7, continuous), mask)
    return (tree, j_make_segment_loss(0.99, continuous=continuous),
            make_segment_loss(0.99, continuous=continuous), batch)


LOSS_CASES = ["on_policy", "on_policy_continuous", "segment_all_ones",
              "segment_dead_padded", "segment_continuous", "replay", "replay_continuous"]


@pytest.mark.parametrize("name", LOSS_CASES)
def test_loss_and_gradients_match_the_reference(name):
    tree, ref_loss, port_loss, batch = _case(name)
    want, ref_grads = jax.value_and_grad(ref_loss)(tree, jax.tree.map(jnp.asarray, batch))
    got, grads = _port_loss_and_grads(port_loss, params_from_jax(tree, device="cpu"),
                                      _torch_batch(batch))
    assert abs(got - float(want)) <= ATOL, (got, float(want))
    for g, r in zip(jax.tree.leaves(params_to_jax(grads)), jax.tree.leaves(ref_grads)):
        np.testing.assert_allclose(g, np.asarray(r), atol=ATOL, rtol=0)


def test_segment_loss_on_all_ones_equals_reinforce_on_the_time_major_batch():
    """The masked env-major loss on an all-ones mask is the single-fleet
    loss on the same rollout, time-major."""
    tree, _, port_loss, _ = _case("on_policy")
    params = params_from_jax(tree, device="cpu")
    batch = _rollout(11)
    a = port_loss(params, _torch_batch(batch))
    b = make_segment_loss(0.99)(params, _torch_batch(_env_major(batch, np.ones(N, np.float32))))
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    assert padded_size(6, 8) == 8 and padded_size(6, 1) == 6


def _hold_step(got, tree, port_grads, ref_grads):
    """``tests/test_torch_policy.py``'s three holds of one Adam step (see
    the note there): against optax.adam on the port's gradients (every
    element, atol 1e-5), on the reference's (atol 1e-5 where the reference
    gradient is at least SENSITIVE) and on the reference's within 1e-5 plus
    Adam's amplification of the gradient gap (every element).  Its guard
    that the second hold covers over 99% of the elements is taken over all
    parameters together: this policy's bias vectors have 2-64 elements."""
    same_grads = _flat(_optax_step(tree, params_to_jax(port_grads)))
    reference = _flat(_optax_step(tree, ref_grads))
    held = total = 0
    for g, a, b, pg, rg in zip(_flat(params_to_jax(got)), same_grads, reference,
                               _flat(params_to_jax(port_grads)), _flat(ref_grads)):
        np.testing.assert_allclose(g, a, atol=1e-5)
        well = np.abs(rg) >= SENSITIVE
        held, total = held + well.sum(), total + well.size
        np.testing.assert_allclose(g[well], b[well], atol=1e-5)
        pg, rg = pg.astype(np.float64), rg.astype(np.float64)
        least = np.where(np.sign(pg) == np.sign(rg), np.minimum(np.abs(pg), np.abs(rg)), 0.0)
        slope = LR * EPS / (least + EPS) ** 2
        gap = np.abs(g.astype(np.float64) - b)
        assert (gap <= 1e-5 + slope * np.abs(pg - rg)).all(), gap.max()
    assert held / total > 0.99


@pytest.mark.parametrize("name", ["on_policy", "segment_dead_padded", "replay"])
def test_one_update_matches_optax_adam(name):
    tree, ref_loss, port_loss, batch = _case(name)
    ref_grads = jax.grad(ref_loss)(tree, jax.tree.map(jnp.asarray, batch))
    params = params_from_jax(tree, device="cpu")
    _, port_grads = _port_loss_and_grads(port_loss, params, _torch_batch(batch))
    state = TrainState.create(params, lr=3e-3)
    state, _ = make_train_step(port_loss)(state, _torch_batch(batch))
    _hold_step(state.params, tree, port_grads, ref_grads)


# -- SegmentFanIn -----------------------------------------------------------------


def _seg_lists(rng, t, n, d, fill=None):
    obs = [rng.random((n, d)).astype(np.float32) for _ in range(t)]
    if fill is not None:
        obs = [np.full((n, d), fill, np.float32) for _ in range(t)]
    return (obs,
            [rng.integers(0, 2, (n,)).astype(np.int32) for _ in range(t)],
            [rng.random((n,)).astype(np.float32) for _ in range(t)],
            [np.zeros((n,), bool) for _ in range(t)])


def test_fanin_three_fleets_no_mesh():
    fanin = SegmentFanIn([2, 2, 2], device="cpu")
    assert fanin.n_real == 6 and fanin.n_padded == 6
    rng = np.random.default_rng(0)
    stop = threading.Event()
    for f in range(3):
        assert fanin.put_segment(f, _seg_lists(rng, 4, 2, 3), stop)
    segs = fanin.collect(lambda f: True, stop)
    assert sorted(segs) == [0, 1, 2]
    batch = fanin.assemble(segs)
    assert batch.data["obs"].shape == (6, 4, 3)
    assert batch.data["mask"].tolist() == [1] * 6
    dev = fanin.to_device(batch)
    assert isinstance(dev["obs"], torch.Tensor) and dev["rewards"].shape == (6, 4)
    assert fanin.arena_pool.in_use == 0


def test_dead_fleet_rows_zeroed_and_masked():
    fanin = SegmentFanIn([2, 2], device="cpu")
    rng = np.random.default_rng(1)
    stop = threading.Event()
    fanin.put_segment(0, _seg_lists(rng, 4, 2, 3), stop)
    fanin.put_segment(1, _seg_lists(rng, 4, 2, 3, fill=7.0), stop)
    b1 = fanin.assemble(fanin.collect(lambda f: True, stop))
    assert b1.data["mask"].tolist() == [1, 1, 1, 1]
    b1.recycle()
    fanin.put_segment(0, _seg_lists(rng, 4, 2, 3), stop)
    t0 = time.perf_counter()
    segs = fanin.collect(lambda f: f == 0, stop)
    assert time.perf_counter() - t0 < 5.0
    assert sorted(segs) == [0]
    b2 = fanin.assemble(segs)
    assert b2.data["mask"].tolist() == [1, 1, 0, 0]
    np.testing.assert_array_equal(b2.data["obs"][2:], 0.0)


def test_collect_drains_dead_fleets_final_segment():
    fanin = SegmentFanIn([2], device="cpu")
    rng = np.random.default_rng(2)
    stop = threading.Event()
    fanin.put_segment(0, _seg_lists(rng, 2, 2, 3), stop)
    segs = fanin.collect(lambda f: False, stop)
    assert sorted(segs) == [0]


def test_assemble_is_byte_equal_to_the_reference():
    """Three rounds through both packages' fan-ins (fleets of 2, 3 and 2
    envs): all live; fleet 1 dead with an empty queue and fleet 2 dead but
    owing a last segment (drained); fleet 2 alone.  Every leaf and the mask
    equal, dtypes included."""
    sizes = [2, 3, 2]
    ours, ref = SegmentFanIn(sizes, device="cpu"), JSegmentFanIn(sizes, mesh=None)
    rng = np.random.default_rng(3)
    stop = threading.Event()
    rounds = [({0, 1, 2}, {0, 1, 2}), ({0, 2}, {0}), ({2}, set())]
    for fill, alive in rounds:
        for f in sorted(fill):
            seg = _seg_lists(rng, 5, sizes[f], 3, fill=None if f != 1 else 9.0)
            assert ours.put_segment(f, seg, stop) and ref.put_segment(f, seg, stop)
        a = ours.assemble(ours.collect(lambda f: f in alive, stop))
        b = ref.assemble(ref.collect(lambda f: f in alive, stop))
        assert a.data.keys() == b.data.keys()
        for key in b.data:
            assert a.data[key].dtype == b.data[key].dtype, key
            assert np.array_equal(a.data[key], b.data[key]), key
        assert a.data["mask"].tolist() == [float(f in fill) for f in (0, 0, 1, 1, 1, 2, 2)]
        a.recycle()
        b.recycle()


def test_to_device_on_cpu_owns_its_copy_before_recycling():
    fanin = SegmentFanIn([2, 2], device="cpu", arena_pool=None)
    rng = np.random.default_rng(4)
    stop = threading.Event()
    for f in range(2):
        fanin.put_segment(f, _seg_lists(rng, 3, 2, 3), stop)
    dev = fanin.to_device(fanin.assemble(fanin.collect(lambda f: True, stop)))
    kept = {k: v.clone() for k, v in dev.items()}
    assert fanin.arena_pool.in_use == 0
    for _ in range(3):  # later batches reuse the recycled arenas
        for f in range(2):
            fanin.put_segment(f, _seg_lists(rng, 3, 2, 3, fill=5.0), stop)
        fanin.to_device(fanin.assemble(fanin.collect(lambda f: True, stop)))
    for k in kept:
        assert torch.equal(dev[k], kept[k]), k


# -- run_offline, the whole path --------------------------------------------------


def test_run_offline_uniform_matches_the_reference():
    """Uniform draws depend only on the seed and the appends, so both
    packages train on the same batches in the same order."""
    rng = np.random.default_rng(8)
    bufs = (ReplayBuffer(512, seed=2, prioritized=False, counters=EventCounters()),
            JReplayBuffer(512, seed=2, prioritized=False))
    for _ in range(300):
        tr = {"obs": rng.standard_normal(D).astype(np.float32),
              "action": np.int32(rng.integers(0, A)), "reward": np.float32(rng.random()),
              "next_obs": rng.standard_normal(D).astype(np.float32), "done": False}
        healthy = bool(rng.random() > 0.1)
        for b in bufs:
            b.append(tr, healthy=healthy)
    ref = JActorLearner(None, obs_dim=D, num_actions=A, seed=4, replay=bufs[1])
    port = _port_learner(jax.device_get(ref.state.params), replay=bufs[0])
    want = ref.run_offline(num_updates=10, batch_size=32)
    got = port.run_offline(num_updates=10, batch_size=32)
    assert got["updates"] == want["updates"] == 10
    assert abs(got["losses"][0] - want["losses"][0]) <= 1e-5
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-4, rtol=0)
    for a, b in zip(jax.tree.leaves(params_to_jax(port.state.params)),
                    jax.tree.leaves(jax.device_get(ref.state.params))):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    assert got["replay"]["samples"] >= 10
    stages = bufs[0].timer.summary()
    assert stages["device_put"]["count"] >= 10 and stages["recycle"]["count"] >= 10


def test_snapshot_is_a_copy_that_survives_the_next_update():
    buf = ReplayBuffer(256, seed=0, counters=EventCounters())
    rng = np.random.default_rng(1)
    for _ in range(128):
        buf.append({"obs": rng.standard_normal(D).astype(np.float32),
                    "action": np.int64(rng.integers(0, A)),
                    "reward": np.float32(rng.random())})
    al = ActorLearner(None, D, A, device="cpu", replay=buf, replay_batch=32)
    for k in range(3):
        snap, event = al._actor_params
        assert event is None  # no stream to order on the CPU
        at_k = {n: v.detach().clone() for n, v in al.state.params.items()}
        assert all(snap[n].data_ptr() != p.data_ptr() for n, p in al.state.params.items())
        data, idx, w = buf.sample(32, keys=("obs", "action", "reward"))
        al._replay_update(data, idx, w)
        assert al._updates_done == k + 1
        for n in at_k:
            assert torch.equal(snap[n], at_k[n]), n  # the old snapshot held still
        assert any(not torch.equal(al.state.params[n], at_k[n]) for n in at_k)
        new, _ = al._actor_params
        assert all(torch.equal(new[n], al.state.params[n]) for n in at_k)
    assert fleet_seed(0, 0) == fleet_seed(0, 0) != fleet_seed(0, 1)


def test_sampling_waits_while_a_step_is_captured():
    """An actor's sampling copies pageable memory to and from the card,
    which torch refuses while another thread captures a CUDA graph: it
    waits at the capture gate while a capture is open, and goes on after."""
    from blendjax_torch.models.train import capture_gate

    al = ActorLearner(None, D, A, device="cpu")
    params, _ = al._actor_params
    obs = np.zeros((2, D), np.float32)
    done = threading.Event()

    def sample():
        al._sample(params, torch.Generator().manual_seed(0), obs)
        done.set()

    with capture_gate.capturing():
        t = threading.Thread(target=sample, daemon=True)
        t.start()
        assert not done.wait(0.3), "the actor sampled while a capture was open"
    assert done.wait(5)
    t.join(timeout=5)


# -- refused arguments and validation ---------------------------------------------


@pytest.fixture(scope="module")
def mesh_ranks():
    """2 gloo ranks running ``helpers.torch_parallel_ranks.learner_mesh_options``."""
    from helpers import torch_parallel_ranks
    from helpers.torch_ranks import Ranks

    batch = _env_major(_rollout(3, t=8, n=2), np.ones(2, np.float32))
    r = Ranks(torch_parallel_ranks.learner_mesh_options, 2, {"batch": batch})
    try:
        yield r
    finally:
        r.close()


@pytest.mark.parametrize("name, item", [("mesh", None), ("pipeline_stages", "item 7")])
def test_not_ported_arguments_name_their_roadmap_item(name, item, mesh_ranks):
    """Both arguments are ported (the ids keep their old names).  ``mesh=``:
    on 2 ranks one sharded update runs, the ranks hold one replica of the
    parameters (and their actors' snapshot is its local copy), and a mesh
    with no 'data' axis is refused.  ``pipeline_stages=`` (item 7d): a
    2-stage ``pg`` fleet of stage threads on the CPU takes one update from
    the replay, and the learner's state and snapshot are the fleet's
    committed parameters."""
    ActorLearner(None, D, A, device="cpu", **{name: None})  # the default is accepted
    if item is not None:
        from blendjax_torch.parallel.mpmd import MpmdTrain, normalize_spec, start_stage_threads

        spec = normalize_spec({"family": "pg", "d_in": D, "wire": 8, "d_out": A,
                               "n_layers": 2, "n_procs": 2, "seed": 1})
        rng = np.random.default_rng(0)
        buf = ReplayBuffer(64, seed=0)
        for _ in range(32):
            buf.append({"obs": rng.standard_normal(D).astype(np.float32),
                        "action": int(rng.integers(0, A)), "reward": float(rng.standard_normal())})
        with start_stage_threads(spec, device="cpu") as handle:
            driver = MpmdTrain(handle.addresses, spec)
            try:
                driver.hello_all()
                al = ActorLearner(None, D, A, device="cpu", replay=buf, pipeline_stages=driver)
                before = {k: v.clone() for k, v in al.state.params.items()}
                stats = al.run_offline(num_updates=1, batch_size=16)
                fleet = driver.gather_params()
                infos = driver.stage_infos()
            finally:
                driver.close()
        assert stats["updates"] == 1 and np.isfinite(stats["losses"][0])
        assert al.state.step == 1 and [i["applied"] for i in infos] == [1, 1]
        assert sorted(al.state.params) == sorted(fleet)
        for k, v in fleet.items():
            np.testing.assert_array_equal(al.state.params[k].detach().numpy(), v)
            np.testing.assert_array_equal(al._actor_params[0][k].numpy(), v)
        assert any(not torch.equal(before[k], al.state.params[k]) for k in fleet)
        return
    out = mesh_ranks.result("actor_learner", 100)
    for rec in out.values():
        assert rec["step"] == 1 and np.isfinite(rec["loss"]) and rec["loss"] == out[0]["loss"]
        assert "has no 'data' axis" in rec["refused"]
        for k, v in rec["params"].items():
            np.testing.assert_array_equal(v, out[0]["params"][k])
            np.testing.assert_array_equal(rec["snapshot"][k], v)


def _scenario_option(name):
    from blendjax_torch.scenario import CurriculumScheduler, DomainRandomizer, ScenarioCatalog
    from blendjax_torch.scenario import ScenarioSpec

    cat = ScenarioCatalog([ScenarioSpec("lite"), ScenarioSpec("rich", physics_rate_us=9)])
    return {"scenarios": lambda: DomainRandomizer(cat, [["tcp://127.0.0.1:1"]] * 2,
                                                  counters=EventCounters()),
            "curriculum": lambda: CurriculumScheduler(cat, counters=EventCounters()),
            "fanin_min_ready": lambda: 0}[name]()


@pytest.mark.parametrize("name", ["scenarios", "curriculum", "fanin_min_ready"])
def test_scenario_arguments_are_accepted_as_the_references(name):
    """The scenario plane's arguments are taken as the reference takes
    them: the learner keeps the randomizer and the curriculum, clamps
    ``fanin_min_ready`` to at least 1, and its stats and checkpoint carry
    the same scenario keys as the reference learner's."""
    value = _scenario_option(name)
    kw = {"fanin_min_ready": 0} if name == "fanin_min_ready" else {name: value}
    al = ActorLearner([object(), object()], D, A, device="cpu", **kw)
    ref = JActorLearner([object(), object()], D, A, **kw)
    if name == "fanin_min_ready":
        assert al.fanin_min_ready == ref.fanin_min_ready == 1
    else:
        attr = "randomizer" if name == "scenarios" else "curriculum"
        assert getattr(al, attr) is getattr(ref, attr) is value
    assert sorted(al.stats()) == sorted(set(ref.stats()) | {"last_published_version"})
    assert al.checkpoint_state().keys() == ref.checkpoint_state().keys()
    if name == "scenarios":
        value.close()


def _filled_buffer(buf, n=128, seed=1):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        buf.append({"obs": rng.standard_normal(D).astype(np.float32),
                    "action": np.int64(rng.integers(0, A)),
                    "reward": np.float32(rng.random())})
    return buf


@pytest.mark.parametrize("name", ["weight_bus", "hub"])
def test_ported_arguments_are_held(name):
    """``weight_bus=``: every ``publish_every``-th update publishes the
    learner's params in the reference's layout (a subscriber's snapshot
    equals ``params_to_jax`` of the params at that update, exactly), timed
    as ``weight_publish``.  ``hub=``: one scrape holds the sharded replay's
    client counters and stages, each shard process's as a remote, and the
    loop's ``stats`` probe."""
    from blendjax_torch.replay import ShardedReplay
    from blendjax_torch.replay.service import start_shard_thread
    from blendjax_torch.weights import WeightPublisher, WeightSubscriber

    if name == "weight_bus":
        buf = _filled_buffer(ReplayBuffer(256, seed=0, counters=EventCounters()))
        with WeightPublisher(version_base=0).start() as pub:
            sub = WeightSubscriber(pub.address)
            try:
                al = ActorLearner(None, D, A, device="cpu", replay=buf, replay_batch=32,
                                  weight_bus=pub, publish_every=2)
                published = {}
                for _ in range(4):
                    data, idx, w = buf.sample(32, keys=("obs", "action", "reward"))
                    al._replay_update(data, idx, w)
                    if al._updates_done % 2 == 0:
                        published[al.last_published_version] = params_to_jax(al.state.params)
                assert sorted(published) == [1, 2] and pub.version == 2
                assert al.stats()["last_published_version"] == 2
                assert al.checkpoint_state()["last_published_version"] == 2
                assert al.timer.summary()["weight_publish"]["count"] == 2
                deadline = time.monotonic() + 10
                snap = None
                while (snap is None or snap.version < 2) and time.monotonic() < deadline:
                    snap = sub.poll() or snap
                    time.sleep(0.02)
                assert snap is not None and snap.version == 2
                for a, b in zip(jax.tree.leaves(snap.tree()), jax.tree.leaves(published[2])):
                    np.testing.assert_array_equal(a, b)
            finally:
                sub.close()
        return
    from blendjax_torch.obs.hub import TelemetryHub

    # the shards' own counters: the process-wide ones hold other tests' events
    handles = [start_shard_thread(128, shard_id=i, counters=EventCounters()) for i in range(2)]
    try:
        buf = _filled_buffer(ShardedReplay([h.address for h in handles], seed=0,
                                           counters=EventCounters()))
        hub = TelemetryHub()
        al = ActorLearner(None, D, A, device="cpu", replay=buf, hub=hub)
        al.run_offline(num_updates=2, batch_size=32)
        snap = hub.scrape()
        assert snap["counters"]["replay_appends"] == 128
        assert snap["stages"]["shard_append"]["count"] == 128
        assert snap["stages"]["shard_srv_append"]["count"] == 128  # the shards, as remotes
        assert snap["components"]["actor_learner"]["probe"]["updates"] == 2
        assert set(snap["components"]) >= {buf.name, f"{buf.name}/shard0",
                                           f"{buf.name}/shard1", "actor_learner"}
        assert "remote_errors" not in snap
        buf.close()
    finally:
        for h in handles:
            h.close()


def test_validation_errors(mesh_ranks):
    with pytest.raises(TypeError, match="unexpected keyword"):
        ActorLearner(None, D, A, device="cpu", optimiser=None)
    with pytest.raises(ValueError, match="num_fleets"):
        ActorLearner([object(), object()], D, A, num_fleets=3, device="cpu")
    with pytest.raises(ValueError, match="replay buffer"):
        ActorLearner(None, D, A, replay_ratio=1, device="cpu")
    al = ActorLearner(None, D, A, device="cpu")
    with pytest.raises(RuntimeError, match="run_offline"):
        al.run(num_updates=1)
    with pytest.raises(RuntimeError, match="replay buffer"):
        al.run_offline(1)
    # a fan-in over a mesh: 1 + 2 real rows over 2 ranks pad to 2 each
    out = mesh_ranks.result("fanin", 100)
    assert out[0]["mask"] + out[1]["mask"] == [1, 0, 1, 1]
    assert {rec["shape"] for rec in out.values()} == {(4, 3, 2)}
    assert {rec["n_padded"] for rec in out.values()} == {4}


# -- live, on the port's echo producers -------------------------------------------

VALUES = np.array([0.0, 1.0], np.float64)


def _action_map(a):
    return list(VALUES[np.asarray(a)])


@pytest.fixture
def fake_blender(monkeypatch):
    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)
    monkeypatch.setenv("BLENDJAX_FAKE_BPY", "1")


def _echo_pool(**kw):
    return launch_env_pool(scene="", script=ENV_SCRIPT, num_instances=2, background=True,
                           horizon=1_000_000, timeoutms=30000, start_port=_free_block(2), **kw)


def _learned(stats):
    first = np.mean(stats["segment_rewards"][:5])
    last = np.mean(stats["segment_rewards"][-5:])
    assert last > first
    assert last > 0.08, f"policy failed to converge: {last}"


def test_actor_learner_improves_and_overlaps(fake_blender):
    with _echo_pool() as pool:
        al = ActorLearner(pool, obs_dim=1, num_actions=2, rollout_len=16, seed=1,
                          action_map=_action_map, device="cpu")
        stats = al.run(num_updates=40)
    assert stats["updates"] == 40
    # the actor ran AHEAD of the learner (strict: a serialized loop
    # produces exactly the consumed segments)
    assert stats["env_steps"] > 40 * 16 * 2
    assert stats["env_steps_per_sec"] > 0
    _learned(stats)
    assert stats["stages"]["policy"]["count"] * 2 == stats["env_steps"]
    assert stats["stages"]["update"]["count"] == 40


def test_actor_learner_with_replay_off_policy_path(fake_blender):
    buf = ReplayBuffer(4096, seed=0, counters=EventCounters())
    with _echo_pool() as pool:
        al = ActorLearner(pool, obs_dim=1, num_actions=2, rollout_len=16, seed=1,
                          action_map=_action_map, replay=buf, replay_ratio=1,
                          replay_batch=32, device="cpu")
        stats = al.run(num_updates=20)
    assert stats["updates"] == 20
    assert stats["replay"]["appends"] == stats["env_steps"]
    assert stats["replay"]["excluded"] == 0
    assert stats["replay_updates"] > 0
    assert len(buf) > 0
    # the fleet is gone: off-policy training continues from the buffer alone
    off = al.run_offline(num_updates=10, batch_size=32)
    assert off["updates"] == 10
    assert off["replay"]["samples"] >= 10
    assert al.state.step == 20 + stats["replay_updates"] + 10


def test_actor_learner_pipelined_double_buffer(fake_blender):
    with _echo_pool(pipeline_depth=2) as pool:
        al = ActorLearner(pool, obs_dim=1, num_actions=2, rollout_len=16, seed=1,
                          action_map=_action_map, pipeline=True, device="cpu")
        stats = al.run(num_updates=30)
    assert stats["updates"] == 30
    assert stats["env_steps"] > 30 * 16 * 2
    assert stats["unhealthy_env_steps"] == 0
    _learned(stats)


def test_kill_one_fleet_keeps_training(fake_blender):
    """Two fleets of two echo producers, no mesh; every producer of fleet 1
    is killed mid-run.  The learner completes its updates from fleet 0,
    fleet 1's rows masked, and reports fleet 1 dead."""
    policy = FaultPolicy(max_retries=1, backoff_base=0.05, deadline_s=2.0,
                         circuit_threshold=0, seed=7)
    launchers, pools = [], []
    try:
        for _ in range(2):
            bl = BlenderLauncher(scene="", script=ENV_SCRIPT, num_instances=2,
                                 named_sockets=["GYM"], start_port=_free_block(2),
                                 background=True,
                                 instance_args=[["--horizon", "1000000"]] * 2).__enter__()
            launchers.append(bl)
            wait_env_ready(bl.launch_info.addresses["GYM"])
            pools.append(EnvPool(bl.launch_info.addresses["GYM"], timeoutms=10000,
                                 fault_policy=policy, counters=EventCounters()))
        al = ActorLearner(pools, obs_dim=1, num_actions=2, rollout_len=8, seed=1,
                          action_map=_action_map, device="cpu")

        def killer():
            while sum(al._env_steps_by_fleet) < 64:
                time.sleep(0.02)
            kill_instance(launchers[1], 0)
            kill_instance(launchers[1], 1)

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        stats = al.run(num_updates=30)  # completing AT ALL = no stall
        kt.join(timeout=10)
        assert not kt.is_alive()
    finally:
        for pool in pools:
            pool.close()
        for bl in launchers:
            bl.__exit__(None, None, None)
    assert stats["updates"] == 30
    assert stats["num_fleets"] == 2
    assert stats["dead_fleets"] == [1]
    assert stats["env_steps_by_fleet"][0] > stats["env_steps_by_fleet"][1]
    assert not pools[1].healthy.any() and pools[0].healthy.all()


def test_killed_fleet_rejoins_after_its_producer_is_relaunched(fake_blender):
    """Fleet re-admission without the (unported) supervisor: fleet 1's only
    producer is killed, its actor dies and its rows are masked; a producer
    relaunched on its address is re-admitted by the pool's probes, and the
    learner restarts the fleet's actor thread, so the fleet rejoins."""
    policy = FaultPolicy(max_retries=1, backoff_base=0.05, deadline_s=2.0,
                         circuit_threshold=0, seed=7)
    bases = [_free_block(1), _free_block(1)]
    launchers, pools, relaunched = [], [], None

    def launch(base):
        bl = BlenderLauncher(scene="", script=ENV_SCRIPT, num_instances=1,
                             named_sockets=["GYM"], start_port=base, background=True,
                             instance_args=[["--horizon", "1000000"]]).__enter__()
        wait_env_ready(bl.launch_info.addresses["GYM"])
        return bl

    try:
        for base in bases:
            launchers.append(launch(base))
            pools.append(EnvPool(launchers[-1].launch_info.addresses["GYM"],
                                 timeoutms=10000, fault_policy=policy,
                                 counters=EventCounters()))
        al = ActorLearner(pools, obs_dim=1, num_actions=2, rollout_len=8, seed=1,
                          action_map=_action_map, device="cpu")
        al.fleet_restart_cooldown = 0.2
        result = {}
        runner = threading.Thread(
            target=lambda: result.update(al.run(num_updates=100_000, seconds=120)),
            daemon=True)
        runner.start()
        deadline = time.monotonic() + 60
        while min(al._env_steps_by_fleet) < 16 and time.monotonic() < deadline:
            time.sleep(0.02)
        steps_at_kill = al._env_steps_by_fleet[1]
        kill_instance(launchers[1], 0)
        launchers[1].launch_info.processes[0].wait(timeout=10)
        while al._actor_errors[1] is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert al.stats()["dead_fleets"] == [1]
        relaunched = launch(bases[1])
        pools[1].notify_respawn(0)
        while not pools[1].healthy.all() and time.monotonic() < deadline:
            pools[1].probe(block_ms=100)
        assert pools[1].healthy.all(), "the relaunched producer was not re-admitted"
        while time.monotonic() < deadline and not (
                al._fleet_restarts[1] >= 1 and al._actor_errors[1] is None
                and al._env_steps_by_fleet[1] > steps_at_kill + 8):
            time.sleep(0.05)
        al._stop.set()
        runner.join(timeout=30)
        assert not runner.is_alive()
    finally:
        for pool in pools:
            pool.close()
        for bl in launchers + ([relaunched] if relaunched is not None else []):
            bl.__exit__(None, None, None)
    assert result["fleet_restarts"][1] >= 1
    assert result["dead_fleets"] == []  # the fleet rejoined
    assert result["env_steps_by_fleet"][1] > steps_at_kill + 8
    assert result["fleet_restarts"][0] == 0
