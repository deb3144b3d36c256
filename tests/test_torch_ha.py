"""The port's learner failover (``blendjax_torch.ha``) against the
reference's ``tests/test_ha.py``, on the CPU.

- the offline cut is crash-exact: restoring a manifest continues the replay
  draw stream index for index, and the parameters and Adam's state restore
  bit for bit;
- retention and the damaged-cut fallback; the skip while a serialization
  is in flight; the supervisor's postmortem naming the learner;
- a cut written by either package restores in the other, with an equal
  draw stream and equal parameters (through ``convert``'s layouts);
- the sharded cut over live shard services (the reference's
  ``test_checkpointer_sharded_cut_and_reconcile``): equal draws when
  nothing moved, the slots appended past the cut reconciled out; a
  sharded cut written by either package restores in the other; a resume
  republishes under a higher weight version;
- the SIGKILL -> respawn -> resume drill (``chaos``), with the port's echo
  producers (``tests/blender/torch_env.blend.py``) under the fake Blender and
  a ``--device cpu`` child; and the sharded drill: the child over two
  replay shard processes and a weight bus, a subscribed policy server and
  its client seeing strictly increasing versions across the respawn.

- the curriculum rides the cut: a resumed learner's scheduler continues
  mid-interval and the checkpointed assignment is pushed again into the
  producers; a cut of either package's learner restores the other's
  curriculum and assignment.

Not ported: the benchmark cases and the full-stack acceptance (the
benchmarks and ``ServerProcess`` are ROADMAP items 10 and 9).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from blendjax.ha import TrainCheckpointer as JTrainCheckpointer
from blendjax.ha import latest_manifest as j_latest_manifest
from blendjax.ha import restore_replay as j_restore_replay
from blendjax.models.actor_learner import ActorLearner as JActorLearner
from blendjax.replay import ReplayBuffer as JReplayBuffer
from blendjax_torch.ha import TrainCheckpointer, latest_manifest, restore_replay
from blendjax_torch.models import convert
from blendjax_torch.models.actor_learner import ActorLearner
from blendjax_torch.replay import ReplayBuffer
from blendjax_torch.utils.timing import EventCounters
from helpers import BLEND_SCRIPTS, FAKE_BLENDER, REPO_ROOT
from test_torch_env import _free_block

ENV_SCRIPT = f"{BLEND_SCRIPTS}/torch_env.blend.py"


@pytest.fixture
def fake_blender(monkeypatch):
    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)
    monkeypatch.setenv("BLENDJAX_FAKE_BPY", "1")


def _fill(buf, n, obs_dim=4, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        buf.append({
            "obs": rng.standard_normal(obs_dim).astype(np.float32),
            "action": np.int32(rng.integers(0, 3)),
            "reward": np.float32(rng.standard_normal()),
            "next_obs": rng.standard_normal(obs_dim).astype(np.float32),
            "done": np.bool_(False),
        })


def _offline_learner(buf, checkpointer=None, seed=0):
    return ActorLearner(None, 4, 3, replay=buf, seed=seed, checkpointer=checkpointer,
                        device="cpu")


def _adam_equal(a, b):
    for p, q in zip(a.state.params.values(), b.state.params.values()):
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a.state.optimizer.state[p][key],
                               b.state.optimizer.state[q][key]), key


# -- the TrainCheckpointer ----------------------------------------------------------


def test_checkpointer_offline_cut_is_crash_exact(tmp_path):
    counters = EventCounters()
    buf = ReplayBuffer(256, seed=0)
    _fill(buf, 128)
    ck = TrainCheckpointer(str(tmp_path), every_updates=2, counters=counters)
    al = _offline_learner(buf, ck)
    al.run_offline(num_updates=5, batch_size=32)
    ck.join()
    assert counters.get("ha_ckpt_saves") >= 1
    assert ck.checkpoint(al, block=True) == 5
    man = latest_manifest(str(tmp_path))
    assert man["update"] == 5 and man["replay_kind"] == "local"
    assert man["aux"] == {"updates": 5, "seed": 0, "last_published_version": None}
    with np.load(tmp_path / man["train"]) as data:
        assert len(data.files) == 3 * len(al.state.params) + 2

    seq_no_crash = [buf.sample(16)[1].tolist() for _ in range(4)]
    buf2 = restore_replay(man, counters=EventCounters())
    ck2 = TrainCheckpointer(str(tmp_path), counters=EventCounters())
    al2 = _offline_learner(buf2)
    ck2.restore(al2, man, republish=False)
    assert al2._updates_done == 5 and al2.state.step == 5
    assert [buf2.sample(16)[1].tolist() for _ in range(4)] == seq_no_crash
    _adam_equal(al, al2)
    assert ck2.counters.get("ha_restores") == 1
    assert {"ha_snapshot", "ha_serialize"} <= set(ck.timer.summary())
    assert "ha_restore" in ck2.timer.summary()
    # the actors' snapshot was rebuilt from the restored parameters
    snap, _ = al2._actor_params
    assert all(torch.equal(snap[k], v) for k, v in al2.state.params.items())


def test_checkpointer_retention_and_damaged_fallback(tmp_path):
    counters = EventCounters()
    buf = ReplayBuffer(64, seed=0)
    _fill(buf, 32)
    ck = TrainCheckpointer(str(tmp_path), max_to_keep=2, counters=counters)
    al = _offline_learner(buf, ck)
    for _ in range(4):
        al.run_offline(num_updates=1, batch_size=16)
        ck.checkpoint(al, block=True)
    manifests = sorted(p for p in os.listdir(tmp_path) if p.startswith("manifest_"))
    assert len(manifests) == 2
    assert counters.get("ha_ckpt_evicted") == 2
    man = latest_manifest(str(tmp_path))
    assert man["update"] == 4
    assert len(ck.train_mgr.all_steps()) <= 2
    replays = sorted(p for p in os.listdir(tmp_path) if p.startswith("replay_"))
    assert replays == ["replay_00000003.npz", "replay_00000004.npz"]

    with open(os.path.join(tmp_path, man["train"]), "r+b") as f:
        f.truncate(12)
    ctr2 = EventCounters()
    man2 = latest_manifest(str(tmp_path), counters=ctr2)
    assert man2["update"] == 3
    assert ctr2.get("ha_restore_fallbacks") == 1


def test_checkpointer_skips_while_serialize_inflight(tmp_path):
    counters = EventCounters()
    buf = ReplayBuffer(64, seed=0)
    _fill(buf, 32)
    ck = TrainCheckpointer(str(tmp_path), every_updates=1, counters=counters)
    al = _offline_learner(buf, ck)
    al.run_offline(num_updates=1, batch_size=16)
    ck.join()

    release = threading.Event()
    real = ck._serialize

    def slow_serialize(*args, **kwargs):
        release.wait(10)
        return real(*args, **kwargs)

    ck._serialize = slow_serialize
    al._updates_done += 1
    assert ck.maybe_checkpoint(al) == al._updates_done  # starts async
    al._updates_done += 1
    assert ck.maybe_checkpoint(al) is None  # skipped
    assert counters.get("ha_ckpt_skipped") == 1
    assert ck.stats()["serialize_inflight"]
    release.set()
    ck.join(timeout=10)
    assert counters.get("ha_ckpt_failures") == 0
    assert not ck.stats()["serialize_inflight"]


def test_load_checkpoint_state_writes_another_state_in_place():
    """A TrainState that is not the learner's own is copied into the
    learner's tensors (the captured steps' addresses stay); the counter,
    the seed and the bus version come from the aux dict."""
    buf = ReplayBuffer(64, seed=0)
    _fill(buf, 32)
    src = _offline_learner(buf, seed=0)
    src.run_offline(num_updates=3, batch_size=16)
    dst = _offline_learner(ReplayBuffer(64, seed=0), seed=4)
    ptrs = {k: v.data_ptr() for k, v in dst.state.params.items()}
    dst.load_checkpoint_state(src.state, {"updates": 3, "seed": 0,
                                          "last_published_version": 7})
    assert {k: v.data_ptr() for k, v in dst.state.params.items()} == ptrs
    _adam_equal(src, dst)
    assert (dst._updates_done, dst._seed, dst.last_published_version) == (3, 0, 7)
    assert dst.checkpoint_state() == {"updates": 3, "seed": 0, "last_published_version": 7}


def test_the_barrier_failing_is_counted_and_training_goes_on(tmp_path):
    counters = EventCounters()
    buf = ReplayBuffer(64, seed=0)
    _fill(buf, 32)
    ck = TrainCheckpointer(str(tmp_path), every_updates=1, counters=counters)
    al = _offline_learner(buf, ck)
    al.state.optimizer = torch.optim.SGD(list(al.state.params.values()), lr=0.1)
    assert ck.checkpoint(al) is None
    assert counters.get("ha_ckpt_failures") == 1 and latest_manifest(str(tmp_path)) is None


def test_a_stop_request_ends_a_single_fleet_run_at_once():
    """The supervised learner's SIGTERM sets the run's stop event: with no
    segment queued the run returns at once, not at its deadline."""
    release = threading.Event()

    class StalledPool:
        num_envs = 1

        def reset(self):
            return np.zeros((1, 1), np.float32), {}

        def step(self, actions):
            release.wait(30)
            return np.zeros((1, 1), np.float32), [0.0], [False], [{}]

    def term():  # the child's SIGTERM handler, then the env answers
        al._stop.set()
        release.set()

    al = ActorLearner(StalledPool(), 1, 2, rollout_len=4, device="cpu")
    threading.Timer(0.5, term).start()
    t0 = time.monotonic()
    try:
        st = al.run(num_updates=5, seconds=30)
    finally:
        release.set()
    assert time.monotonic() - t0 < 5 and st["updates"] == 0


def _curriculum_mid_interval(cls):
    cur = cls(["lite", "rich"], interval=4, counters=EventCounters())
    cur.pin({"lite": 0.7, "rich": 0.3})
    cur.update()
    cur.observe_return("rich", 1.5)
    for _ in range(3):
        cur.tick()  # mid-interval: the gate state must survive too
    return cur


def test_checkpoint_state_carries_curriculum(tmp_path):
    """The cut includes the curriculum: a restored learner's scheduler
    continues mid-interval with the pinned mix, tick counters and return
    EMAs, never restarted at the uniform mix; a foreign catalog's cut is
    refused."""
    from blendjax_torch.scenario import CurriculumScheduler

    buf = ReplayBuffer(64, seed=0)
    _fill(buf, 32)
    cur = _curriculum_mid_interval(CurriculumScheduler)
    al = ActorLearner(None, 4, 3, replay=buf, curriculum=cur, seed=0, device="cpu")
    al._updates_done = 9
    aux = al.checkpoint_state()
    json.dumps(aux)  # rides inline in the manifest

    cur2 = CurriculumScheduler(["lite", "rich"], interval=4, counters=EventCounters())
    al2 = ActorLearner(None, 4, 3, replay=buf, curriculum=cur2, seed=0, device="cpu")
    al2.load_checkpoint_state(al.state, aux)
    assert al2._updates_done == 9
    assert cur2.policy == "pinned"
    assert cur2.mix() == cur.mix()
    assert cur2.stats()["returns_ema"] == cur.stats()["returns_ema"]
    assert cur2._ticks == cur._ticks
    assert cur2.tick() is not None and cur.tick() is not None  # due on the same tick
    with pytest.raises(ValueError, match="same catalog"):
        CurriculumScheduler(["other"]).load_state_dict(aux["curriculum"])


@pytest.mark.parametrize("direction", ["torch->jax", "jax->torch"])
def test_resumed_learner_restores_curriculum_and_repushes_assignment(tmp_path, direction):
    """A cut written by either package's checkpointer over a learner with a
    curriculum and a randomizer restores into the other package's learner:
    the curriculum's state equal, and the checkpointed assignment pushed
    again into the producers (counted, and received)."""
    from blendjax.btb.duplex import DuplexChannel as ProducerDuplex
    from blendjax.scenario import CurriculumScheduler as JCurriculumScheduler
    from blendjax.scenario import DomainRandomizer as JDomainRandomizer
    from blendjax.scenario import ScenarioCatalog as JScenarioCatalog
    from blendjax.scenario import ScenarioSpec as JScenarioSpec
    from blendjax_torch.scenario import (CurriculumScheduler, DomainRandomizer,
                                         ScenarioCatalog, ScenarioSpec)

    addrs = [f"tcp://127.0.0.1:{_free_block(1)}" for _ in range(3)]
    prods = [ProducerDuplex(a, btid=i) for i, a in enumerate(addrs)]
    port_side = dict(al=lambda **kw: ActorLearner(None, 4, 3, device="cpu", **kw),
                     ck=TrainCheckpointer, cur=CurriculumScheduler, rnd=DomainRandomizer,
                     cat=ScenarioCatalog([ScenarioSpec("lite"), ScenarioSpec("rich")]),
                     buf=ReplayBuffer)
    ref_side = dict(al=lambda **kw: JActorLearner(None, 4, 3, **kw), ck=JTrainCheckpointer,
                    cur=JCurriculumScheduler, rnd=JDomainRandomizer,
                    cat=JScenarioCatalog([JScenarioSpec("lite"), JScenarioSpec("rich")]),
                    buf=JReplayBuffer)
    src, dst = (port_side, ref_side) if direction == "torch->jax" else (ref_side, port_side)
    rnds = []
    try:
        buf = src["buf"](128, seed=0)
        _fill(buf, 64)
        cur = _curriculum_mid_interval(src["cur"])
        # the source's fleets were assigned by its randomizer; no producer
        # is dialled on that side
        rnd = src["rnd"](src["cat"], [[a] for a in addrs], counters=EventCounters())
        rnd._assigned = ["rich", "lite", "rich"]
        rnds.append(rnd)
        ck = src["ck"](str(tmp_path), every_updates=100, counters=EventCounters())
        al = src["al"](replay=buf, seed=0, checkpointer=ck, curriculum=cur, scenarios=rnd)
        al.run_offline(num_updates=3, batch_size=16)
        assert ck.checkpoint(al, block=True) == 3

        counters = EventCounters()
        cur2 = dst["cur"](["lite", "rich"], interval=4, counters=EventCounters())
        rnd2 = dst["rnd"](dst["cat"], [[a] for a in addrs], counters=counters)
        rnds.append(rnd2)
        man = (latest_manifest if dst is port_side else j_latest_manifest)(str(tmp_path))
        buf2 = (restore_replay if dst is port_side else j_restore_replay)(
            man, counters=EventCounters())
        al2 = dst["al"](replay=buf2, seed=0, curriculum=cur2, scenarios=rnd2)
        kw = {} if dst is port_side else {"republish": False}
        dst["ck"](str(tmp_path), counters=EventCounters()).restore(al2, man, **kw)
        assert al2._updates_done == 3
        assert cur2.state_dict() == cur.state_dict()
        assert rnd2.assignments == ["rich", "lite", "rich"]
        assert counters.get("scenario_pushes") == 3  # re-pushed, every fleet
        got = [p.recv(timeoutms=5000) for p in prods]
        assert [m["scenario"] for m in got] == ["rich", "lite", "rich"]
    finally:
        for r in rnds:
            r.close()
        for p in prods:
            p.close()


def test_learner_supervisor_postmortem_names_learner(tmp_path):
    from blendjax_torch.ha import LearnerSupervisor
    from blendjax_torch.utils.timing import HA_EVENTS

    stats = {"pid": 4242, "updates": 17, "last_ckpt_update": 16}
    fake = types.SimpleNamespace(ckpt_dir=str(tmp_path), read_stats=lambda: dict(stats),
                                 launch_info=None)
    counters = EventCounters()
    sup = LearnerSupervisor(fake, counters=counters, postmortem_dir=str(tmp_path))
    sup._on_death(0, -9)
    assert counters.get("ha_learner_deaths") == 1
    assert sup.last_postmortem is not None
    doc = json.loads(open(sup.last_postmortem).read())
    assert doc["format"] == "blendjax.postmortem/1"
    assert doc["extra"]["target"] == "learner"
    assert doc["extra"]["exit_code"] == -9
    assert doc["extra"]["stats"]["updates"] == 17
    assert any(e["event"] == "learner_death" and e["target"] == "learner"
               for e in doc["events"])
    h = sup.health()
    for name in HA_EVENTS:
        assert name in h
    assert h["ha_learner_deaths"] == 1
    assert h["learner_stats"]["last_ckpt_update"] == 16


# -- across packages ----------------------------------------------------------------


def _port_leaves(al):
    return convert.train_state_arrays(al.state)


def test_reference_cut_restores_in_the_port(tmp_path):
    jbuf = JReplayBuffer(256, seed=0)
    _fill(jbuf, 128)
    jck = JTrainCheckpointer(str(tmp_path), every_updates=100, counters=EventCounters())
    jal = JActorLearner(None, 4, 3, replay=jbuf, seed=0, checkpointer=jck)
    jal.run_offline(num_updates=5, batch_size=32)
    assert jck.checkpoint(jal, block=True) == 5
    seq_no_crash = [jbuf.sample(16)[1].tolist() for _ in range(4)]

    man = latest_manifest(str(tmp_path))
    assert man["update"] == 5 and man["replay_kind"] == "local"
    buf = restore_replay(man, counters=EventCounters())
    al = _offline_learner(buf, seed=3)
    TrainCheckpointer(str(tmp_path), counters=EventCounters()).restore(al, man)
    assert al._updates_done == 5 and al._seed == 0
    assert [buf.sample(16)[1].tolist() for _ in range(4)] == seq_no_crash
    ref = [np.asarray(x) for x in jax.tree.leaves(jal.state)]
    got = _port_leaves(al)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_port_cut_restores_in_the_reference(tmp_path):
    buf = ReplayBuffer(256, seed=0)
    _fill(buf, 128)
    ck = TrainCheckpointer(str(tmp_path), every_updates=100, counters=EventCounters())
    al = _offline_learner(buf, ck)
    al.run_offline(num_updates=5, batch_size=32)
    assert ck.checkpoint(al, block=True) == 5
    seq_no_crash = [buf.sample(16)[1].tolist() for _ in range(4)]

    man = j_latest_manifest(str(tmp_path))
    jbuf = j_restore_replay(man, counters=EventCounters())
    jal = JActorLearner(None, 4, 3, replay=jbuf, seed=3)
    JTrainCheckpointer(str(tmp_path), counters=EventCounters()).restore(jal, man,
                                                                        republish=False)
    assert jal._updates_done == 5 and jal._seed == 0
    assert [jbuf.sample(16)[1].tolist() for _ in range(4)] == seq_no_crash
    for a, b in zip(jax.tree.leaves(jal.state), _port_leaves(al)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_replay_file_crosses_packages_both_ways(tmp_path):
    """A buffer saved by either package restores in the other and draws the
    saved buffer's stream; the scenario stamps and names round-trip."""
    for saver, loader in ((ReplayBuffer, JReplayBuffer), (JReplayBuffer, ReplayBuffer)):
        src = saver(32, seed=9)
        for k in range(40):
            src.append({"obs": np.full(3, k, np.float32), "reward": np.float32(k)},
                       healthy=k % 6 != 2, scenario="a" if k % 2 else "b")
        src.sample(8)
        src.update_priorities([0, 4], [3.0, 7.0])
        path = str(tmp_path / f"{saver.__module__}.npz")
        src.save(path)
        dst = loader.restore(path)
        assert dst._scenario_names == src._scenario_names
        np.testing.assert_array_equal(dst._scenario, src._scenario)
        for _ in range(5):
            da, ia, wa = src.sample(8)
            db, ib, wb = dst.sample(8)
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(wa, wb)
            np.testing.assert_array_equal(da["obs"], db["obs"])


def test_sharded_cut_and_control_plane_flags_name_item_9(tmp_path):
    """The control plane's half that ROADMAP item 9 named is ported: a
    sharded cut asks for the shard endpoints instead of refusing, and the
    learner child and ``LearnerProcess`` take the shard, bus and probe
    flags."""
    from blendjax_torch.ha import LearnerProcess
    from blendjax_torch.ha.learner import build_parser

    man = {"replay": "replay_00000001.npz", "replay_kind": "sharded",
           "_directory": str(tmp_path)}
    with pytest.raises(ValueError, match="shard endpoints"):
        restore_replay(man)
    lp = LearnerProcess(ckpt_dir=str(tmp_path), env_addresses=["tcp://127.0.0.1:1"],
                        replay_shards=["tcp://127.0.0.1:2", "tcp://127.0.0.1:3"],
                        shard_capacity=64, weight_bus="tcp://127.0.0.1:4", publish_every=3,
                        probe_batch=8, device="cpu")
    args = build_parser().parse_args(lp._cmd[3:])
    assert args.replay_shards == "tcp://127.0.0.1:2,tcp://127.0.0.1:3"
    assert (args.shard_capacity, args.weight_bus, args.publish_every, args.probe_batch) == (
        64, "tcp://127.0.0.1:4", 3, 8)


def test_checkpointer_sharded_cut_and_reconcile(tmp_path):
    """The cut over live shard services: the draws of a restore equal the
    no-crash draws when nothing moved past the cut, and the slots a dead
    incarnation appended past the cut leave the restored draw domain
    (``replay_shard_lost``) until the resumed actors rewrite them."""
    from blendjax_torch.replay.service import start_shard_thread
    from blendjax_torch.replay.shard_client import ShardedReplay

    shards = [start_shard_thread(64, shard_id=i, data_dir=str(tmp_path / f"s{i}"))
              for i in range(2)]
    try:
        addrs = [h.address for h in shards]
        buf = ShardedReplay(addrs, seed=3, counters=EventCounters())
        _fill(buf, 140, seed=7)  # a full ring and wraparound
        for _ in range(3):
            buf.sample(8)
        ck = TrainCheckpointer(str(tmp_path / "ck"), counters=EventCounters())
        ck.checkpoint(_offline_learner(buf), block=True)
        man = latest_manifest(str(tmp_path / "ck"))
        assert man["replay_kind"] == "sharded"

        seq_no_crash = [buf.sample(8)[1].tolist() for _ in range(4)]
        buf_a = restore_replay(man, addrs, counters=EventCounters())
        assert [buf_a.sample(8)[1].tolist() for _ in range(4)] == seq_no_crash
        assert buf_a.counters.get("replay_shard_lost") == 0

        head_at_cut = buf._head
        _fill(buf, 10, seed=11)  # the doomed incarnation appends past the cut
        rolled = {(head_at_cut + k) % buf.capacity for k in range(10)}
        ctr_b = EventCounters()
        buf_b = restore_replay(man, addrs, counters=ctr_b)
        assert ctr_b.get("replay_shard_lost") == len(rolled)
        for _ in range(6):
            _, idx, _ = buf_b.sample(8)
            assert not (set(idx.tolist()) & rolled), "drew a slot whose row was rolled back"
        _fill(buf_b, 10, seed=12)
        buf_b.sample(32)
        for b in (buf, buf_a, buf_b):
            b.close()
    finally:
        for h in shards:
            h.close()


def test_sharded_cut_crosses_packages(tmp_path):
    """A sharded cut the reference wrote over the port's shards restores in
    the port, and the port's over the reference's shards restores in the
    reference: the draws continue equal, index for index."""
    from blendjax.replay.service import start_shard_thread as j_start_shard_thread
    from blendjax.replay.shard_client import ShardedReplay as JShardedReplay
    from blendjax_torch.replay.service import start_shard_thread
    from blendjax_torch.replay.shard_client import ShardedReplay

    for writer, reader, start in ((JShardedReplay, ShardedReplay, start_shard_thread),
                                  (ShardedReplay, JShardedReplay, j_start_shard_thread)):
        shards = [start(32, shard_id=i) for i in range(2)]
        try:
            addrs = [h.address for h in shards]
            buf = writer(addrs, seed=5)
            _fill(buf, 80, seed=2)
            buf.sample(8)
            path = str(tmp_path / f"{writer.__module__}.npz")
            buf.save(path)
            want = [buf.sample(8)[1].tolist() for _ in range(4)]
            other = reader.restore(path, addrs)
            assert [other.sample(8)[1].tolist() for _ in range(4)] == want
            buf.close()
            other.close()
        finally:
            for h in shards:
                h.close()


def test_resume_republishes_under_a_higher_version(tmp_path):
    """``restore(republish=True)`` with a weight bus publishes the restored
    params (the reference's layout) under a version above every one the
    dead learner published, counted ``ha_resume_publishes``."""
    from blendjax_torch.weights import WeightPublisher, WeightSubscriber

    buf = ReplayBuffer(256, seed=0)
    _fill(buf, 128)
    ck = TrainCheckpointer(str(tmp_path), counters=EventCounters())
    with WeightPublisher(version_base=10).start() as pub:
        al = ActorLearner(None, 4, 3, replay=buf, device="cpu", weight_bus=pub,
                          checkpointer=ck)
        al.run_offline(num_updates=3, batch_size=32)
        ck.checkpoint(al, block=True)
        dead_version = pub.version
        assert al.last_published_version == dead_version == 13
    man = latest_manifest(str(tmp_path))
    assert man["aux"]["last_published_version"] == 13
    counters = EventCounters()
    with WeightPublisher(version_base=100).start() as pub:
        sub = WeightSubscriber(pub.address)
        try:
            al2 = ActorLearner(None, 4, 3, replay=restore_replay(man), device="cpu",
                               weight_bus=pub)
            TrainCheckpointer(str(tmp_path), counters=counters).restore(al2, man)
            assert al2.last_published_version == 101 > dead_version
            assert counters.get("ha_resume_publishes") == 1
            deadline = time.monotonic() + 10
            snap = None
            while snap is None and time.monotonic() < deadline:
                snap = sub.poll()
                time.sleep(0.02)
            assert snap is not None and snap.version == 101
            for a, b in zip(jax.tree.leaves(snap.tree()),
                            jax.tree.leaves(convert.params_to_jax(al.state.params))):
                np.testing.assert_array_equal(a, b)
        finally:
            sub.close()


def test_learner_without_producers_exits_2(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "blendjax_torch.ha.learner", "--ckpt-dir",
         str(tmp_path / "ck"), "--device", "cpu"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=60)
    assert out.returncode == 2 and "--envs" in out.stderr, out.stderr


def test_learner_command_line_parses_negative_action_values(tmp_path):
    from blendjax_torch.ha import LearnerProcess
    from blendjax_torch.ha.learner import build_parser

    lp = LearnerProcess(ckpt_dir=str(tmp_path), env_addresses=["tcp://127.0.0.1:1"],
                        action_values=[-20.0, 20.0], device="cpu")
    args = build_parser().parse_args(lp._cmd[3:])
    assert args.action_values == "-20.0,20.0" and args.device == "cpu"
    assert args.envs == "tcp://127.0.0.1:1"


def test_ha_imports_lazily_without_torch():
    code = ("import json, sys\n"
            "import blendjax_torch.ha, blendjax_torch.btt.watchdog\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] == 'torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# -- chaos: supervised kill -> respawn -> resume --------------------------------------


def _await_stats(lp, cond, timeout, what):
    deadline = time.monotonic() + timeout
    while True:
        s = lp.read_stats() or {}
        if cond(s):
            return s
        if time.monotonic() >= deadline:
            raise AssertionError(f"timed out waiting for {what}: {s}")
        time.sleep(0.1)


@pytest.mark.chaos
def test_supervised_learner_kill_respawn_resume(fake_blender, tmp_path):
    """SIGKILL the supervised learner mid-training on a live fleet of the
    port's echo producers -> watchdog respawn -> the child resumes from the
    latest complete manifest (the update counter continues from the cut),
    with the death postmortem written."""
    from blendjax_torch.btt.launcher import BlenderLauncher
    from blendjax_torch.ha import LearnerProcess, LearnerSupervisor

    counters = EventCounters()
    with BlenderLauncher(scene="", script=ENV_SCRIPT, num_instances=2, named_sockets=["GYM"],
                         background=True, start_port=_free_block(2),
                         instance_args=[["--horizon", "1000000"]] * 2) as bl:
        with LearnerProcess(ckpt_dir=str(tmp_path / "ck"),
                            env_addresses=bl.launch_info.addresses["GYM"], obs_dim=1,
                            num_actions=2, rollout_len=8, seed=1, ckpt_every=2,
                            chunk_updates=2, action_values=[0.0, 1.0], device="cpu") as lp:
            with LearnerSupervisor(lp, interval=0.3, counters=counters,
                                   postmortem_dir=str(tmp_path / "pm")) as sup:
                pre = _await_stats(lp, lambda s: s.get("updates", 0) >= 3
                                   and s.get("last_ckpt_update", 0) >= 2,
                                   90, "warm-up and the first checkpoint")
                os.kill(lp.launch_info.processes[0].pid, signal.SIGKILL)
                assert sup.await_deaths(1, 30)
                assert sup.await_respawns(1, 30)
                # past the resume point too: a cut taken after ``pre`` was
                # read resumes the child beyond ``pre["updates"]`` already
                post = _await_stats(lp, lambda s: s.get("pid") not in (None, pre["pid"])
                                    and s.get("updates", 0)
                                    > max(pre["updates"], s.get("resumed_from") or 0),
                                    120, "post-respawn progress")
    assert post["resumed_from"] >= pre["last_ckpt_update"] >= 2
    assert post["updates"] > pre["updates"]
    assert set(post["boot"]) >= {"import_s", "device_init_s", "restore_s", "ready_ts"}
    assert post["first_update_ts"] >= post["boot"]["ready_ts"]
    assert counters.get("ha_learner_deaths") == 1
    assert counters.get("ha_learner_respawns") == 1
    doc = json.loads(open(sup.last_postmortem).read())
    assert doc["extra"]["target"] == "learner"
    assert doc["extra"]["stats"]["updates"] >= pre["updates"]


@pytest.mark.chaos
def test_supervised_sharded_learner_kill_respawn_resume(fake_blender, tmp_path):
    """SIGKILL the supervised learner over two replay shard processes and a
    weight bus, with a policy server subscribed and a client stepping: the
    respawned child reconciles the sharded cut, records the probe digest of
    its first draw, and republishes; the client sees strictly increasing
    weight versions across the respawn and no error.  Every wait is
    bounded."""
    from blendjax_torch.btt.launcher import BlenderLauncher
    from blendjax_torch.ha import LearnerProcess, LearnerSupervisor
    from blendjax_torch.models import policy as tpol
    from blendjax_torch.replay.service import ShardFleet
    from blendjax_torch.replay.shard_client import free_port
    from blendjax_torch.serve import PolicyModel, ServeClient, start_server_thread
    from blendjax_torch.weights import WeightSubscriber

    counters = EventCounters()
    bus = f"tcp://127.0.0.1:{free_port()}"
    observed, errors = [], []
    stop = threading.Event()

    def client_loop(address):
        c = ServeClient(address, timeoutms=10000)
        try:
            c.reset()
            while not stop.is_set():
                v = c.step(np.zeros(1, np.float32)).get("weight_version")
                if v is not None and (not observed or observed[-1] != v):
                    observed.append(v)
                time.sleep(0.005)
        except Exception as exc:  # noqa: BLE001 - the assertion's subject
            errors.append(f"{type(exc).__name__}: {exc}")
        finally:
            c.close()

    params = tpol.init(torch.Generator().manual_seed(5), 1, 2, device="cpu")
    with ShardFleet(2, capacity_per_shard=128, data_dir=str(tmp_path / "shards")) as fleet, \
            BlenderLauncher(scene="", script=ENV_SCRIPT, num_instances=2, named_sockets=["GYM"],
                            background=True, start_port=_free_block(2),
                            instance_args=[["--horizon", "1000000"]] * 2) as bl, \
            start_server_thread(PolicyModel(params, 1), subscriber=WeightSubscriber(bus)) as srv:
        t = threading.Thread(target=client_loop, args=(srv.address,), daemon=True)
        t.start()
        try:
            with LearnerProcess(ckpt_dir=str(tmp_path / "ck"),
                                env_addresses=bl.launch_info.addresses["GYM"],
                                replay_shards=fleet.addresses, shard_capacity=128,
                                weight_bus=bus, publish_every=1, obs_dim=1, num_actions=2,
                                rollout_len=8, seed=1, ckpt_every=2, chunk_updates=2,
                                action_values=[0.0, 1.0], probe_batch=8, device="cpu") as lp:
                with LearnerSupervisor(lp, interval=0.3, counters=counters,
                                       postmortem_dir=str(tmp_path / "pm")) as sup:
                    pre = _await_stats(lp, lambda s: s.get("updates", 0) >= 4
                                       and s.get("last_ckpt_update", 0) >= 2,
                                       90, "warm-up and the first checkpoint")
                    deadline = time.monotonic() + 30
                    while not observed and time.monotonic() < deadline:
                        time.sleep(0.05)
                    assert observed, "the server never adopted a version before the kill"
                    os.kill(lp.launch_info.processes[0].pid, signal.SIGKILL)
                    assert sup.await_deaths(1, 30)
                    assert sup.await_respawns(1, 30)
                    post = _await_stats(lp, lambda s: s.get("pid") not in (None, pre["pid"])
                                        and s.get("updates", 0) > pre["updates"]
                                        and "probe_digest" in s,
                                        120, "post-respawn progress")
                    deadline = time.monotonic() + 30
                    while (observed[-1] <= pre["last_published_version"]
                           and time.monotonic() < deadline):
                        time.sleep(0.05)
        finally:
            stop.set()
            t.join(timeout=20)
    assert not t.is_alive()
    assert errors == []
    assert post["resumed_from"] >= pre["last_ckpt_update"] >= 2
    assert len(post["probe_digest"]) == 16, post["probe_digest"]  # drew a full batch
    assert observed == sorted(set(observed)), observed  # strictly increasing
    assert observed[-1] > pre["last_published_version"]
    assert counters.get("ha_learner_deaths") == 1 and counters.get("ha_learner_respawns") == 1
