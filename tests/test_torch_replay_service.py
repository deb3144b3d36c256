"""The port's sharded replay service (``blendjax_torch.replay.service``,
``shard_client.py``) against the reference's ``tests/test_replay_service.py``,
on the CPU.

1. **The reference's cases** against the port: the reply cache making a
   retried append exactly-once, errors as replies, crash-exact restore
   (checkpoint plus the unfinalized spill tail) and a torn spill tail, the
   draw stream bit-identical across 1 and 4 shards and an in-process
   ``ReplayBuffer``, a mid-stream save/restore over restarted shards, the
   refusal of a shard behind the checkpoint, quarantine with degraded draws,
   the journal and re-admission, degraded draws on a non-power-of-2
   capacity, a gather failure mid-sample, all shards dead, exactly-once
   through a lossy wire over tcp (``ChaosProxy``) and shm (``ShmChaos``),
   the buffer's diagnosable errors, ``run_offline`` over a sharded replay,
   and the SIGKILL chaos drill (``FleetSupervisor`` over a ``ShardFleet``).
   Not ported: the bench-schema case, which measures the reference's stack
   through ``benchmarks/``.
2. **Across the packages**, all held exactly (``np.array_equal``): the
   port's ``ShardedReplay`` draws the reference's stream, index for index,
   weight for weight and row for row, at 1 and 4 shards; the port's client
   over the reference's shard processes, and the reference's client over
   the port's; and ``run_offline`` over a port ``ShardedReplay`` against
   the reference's over its own (uniform, as ``test_torch_actor_learner``
   holds it: the first loss within 1e-5, later losses and the params within
   1e-4).
3. **Live resharding** (the reference's ``tests/test_autoscale.py`` replay
   cases): 2 -> 3 shards with rows past the checkpoint cut in the moving
   range, draws bit-identical to an unresharded twin; the new shard
   SIGKILLed mid-handoff aborting whole; ``reshard_replay`` end to end and
   its abort on a dead source; and the resharded stream against the
   reference's unresharded ``ShardedReplay`` (indices and rows exactly, IS
   weights within 1e-6).
"""

import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

from blendjax.models.actor_learner import ActorLearner as JActorLearner
from blendjax.replay import ShardedReplay as JShardedReplay
from blendjax.replay.service import start_shard_thread as j_start_shard_thread
from blendjax_torch.btt.faults import FaultPolicy
from blendjax_torch.replay import ReplayBuffer, ShardedReplay
from blendjax_torch.replay.service import ReplayShard, ShardFleet, start_shard_thread
from blendjax_torch.utils.timing import EventCounters
from helpers import REPO_ROOT
from helpers.time_limit import time_limit


def _row(i, d=4):
    """Deterministic transition keyed by its append index."""
    return {
        "obs": np.full(d, i, np.float32),
        "action": np.int32(i % 3),
        "reward": np.float32(i % 7),
        "done": bool(i % 11 == 0),
    }


def _fill(buf, n, start=0):
    for i in range(start, start + n):
        buf.append(_row(i))


def _wait_until(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def _assert_same_draw(a, b):
    (da, ia, wa), (db, ib, wb) = a, b
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(wa, wb)
    assert set(da) == set(db)
    for key in da:
        np.testing.assert_array_equal(da[key], db[key])


@pytest.fixture
def shard4():
    handles = [start_shard_thread(16, shard_id=i) for i in range(4)]
    yield handles
    for h in handles:
        h.close()


# -- the shard server -------------------------------------------------------------


def test_shard_handle_append_retry_is_exactly_once():
    shard = ReplayShard("tcp://127.0.0.1:*", 8, shard_id=0)
    try:
        req = {"cmd": "append", "slots": [0], "rows": [_row(1)], "btmid": "aa"}
        r1 = shard.handle(dict(req))
        r2 = shard.handle(dict(req))  # the retry
        assert r1["seq"] == r2["seq"] == 1
        assert shard.seq == 1
        assert shard.store.read_row(0)["obs"][0] == 1.0
        r3 = shard.handle({"cmd": "append", "slots": [1], "rows": [_row(2)], "btmid": "bb"})
        assert r3["seq"] == 2
    finally:
        shard.close()


def test_shard_handle_errors_are_replies_not_crashes():
    shard = ReplayShard("tcp://127.0.0.1:*", 8, shard_id=0)
    try:
        r = shard.handle({"cmd": "no-such-cmd", "btmid": "x"})
        assert "error" in r and "no-such-cmd" in r["error"]
        assert shard.handle({"cmd": "hello"})["capacity"] == 8
    finally:
        shard.close()


def test_shard_crash_exact_restore(tmp_path):
    a = ReplayShard("tcp://127.0.0.1:*", 32, shard_id=0, data_dir=str(tmp_path),
                    checkpoint_every=8)
    for i in range(20):
        a.handle({"cmd": "append", "slots": [i % 32], "rows": [_row(i)], "btmid": f"m{i}"})
    assert a.seq == 20 and a._last_ckpt_seq == 16
    a._sock.close(0)  # a SIGKILL stand-in: the spill header stays unfinalized
    b = ReplayShard("tcp://127.0.0.1:*", 32, shard_id=0, data_dir=str(tmp_path))
    try:
        assert b.seq == 20
        assert b.restored_from == (16, 4)  # checkpoint seq + spill-tail rows
        for i in range(20):
            np.testing.assert_array_equal(b.store.read_row(i % 32)["obs"], _row(i)["obs"])
    finally:
        b.close()


def test_shard_restore_survives_torn_spill_tail(tmp_path):
    a = ReplayShard("tcp://127.0.0.1:*", 16, shard_id=0, data_dir=str(tmp_path))
    for i in range(6):
        a.handle({"cmd": "append", "slots": [i], "rows": [_row(i)], "btmid": f"m{i}"})
    a._sock.close(0)
    spill = a._spill_paths()[0]
    with open(spill, "r+b") as f:
        f.truncate(os.path.getsize(spill) - 7)  # tear the last record
    b = ReplayShard("tcp://127.0.0.1:*", 16, shard_id=0, data_dir=str(tmp_path))
    try:
        assert b.seq == 5  # the torn 6th record is gone, 5 survive
        assert b.store.read_row(4)["obs"][0] == 4.0
    finally:
        b.close()


# -- the draw stream --------------------------------------------------------------


def _drive_in_lockstep(bufs, rounds=6):
    """Appends past wraparound, draws, priority updates and more appends,
    every draw held equal across ``bufs``."""
    for b in bufs:
        _fill(b, 80)  # wraps the 64-slot ring
    for _ in range(rounds):
        draws = [b.sample(8) for b in bufs]
        for d in draws[1:]:
            _assert_same_draw(draws[0], d)
        prios = np.abs(np.asarray(draws[0][0]["reward"], np.float64) - 3.0)
        for b, (_, idx, _w) in zip(bufs, draws):
            b.update_priorities(idx, prios)
        for b in bufs:
            _fill(b, 4, start=1000)


def test_draw_stream_identical_across_shard_layouts(shard4):
    h1 = start_shard_thread(64, shard_id=0)
    try:
        one = ShardedReplay([h1.address], seed=5)
        four = ShardedReplay([h.address for h in shard4], seed=5)
        _drive_in_lockstep((one, four, ReplayBuffer(64, seed=5)))
        one.close()
        four.close()
    finally:
        h1.close()


def test_stream_continues_across_mid_stream_save_restore(tmp_path):
    handles = [start_shard_thread(32, shard_id=i, data_dir=str(tmp_path)) for i in range(2)]
    try:
        buf = ShardedReplay([h.address for h in handles], seed=9)
        _fill(buf, 50)
        for _ in range(3):
            buf.sample(8)
        ck = str(tmp_path / "client.npz")
        buf.save(ck)
        expected = [buf.sample(8) for _ in range(5)]
        buf.close()
    finally:
        for h in handles:
            h.close()
    # cold restart: fresh shard servers restore from disk, then the client
    handles = [start_shard_thread(32, shard_id=i, data_dir=str(tmp_path)) for i in range(2)]
    try:
        ref = ShardedReplay.restore(ck, [h.address for h in handles])
        for want in expected:
            _assert_same_draw(ref.sample(8), want)
        ref.close()
    finally:
        for h in handles:
            h.close()


def test_restore_refuses_mismatched_shard_state(tmp_path):
    handles = [start_shard_thread(16, shard_id=i, data_dir=str(tmp_path)) for i in range(2)]
    try:
        buf = ShardedReplay([h.address for h in handles], seed=1)
        _fill(buf, 20)
        ck = str(tmp_path / "client.npz")
        buf.save(ck)
        _fill(buf, 5, start=100)  # the shards move past the checkpoint
        with pytest.raises(RuntimeError, match="seq"):
            ShardedReplay.restore(ck, [h.address for h in handles])
        buf.close()
    finally:
        for h in handles:
            h.close()


# -- quarantine, degraded draws, the journal ---------------------------------------


def test_quarantine_degraded_sampling_journal_and_readmission(shard4):
    counters = EventCounters()
    buf = ShardedReplay([h.address for h in shard4], seed=3, counters=counters)
    _fill(buf, 60)
    buf.quarantine_shard(1, reason="test")
    assert list(buf.quarantined) == [False, True, False, False]
    assert counters.get("replay_shard_quarantined") == 1
    lo, hi = 16, 32
    for _ in range(6):
        data, idx, w = buf.sample(8)
        assert not ((idx >= lo) & (idx < hi)).any(), idx
        assert w.max() == pytest.approx(1.0)
    _fill(buf, 40, start=60)  # the head wraps through shard 1's range
    st = buf.stats()["shards"]
    assert st["journal_pending"] > 0
    assert counters.get("replay_shard_journal") == st["journal_pending"]
    assert buf.probe()
    st = buf.stats()["shards"]
    assert st["quarantined"] == [] and st["journal_pending"] == 0
    assert counters.get("replay_shard_readmissions") == 1
    got = buf.get(20)  # slot 20 was overwritten by append 84 (64 + 20)
    np.testing.assert_array_equal(got["obs"], _row(84)["obs"])
    seen = set()
    for _ in range(20):
        _, idx, _ = buf.sample(8)
        seen.update(int(i) for i in idx)
    assert any(lo <= i < hi for i in seen), "re-admitted range never drawn"
    buf.close()


def test_degraded_draws_follow_renormalized_priorities_non_pow2():
    handles = [start_shard_thread(12, shard_id=i) for i in range(3)]
    try:
        buf = ShardedReplay([h.address for h in handles], seed=7)
        assert buf.capacity == 36  # not a power of two
        _fill(buf, 36)
        hot = 30  # shard 2
        buf.update_priorities(np.arange(36), np.full(36, 1e-6))
        buf.tree.set(hot, buf.tree.total * 1e6)
        buf.quarantine_shard(0, reason="test")
        counts = {}
        for _ in range(10):
            _, idx, w = buf.sample(8)
            assert not (idx < 12).any(), idx
            for i in idx:
                counts[int(i)] = counts.get(int(i), 0) + 1
        assert counts.get(hot, 0) >= 0.9 * sum(counts.values()), counts
        buf.close()
    finally:
        for h in handles:
            h.close()


def test_gather_failure_mid_sample_quarantines_and_redraws(shard4):
    policy = FaultPolicy(max_retries=0, circuit_threshold=0, seed=1)
    buf = ShardedReplay([h.address for h in shard4], seed=3, fault_policy=policy,
                        timeoutms=300)
    _fill(buf, 64)
    shard4[2].close()  # stops serving, with no death notification
    data, idx, w = buf.sample(8)  # succeeds degraded
    assert not ((idx >= 32) & (idx < 48)).any()
    assert list(buf.quarantined) == [False, False, True, False]
    assert not buf.probe(block_ms=100)
    buf.close()


def test_all_shards_dead_raises_diagnosable_timeout():
    h = start_shard_thread(16, shard_id=0)
    policy = FaultPolicy(max_retries=0, circuit_threshold=0, seed=1)
    buf = ShardedReplay([h.address], seed=0, fault_policy=policy, timeoutms=200,
                        name="svc-replay")
    _fill(buf, 10)
    h.close()
    with pytest.raises(TimeoutError) as ei:
        buf.sample(4)
    msg = str(ei.value)
    assert "svc-replay" in msg and "shard" in msg and "eligible" in msg
    buf.close()


@pytest.mark.parametrize("transport", ["tcp", "shm"])
def test_exactly_once_through_lossy_wire(shard4, transport):
    """Duplicated and lost append traffic: however many copies reach the
    shard, it applies the append once.  ``tcp`` stalls a ``ChaosProxy``
    relay; ``shm`` duplicates one in-ring request, then drops one whose
    same-id retry rides the demoted ZMQ path."""
    from blendjax_torch.btt.chaos import ChaosProxy
    from blendjax_torch.btt.shm_rpc import ShmChaos, enabled

    policy = FaultPolicy(max_retries=2, backoff_base=0.01, backoff_max=0.05,
                         circuit_threshold=0, seed=2)
    if transport == "shm":
        assert enabled(), "ShmRPC is off on this host (BJX_NO_SHM_RPC?)"
        chaos = ShmChaos()
        buf = ShardedReplay([shard4[0].address], seed=0, fault_policy=policy, timeoutms=300)
        _fill(buf, 4)  # the second RPC upgrades mid-fill
        assert buf.clients[0].transport == "shm"
        buf.clients[0]._channel()._shm.chaos = chaos
        base_seq = buf.stats()["shards"]["acked"][0]
        chaos.dup_next("up")
        buf.append(_row(99))
        assert shard4[0].shard.handle({"cmd": "hello"})["seq"] == base_seq + 1
        chaos.drop_next("up")
        buf.append(_row(100))
        assert buf.clients[0].transport == "tcp"
        assert shard4[0].shard.handle({"cmd": "hello"})["seq"] == base_seq + 2
        assert buf.stats()["shards"]["acked"][0] == base_seq + 2
        assert chaos.duplicated >= 1 and chaos.dropped >= 1
        assert shard4[0].shard.counters.get("replay_shm_bytes") > 0
        buf.close()
        return
    with ChaosProxy(shard4[0].address) as proxy:
        buf = ShardedReplay([proxy.address], seed=0, fault_policy=policy, timeoutms=250,
                            shm=False)
        _fill(buf, 4)
        base_seq = buf.stats()["shards"]["acked"][0]
        proxy.stall()
        done = {}

        def appender():
            buf.append(_row(99))
            done["ok"] = True

        t = threading.Thread(target=appender, daemon=True)
        t.start()
        time.sleep(0.4)  # the first attempt times out, a retry is queued
        proxy.resume()
        t.join(timeout=10)
        assert not t.is_alive() and done.get("ok")
        assert shard4[0].shard.handle({"cmd": "hello"})["seq"] == base_seq + 1
        assert buf.stats()["shards"]["acked"][0] == base_seq + 1
        buf.close()


def test_underfill_and_arena_errors_name_buffer_and_embed_stats():
    from blendjax_torch.btt.arena import ArenaPool

    buf = ReplayBuffer(32, seed=0, name="tiny-replay")
    buf.append(_row(0))
    with pytest.raises(TimeoutError) as ei:
        buf.sample(8, timeout=0.05)
    msg = str(ei.value)
    assert "tiny-replay" in msg and "size=1/32" in msg and "eligible=1" in msg
    _fill(buf, 20)
    pool = ArenaPool(pool_size=1)
    hostage = pool.acquire()
    assert hostage is not None
    gen = buf.sample_batches(4, arena_pool=pool, timeout=0.1)
    with pytest.raises(TimeoutError) as ei:
        next(gen)
    msg = str(ei.value)
    assert "tiny-replay" in msg and "pool size 1" in msg and "appends=21" in msg


def test_run_offline_accepts_sharded_replay(shard4):
    from blendjax_torch.models.actor_learner import ActorLearner

    buf = ShardedReplay([h.address for h in shard4], seed=2)
    rng = np.random.default_rng(0)
    for _ in range(60):
        buf.append({"obs": rng.random(3).astype(np.float32),
                    "action": np.int32(rng.integers(0, 2)),
                    "reward": np.float32(rng.random()), "done": False})
    al = ActorLearner(None, obs_dim=3, num_actions=2, seed=2, replay=buf, device="cpu")
    out = al.run_offline(num_updates=3, batch_size=16)
    assert out["updates"] == 3
    assert all(np.isfinite(v) for v in out["losses"])
    assert out["replay"]["shards"]["count"] == 4
    buf.close()


# -- the chaos drill ----------------------------------------------------------------


@pytest.mark.chaos
def test_kill_one_shard_degraded_then_crash_exact_readmission(tmp_path):
    """SIGKILL 1 of 3 shard processes mid-training: draws continue degraded,
    the supervisor respawns the process, which restores its checkpoint and
    spill tail; re-admission brings the pre-kill rows back bit for bit, the
    draw stream continues from a checkpoint, the killed shard's channel
    re-upgrades to shm, and nothing is left under the fleet's /dev/shm
    prefixes.  Every wait is bounded."""
    from blendjax_torch.btt.chaos import kill_instance
    from blendjax_torch.btt.shm_rpc import enabled as shm_enabled
    from blendjax_torch.btt.shm_rpc import leaked_objects
    from blendjax_torch.btt.supervise import FleetSupervisor

    counters = EventCounters()
    policy = FaultPolicy(max_retries=1, backoff_base=0.02, backoff_max=0.1, deadline_s=1.0,
                         circuit_threshold=0, seed=3)
    with ShardFleet(3, capacity_per_shard=48, data_dir=str(tmp_path / "shards"),
                    checkpoint_every=20) as fleet:
        buf = ShardedReplay(fleet.addresses, seed=5, fault_policy=policy,
                            counters=counters, timeoutms=1000)
        with FleetSupervisor(fleet, pool=None, interval=0.15, counters=counters,
                             replay=buf, heal_interval=0.05) as sup:
            _fill(buf, 120)
            for _ in range(3):
                buf.sample(8)
            lo, hi = 48, 96  # shard 1's global slot range
            expected_rows = {slot: buf.get(slot) for slot in range(lo, hi, 7)}
            kill_instance(fleet, 1)
            assert sup.await_deaths(1, timeout=20)
            for _ in range(5):
                data, idx, w = buf.sample(8)
                assert not ((idx >= lo) & (idx < hi)).any(), idx
            assert counters.get("replay_shard_quarantined") >= 1
            assert buf.stats()["shards"]["quarantined"] == [1]
            h = sup.health()
            assert h["deaths"] >= 1
            assert h["replay"]["shards"]["quarantined"] == [1]
            assert sup.await_healthy(timeout=30), (counters.snapshot(), buf.stats())
            assert counters.get("replay_shard_readmissions") == 1
            assert counters.get("replay_shard_lost") == 0
            for slot, row in expected_rows.items():
                got = buf.get(slot)
                for key in row:
                    np.testing.assert_array_equal(got[key], row[key])
            seen = set()
            for _ in range(20):
                _, idx, _ = buf.sample(8)
                seen.update(int(i) for i in idx)
            assert any(lo <= i < hi for i in seen)
            ck = str(tmp_path / "client.npz")
            buf.save(ck)
            expected = [buf.sample(8) for _ in range(5)]
            ref = ShardedReplay.restore(ck, fleet.addresses, fault_policy=policy,
                                        counters=EventCounters(), timeoutms=1000)
            for want in expected:
                _assert_same_draw(ref.sample(8), want)
            ref.close()
            if shm_enabled():
                deadline = time.monotonic() + 15
                while time.monotonic() < deadline and buf.clients[1].transport != "shm":
                    buf.sample(8)
                    time.sleep(0.05)
                assert buf.clients[1].transport == "shm"
        buf.close()
    for base in fleet.shm_bases:
        if base is not None:
            assert not leaked_objects(base), leaked_objects(base)


# -- across the packages -------------------------------------------------------------


@pytest.mark.parametrize("num_shards", [1, 4])
def test_draw_stream_equals_the_reference_sharded_replay(num_shards):
    cap = 64 // num_shards
    port = [start_shard_thread(cap, shard_id=i) for i in range(num_shards)]
    ref = [j_start_shard_thread(cap, shard_id=i) for i in range(num_shards)]
    try:
        a = ShardedReplay([h.address for h in port], seed=11)
        b = JShardedReplay([h.address for h in ref], seed=11)
        _drive_in_lockstep((a, b, ReplayBuffer(64, seed=11)))
        a.close()
        b.close()
    finally:
        for h in port + ref:
            h.close()


def test_clients_drive_the_other_packages_shards():
    """The port's client over the reference's shards and the reference's
    client over the port's: both draw the in-process buffer's stream, and
    the rows each client wrote read back equal through the other's
    shards."""
    ref_shards = [j_start_shard_thread(16, shard_id=i) for i in range(4)]
    port_shards = [start_shard_thread(16, shard_id=i) for i in range(4)]
    try:
        a = ShardedReplay([h.address for h in ref_shards], seed=4)
        b = JShardedReplay([h.address for h in port_shards], seed=4)
        _drive_in_lockstep((a, b, ReplayBuffer(64, seed=4)))
        for slot in range(0, 64, 5):
            want = a.get(slot)
            got = b.get(slot)
            for key in want:
                np.testing.assert_array_equal(np.asarray(got[key]), want[key])
        assert a.clients[0].transport == "shm" and b.clients[0].transport == "shm"
        a.close()
        b.close()
    finally:
        for h in ref_shards + port_shards:
            h.close()


def test_run_offline_over_sharded_replay_matches_the_reference():
    """Uniform draws over two shards in each package: both learners train
    on the same batches from the same params."""
    from blendjax_torch.models.actor_learner import ActorLearner
    from blendjax_torch.models.convert import params_from_jax, params_to_jax
    from blendjax_torch.models.train import TrainState

    port_shards = [start_shard_thread(256, shard_id=i) for i in range(2)]
    ref_shards = [j_start_shard_thread(256, shard_id=i) for i in range(2)]
    try:
        a = ShardedReplay([h.address for h in port_shards], seed=2, prioritized=False,
                          counters=EventCounters())
        b = JShardedReplay([h.address for h in ref_shards], seed=2, prioritized=False)
        rng = np.random.default_rng(8)
        for _ in range(300):
            tr = {"obs": rng.standard_normal(4).astype(np.float32),
                  "action": np.int32(rng.integers(0, 3)),
                  "reward": np.float32(rng.random()), "done": False}
            for buf in (a, b):
                buf.append(tr)
        ref = JActorLearner(None, obs_dim=4, num_actions=3, seed=4, replay=b)
        port = ActorLearner(None, 4, 3, device="cpu", replay=a)
        port.load_checkpoint_state(
            TrainState.create(params_from_jax(jax.device_get(ref.state.params), device="cpu"),
                              lr=3e-3), {})
        want = ref.run_offline(num_updates=6, batch_size=32)
        got = port.run_offline(num_updates=6, batch_size=32)
        assert got["updates"] == want["updates"] == 6
        assert abs(got["losses"][0] - want["losses"][0]) <= 1e-5
        np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-4, rtol=0)
        for x, y in zip(jax.tree.leaves(params_to_jax(port.state.params)),
                        jax.tree.leaves(jax.device_get(ref.state.params))):
            np.testing.assert_allclose(x, y, atol=1e-4, rtol=0)
        a.close()
        b.close()
    finally:
        for h in port_shards + ref_shards:
            h.close()


def test_shard_serves_a_client_without_torch():
    """A shard and its client run with neither torch nor jax imported (a
    respawned shard process must not pay the torch import)."""
    code = ("import sys\n"
            "import numpy as np\n"
            "from blendjax_torch.replay.service import start_shard_thread\n"
            "from blendjax_torch.replay.shard_client import ShardClient\n"
            "h = start_shard_thread(8)\n"
            "c = ShardClient(h.address, timeoutms=5000)\n"
            "c.rpc('append', {'slots': [0], 'rows': [{'x': np.ones(2, np.float32)}]},\n"
            "      raw_buffers=True)\n"
            "assert c.rpc('hello')['seq'] == 1\n"
            "c.close()\n"
            "h.close()\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# -- live resharding (the reference's tests/test_autoscale.py cases) -------------------


@pytest.mark.chaos
@time_limit(120)
def test_reshard_two_to_three_bit_identical_draws(tmp_path):
    """Grow 2 -> 3 shards with rows appended past the checkpoint cut landing
    in the moving range: the draw stream stays bit-identical to an
    unresharded twin's, moved rows serve byte-equal, and the ownership map
    records the split."""
    counters = EventCounters()
    with ShardFleet(2, capacity_per_shard=24, data_dir=str(tmp_path / "a"),
                    checkpoint_every=1000) as fleet, \
            ShardFleet(2, capacity_per_shard=24, data_dir=str(tmp_path / "b"),
                       checkpoint_every=1000) as twin_fleet:
        buf = ShardedReplay(fleet.addresses, seed=5, counters=counters)
        twin = ShardedReplay(twin_fleet.addresses, seed=5)
        # slots 0..11 before the cut, 12..23 (shard 0's moving upper half)
        # after it: the delta the restored checkpoint cannot hold
        _fill(buf, 12)
        _fill(twin, 12)
        cut = buf.clients[0].rpc("save")
        _fill(buf, 12, start=12)
        _fill(twin, 12, start=12)
        idx, addr = fleet.grow(restore_ckpt=cut["path"])
        shard = buf.adopt_shard(addr, source=0, cut_seq=int(cut["seq"]))
        assert shard == 2 and buf.num_shards == 3
        assert counters.get("autoscale_reshard_handoffs") == 1
        assert counters.get("autoscale_reshard_rows_copied") == 12
        assert counters.get("autoscale_reshard_aborts") == 0
        assert buf.stats()["shards"]["owned_slots"] == [12, 24, 12]
        for slot in range(12, 24):
            got, want = buf.get(slot), twin.get(slot)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
        for _ in range(5):
            _assert_same_draw(buf.sample(8), twin.sample(8))
        _fill(buf, 30, start=24)
        _fill(twin, 30, start=24)
        for _ in range(5):
            _assert_same_draw(buf.sample(8), twin.sample(8))
        buf.close()
        twin.close()


@time_limit(90)
def test_shard_client_carries_one_request_at_a_time(tmp_path):
    """A shard's client used by two threads at once (the buffer's appends,
    and checkpoint cuts as a reshard takes them): every RPC gets its own
    reply, none is dropped as stale, and the shard is never quarantined."""
    counters = EventCounters()
    policy = FaultPolicy(max_retries=1, backoff_base=0.02, backoff_max=0.1, deadline_s=2.0,
                         circuit_threshold=0, seed=3)
    with ShardFleet(1, capacity_per_shard=128, data_dir=str(tmp_path),
                    checkpoint_every=0) as fleet:
        buf = ShardedReplay(fleet.addresses, seed=9, counters=counters, fault_policy=policy,
                            timeoutms=1000)
        for k in range(128):
            buf.append(_row(k, d=16384))
        stop, appended = threading.Event(), []

        def appender():
            k = 128
            while not stop.is_set():
                buf.append(_row(k, d=16384))
                appended.append(k)
                k += 1

        writer = threading.Thread(target=appender)
        writer.start()
        try:
            cuts = []
            for _ in range(30):
                _wait_until(lambda n=len(appended): len(appended) > n)
                cuts.append(buf.clients[0].rpc("save")["seq"])
        finally:
            stop.set()
            writer.join(timeout=60)
        assert cuts == sorted(cuts) and len(set(cuts)) == len(cuts)
        assert counters.get("replay_shard_quarantined") == 0
        assert counters.get("stale_replies") == 0
        assert not buf._pending.any()
        buf.close()


@time_limit(90)
def test_reshard_replay_under_concurrent_appends(tmp_path):
    """``reshard_replay`` while another thread appends: the source's
    checkpoint cut and the appends share the source's channel, so neither
    loses its reply (no quarantine, no journalled row), the handoff lands,
    and the draws equal an unresharded twin's that took the same appends."""
    from blendjax_torch.autoscale import reshard_replay

    counters = EventCounters()
    policy = FaultPolicy(max_retries=1, backoff_base=0.02, backoff_max=0.1, deadline_s=2.0,
                         circuit_threshold=0, seed=3)
    with ShardFleet(2, capacity_per_shard=64, data_dir=str(tmp_path / "a"),
                    checkpoint_every=0) as fleet, \
            ShardFleet(2, capacity_per_shard=64, data_dir=str(tmp_path / "b"),
                       checkpoint_every=0) as twin_fleet:
        buf = ShardedReplay(fleet.addresses, seed=9, counters=counters, fault_policy=policy,
                            timeoutms=1000)
        twin = ShardedReplay(twin_fleet.addresses, seed=9, timeoutms=1000)
        # 64 KiB rows: the source's cut takes long enough for appends to
        # queue behind it
        for k in range(96):
            buf.append(_row(k, d=16384))
            twin.append(_row(k, d=16384))

        stop, appended = threading.Event(), []

        def appender():
            k = 96
            while not stop.is_set():
                buf.append(_row(k, d=16384))
                twin.append(_row(k, d=16384))
                appended.append(k)
                k += 1

        writer = threading.Thread(target=appender)
        writer.start()
        _wait_until(lambda: len(appended) >= 8)
        shard, _ = reshard_replay(buf, fleet, counters=counters)
        stop.set()
        writer.join(timeout=60)
        assert not writer.is_alive()
        assert shard == 2 and buf.num_shards == 3
        assert counters.get("autoscale_reshard_handoffs") == 1
        assert counters.get("autoscale_reshard_aborts") == 0
        assert counters.get("replay_shard_quarantined") == 0
        assert not buf._pending.any()
        for _ in range(8):
            _assert_same_draw(buf.sample(16), twin.sample(16))
        buf.close()
        twin.close()


@pytest.mark.chaos
@pytest.mark.slow  # process-heavy, as the reference's
@time_limit(120)
def test_kill_new_shard_mid_handoff_aborts_whole(tmp_path):
    """SIGKILL the new shard between its restore-spawn and the handoff:
    ``ReshardAborted``, the ownership map untouched, the source serving its
    full range, draws going on, and the half-born process retired."""
    from blendjax_torch.btt.chaos import kill_instance
    from blendjax_torch.replay.shard_client import ReshardAborted

    counters = EventCounters()
    policy = FaultPolicy(max_retries=1, backoff_base=0.02, backoff_max=0.1,
                         deadline_s=1.0, circuit_threshold=0, seed=3)
    with ShardFleet(2, capacity_per_shard=24, data_dir=str(tmp_path / "shards"),
                    checkpoint_every=1000) as fleet:
        buf = ShardedReplay(fleet.addresses, seed=5, fault_policy=policy,
                            counters=counters, timeoutms=1000)
        _fill(buf, 30)
        owned_before = buf.stats()["shards"]["owned_slots"]
        cut = buf.clients[0].rpc("save")
        idx, addr = fleet.grow(restore_ckpt=cut["path"])
        kill_instance(fleet, idx)
        with pytest.raises(ReshardAborted):
            buf.adopt_shard(addr, source=0, cut_seq=int(cut["seq"]), timeoutms=500)
        assert counters.get("autoscale_reshard_aborts") == 1
        assert counters.get("autoscale_reshard_handoffs") == 0
        assert buf.num_shards == 2
        assert buf.stats()["shards"]["owned_slots"] == owned_before
        _, i, _ = buf.sample(8)
        assert len(i) == 8
        for slot in (0, 13, 29):
            np.testing.assert_array_equal(buf.get(slot)["obs"], _row(slot)["obs"])
        assert fleet.retire(idx) is True
        with pytest.raises(RuntimeError, match="retired"):
            fleet.respawn(idx)
        buf.close()


@pytest.mark.chaos
@pytest.mark.slow  # process-heavy, as the reference's
@time_limit(120)
def test_reshard_replay_orchestration_retires_newcomer_on_abort(tmp_path):
    """``reshard_replay`` end to end (save, grow, adopt), then a dead
    source: the handoff fails whole and nothing is spawned or changed."""
    from blendjax_torch.autoscale import reshard_replay
    from blendjax_torch.btt.chaos import kill_instance
    from blendjax_torch.replay.shard_client import ReshardAborted

    counters = EventCounters()
    policy = FaultPolicy(max_retries=0, deadline_s=1.0, circuit_threshold=0, seed=1)
    with ShardFleet(2, capacity_per_shard=24, data_dir=str(tmp_path / "shards"),
                    checkpoint_every=1000) as fleet:
        buf = ShardedReplay(fleet.addresses, seed=7, fault_policy=policy,
                            counters=counters, timeoutms=1000)
        _fill(buf, 40)
        shard, addr = reshard_replay(buf, fleet, counters=counters)
        assert shard == 2 and buf.num_shards == 3
        assert counters.get("autoscale_reshard_handoffs") == 1
        buf.sample(8)
        kill_instance(fleet, 1)
        procs = fleet.launch_info.processes
        n_procs = sum(1 for p in procs if p is not None)
        with pytest.raises(ReshardAborted):
            reshard_replay(buf, fleet, source=1, counters=counters)
        assert counters.get("autoscale_reshard_aborts") >= 1
        assert buf.num_shards == 3
        assert sum(1 for p in procs if p is not None) <= n_procs
        buf.close()


@pytest.mark.parametrize("source", [0, 1])
@time_limit(120)
def test_resharded_draws_equal_the_reference_sharded_replay(tmp_path, source):
    """The port's ``ShardedReplay`` resharded 2 -> 3 by ``reshard_replay``
    under appends draws the reference's unresharded ``ShardedReplay``
    stream: indices and rows exactly, IS weights within 1e-6."""
    from blendjax_torch.autoscale import reshard_replay

    ref = [j_start_shard_thread(32, shard_id=i) for i in range(2)]
    counters = EventCounters()
    try:
        with ShardFleet(2, capacity_per_shard=32, data_dir=str(tmp_path / "shards"),
                        checkpoint_every=1000) as fleet:
            a = ShardedReplay(fleet.addresses, seed=13, counters=counters)
            b = JShardedReplay([h.address for h in ref], seed=13)
            _fill(a, 40)
            _fill(b, 40)
            reshard_replay(a, fleet, source=source, counters=counters)
            assert a.num_shards == 3
            assert counters.get("autoscale_reshard_handoffs") == 1
            for r in range(8):
                (da, ia, wa), (db, ib, wb) = a.sample(8), b.sample(8)
                np.testing.assert_array_equal(ia, ib)
                np.testing.assert_allclose(wa, wb, rtol=0, atol=1e-6)
                for key in db:
                    np.testing.assert_array_equal(da[key], db[key])
                prio = np.linspace(0.5, 2.0, len(ia)) * (r + 1)
                a.update_priorities(ia, prio)
                b.update_priorities(ib, prio)
                _fill(a, 5, start=40 + 5 * r)
                _fill(b, 5, start=40 + 5 * r)
            a.close()
            b.close()
    finally:
        for h in ref:
            h.close()
