"""The port's experience replay (``blendjax_torch.replay``) against the
reference's (``blendjax.replay``), on the CPU.

1. **The reference's cases** — ``tests/test_replay.py`` re-run against the
   port: the sum tree, the ``ColumnStore`` schema, drift and
   ``gather(out=, keys=)``, wraparound and counts, unhealthy rows stored
   but never sampled (the in-band flag included), same seed same stream,
   the sample wait and timeout, concurrent append and sample with no torn
   rows, ``update_priorities`` skipping dead and overwritten slots,
   ``sample_batches`` through an ``ArenaPool`` and the port's
   ``device_prefetch`` (``device="cpu"``), and the ``.btr`` prefill,
   bit-identical to direct appends (also from a live pool of the port's
   echo producers), and the save/restore cases: the continued draw stream
   across a save and restore, foreign files refused, and a file saved by
   either package restored by the other.  Not ported: the supervisor's
   health case and the replay benchmark's (item 9 and the benchmarks).
2. **Differential** — the same seeded appends into both packages' buffers
   (healthy and unhealthy rows, past wraparound), then 50 rounds of
   ``sample`` and ``update_priorities`` with appends between them: every
   round's indices, IS weights, gathered arrays and ``tree.total`` are
   equal (``np.array_equal``), prioritized and uniform.
"""

import threading
import time

import numpy as np
import pytest
import torch

from blendjax.btt.file import FileRecorder as JFileRecorder
from blendjax.replay import ReplayBuffer as JReplayBuffer
from blendjax.replay import transition_to_message as j_transition_to_message
from blendjax_torch.btt.arena import ArenaBatch, ArenaPool
from blendjax_torch.btt.envpool import launch_env_pool
from blendjax_torch.btt.file import FileRecorder
from blendjax_torch.btt.prefetch import device_prefetch
from blendjax_torch.replay import (
    HEALTHY_KEY,
    ColumnStore,
    ReplayBuffer,
    SumTree,
    message_to_transition,
    prefill_from_btr,
    transition_to_message,
)
from blendjax_torch.utils.timing import EventCounters
from helpers import BLEND_SCRIPTS, FAKE_BLENDER
from test_torch_env import _free_block

ENV_SCRIPT = f"{BLEND_SCRIPTS}/torch_env.blend.py"


def _tr(k, obs_dim=4):
    """Deterministic transition whose every field encodes ``k`` — a
    sampled row with disagreeing fields is a torn row."""
    return {
        "obs": np.full((obs_dim,), k, np.float32),
        "action": np.int32(k % 7),
        "reward": np.float32(k),
        "done": bool(k % 5 == 0),
    }


def _fill(buf, n, healthy=None, start=0):
    for k in range(start, start + n):
        buf.append(_tr(k), healthy=True if healthy is None else healthy(k))


# -- sum tree ---------------------------------------------------------------------


def test_sumtree_set_total_search():
    t = SumTree(8)
    t.set(0, 1.0)
    t.set(3, 3.0)
    t.set(7, 4.0)
    assert t.total == pytest.approx(8.0)
    assert t.prefix_search(0.5) == 0
    assert t.prefix_search(1.5) == 3
    assert t.prefix_search(7.9) == 7
    t.set(3, 0.0)
    assert t.total == pytest.approx(5.0)
    assert t.get(3) == 0.0


def test_sumtree_rebuild_matches_incremental():
    for cap in (16, 13, 3, 2, 1):
        leaves = np.arange(cap, dtype=float) + 0.5
        a, b = SumTree(cap), SumTree(cap)
        for i, p in enumerate(leaves):
            a.set(i, p)
        b.rebuild(leaves)
        np.testing.assert_array_equal(a._tree, b._tree)
        for m in np.linspace(0.0, a.total, 7, endpoint=False):
            assert a.prefix_search(float(m)) == b.prefix_search(float(m))


def test_sumtree_batch_search_matches_scalar():
    rng = np.random.default_rng(3)
    for cap in (16, 13):
        t = SumTree(cap)
        for i, p in enumerate(rng.random(cap) * 5):
            t.set(i, float(p))
        masses = rng.random(64) * t.total
        batch = t.prefix_search_batch(masses)
        scalar = [t.prefix_search(float(m)) for m in masses]
        np.testing.assert_array_equal(batch, scalar)
        np.testing.assert_array_equal(t.get_many(batch), [t.get(i) for i in batch])


def test_sumtree_rejects_bad_priorities():
    t = SumTree(4)
    with pytest.raises(ValueError):
        t.set(0, -1.0)
    with pytest.raises(ValueError):
        t.set(0, float("nan"))
    with pytest.raises(ValueError):
        t.rebuild([1.0, -1.0, 0.0, 0.0])


# -- columnar ring store ----------------------------------------------------------


def test_columnstore_schema_fixed_and_drift_raises():
    cs = ColumnStore(4)
    cs.write_row(0, _tr(0))
    assert set(cs.keys) == {"obs", "action", "reward", "done"}
    with pytest.raises(ValueError):
        cs.write_row(1, {**_tr(1), "obs": np.zeros((5,), np.float32)})
    with pytest.raises(KeyError):
        cs.write_row(1, {"obs": np.zeros((4,), np.float32)})
    with pytest.raises(TypeError):
        ColumnStore(4).write_row(0, {"s": "a string"})


def test_columnstore_rejecting_first_row_leaves_no_partial_schema():
    cs = ColumnStore(4)
    with pytest.raises(TypeError):
        cs.write_row(0, {"obs": np.zeros(4, np.float32), "note": "str"})
    assert cs.keys == ()
    cs.write_row(0, _tr(0))
    assert set(cs.keys) == {"obs", "action", "reward", "done"}
    assert set(cs.gather([0])) == {"obs", "action", "reward", "done"}


def test_columnstore_gather_keys_selection():
    cs = ColumnStore(4)
    cs.write_row(0, _tr(5))
    batch = cs.gather([0, 0], keys=("obs", "reward"))
    assert set(batch) == {"obs", "reward"}
    np.testing.assert_array_equal(batch["reward"], [5.0, 5.0])
    with pytest.raises(KeyError, match="no such replay column"):
        cs.gather([0], keys=("nope",))


def test_columnstore_read_row_copies():
    cs = ColumnStore(4)
    cs.write_row(0, _tr(3))
    row = cs.read_row(0)
    row["obs"][:] = -1
    np.testing.assert_array_equal(cs.read_row(0)["obs"], np.full(4, 3, np.float32))


def test_columnstore_gather_out_and_alloc():
    cs = ColumnStore(8)
    for k in range(8):
        cs.write_row(k, _tr(k))
    idx = np.array([7, 0, 3, 3])
    batch = cs.gather(idx)
    np.testing.assert_array_equal(batch["reward"], [7, 0, 3, 3])
    np.testing.assert_array_equal(batch["obs"][1], np.zeros(4, np.float32))
    out = {"obs": np.empty((4, 4), np.float32)}
    batch2 = cs.gather(idx, out=out)
    assert batch2["obs"] is out["obs"]
    np.testing.assert_array_equal(batch2["obs"], batch["obs"])
    made = {}

    def factory(key, shape, dtype):
        made[key] = np.empty(shape, dtype)
        return made[key]

    batch3 = cs.gather(idx, out=factory)
    assert batch3["reward"] is made["reward"]
    np.testing.assert_array_equal(batch3["reward"], batch["reward"])
    with pytest.raises(ValueError, match="need"):
        cs.gather(idx, out={"obs": np.empty((3, 4), np.float32)})


@pytest.mark.parametrize("obs_shape", [(4,), (64, 96, 3), (128, 160, 4)])
def test_columnstore_rows_and_gathers_equal_the_references(obs_shape):
    """Small rows, rows above the native-gather threshold (16 KiB) and rows
    above the native-copy threshold (64 KiB) store and gather the same
    bytes in both packages."""
    from blendjax.replay import ColumnStore as JColumnStore

    rng = np.random.default_rng(0)
    ours, ref = ColumnStore(6), JColumnStore(6)
    for k in range(9):
        row = {"obs": rng.integers(0, 255, obs_shape).astype(np.uint8),
               "reward": np.float32(rng.random())}
        ours.write_row(k % 6, row)
        ref.write_row(k % 6, row)
    idx = rng.integers(0, 6, 16)
    got, want = ours.gather(idx), ref.gather(idx)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(ours.columns[key], ref.columns[key])


def test_columnstore_large_rows_take_the_native_copies(monkeypatch):
    """Rows of 16 KiB or more gather through the native ``gather_into``
    (into a given ``out=`` buffer too), and rows of 64 KiB or more are
    written through ``copy_into``'s native path; the bytes equal numpy's."""
    from blendjax_torch.native import ring as nring
    from blendjax_torch.replay import ring as rring

    assert nring.native_available()
    calls = {"gather": 0}
    real_gather = rring.gather_into

    def counting_gather(dst, srcs):
        calls["gather"] += 1
        return real_gather(dst, srcs)

    monkeypatch.setattr(rring, "gather_into", counting_gather)
    rng = np.random.default_rng(3)
    cs = ColumnStore(5)
    rows = [{"obs": rng.integers(0, 255, (128, 160, 4), dtype=np.uint8),
             "small": rng.random(3).astype(np.float32)} for _ in range(5)]
    for k, row in enumerate(rows):
        cs.write_row(k, row)
    idx = np.array([4, 0, 0, 3])
    out = {"obs": np.empty((4, 128, 160, 4), np.uint8)}
    got = cs.gather(idx, out=out)
    assert got["obs"] is out["obs"] and calls["gather"] == 1  # "small" took np.take
    np.testing.assert_array_equal(got["obs"], np.stack([rows[i]["obs"] for i in idx]))
    np.testing.assert_array_equal(got["small"], np.stack([rows[i]["small"] for i in idx]))


# -- replay buffer ----------------------------------------------------------------


def test_ring_wraparound_and_counts():
    counters = EventCounters()
    buf = ReplayBuffer(8, seed=0, counters=counters)
    _fill(buf, 20)
    assert len(buf) == 8
    assert buf.num_eligible == 8
    stats = buf.stats()
    assert stats["appends"] == 20
    assert stats["overwrites"] == 12
    assert counters.get("replay_appends") == 20
    assert counters.get("replay_overwrites") == 12
    rewards = sorted(float(buf.get(i)["reward"]) for i in range(8))
    assert rewards == [float(k) for k in range(12, 20)]


def test_unhealthy_rows_stored_but_never_sampled():
    buf = ReplayBuffer(64, seed=1)
    _fill(buf, 48, healthy=lambda k: k % 3 != 0)
    assert len(buf) == 48
    assert buf.num_eligible == 32
    assert buf.stats()["excluded"] == 16
    seen = set()
    for _ in range(40):
        _, idx, _ = buf.sample(16)
        seen.update(int(i) for i in idx)
    sampled_rewards = {int(buf.get(i)["reward"]) for i in seen}
    assert all(k % 3 != 0 for k in sampled_rewards)
    ubuf = ReplayBuffer(64, seed=1, prioritized=False)
    _fill(ubuf, 48, healthy=lambda k: k % 3 != 0)
    for _ in range(20):
        data, idx, w = ubuf.sample(16)
        assert (np.asarray(data["reward"]).astype(int) % 3 != 0).all()
        np.testing.assert_array_equal(w, np.ones(16, np.float32))


def test_healthy_flag_rides_in_band():
    buf = ReplayBuffer(8, seed=0)
    buf.append({**_tr(1), HEALTHY_KEY: False})
    buf.append({**_tr(2), HEALTHY_KEY: True})
    assert HEALTHY_KEY not in buf.store.keys
    assert len(buf) == 2 and buf.num_eligible == 1


def test_prioritized_sampling_prefers_high_priority():
    buf = ReplayBuffer(64, seed=7, alpha=1.0)
    _fill(buf, 64)
    buf.update_priorities([5], [1000.0])
    counts = np.zeros(64, int)
    for _ in range(64):
        _, idx, w = buf.sample(8)
        for i in idx:
            counts[int(i)] += 1
        assert w.max() == pytest.approx(1.0)
        assert w.min() > 0
    assert counts[5] > counts.sum() // 2


def test_sampling_determinism_same_seed_same_stream():
    streams = []
    for _ in range(2):
        buf = ReplayBuffer(32, seed=123)
        _fill(buf, 40, healthy=lambda k: k % 4 != 1)
        buf.update_priorities([1, 2, 3], [5.0, 0.5, 2.0])
        draws = []
        for _ in range(6):
            data, idx, w = buf.sample(8)
            draws.append((idx.copy(), w.copy(), data["obs"].copy()))
        streams.append(draws)
    for (ia, wa, oa), (ib, wb, ob) in zip(*streams):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(oa, ob)


def test_sample_wait_blocks_until_filled_and_times_out():
    counters = EventCounters()
    buf = ReplayBuffer(16, seed=0, counters=counters)
    with pytest.raises(TimeoutError):
        buf.sample(4, timeout=0.2)
    assert counters.get("replay_sample_waits") >= 1
    t = threading.Thread(target=lambda: (time.sleep(0.15), _fill(buf, 8)), daemon=True)
    t.start()
    data, idx, w = buf.sample(4, timeout=10.0)
    assert data["obs"].shape == (4, 4)
    t.join(timeout=10)
    assert not t.is_alive()
    assert buf.timer.count("sample_wait") >= 1
    empty = ReplayBuffer(4, seed=0)
    stop = threading.Event()
    stop.set()
    assert empty.sample(2, stop_event=stop, timeout=5.0) is None


def test_concurrent_append_sample_no_torn_rows():
    buf = ReplayBuffer(64, seed=5)
    _fill(buf, 64)
    stop = threading.Event()
    errors = []

    def actor():
        k = 64
        while not stop.is_set():
            try:
                buf.append(_tr(k))
            except Exception as e:  # noqa: BLE001 - surfaced by assert
                errors.append(e)
                return
            k += 1

    t = threading.Thread(target=actor, daemon=True)
    t.start()
    try:
        for _ in range(200):
            data, idx, w = buf.sample(8)
            obs0 = data["obs"][:, 0]
            np.testing.assert_array_equal(data["obs"], np.repeat(obs0[:, None], 4, axis=1))
            np.testing.assert_array_equal(data["reward"], obs0)
            np.testing.assert_array_equal(data["action"], obs0.astype(np.int64) % 7)
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert not errors
    assert buf.stats()["appends"] > 64


def test_update_priorities_skips_dead_rows():
    buf = ReplayBuffer(8, seed=0)
    _fill(buf, 4, healthy=lambda k: k != 2)
    assert buf.tree.get(2) == 0.0
    buf.sample(4, min_size=1)
    buf.update_priorities([2, 3], [100.0, 100.0])
    assert buf.tree.get(2) == 0.0
    assert buf.tree.get(3) > 0.0


def test_update_priorities_skips_slots_overwritten_since_draw():
    buf = ReplayBuffer(4, seed=0)
    _fill(buf, 4)
    _, idx, _ = buf.sample(4)
    _fill(buf, 4, start=100)
    entered = {int(i): buf.tree.get(int(i)) for i in idx}
    buf.update_priorities(idx, [1e6] * len(idx))
    for i in idx:
        assert buf.tree.get(int(i)) == entered[int(i)]
    buf.update_priorities([0], [5.0])
    assert buf.tree.get(0) == entered[0]
    _, idx2, _ = buf.sample(4)
    buf.update_priorities(idx2, [9.0] * len(idx2))
    assert buf.tree.get(int(idx2[0])) == pytest.approx((9.0 + buf.eps) ** buf.alpha)


def test_nonuniform_scenario_mix_draws_the_references():
    """A non-uniform ``scenario_mix`` draws the reference's strata: the same
    indices and IS weights, stratum by stratum."""
    bufs = (ReplayBuffer(8, seed=0), JReplayBuffer(8, seed=0))
    for buf in bufs:
        for k in range(8):
            buf.append(_tr(k), scenario="a" if k % 2 else "b")
    (da, ia, wa), (db, ib, wb) = (b.sample(4, scenario_mix={"a": 0.7, "b": 0.3}) for b in bufs)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(wa, wb)
    np.testing.assert_array_equal(da["obs"], db["obs"])
    assert (ia % 2 == 1).sum() == 3  # apportioned 3 : 1 by largest remainder


def test_determinism_across_save_restore_roundtrip(tmp_path):
    path = str(tmp_path / "replay.npz")
    buf = ReplayBuffer(32, seed=9)
    _fill(buf, 40, healthy=lambda k: k % 6 != 2)
    buf.sample(8)  # advance the RNG mid-stream
    buf.update_priorities([0, 4], [3.0, 7.0])
    buf.save(path)
    restored = ReplayBuffer.restore(path)
    assert restored.store.keys == buf.store.keys
    for key in buf.store.keys:
        np.testing.assert_array_equal(restored.store.columns[key], buf.store.columns[key])
    np.testing.assert_array_equal(restored.tree.leaves(), buf.tree.leaves())
    assert len(restored) == len(buf)
    assert restored.num_eligible == buf.num_eligible
    for _ in range(5):
        da, ia, wa = buf.sample(8)
        db, ib, wb = restored.sample(8)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(da["obs"], db["obs"])
    buf.append(_tr(99))
    restored.append(_tr(99))
    da, ia, _ = buf.sample(4)
    db, ib, _ = restored.sample(4)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(da["reward"], db["reward"])


def test_restore_rejects_foreign_files(tmp_path):
    from blendjax_torch.utils.checkpoint import save_state

    path = str(tmp_path / "other.npz")
    save_state(path, {"x": np.zeros(3)}, {"format": "something/else"})
    with pytest.raises(ValueError, match="not a replay checkpoint"):
        ReplayBuffer.restore(path)


@pytest.mark.parametrize("prioritized", [True, False])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_saved_file_restores_in_the_other_package(tmp_path, writer, prioritized):
    """Either package's file restores in the other: the same columns, tree
    and counters, and the same draws and weights from there on, as the
    saved buffer itself would draw them."""
    path = str(tmp_path / "replay.npz")
    src_cls, dst_cls = ((ReplayBuffer, JReplayBuffer) if writer == "port"
                        else (JReplayBuffer, ReplayBuffer))
    src = src_cls(32, seed=4, prioritized=prioritized)
    _fill(src, 45, healthy=lambda k: k % 7 != 3)
    _, idx, _ = src.sample(8)
    src.update_priorities(idx, np.arange(8.0))
    src.save(path)
    dst = dst_cls.restore(path)
    assert dst.stats()["appends"] == src.stats()["appends"] == 45
    assert dst.num_eligible == src.num_eligible
    for key in src.store.keys:
        np.testing.assert_array_equal(dst.store.columns[key], src.store.columns[key])
    for _ in range(6):
        da, ia, wa = src.sample(8)
        db, ib, wb = dst.sample(8)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(da["obs"], db["obs"])
        src.update_priorities(ia, np.abs(da["reward"]))
        dst.update_priorities(ib, np.abs(db["reward"]))


def test_uniform_scenario_mix_is_the_plain_draw():
    """Stamps are bookkeeping: a stamped buffer sampled under a uniform mix
    over every stamp draws the reference's plain stream."""
    ours, ref = ReplayBuffer(16, seed=3), JReplayBuffer(16, seed=3)
    for k in range(16):
        scen = "a" if k % 2 else "b"
        ours.append(_tr(k), scenario=scen)
        ref.append(_tr(k))
    for _ in range(4):
        _, ia, wa = ours.sample(4, scenario_mix={"a": 0.5, "b": 0.5})
        _, ib, wb = ref.sample(4)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(wa, wb)
    assert set(ours.stats()["scenarios"]) == {"a", "b"}


# -- arena + device feed ----------------------------------------------------------


def test_sample_batches_through_arena_pool_and_device_prefetch():
    buf = ReplayBuffer(64, seed=11)
    _fill(buf, 64)
    pool = ArenaPool(pool_size=2)
    stop = threading.Event()
    gen = buf.sample_batches(8, arena_pool=pool, stop_event=stop)
    first = next(gen)
    assert isinstance(first, ArenaBatch)
    idx, w = first.meta
    np.testing.assert_array_equal(first.data["replay_idx"], idx)
    np.testing.assert_array_equal(first.data["is_weight"], w)
    assert first.data["obs"] is first.arena.buffers["obs"]
    first.recycle()
    gen.close()

    stop2 = threading.Event()
    gen2 = buf.sample_batches(8, arena_pool=pool, stop_event=stop2)
    it = device_prefetch(gen2, size=2, device="cpu")
    seen = 0
    try:
        for dev_batch in it:
            assert isinstance(dev_batch["obs"], torch.Tensor)
            ridx = dev_batch["replay_idx"].numpy()
            robs = dev_batch["obs"].numpy()
            for j, slot in enumerate(ridx):
                np.testing.assert_array_equal(robs[j], buf.get(int(slot))["obs"])
            seen += 1
            if seen >= 4:
                break
    finally:
        stop2.set()
        it.close()
    assert pool.in_use == 0


def test_sample_batches_plain_without_pool():
    buf = ReplayBuffer(16, seed=2)
    _fill(buf, 16)
    gen = buf.sample_batches(4)
    batch = next(gen)
    assert isinstance(batch, dict) and "replay_idx" in batch
    gen.close()


# -- .btr prefill -----------------------------------------------------------------


def test_transition_message_roundtrip():
    msg = transition_to_message(_tr(3), healthy=False)
    tr, healthy = message_to_transition(msg)
    assert healthy is False and HEALTHY_KEY not in tr
    np.testing.assert_array_equal(tr["obs"], _tr(3)["obs"])
    ref = j_transition_to_message(_tr(3), healthy=False)
    assert msg.keys() == ref.keys()
    assert all(np.array_equal(msg[k], v) for k, v in ref.items())


def _assert_same_buffers(a, b, rounds=4):
    assert a.store.keys == b.store.keys
    for key in b.store.keys:
        np.testing.assert_array_equal(a.store.columns[key], b.store.columns[key])
    np.testing.assert_array_equal(a.tree.leaves(), b.tree.leaves())
    assert a.num_eligible == b.num_eligible
    for _ in range(rounds):
        da, ia, wa = b.sample(8)
        db, ib, wb = a.sample(8)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(da["obs"], db["obs"])
        np.testing.assert_array_equal(wa, wb)


@pytest.mark.parametrize("recorder", ["port", "reference"])
def test_prefill_from_btr_bit_identical_to_direct_appends(tmp_path, recorder):
    """The port's prefill of a recording, made by either package's
    recorder, equals direct appends (and the reference's direct appends)."""
    rec_cls = FileRecorder if recorder == "port" else JFileRecorder
    prefix = str(tmp_path / "run")
    transitions = [(_tr(k), k % 4 != 2) for k in range(20)]
    direct = ReplayBuffer(32, seed=21)
    ref = JReplayBuffer(32, seed=21)
    with rec_cls(rec_cls.filename(prefix, 0), max_messages=32) as rec:
        for tr, healthy in transitions:
            rec.save(transition_to_message(tr, healthy=healthy))
            direct.append(tr, healthy=healthy)
            ref.append(tr, healthy=healthy)

    hydrated = ReplayBuffer(32, seed=21)
    assert prefill_from_btr(hydrated, prefix) == 20
    _assert_same_buffers(hydrated, direct)
    again = ReplayBuffer(32, seed=21)
    prefill_from_btr(again, prefix)
    _assert_same_buffers(again, ref)


def test_prefill_transform_and_limit(tmp_path):
    path = tmp_path / "raw.btr"
    with FileRecorder(path, max_messages=16) as rec:
        for k in range(10):
            rec.save({"image": np.full((2, 2), k, np.uint8), "btid": 0})
    buf = ReplayBuffer(16, seed=0)
    n = prefill_from_btr(
        buf, path,
        transform=lambda m: None if int(m["image"][0, 0]) % 2 else {
            "obs": m["image"].astype(np.float32).ravel()},
        limit=4,
    )
    assert n == 4
    assert len(buf) == 4
    assert set(buf.get(0)) == {"obs"}


def test_prefill_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        prefill_from_btr(ReplayBuffer(4), str(tmp_path / "nope"))


@pytest.fixture
def fake_blender(monkeypatch):
    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)
    monkeypatch.setenv("BLENDJAX_FAKE_BPY", "1")


def test_record_path_interop_live_envpool(fake_blender, tmp_path):
    """Transitions recorded during a live run of the port's pool over its
    echo producers prefill a buffer bit-identically to direct appends."""
    prefix = str(tmp_path / "live")
    direct = ReplayBuffer(256, seed=4)
    rng = np.random.default_rng(0)
    with launch_env_pool(scene="", script=ENV_SCRIPT, num_instances=2, background=True,
                         horizon=1_000_000, timeoutms=30000,
                         start_port=_free_block(2)) as pool:
        obs, _ = pool.reset()
        obs = np.asarray(obs, np.float32).reshape(pool.num_envs, -1)
        with FileRecorder(FileRecorder.filename(prefix, 0), max_messages=256) as rec:
            for _ in range(12):
                actions = rng.integers(0, 2, pool.num_envs).astype(float)
                nobs, rew, done, infos = pool.step(list(actions))
                nobs = np.asarray(nobs, np.float32).reshape(pool.num_envs, -1)
                for i in range(pool.num_envs):
                    tr = {"obs": obs[i], "action": np.float32(actions[i]),
                          "reward": np.float32(rew[i]), "next_obs": nobs[i],
                          "done": bool(done[i])}
                    healthy = bool(infos[i].get("healthy", True))
                    rec.save(transition_to_message(tr, healthy=healthy))
                    direct.append(tr, healthy=healthy)
                obs = nobs
    hydrated = ReplayBuffer(256, seed=4)
    assert prefill_from_btr(hydrated, prefix) == 24
    for key in direct.store.keys:
        np.testing.assert_array_equal(hydrated.store.columns[key], direct.store.columns[key])
    da, ia, wa = direct.sample(8)
    db, ib, wb = hydrated.sample(8)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(da["obs"], db["obs"])


# -- differential: the port's buffer against the reference's ----------------------


def _transition(rng, k):
    return {"obs": rng.standard_normal(3).astype(np.float32),
            "action": np.int64(rng.integers(0, 2)),
            "reward": np.float32(rng.random()),
            "next_obs": rng.standard_normal(3).astype(np.float32),
            "done": bool(rng.random() < 0.05)}


@pytest.mark.parametrize("prioritized", [True, False])
def test_sample_and_priority_rounds_equal_the_references(prioritized):
    """Same appends (a fifth unhealthy, 1.5x past wraparound, more between
    rounds), then 50 rounds of sample + update_priorities: indices, IS
    weights, gathered arrays and the tree's total equal every round."""
    rng = np.random.default_rng(0)
    kw = dict(seed=17, prioritized=prioritized, alpha=0.6, beta=0.4)
    ours = ReplayBuffer(96, counters=EventCounters(), **kw)
    ref = JReplayBuffer(96, **kw)

    def append(n):
        for k in range(n):
            tr, healthy = _transition(rng, k), bool(rng.random() >= 0.2)
            ours.append(tr, healthy=healthy)
            ref.append(tr, healthy=healthy)

    append(144)
    for rnd in range(50):
        beta = None if rnd % 3 else 0.4 + rnd / 100
        keys = None if rnd % 2 else ("obs", "action", "reward")
        da, ia, wa = ours.sample(16, beta=beta, keys=keys)
        db, ib, wb = ref.sample(16, beta=beta, keys=keys)
        assert np.array_equal(ia, ib) and ia.dtype == ib.dtype, rnd
        assert np.array_equal(wa, wb) and wa.dtype == wb.dtype, rnd
        assert da.keys() == db.keys()
        for key in db:
            assert np.array_equal(da[key], db[key]) and da[key].dtype == db[key].dtype
        errors = np.abs(rng.standard_normal(16)) * (1 + rnd)
        ours.update_priorities(ia, errors)
        ref.update_priorities(ib, errors)
        if prioritized:
            assert ours.tree.total == ref.tree.total, rnd
            np.testing.assert_array_equal(ours.tree.leaves(), ref.tree.leaves())
        if rnd % 5 == 4:
            append(7)
    assert ours.stats()["samples"] == ref.stats()["samples"] == 50
    for key in ("size", "eligible", "excluded", "appends", "overwrites", "priority_total"):
        assert ours.stats()[key] == ref.stats()[key], key
