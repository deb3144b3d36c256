"""The port's arena stream against the reference's, on the CPU.

1. **Parity** — the port's ``_BatchBuilder`` gives byte-identical batches
   to the reference's ``_BatchBuilder(defer=True)`` (and to ``stream() +
   collate``) on the cases of ``tests/test_arena.py``: nested
   dicts/tuples, ragged leaves, mixed dtypes, non-contiguous arrays, both
   wire encodings (raw-buffer multipart and compat pickle), with and
   without a recycled arena, on the precompiled plan and on its
   generic-walk fallback.
2. **Backpressure** — an exhausted ``ArenaPool`` blocks assembly,
   recycling resumes it, a stop aborts the wait, a double recycle is a
   no-op.
3. **The stream** — ``TorchStream(arena='auto')`` through fake-Blender
   producers gives batch for batch what ``arena=False`` gives, and the
   pool drains after close.

``test_arena.py``'s shm cases run on the port too: the shm stream threads
the pool through the eager builder, ``gather_into`` equals numpy, and the
eager builder's drift degrade does not alias a recycled arena (its
deferred twin is kept).
"""

import runpy
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from blendjax import wire as jwire
from blendjax.btt.arena import ArenaPool as JArenaPool
from blendjax.btt.dataset import _BatchBuilder as JBatchBuilder
from blendjax_torch import datagen
from blendjax_torch import wire
from blendjax_torch.btt.arena import Arena, ArenaBatch, ArenaPool
from blendjax_torch.btt.collate import collate
from blendjax_torch.btt.dataset import RemoteIterableDataset, _BatchBuilder
from blendjax_torch.btt.launcher import BlenderLauncher
from blendjax_torch.btt.prefetch import TorchStream, _resolve_arena, device_prefetch
from helpers.producers import ProducerFleet

HERE = Path(__file__).resolve().parent
FAKE_BLENDER = HERE / "helpers" / "fake_blender.py"


def assert_tree_equal(a, b, path=""):
    """Structure + dtype + byte equality over collated pytrees."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), (path, type(b))
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


class Pair:
    """The reference's builder and the port's, fed the same frames, each
    with its own schema cache and (optionally) its own one-arena pool, so
    a second batch reuses the first one's arena."""

    def __init__(self, arena):
        self.caches = ({}, {})
        self.pools = (JArenaPool(1), ArenaPool(1)) if arena else None

    def build(self, msgs, batch_size=None):
        n = batch_size or len(msgs)
        out = []
        for i, make in enumerate((lambda a, c: JBatchBuilder(n, arena=a, defer=True,
                                                             schema_cache=c),
                                  lambda a, c: _BatchBuilder(n, arena=a, schema_cache=c))):
            arena = self.pools[i].acquire(timeout=1) if self.pools else None
            builder = make(arena, self.caches[i])
            for m in msgs:
                builder.add_message(m)
            batch = builder.finish()
            out.append(batch)
            if arena is not None:
                arena.release()
        ref, got = out
        assert_tree_equal(ref, got)
        return got


def encode(msg, raw):
    frames = jwire.encode(msg, raw_buffers=raw)
    # the port's encoder writes the same bytes
    assert [bytes(f) for f in frames] == [bytes(f) for f in wire.encode(msg, raw)]
    return frames


def legacy_batch(msgs):
    return collate([wire.decode(m) for m in msgs])


@pytest.fixture(params=[False, True], ids=["no-arena", "recycled-arena"])
def pair(request):
    return Pair(request.param)


class TestArenaParity:
    """Port == reference == collate, byte for byte."""

    @pytest.mark.parametrize("raw", [True, False], ids=["raw", "compat"])
    def test_nested_dicts_tuples_scalars(self, raw, pair):
        def make(i):
            return {
                "image": np.full((8, 6, 3), i, np.uint8),
                "nested": {
                    "xy": np.array([i, i + 1], np.float32),
                    "deep": {"flag": bool(i % 2)},
                    "tag": f"t{i}",
                },
                "tup": (np.arange(3, dtype=np.int32) + i, i * 1.5),
                "pts": [np.full((2, 2), i, np.float64)],
                "frameid": i,
            }

        for trial in range(2):  # the second trial decodes along the cached plan
            msgs = [encode(make(i + 4 * trial), raw) for i in range(4)]
            assert_tree_equal(legacy_batch(msgs), pair.build(msgs))

    @pytest.mark.parametrize("raw", [True, False], ids=["raw", "compat"])
    def test_ragged_and_mixed_dtype_degrade(self, raw, pair):
        msgs = [encode({"img": np.full((4 + i, 3), i, np.uint8),  # ragged
                        "val": np.array([i], np.float32 if i < 2 else np.float64),
                        "k": i}, raw)
                for i in range(3)]
        got = pair.build(msgs, batch_size=4)  # also a partial batch
        assert_tree_equal(legacy_batch(msgs), got)
        assert isinstance(got["img"], list)  # ragged stays a list
        assert got["val"].dtype == np.float64  # upcast rule preserved

    @pytest.mark.parametrize("raw", [True, False], ids=["raw", "compat"])
    def test_non_contiguous_arrays(self, raw, pair):
        base = np.arange(96, dtype=np.int16).reshape(8, 12)
        msgs = [encode({"a": np.asfortranarray(base + i), "b": base[::2, ::3] + i}, raw)
                for i in range(4)]
        assert_tree_equal(legacy_batch(msgs), pair.build(msgs))

    def test_compat_pickle_messages_fall_back_to_collate_rules(self, pair):
        msgs = [encode({"image": np.full((5, 4), i, np.uint8), "frameid": i}, False)
                for i in range(4)]
        assert len(msgs[0]) == 1  # really the compat encoding
        for _ in range(2):  # plan path on the second batch
            assert_tree_equal(legacy_batch(msgs), pair.build(msgs))

    @pytest.mark.parametrize("raw", [True, False], ids=["raw", "compat"])
    def test_key_semantics_and_plan_fallback(self, raw, pair):
        img = np.zeros((4, 4), np.uint8)
        # batch 1 fixes the schema/plan
        pair.build([encode({"image": img, "frameid": i}, raw) for i in range(2)])
        # batch 2: an extra key appears -> plan fallback, key adopted
        msgs2 = [encode({"image": img, "frameid": i, "extra": i}, raw) for i in range(2)]
        got = pair.build(msgs2)
        assert_tree_equal(legacy_batch(msgs2), got)
        assert "extra" in got
        # batch 3: a late-message-only key is dropped
        msgs3 = [encode({"image": img, "frameid": 0}, raw),
                 encode({"image": img, "frameid": 1, "late": 9}, raw)]
        assert "late" not in pair.build(msgs3)
        # a message missing a first-message key raises, in both packages
        missing = [encode({"image": img, "frameid": 0}, raw), encode({"image": img}, raw)]
        for make in (lambda: JBatchBuilder(2, defer=True), lambda: _BatchBuilder(2)):
            builder = make()
            for m in missing:
                builder.add_message(m)
            with pytest.raises(KeyError):
                builder.finish()

    def test_drift_degrade_does_not_alias_recycled_arena(self):
        """A within-batch shape drift degrades a key to a ragged list;
        those slots must not alias the arena a later batch overwrites."""
        pool = ArenaPool(1)
        arena = pool.acquire()
        b1 = _BatchBuilder(2, arena=arena)
        b1.add_message(wire.encode({"x": np.array([0, 1, 2, 3])}, raw_buffers=True))
        b1.add_message(wire.encode({"x": np.array([9, 9])}, raw_buffers=True))
        batch1 = b1.finish()
        arena.release()
        arena2 = pool.acquire()
        assert arena2 is arena
        b2 = _BatchBuilder(2, arena=arena2)
        for _ in range(2):
            b2.add_message(wire.encode({"x": np.array([-1, -1, -1, -1])}, raw_buffers=True))
        b2.finish()
        np.testing.assert_array_equal(batch1["x"][0], [0, 1, 2, 3])

    def test_eager_drift_degrade_does_not_alias_recycled_arena(self):
        """Eager (shm) assembly: a mid-batch shape drift degrades a key to a
        ragged list; the slots already copied must be copies, not views into
        the arena buffer a later batch overwrites."""
        pool = ArenaPool(1)
        arena = pool.acquire()
        b1 = _BatchBuilder(2, arena=arena, defer=False)
        b1.add_message(wire.encode({"x": np.array([0, 1, 2, 3])}, raw_buffers=True))
        b1.add_message(wire.encode({"x": np.array([9, 9])}, raw_buffers=True))
        batch1 = b1.finish()
        arena.release()
        arena2 = pool.acquire()
        assert arena2 is arena
        b2 = _BatchBuilder(2, arena=arena2, defer=False)
        for _ in range(2):
            b2.add_message(wire.encode({"x": np.array([-1, -1, -1, -1])}, raw_buffers=True))
        b2.finish()
        np.testing.assert_array_equal(batch1["x"][0], [0, 1, 2, 3])

    def test_gather_into_matches_numpy(self):
        from blendjax_torch.native.ring import gather_into

        rng = np.random.default_rng(0)
        parts = [rng.integers(0, 255, (40, 7), np.uint8) for _ in range(6)]
        dst = np.empty((6, 40, 7), np.uint8)
        gather_into(dst, parts)
        np.testing.assert_array_equal(dst, np.stack(parts))
        # buffer-protocol sources (the wire-frame case) and fortran order
        dst2 = np.empty((3, 4, 4), np.float32)
        srcs = [np.arange(16, dtype=np.float32).reshape(4, 4) + i for i in range(3)]
        gather_into(dst2, [memoryview(srcs[0].tobytes()), srcs[1],
                           np.asfortranarray(srcs[2])])
        np.testing.assert_array_equal(dst2, np.stack(srcs))
        with pytest.raises(ValueError, match="bytes"):
            gather_into(np.empty(3, np.uint8), [b"toolongbytes"])

    def test_arena_buffers_are_recycled_not_reallocated(self):
        pool = ArenaPool(2)
        cache = {}

        def build(msgs, arena):
            b = _BatchBuilder(len(msgs), arena=arena, schema_cache=cache)
            for m in msgs:
                b.add_message(m)
            return b.finish()

        arena = pool.acquire()
        msgs = [wire.encode({"image": np.full((16, 16), i, np.uint8)}, raw_buffers=True)
                for i in range(4)]
        first = build(msgs, arena)
        buf_id = id(first["image"])
        arena.release()
        arena2 = pool.acquire()
        assert arena2 is arena  # freelist reuse
        msgs2 = [wire.encode({"image": np.full((16, 16), 40 + i, np.uint8)}, raw_buffers=True)
                 for i in range(4)]
        second = build(msgs2, arena2)
        # same backing buffer, new bytes: no per-batch allocation
        assert id(second["image"]) == buf_id
        assert_tree_equal(legacy_batch(msgs2), second)


class TestArenaPoolBackpressure:
    def test_exhaustion_blocks_then_recycle_unblocks(self):
        pool = ArenaPool(2)
        a1, a2 = pool.acquire(), pool.acquire()
        assert pool.in_use == 2
        t0 = time.monotonic()
        assert pool.acquire(timeout=0.2) is None  # exhausted: blocks
        assert time.monotonic() - t0 >= 0.2
        got = []
        waiter = threading.Thread(target=lambda: got.append(pool.acquire(timeout=5.0)),
                                  daemon=True)
        waiter.start()
        time.sleep(0.05)
        a1.release()  # the consumer finally recycles
        waiter.join(timeout=5)
        assert got and got[0] is a1
        a2.release()
        assert pool.in_use == 1  # got[0] still checked out

    def test_stop_event_aborts_wait(self):
        pool = ArenaPool(1)
        pool.acquire()
        stop = threading.Event()
        res = {}
        t = threading.Thread(target=lambda: res.setdefault("a", pool.acquire(stop_event=stop)),
                             daemon=True)
        t.start()
        time.sleep(0.05)
        stop.set()
        t.join(timeout=5)
        assert "a" in res and res["a"] is None

    def test_double_recycle_is_idempotent(self):
        pool = ArenaPool(1)
        arena = pool.acquire()
        batch = ArenaBatch({"x": np.zeros(2)}, arena)
        batch.recycle()
        batch.recycle()
        assert pool.in_use == 0
        assert pool.acquire() is arena

    def test_threads_never_share_an_arena(self):
        """More threads than cores acquire and release one small pool with
        a shortened switch interval: no arena is ever held twice, and every
        arena is back at the end."""
        import os
        import sys

        pool = ArenaPool(3)
        holders, lock, errors = {}, threading.Lock(), []

        def work():
            for _ in range(200):
                arena = pool.acquire(timeout=10)
                if arena is None:
                    errors.append("acquire timed out")
                    return
                with lock:
                    if id(arena) in holders:
                        errors.append("an arena was handed out twice")
                    holders[id(arena)] = threading.get_ident()
                with lock:
                    del holders[id(arena)]
                ArenaBatch({}, arena).recycle()

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work, daemon=True)
                       for _ in range(2 * (os.cpu_count() or 1) + 2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        assert pool.in_use == 0

    def test_stream_backpressures_into_pool(self):
        """Over real sockets: a consumer that never recycles stalls the
        stream once the pool drains; recycling resumes it."""
        pool = ArenaPool(2)
        with ProducerFleet(num_producers=1, raw_buffers=True) as fleet:
            ds = RemoteIterableDataset(fleet.addresses, max_items=64, timeoutms=20000)
            gen = ds.stream_batches(4, arena_pool=pool)
            held = [next(gen), next(gen)]  # exhausts the pool
            assert all(isinstance(b, ArenaBatch) for b in held)
            assert pool.in_use == 2
            blocked = []
            t = threading.Thread(target=lambda: blocked.append(next(gen)), daemon=True)
            t.start()
            time.sleep(0.5)
            assert not blocked, "the stream must stall while the pool is dry"
            held[0].recycle()  # the copy "completes"
            t.join(timeout=10)
            assert len(blocked) == 1
            assert blocked[0].data["image"].shape == (4, 16, 16, 3)
            gen.close()

    def test_generator_close_does_not_double_release_yielded_arena(self):
        pool = ArenaPool(2)
        with ProducerFleet(num_producers=1, raw_buffers=True) as fleet:
            ds = RemoteIterableDataset(fleet.addresses, max_items=64, timeoutms=20000)
            gen = ds.stream_batches(4, arena_pool=pool)
            batch = next(gen)
            gen.close()  # GeneratorExit lands at the suspended yield
        assert isinstance(batch, ArenaBatch)
        assert pool.in_use == 1  # still owned by the yielded batch
        fresh = pool.acquire(timeout=1.0)
        assert fresh is not batch.arena
        batch.recycle()
        assert pool.in_use == 1  # only `fresh` remains out


    def test_shm_stream_yields_arena_batches(self):
        """The shm transport threads the same pool through its eager
        (record-lifetime-bounded) builder."""
        import os
        import uuid

        from blendjax_torch.btb.publisher import DataPublisher

        addr = f"shm://bjx-test-t-arena-{uuid.uuid4().hex[:6]}-{os.getpid()}"

        def produce():
            pub = DataPublisher(addr, btid=0, raw_buffers=True, sndtimeoms=500)
            i = 0
            while i < 8:
                if pub.publish(image=np.full((8, 8), i, np.uint8), frameid=i):
                    i += 1
            pub.close()

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        pool = ArenaPool(3)
        ds = RemoteIterableDataset([addr], max_items=8, timeoutms=10000)
        batches = []
        for b in ds.stream_batches(4, arena_pool=pool):
            assert isinstance(b, ArenaBatch)
            batches.append(b.data["frameid"].tolist())
            b.recycle()
        t.join(timeout=10)
        assert batches == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert pool.in_use == 0


class TestFeed:
    """The device feed's side of the arena, on the CPU."""

    def test_resolve_arena_options(self):
        ds = RemoteIterableDataset(["tcp://127.0.0.1:1"])
        pool = _resolve_arena("auto", ds, 2, 2)
        assert pool.pool_size == 2 + 2 + 3
        assert _resolve_arena(5, ds, 2, 2).pool_size == 5
        assert _resolve_arena(pool, ds, 2, 2) is pool
        assert _resolve_arena(False, ds, 2, 2) is None
        assert _resolve_arena(None, ds, 2, 2) is None
        with pytest.raises(ValueError):
            _resolve_arena(0, ds, 2, 2)
        with pytest.raises(ValueError):
            _resolve_arena("yes", ds, 2, 2)
        # a per-item transform keeps the stream on the collate path
        per_item = RemoteIterableDataset(["tcp://127.0.0.1:1"], item_transform=dict)
        assert _resolve_arena("auto", per_item, 2, 2) is None
        with pytest.raises(ValueError):
            _resolve_arena(True, per_item, 2, 2)

    def test_arena_buffers_are_reused_and_replaced_on_drift(self):
        arena = Arena()
        buf = arena.get_buffer(("x",), (4, 3), np.dtype(np.float32))
        assert type(buf) is np.ndarray and buf.shape == (4, 3)
        assert arena.get_buffer(("x",), (4, 3), np.dtype(np.float32)) is buf
        # schema drift (shape, then dtype) replaces the buffer
        buf2 = arena.get_buffer(("x",), (4, 5), np.dtype(np.float32))
        assert buf2 is not buf and buf2.shape == (4, 5)
        buf3 = arena.get_buffer(("x",), (4, 5), np.dtype(np.int16))
        assert buf3.dtype == np.int16 and arena.buffers == {("x",): buf3}

    def test_cpu_feed_recycles_after_owning_its_copy(self):
        """One arena, refilled for every batch: each CPU batch keeps its
        values, and every arena is back in the pool at the end."""
        pool = ArenaPool(1)

        def batches():
            for i in range(3):
                arena = pool.acquire(timeout=5)
                assert arena is not None, "the feed never recycled"
                buf = arena.get_buffer(("x",), (2, 3), np.dtype(np.float32))
                buf[...] = i
                yield ArenaBatch({"x": buf}, arena)

        out = list(device_prefetch(batches(), size=1, device="cpu",
                                   transform=lambda b: {**b, "y": b["x"] * 2}))
        assert [float(b["x"][0, 0]) for b in out] == [0.0, 1.0, 2.0]
        assert [float(b["y"][0, 0]) for b in out] == [0.0, 2.0, 4.0]
        assert pool.in_use == 0


# -- the stream through fake-Blender producers ----------------------------------

H, W, K = 24, 32, 2
SEED = 3


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _keep_ids(batch):
    return {**datagen.item_transform(batch), "btid": batch["btid"],
            "frameid": batch["frameid"]}


def _run_stream(monkeypatch, arena):
    """16 items from one fresh seeded producer in 4 batches, as a list of
    numpy batches, and the stream."""
    monkeypatch.setenv("BLENDJAX_BLENDER", str(FAKE_BLENDER))
    args = ["--height", str(H), "--width", str(W), "--keypoints", str(K)]
    with BlenderLauncher(scene="", script=str(datagen.FRAMES_SCRIPT), num_instances=1,
                         named_sockets=["DATA"], start_port=_free_port(), background=True,
                         seed=SEED, instance_args=[args]) as bl:
        ds = RemoteIterableDataset(bl.launch_info.addresses["DATA"], max_items=16)
        with TorchStream(ds, batch_size=4, num_workers=1, device="cpu",
                         transform=_keep_ids, arena=arena) as stream:
            out = [{k: v.numpy() for k, v in b.items()} for b in stream]
    return out, stream


def test_arena_stream_equals_the_collate_stream(monkeypatch):
    plain, plain_stream = _run_stream(monkeypatch, arena=False)
    pooled, stream = _run_stream(monkeypatch, arena="auto")
    assert plain_stream.arena_pool is None and stream.arena_pool is not None
    assert stream.timer.count("scatter") == 4 and stream.timer.count("recycle") == 4
    # without a pool the batches still assemble from the frames, into fresh
    # buffers (the reference's arena=False)
    assert plain_stream.timer.count("scatter") == 4
    assert plain_stream.timer.count("recycle") == 0
    assert stream.arena_pool.in_use == 0  # every arena back after close
    assert len(pooled) == len(plain) == 4
    make_frame = runpy.run_path(str(datagen.FRAMES_SCRIPT), run_name="frames")["make_frame"]
    for a, b in zip(pooled, plain):
        assert_tree_equal(a, b)
        for i in range(4):
            image, xy = make_frame(SEED + int(a["btid"][i]), int(a["frameid"][i]), H, W, K)
            np.testing.assert_array_equal(a["image"][i], image)
    # one producer, one worker: the items arrive in the order published
    assert [int(f) for b in pooled for f in b["frameid"]] == list(range(16))
