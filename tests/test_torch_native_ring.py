"""The port's shm ring (``blendjax_torch/native``) on the CPU.

1. The cases of ``tests/test_native_ring.py``, against the port's ring,
   publisher, dataset, loader and launcher.
2. Across the packages: a port writer feeds a reference reader and a
   reference writer a port reader, frames byte-equal across a wraparound
   and a generation reopen; the port never loads the reference's library.
3. ``fast_stack``, ``gather_into`` and ``copy_into`` byte-equal to numpy
   and to the reference's.
4. The port's eager ``_BatchBuilder`` fed ring records (views released
   after each message) byte-equal to the reference's, on
   ``tests/test_arena.py``'s cases, with and without a recycled arena.

Every comparison is exact (bytes).
"""

import os
import threading

import numpy as np
import pytest

from blendjax_torch import wire
from blendjax_torch.native import ring as nring

pytestmark = pytest.mark.skipif(
    not nring.native_available(), reason="native ring not built (no g++?)"
)


def _addr(tag):
    return f"shm://bjx-test-t-{tag}-{os.getpid()}"


def test_roundtrip_and_order():
    w = nring.ShmRingWriter(_addr("rt"), capacity_bytes=1 << 16)
    r = nring.ShmRingReader(_addr("rt"))
    try:
        for i in range(10):
            assert w.send_frames([f"msg{i}".encode(), b"x" * i])
        for i in range(10):
            frames = r.recv_frames(timeout_ms=1000)
            assert frames == [f"msg{i}".encode(), b"x" * i]
        assert r.recv_frames(timeout_ms=0) is None
    finally:
        w.close()
        r.close()


def test_wraparound_many_messages():
    # ring much smaller than total traffic -> exercises the wrap marker
    w = nring.ShmRingWriter(_addr("wrap"), capacity_bytes=1 << 14)  # 16 KiB
    r = nring.ShmRingReader(_addr("wrap"))
    payload = os.urandom(1000)
    n = 200
    errors = []

    def produce():
        for i in range(n):
            if not w.send_frames([i.to_bytes(4, "little"), payload], timeout_ms=5000):
                errors.append(i)
                return

    t = threading.Thread(target=produce)
    t.start()
    try:
        for i in range(n):
            frames = r.recv_frames(timeout_ms=5000)
            assert frames is not None, f"timeout at {i}"
            assert int.from_bytes(frames[0], "little") == i
            assert frames[1] == payload
    finally:
        t.join()
        w.close()
        r.close()
    assert not errors


def test_backpressure_blocks_writer():
    w = nring.ShmRingWriter(_addr("bp"), capacity_bytes=1 << 12)  # 4 KiB
    r = nring.ShmRingReader(_addr("bp"))
    try:
        big = b"z" * 1500
        assert w.send_frames([big], timeout_ms=200)
        assert w.send_frames([big], timeout_ms=200)
        # ring full now: bounded wait then False
        assert not w.send_frames([big], timeout_ms=200)
        # drain one -> space again
        assert r.recv_frames(timeout_ms=1000) is not None
        assert w.send_frames([big], timeout_ms=2000)
    finally:
        w.close()
        r.close()


def test_oversize_message_raises():
    w = nring.ShmRingWriter(_addr("big"), capacity_bytes=1 << 12)
    try:
        with pytest.raises(ValueError, match="larger than ring"):
            w.send_frames([b"x" * (1 << 13)])
    finally:
        w.close()


def test_eof_after_producer_close():
    w = nring.ShmRingWriter(_addr("eof"), capacity_bytes=1 << 14)
    r = nring.ShmRingReader(_addr("eof"))
    w.send_frames([b"last"])
    w.close(unlink=False)
    assert r.recv_frames(timeout_ms=1000) == [b"last"]
    with pytest.raises(EOFError):
        r.recv_frames(timeout_ms=1000)
    r.close()


def test_publisher_dataset_shm_end_to_end(tmp_path):
    from blendjax_torch.btb.publisher import DataPublisher
    from blendjax_torch.btt.dataset import FileDataset, RemoteIterableDataset

    addrs = [_addr("e2e-0"), _addr("e2e-1")]
    stop = threading.Event()

    def produce(addr, btid):
        pub = DataPublisher(addr, btid=btid, raw_buffers=True, sndtimeoms=200)
        i = 0
        while not stop.is_set() and i < 64:
            img = np.full((8, 8, 3), (btid * 10 + i) % 255, np.uint8)
            if pub.publish(image=img, frameid=i):
                i += 1
        pub.close()

    threads = [
        threading.Thread(target=produce, args=(a, i), daemon=True)
        for i, a in enumerate(addrs)
    ]
    for t in threads:
        t.start()
    try:
        prefix = str(tmp_path / "shmrec")
        ds = RemoteIterableDataset(addrs, max_items=16, timeoutms=10000,
                                   record_path_prefix=prefix)
        items = list(ds.stream(worker_id=0, num_workers=2))  # rings split
        assert len(items) == 8
        assert all(i["btid"] == 0 for i in items)  # worker 0 owns ring 0
        assert items[0]["image"].shape == (8, 8, 3)
        # recording worked through the shm path too
        replay = FileDataset(prefix)
        assert len(replay) == 8
        np.testing.assert_array_equal(replay[0]["image"], items[0]["image"])
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)


def test_shm_timeout():
    from blendjax_torch.btt.dataset import RemoteIterableDataset

    w = nring.ShmRingWriter(_addr("idle"), capacity_bytes=1 << 12)
    try:
        ds = RemoteIterableDataset([_addr("idle")], max_items=1, timeoutms=300)
        with pytest.raises(TimeoutError):
            list(ds)
    finally:
        w.close()


def test_launcher_shm_addresses():
    from blendjax_torch.btt.launcher import BlenderLauncher

    bl = BlenderLauncher.__new__(BlenderLauncher)
    bl.bind_addr = "127.0.0.1"
    bl.proto = "shm"
    bl.start_port = 13000
    bl.num_instances = 2
    bl.named_sockets = ["DATA"]
    bl._nonce = "cafe0123"
    bl._shm_base = f"blendjax-{bl._nonce}"
    # the nonce leads the name: launch-unique, and one glob sweeps it
    assert bl._addresses()["DATA"] == [
        "shm://blendjax-cafe0123-DATA-13000",
        "shm://blendjax-cafe0123-DATA-13001",
    ]


def test_fast_stack_matches_np_stack():
    rng = np.random.default_rng(0)
    items = [rng.random((480, 640, 4)).astype(np.float32) for _ in range(8)]
    np.testing.assert_array_equal(nring.fast_stack(items), np.stack(items))
    # non-contiguous sources are handled via a contiguous copy
    views = [a[:, ::2, :] for a in items]
    np.testing.assert_array_equal(nring.fast_stack(views), np.stack(views))
    # uint8 + preallocated out buffer
    bytes_items = [rng.integers(0, 255, (64, 64, 3), dtype=np.uint8) for _ in range(4)]
    out = np.empty((4, 64, 64, 3), np.uint8)
    res = nring.fast_stack(bytes_items, out=out)
    assert res is out
    np.testing.assert_array_equal(out, np.stack(bytes_items))


def test_fast_stack_rejects_mismatch():
    with pytest.raises(ValueError):
        nring.fast_stack([np.zeros((2, 2)), np.zeros((2, 3))])
    with pytest.raises(ValueError):
        nring.fast_stack([np.zeros((2, 2), np.float32), np.zeros((2, 2), np.float64)])


def test_fast_stack_validates_out():
    items = [np.zeros((64, 64), np.float32) for _ in range(4)]
    with pytest.raises(ValueError):
        nring.fast_stack(items, out=np.empty((2, 64, 64), np.float32))
    with pytest.raises(ValueError):
        nring.fast_stack(items, out=np.empty((4, 64, 64), np.float64))
    with pytest.raises(ValueError):
        nring.fast_stack(items, out=np.empty((4, 64, 128), np.float32)[:, :, ::2])


def test_recv_frames_large_payload_buffer_semantics():
    """Frames >= 64KiB come back as uint8 ndarrays (GIL-released copy-out);
    they must decode identically to the bytes path."""

    addr = _addr("bigframe")
    w = nring.ShmRingWriter(addr, capacity_bytes=8 << 20)
    r = nring.ShmRingReader(addr)
    try:
        img = np.arange(512 * 512, dtype=np.uint8).reshape(512, 512)  # 256KB
        frames_out = wire.encode({"image": img, "frameid": 3}, raw_buffers=True)
        assert w.send_frames(frames_out, timeout_ms=1000)
        frames_in = r.recv_frames(timeout_ms=1000)
        assert isinstance(frames_in[1], np.ndarray)  # large payload
        msg = wire.decode(frames_in)
        np.testing.assert_array_equal(msg["image"], img)
        assert msg["frameid"] == 3
    finally:
        r.close()
        w.close(unlink=True)


def _produce_n(addr, btid, n, shape=(32, 32, 3), big_from=None):
    """Publish n frames; from index big_from on, switch image shape
    (schema-drift injection).  Bounded by a deadline so a consumer that
    reads fewer than n items (ring full -> publish timeouts) doesn't leave
    this thread spinning until interpreter exit."""
    import time

    from blendjax_torch.btb.publisher import DataPublisher

    pub = DataPublisher(addr, btid=btid, raw_buffers=True, sndtimeoms=500)
    deadline = time.monotonic() + 30.0
    stalls = 0
    i = 0
    while i < n and stalls < 6 and time.monotonic() < deadline:
        shp = shape if big_from is None or i < big_from else (shape[0] * 2,) + shape[1:]
        img = np.full(shp, (btid * 10 + i) % 255, np.uint8)
        if pub.publish(image=img, frameid=i, tag=f"f{i}"):
            i += 1
            stalls = 0
        else:
            stalls += 1
    pub.close()


def test_stream_batches_matches_item_path():
    """Zero-copy batch assembly must produce byte-identical batches to the
    per-item stream + collate path."""
    from blendjax_torch.btt.collate import collate
    from blendjax_torch.btt.dataset import RemoteIterableDataset

    shape = (64, 64, 4)  # 16KB/frame -> small-copy path; still exercises zc
    addr_a, addr_b = _addr("zc-a"), _addr("zc-b")
    ta = threading.Thread(target=_produce_n, args=(addr_a, 0, 16, shape), daemon=True)
    tb = threading.Thread(target=_produce_n, args=(addr_b, 1, 16, shape), daemon=True)
    ta.start()
    ds = RemoteIterableDataset([addr_a], max_items=12, timeoutms=10000)
    assert ds.supports_batched_stream()
    batches = list(ds.stream_batches(4))
    ta.join(timeout=10)
    assert len(batches) == 3
    for b in batches:
        assert b["image"].shape == (4,) + shape
        assert b["image"].dtype == np.uint8
        assert b["btid"].tolist() == [0] * 4
        assert len(b["tag"]) == 4 and isinstance(b["tag"][0], str)
    # parity against the generic path on an identical stream
    tb.start()
    ds2 = RemoteIterableDataset([addr_b], max_items=12, timeoutms=10000)
    items2 = list(ds2.stream())
    ref = [collate(items2[i : i + 4]) for i in range(0, 12, 4)]
    tb.join(timeout=10)
    for b, r in zip(batches, ref):
        # same frames modulo btid (different producer ids)
        np.testing.assert_array_equal(
            b["image"][:, :, :, 0] - b["btid"][0] * 10 % 255,
            r["image"][:, :, :, 0] - r["btid"][0] * 10 % 255,
        )
        np.testing.assert_array_equal(b["frameid"], r["frameid"])


def test_stream_batches_partial_and_drop_last():
    from blendjax_torch.btt.dataset import RemoteIterableDataset

    addr = _addr("zc-partial")
    t = threading.Thread(target=_produce_n, args=(addr, 0, 10), daemon=True)
    t.start()
    ds = RemoteIterableDataset([addr], max_items=10, timeoutms=10000)
    batches = list(ds.stream_batches(4, drop_last=False))
    t.join(timeout=10)
    assert [b["image"].shape[0] for b in batches] == [4, 4, 2]
    assert batches[-1]["frameid"].tolist() == [8, 9]


def test_stream_batches_schema_drift_degrades():
    """A key whose shape changes mid-batch degrades to the ragged-list
    collate rules instead of failing the stream."""
    from blendjax_torch.btt.dataset import RemoteIterableDataset

    addr = _addr("zc-drift")
    t = threading.Thread(
        target=_produce_n, args=(addr, 0, 8), kwargs={"big_from": 2}, daemon=True
    )
    t.start()
    ds = RemoteIterableDataset([addr], max_items=8, timeoutms=10000)
    batches = list(ds.stream_batches(4))
    t.join(timeout=10)
    assert len(batches) == 2
    first = batches[0]
    assert isinstance(first["image"], list)  # ragged -> list of arrays
    assert first["image"][0].shape == (32, 32, 3)
    assert first["image"][2].shape == (64, 32, 3)
    # second batch is uniform again (all big frames) -> stacked
    assert batches[1]["image"].shape == (4, 64, 32, 3)


def test_loader_uses_batched_stream_on_shm(tmp_path):
    from blendjax_torch.btt.dataset import RemoteIterableDataset
    from blendjax_torch.btt.loader import BatchLoader

    addr = _addr("zc-loader")
    t = threading.Thread(target=_produce_n, args=(addr, 3, 16), daemon=True)
    t.start()
    ds = RemoteIterableDataset([addr], max_items=16, timeoutms=10000)
    with BatchLoader(ds, batch_size=8, num_workers=1) as loader:
        batches = list(loader)
    t.join(timeout=10)
    assert len(batches) == 2
    assert batches[0]["image"].shape == (8, 32, 32, 3)
    assert batches[0]["btid"].tolist() == [3] * 8


def test_stream_batches_nested_container_arrays():
    """Arrays nested inside list values must decode (not leak raw
    placeholders) and stack exactly like the generic collate path."""
    from blendjax_torch.btb.publisher import DataPublisher
    from blendjax_torch.btt.dataset import RemoteIterableDataset

    addr = _addr("zc-nested")

    def produce():
        pub = DataPublisher(addr, btid=0, raw_buffers=True, sndtimeoms=500)
        i = 0
        while i < 8:
            pts = [np.full((3, 2), i, np.float32), np.full((3, 2), i + 1, np.float32)]
            if pub.publish(points=pts, frameid=i):
                i += 1
        pub.close()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    ds = RemoteIterableDataset([addr], max_items=8, timeoutms=10000)
    batches = list(ds.stream_batches(4))
    t.join(timeout=10)
    assert len(batches) == 2
    pts = batches[0]["points"]
    # list of 2 positions, each stacked over the batch -> (4, 3, 2)
    assert isinstance(pts, list) and len(pts) == 2
    assert pts[0].shape == (4, 3, 2) and pts[0].dtype == np.float32
    np.testing.assert_array_equal(pts[0][:, 0, 0], [0, 1, 2, 3])
    np.testing.assert_array_equal(pts[1][:, 0, 0], [1, 2, 3, 4])


def test_stream_batches_key_semantics_match_generic_collate():
    """Missing first-message key -> KeyError; extra later key -> dropped."""
    from blendjax_torch.btb.publisher import DataPublisher
    from blendjax_torch.btt.dataset import RemoteIterableDataset

    addr = _addr("zc-keys")

    def produce(msgs):
        pub = DataPublisher(addr, btid=0, raw_buffers=True, sndtimeoms=500)
        i = 0
        while i < len(msgs):
            if pub.publish(**msgs[i]):
                i += 1
        pub.close()

    img = np.zeros((4, 4), np.uint8)
    # message 2 grows an extra key (dropped); message 3 is complete again
    msgs = [
        {"image": img, "frameid": 0},
        {"image": img, "frameid": 1},
        {"image": img, "frameid": 2, "extra": 7},
        {"image": img, "frameid": 3},
    ]
    t = threading.Thread(target=produce, args=(msgs,), daemon=True)
    t.start()
    ds = RemoteIterableDataset([addr], max_items=4, timeoutms=10000)
    (batch,) = list(ds.stream_batches(4))
    t.join(timeout=10)
    assert "extra" not in batch
    assert batch["frameid"].tolist() == [0, 1, 2, 3]

    # missing key fails loudly instead of silently misaligning slots
    addr2 = _addr("zc-keys2")

    def produce2():
        pub = DataPublisher(addr2, btid=0, raw_buffers=True, sndtimeoms=500)
        ms = [{"image": img, "frameid": 0}, {"image": img}]
        i = 0
        while i < len(ms):
            if pub.publish(**ms[i]):
                i += 1
        pub.close()

    t2 = threading.Thread(target=produce2, daemon=True)
    t2.start()
    ds2 = RemoteIterableDataset([addr2], max_items=2, timeoutms=10000)
    with pytest.raises(KeyError):
        list(ds2.stream_batches(2))
    t2.join(timeout=10)


def test_item_override_disables_batched_stream():
    """A subclass overriding _item() (the documented override point) must
    NOT be routed through the zero-copy batched path, which would silently
    skip its per-item transform; it falls back to stream() + collate and
    the transform is applied."""
    from blendjax_torch.btt.dataset import RemoteIterableDataset
    from blendjax_torch.btt.loader import BatchLoader

    class Doubling(RemoteIterableDataset):
        def _item(self, item):
            item["frameid"] = item["frameid"] * 2
            return item

    addr = _addr("zc-override")
    t = threading.Thread(target=_produce_n, args=(addr, 0, 8), daemon=True)
    t.start()
    ds = Doubling([addr], max_items=8, timeoutms=10000)
    assert not ds.supports_batched_stream()
    with BatchLoader(ds, batch_size=4, num_workers=1) as loader:
        batches = list(loader)
    t.join(timeout=10)
    assert len(batches) == 2
    got = sorted(
        int(v) for b in batches for v in np.asarray(b["frameid"]).ravel()
    )
    assert got == [0, 2, 4, 6, 8, 10, 12, 14]


def test_reader_survives_producer_respawn():
    """Generation change: a respawned producer's bjr_create unlinks and
    recreates the ring; the reader must drain the old generation's buffered
    records, detect the identity change, and remap the new ring."""
    addr = _addr("gen")
    w_a = nring.ShmRingWriter(addr, capacity_bytes=1 << 16)
    r = nring.ShmRingReader(addr)
    assert w_a.send_frames([b"a0"]) and w_a.send_frames([b"a1"])
    assert r.recv_frames(1000) == [b"a0"]
    # producer "crashes" (never calls close -> producer_closed stays 0)
    # and is respawned under the same address
    w_b = nring.ShmRingWriter(addr, capacity_bytes=1 << 16)
    assert w_b.send_frames([b"b0"])
    # old generation drains first; then the reader reopens transparently
    assert r.recv_frames(5000) == [b"a1"]
    assert r.recv_frames(5000) == [b"b0"]
    assert r.reconnects == 1
    r.close()
    w_b.close(unlink=True)
    w_a.close(unlink=False)  # stale mapping cleanup, nothing to unlink


def test_reader_raises_when_ring_gone_for_good():
    """Producer crashed and nothing respawned it: the reader must fail
    with a distinguishable error within the timeout, not hang."""
    addr = _addr("gone")
    w = nring.ShmRingWriter(addr, capacity_bytes=1 << 14)
    r = nring.ShmRingReader(addr)
    nring.unlink_address(addr)
    with pytest.raises(ConnectionResetError, match="vanished"):
        r.recv_frames(1200)
    r.close()
    w.close(unlink=False)


def test_reader_auto_reopen_disabled():
    addr = _addr("noreopen")
    w_a = nring.ShmRingWriter(addr, capacity_bytes=1 << 14)
    r = nring.ShmRingReader(addr, auto_reopen=False)
    w_b = nring.ShmRingWriter(addr, capacity_bytes=1 << 14)
    with pytest.raises(ConnectionResetError):
        r.recv_frames(1200)
    r.close()
    w_b.close(unlink=True)
    w_a.close(unlink=False)


# -- across the packages ------------------------------------------------------


def _jring():
    from blendjax.native import ring as jring

    if not jring.native_available():
        pytest.skip("the reference's ring did not build")
    return jring


def test_port_loads_its_own_library():
    jring = _jring()
    assert nring.native_available()
    assert os.path.basename(nring._LIB._name) == "libblendjax_torch_ring.so"
    assert os.path.realpath(nring._LIB._name) != os.path.realpath(jring._LIB._name)
    assert os.path.dirname(nring.LIBRARY).endswith(os.path.join("build", "native"))


@pytest.mark.parametrize("direction", ["port->ref", "ref->port"])
def test_cross_package_frames_byte_equal_across_wrap_and_reopen(direction):
    """Either package's writer feeds the other's reader: the record layout
    is the same byte for byte.  A 16 KiB ring carries 200 records (the
    wrap marker many times over), then the writer is replaced under the
    same name and the reader drains the old generation and reopens."""
    jring = _jring()
    wmod, rmod = (nring, jring) if direction == "port->ref" else (jring, nring)
    addr = _addr(f"x-{direction[:4]}")
    rng = np.random.default_rng(0)
    frames = [[i.to_bytes(4, "little"), rng.bytes(int(rng.integers(1, 1500))),
               np.full(int(rng.integers(1, 300)), i % 251, np.uint8)] for i in range(200)]
    w = wmod.ShmRingWriter(addr, capacity_bytes=1 << 14)
    r = rmod.ShmRingReader(addr)
    errors = []

    def produce():
        for f in frames:
            if not w.send_frames(f, timeout_ms=5000):
                errors.append(f[0])
                return

    t = threading.Thread(target=produce)
    t.start()
    try:
        for f in frames:
            got = r.recv_frames(timeout_ms=5000)
            assert got is not None
            assert [bytes(g) for g in got] == [bytes(x) for x in f]
    finally:
        t.join()
    assert not errors
    # the producer dies unclosed and is respawned under the same name
    assert w.send_frames([b"old"])
    w2 = wmod.ShmRingWriter(addr, capacity_bytes=1 << 14)
    assert w2.send_frames([b"new", b"gen"])
    assert r.recv_frames(5000) == [b"old"]
    assert r.recv_frames(5000) == [b"new", b"gen"]
    assert r.reconnects == 1
    r.close()
    w2.close(unlink=True)
    w.close(unlink=False)


def test_cross_package_large_frames_and_views():
    """Frames of 64 KiB and more (copied out natively) and the zero-copy
    views decode to the same message in both directions."""
    jring = _jring()
    from blendjax import wire as jwire

    img = np.arange(512 * 512, dtype=np.uint8).reshape(512, 512)
    msg = {"image": img, "xy": np.ones((8, 2), np.float32), "frameid": 7}
    for wmod, rmod, enc, dec in ((nring, jring, wire.encode, jwire.decode),
                                 (jring, nring, jwire.encode, wire.decode)):
        addr = _addr("x-big")
        w = wmod.ShmRingWriter(addr, capacity_bytes=8 << 20)
        r = rmod.ShmRingReader(addr)
        try:
            assert w.send_frames(enc(msg, raw_buffers=True), timeout_ms=1000)
            assert w.send_frames(enc(msg, raw_buffers=True), timeout_ms=1000)
            got = dec(r.recv_frames(timeout_ms=1000))
            np.testing.assert_array_equal(got["image"], img)
            views = r.recv_frames_view(timeout_ms=1000)
            got2 = dec([bytes(v) for v in views])
            r.release_record()
            np.testing.assert_array_equal(got2["xy"], msg["xy"])
            assert got["frameid"] == got2["frameid"] == 7
        finally:
            r.close()
            w.close(unlink=True)


def test_copies_byte_equal_to_numpy_and_reference():
    jring = _jring()
    rng = np.random.default_rng(1)
    for shape, dtype in (((480, 640, 3), np.uint8), ((64, 64, 4), np.float32),
                         ((3, 5), np.int16)):
        items = [rng.integers(0, 200, shape).astype(dtype) for _ in range(6)]
        want = np.stack(items)
        for got in (nring.fast_stack(items), jring.fast_stack(items)):
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        dst, jdst = np.empty_like(want), np.empty_like(want)
        nring.gather_into(dst, [memoryview(a).cast("B") for a in items])
        jring.gather_into(jdst, [memoryview(a).cast("B") for a in items])
        assert dst.tobytes() == jdst.tobytes() == want.tobytes()
        one, jone = np.empty_like(items[0]), np.empty_like(items[0])
        nring.copy_into(one, items[3])
        jring.copy_into(jone, items[3])
        assert one.tobytes() == jone.tobytes() == items[3].tobytes()
    with pytest.raises(ValueError):
        nring.gather_into(np.empty(3, np.uint8), [b"toolongbytes"])


def _arena_cases():
    """``tests/test_arena.py``'s message cases (raw and compat encodings)."""
    def nested(i):
        return {"image": np.full((8, 6, 3), i, np.uint8),
                "nested": {"xy": np.array([i, i + 1], np.float32),
                           "deep": {"flag": bool(i % 2)}, "tag": f"t{i}"},
                "tup": (np.arange(3, dtype=np.int32) + i, i * 1.5),
                "pts": [np.full((2, 2), i, np.float64)], "frameid": i}

    base = np.arange(96, dtype=np.int16).reshape(8, 12)
    return {
        "nested": ([nested(i) for i in range(4)], 4),
        "ragged_mixed": ([{"img": np.full((4 + i, 3), i, np.uint8),
                           "val": np.array([i], np.float32 if i < 2 else np.float64),
                           "k": i} for i in range(3)], 4),
        "non_contiguous": ([{"a": np.asfortranarray(base + i), "b": base[::2, ::3] + i}
                            for i in range(4)], 4),
        "large_rows": ([{"image": np.full((128, 160, 4), i, np.uint8), "frameid": i}
                        for i in range(4)], 4),
        "late_key_dropped": ([{"image": np.zeros((4, 4), np.uint8), "frameid": 0},
                              {"image": np.zeros((4, 4), np.uint8), "frameid": 1,
                               "late": 9}], 2),
    }


@pytest.mark.parametrize("arena", [False, True], ids=["no-arena", "recycled-arena"])
@pytest.mark.parametrize("raw", [True, False], ids=["raw", "compat"])
@pytest.mark.parametrize("case", list(_arena_cases()))
def test_eager_builder_over_shm_matches_reference(case, raw, arena):
    """Each message goes through a ring; both packages' eager builders copy
    it out of the same record view before it is released.  The batches
    (every leaf's bytes, dtype and shape, and the collated structure)
    are equal, and equal to ``stream() + collate``."""
    from test_torch_arena import assert_tree_equal

    from blendjax.btt.arena import ArenaPool as JArenaPool
    from blendjax.btt.dataset import _BatchBuilder as JBatchBuilder
    from blendjax_torch.btt.arena import ArenaPool
    from blendjax_torch.btt.collate import collate
    from blendjax_torch.btt.dataset import _BatchBuilder

    msgs, batch_size = _arena_cases()[case]
    pools = (JArenaPool(1), ArenaPool(1)) if arena else None
    addr = _addr(f"eager-{case}")
    w = nring.ShmRingWriter(addr, capacity_bytes=4 << 20)
    r = nring.ShmRingReader(addr)
    try:
        for trial in range(2):  # the second batch reuses the first one's arena
            arenas = [p.acquire(timeout=1) for p in pools] if pools else [None, None]
            builders = [JBatchBuilder(batch_size, arena=arenas[0], defer=False),
                        _BatchBuilder(batch_size, arena=arenas[1], defer=False)]
            items = []
            for m in msgs:
                assert w.send_frames(wire.encode(m, raw_buffers=raw), timeout_ms=1000)
                views = r.recv_frames_view(timeout_ms=1000)
                items.append(wire.decode([bytes(v) for v in views]))
                for b in builders:
                    b.add_message(views)
                r.release_record()
            ref, got = (b.finish() for b in builders)
            assert_tree_equal(ref, got)
            assert_tree_equal(collate(items), got)
            for a in arenas:
                if a is not None:
                    a.release()
    finally:
        r.close()
        w.close(unlink=True)


def test_collate_large_leaves_equal_the_reference():
    """``collate`` stacks leaves of 64 KiB or more through the native
    ``fast_stack``; its batches equal the reference's byte for byte."""
    from blendjax.btt.collate import collate as jcollate
    from blendjax_torch.btt.collate import collate

    rng = np.random.default_rng(2)
    items = [{"image": rng.integers(0, 255, (120, 160, 4), dtype=np.uint8),
              "xy": rng.random((8, 2)).astype(np.float32), "k": i} for i in range(5)]
    got, want = collate(items), jcollate(items)
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert got[key].tobytes() == want[key].tobytes()
