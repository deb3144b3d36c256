"""The port's ShmRPC transport (``blendjax_torch.btt.shm_rpc``,
``transport.py``, ``rpc.py``) on the CPU.

1. The cases of ``tests/test_shm_rpc.py`` against the port: the duplex
   ring channel, the doorbell, the upgrade at the second RPC, the kill
   switch, demotion and re-upgrade, the use-after-release guard, and
   ``/dev/shm`` hygiene.  (Its replay-shard
   and hub cases wait for those tiers, ROADMAP Queue 1, item 9; the serve
   tier's byte accounting stands in for the first.)
2. Across the packages: the reference's ``ServeClient`` upgrades against
   the port's ``PolicyServer`` and the port's client against the
   reference's server; ``transport == "shm"`` and predictions within
   1e-5 (absolute, plus 1e-5 relative) of the same client over tcp.
3. Exactly-once through frame-layer faults (``ShmChaos``): a duplicated
   request, a dropped reply whose retry rides the demoted ZMQ path, and
   the re-upgrade onto a fresh ring generation; every prediction equal to
   a reference model stepped once per request (exact).
"""

import os
import threading
import time

import numpy as np
import pytest
import zmq

from blendjax_torch import wire
from blendjax_torch.btt import shm_rpc
from blendjax_torch.btt.transport import RpcChannel
from blendjax_torch.utils.timing import EventCounters

pytestmark = pytest.mark.skipif(
    not shm_rpc.enabled(), reason="shm rpc unavailable on this host"
)


class EchoServer:
    """A minimal REP + ShmRPC server: echoes payloads, counts serves.
    The transport without a tier on top."""

    def __init__(self, base=None):
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.REP)
        self.port = self.sock.bind_to_random_port("tcp://127.0.0.1")
        self.address = f"tcp://127.0.0.1:{self.port}"
        self.counters = EventCounters()
        self.transport = shm_rpc.ShmRpcServer(base or shm_rpc.new_base("echo"),
                                              self.counters)
        self.served = {"tcp": 0, "shm": 0}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _reply(self, msg):
        reply = {"echo": msg.get("x"), "arr": msg.get("arr")}
        mid = msg.get(wire.BTMID_KEY)
        if mid is not None:
            reply[wire.BTMID_KEY] = mid
        return reply

    def _serve(self):
        poller = zmq.Poller()
        poller.register(self.sock, zmq.POLLIN)
        poller.register(self.transport.fd, zmq.POLLIN)
        while not self._stop.is_set():
            try:
                events = dict(poller.poll(20))
            except zmq.ZMQError:
                return

            def on_shm(chan, msg):
                self.served["shm"] += 1
                self.transport.send(chan, self._reply(msg))

            self.transport.pump(on_shm)
            if self.sock in events:
                msg = wire.recv_message(self.sock)
                reply = shm_rpc.control_reply(self.transport, msg)
                if reply is None:
                    self.served["tcp"] += 1
                    reply = self._reply(msg)
                wire.send_message(self.sock, reply, raw_buffers=True)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.sock.close(0)
        self.transport.close(unlink=True)


def rpc(chan, payload, raw=False, timeout_ms=2000):
    msg = dict(payload)
    mid = wire.stamp_message_id(msg)
    chan.send_request(msg, raw_buffers=raw)
    deadline = time.monotonic() + timeout_ms / 1000.0
    while time.monotonic() < deadline:
        if chan.poll_reply(50):
            r = chan.recv_reply()
            if r is not None and r.get(wire.BTMID_KEY) == mid:
                return r
    chan.notify_timeout()
    raise TimeoutError("no echo reply")


@pytest.fixture
def echo():
    srv = EchoServer()
    yield srv
    srv.close()
    assert not shm_rpc.leaked_objects(srv.transport.base)


def test_upgrade_at_second_rpc_and_roundtrip(echo):
    chan = RpcChannel(echo.address)
    try:
        assert rpc(chan, {"cmd": "echo", "x": 1})["echo"] == 1
        assert chan.transport == "tcp"
        assert rpc(chan, {"cmd": "echo", "x": 2})["echo"] == 2
        assert chan.transport == "shm"  # upgraded at RPC #2
        # array payloads ride the raw-buffer encoding unchanged
        arr = np.arange(50000, dtype=np.float32).reshape(100, 500)
        r = rpc(chan, {"cmd": "echo", "x": 3, "arr": arr}, raw=True)
        np.testing.assert_array_equal(np.asarray(r["arr"]), arr)
        assert echo.served["shm"] >= 2 and echo.served["tcp"] == 1
        # wire-bytes accounting: the shm side moved the payloads
        assert echo.counters.get("serve_shm_bytes") > arr.nbytes
    finally:
        chan.close()


def test_kill_switch_pins_to_zmq(echo, monkeypatch):
    monkeypatch.setenv(shm_rpc.KILL_ENV, "1")
    chan = RpcChannel(echo.address)
    try:
        for i in range(4):
            rpc(chan, {"cmd": "echo", "x": i})
        assert chan.transport == "tcp"
        assert echo.served["shm"] == 0
    finally:
        chan.close()


def test_server_side_kill_switch_refuses_upgrade(monkeypatch):
    """A server built with the kill-switch set answers shm_connect with
    a refusal; the client pins to ZMQ permanently (state 'off')."""
    monkeypatch.setenv(shm_rpc.KILL_ENV, "1")
    assert not shm_rpc.enabled()
    reply = shm_rpc.control_reply(None, {"cmd": "shm_connect",
                                         "btmid": "m1"})
    assert "error" in reply and reply["btmid"] == "m1"
    # non-control traffic passes through untouched
    assert shm_rpc.control_reply(None, {"cmd": "gather"}) is None


def test_host_token_mismatch_refused(echo):
    chan = RpcChannel(echo.address)
    try:
        rpc(chan, {"cmd": "echo", "x": 0})
        # forge a foreign host token: the server must refuse BEFORE
        # paying any ring-open timeout
        r = chan._rpc_inline(
            {"cmd": "shm_connect", "host": "otherhost|deadbeef"}, 1000
        )
        assert "error" in r and "host token" in r["error"]
    finally:
        chan.close()


def test_oversized_request_rides_zmq_channel_stays(echo, monkeypatch):
    monkeypatch.setattr(shm_rpc, "REQ_CAPACITY", 1 << 20)
    chan = RpcChannel(echo.address)
    try:
        rpc(chan, {"cmd": "echo", "x": 0})
        rpc(chan, {"cmd": "echo", "x": 1})
        assert chan.transport == "shm"
        big = np.zeros(2 << 20, np.uint8)  # 2 MiB > the 1 MiB ring
        r = rpc(chan, {"cmd": "echo", "x": 9, "arr": big}, raw=True)
        assert np.asarray(r["arr"]).nbytes == big.nbytes
        # the oversized message rode ZMQ; the channel stayed upgraded
        assert chan.transport == "shm"
        assert echo.served["tcp"] >= 2
    finally:
        chan.close()


def test_oversized_reply_demotes_and_retry_rides_zmq():
    """A reply that cannot fit the reply ring must NOT become a
    permanent remote error: the server answers with the OVERFLOW_KEY
    stand-in, the channel demotes, and the same-mid retry is served
    over ZMQ — where any size fits."""
    srv = EchoServer()
    # a tiny reply ring (set BEFORE the upgrade creates it), so a
    # modest array reply overflows it
    srv.transport.rep_capacity = 1 << 16
    chan = RpcChannel(srv.address)
    try:
        rpc(chan, {"cmd": "echo", "x": 0})
        rpc(chan, {"cmd": "echo", "x": 1})
        assert chan.transport == "shm"
        big = np.zeros(1 << 20, np.uint8)

        # the RPC must still SUCCEED (served over zmq after the demote)
        msg = {"cmd": "echo", "x": 9, "arr": big}
        mid = wire.stamp_message_id(msg)
        chan.send_request(msg, raw_buffers=True)
        deadline = time.monotonic() + 3
        reply = None
        while time.monotonic() < deadline and reply is None:
            if chan.poll_reply(50):
                r = chan.recv_reply()
                if r is not None and r.get(wire.BTMID_KEY) == mid:
                    reply = r
            elif chan.transport == "tcp":
                # demoted: re-send the SAME mid over zmq (what the
                # FaultPolicy retry does in exactly_once_rpc)
                chan.send_request(msg, raw_buffers=True)
        assert reply is not None and "error" not in reply, reply
        assert np.asarray(reply["arr"]).nbytes == big.nbytes
        assert chan.transport == "tcp"  # demoted by the overflow
    finally:
        chan.close()
        srv.close()


def test_reply_to_dropped_channel_never_segfaults(echo):
    """Replying to a channel whose writer was closed must be a False
    return, not a NULL-handle native call."""
    chan = RpcChannel(echo.address)
    try:
        rpc(chan, {"cmd": "echo", "x": 0})
        rpc(chan, {"cmd": "echo", "x": 1})
        assert chan.transport == "shm"
        server_chan = next(iter(echo.transport._channels.values()))
        server_chan.writer.close(unlink=False)
        assert echo.transport.send(server_chan, {"x": 1}) is False
        with pytest.raises(OSError):
            server_chan.writer.send_frames([b"x"])
    finally:
        chan.close()


def test_dead_server_demotes_then_fresh_generation_heals():
    """The respawn-heal contract at the transport layer: server dies ->
    attempt times out -> channel demotes to ZMQ -> a NEW server on the
    same endpoint answers -> the channel re-upgrades onto its fresh
    ring generation."""
    srv = EchoServer()
    address = srv.address
    chan = RpcChannel(address)
    try:
        rpc(chan, {"cmd": "echo", "x": 0})
        rpc(chan, {"cmd": "echo", "x": 1})
        assert chan.transport == "shm"
        gen1 = chan.generations
        srv.close()  # rings unlinked: the reader sees the ring vanish
        with pytest.raises(TimeoutError):
            rpc(chan, {"cmd": "echo", "x": 2}, timeout_ms=400)
        assert chan.transport == "tcp"  # demoted
        # a fresh incarnation binds the SAME tcp endpoint, new shm base
        srv2 = EchoServer()
        sock = zmq.Context.instance().socket(zmq.REP)
        try:
            # (cannot rebind the exact port reliably; just point the
            # channel at the new server's endpoint — ZMQ reconnect is
            # what a respawned same-port server exercises)
            chan.address = srv2.address
            chan.reset()
            rpc(chan, {"cmd": "echo", "x": 3})
            chan._backoff_s = 0.0  # no need to wait out the backoff
            chan._next_try = 0.0
            rpc(chan, {"cmd": "echo", "x": 4})
            assert chan.transport == "shm"
            assert chan.generations == gen1 + 1
        finally:
            sock.close(0)
            srv2.close()
    finally:
        chan.close()


def test_doorbell_wakes_and_drains(tmp_path):
    from blendjax_torch.native.ring import DoorBell

    path = "/dev/shm/bjx-test-t-bell-%d" % os.getpid()
    owner = DoorBell(path, create=True)
    writer = DoorBell(path)
    try:
        import select

        r, _, _ = select.select([owner.fd], [], [], 0)
        assert not r
        writer.ding()
        r, _, _ = select.select([owner.fd], [], [], 1.0)
        assert r
        assert owner.drain() >= 1
        r, _, _ = select.select([owner.fd], [], [], 0)
        assert not r  # drained
        # no reader / vanished bell: ding is best-effort, never raises
        owner.close(unlink=True)
        writer.ding()
    finally:
        writer.close()
        owner.close(unlink=True)


def test_recv_frames_view_use_after_release_poisoned():
    """With poisoning armed, a frame view kept past ``release_record`` raises instead of silently reading bytes
    the producer may already be overwriting."""
    from blendjax_torch.native.ring import ShmRingReader, ShmRingWriter

    name = f"shm://bjx-test-t-poison-{os.getpid()}"
    w = ShmRingWriter(name, capacity_bytes=1 << 20)
    r = ShmRingReader(name, poison=True)
    try:
        w.send_frames([b"abc", np.arange(10, dtype=np.uint8)])
        frames = r.recv_frames_view(1000)
        assert bytes(frames[0]) == b"abc"
        r.release_record()
        with pytest.raises(ValueError):
            bytes(frames[0])  # poisoned: the slot was freed
        with pytest.raises(ValueError):
            frames[1][0]
        # the reader keeps working normally afterwards
        w.send_frames([b"next"])
        frames = r.recv_frames_view(1000)
        assert bytes(frames[0]) == b"next"
        r.release_record()
    finally:
        r.close()
        w.close(unlink=True)


def test_unpoisoned_views_keep_legacy_behavior():
    from blendjax_torch.native.ring import ShmRingReader, ShmRingWriter

    name = f"shm://bjx-test-t-nopoison-{os.getpid()}"
    w = ShmRingWriter(name, capacity_bytes=1 << 20)
    r = ShmRingReader(name, poison=False)
    try:
        w.send_frames([b"abc"])
        frames = r.recv_frames_view(1000)
        r.release_record()
        bytes(frames[0])  # legacy: no guard (caller's contract)
    finally:
        r.close()
        w.close(unlink=True)


def test_unlink_base_sweeps_everything(echo):
    chan = RpcChannel(echo.address)
    rpc(chan, {"cmd": "echo", "x": 0})
    rpc(chan, {"cmd": "echo", "x": 1})
    assert chan.transport == "shm"
    base = echo.transport.base
    # rings + bells exist under the base prefix (server AND client
    # halves — the client names its objects under the server-allocated
    # channel prefix, so one sweep covers a SIGKILLed fleet's leavings)
    objs = shm_rpc.leaked_objects(base)
    assert any(".c2s" in p for p in objs)
    assert any(".s2c" in p for p in objs)
    assert any(p.endswith(".bell") for p in objs)
    removed = shm_rpc.unlink_base(base)
    assert set(removed) == set(objs)
    assert not shm_rpc.leaked_objects(base)
    chan.close()




# -- the serve tier over ShmRPC ------------------------------------------------


def test_serve_counts_bytes_by_wire():
    """The same workload lands on ``serve_shm_bytes`` when the client
    upgraded and on ``serve_wire_bytes`` when it is pinned to ZMQ."""
    from blendjax_torch.serve import LinearModel, ServeClient, start_server_thread

    counters = EventCounters()
    obs = np.arange(4, dtype=np.float32)
    with start_server_thread(LinearModel(obs_dim=4, slots=2), counters=counters) as h:
        shm_client = ServeClient(h.address, counters=EventCounters())
        shm_client.reset()
        for _ in range(4):
            shm_client.step(obs)
        assert shm_client.transport == "shm"
        shm_bytes = counters.get("serve_shm_bytes")
        assert shm_bytes > 4 * obs.nbytes
        wire_before = counters.get("serve_wire_bytes")
        tcp_client = ServeClient(h.address, counters=EventCounters(), shm=False)
        tcp_client.reset()
        for _ in range(4):
            tcp_client.step(obs)
        assert tcp_client.transport == "tcp"
        assert counters.get("serve_shm_bytes") == shm_bytes
        assert counters.get("serve_wire_bytes") > wire_before + 4 * obs.nbytes
        shm_client.close()
        tcp_client.close()


def _episode_preds(client_cls, address, episode, **kw):
    c = client_cls(address, timeoutms=20000, **kw)
    c.reset(prefix=episode[:3])
    preds = [c.step(o)["pred"] for o in episode[3:]]
    transport = c.transport
    c.close_episode()
    c.close()
    return np.stack(preds), transport


def _seqformer_pair():
    """One small SeqFormer's weights for both packages' servers."""
    import jax

    from blendjax.models import seqformer as jseq
    from blendjax_torch.models.convert import params_from_jax

    tree = jax.device_get(jseq.init(jax.random.PRNGKey(3), obs_dim=5, d_model=32, n_heads=4,
                                    n_layers=2, max_len=32))
    return tree, params_from_jax(tree, device="cpu")


@pytest.mark.parametrize("direction", ["ref client -> port server",
                                       "port client -> ref server"])
def test_cross_package_upgrade(direction):
    """Either package's client upgrades to ShmRPC against the other's
    server; its predictions equal the same client's over tcp within 1e-5."""
    import jax
    import jax.numpy as jnp

    from blendjax.serve import SeqFormerModel as JSeqFormerModel
    from blendjax.serve import ServeClient as JClient
    from blendjax.serve import start_server_thread as jstart
    from blendjax_torch.serve import SeqFormerModel, ServeClient, start_server_thread

    tree, params = _seqformer_pair()
    episode = np.random.default_rng(0).standard_normal((12, 5)).astype(np.float32)
    if direction.startswith("ref client"):
        client_cls = JClient

        def server():
            return start_server_thread(SeqFormerModel(params, slots=2, length=16))
    else:
        client_cls = ServeClient

        def server():
            return jstart(JSeqFormerModel(jax.tree.map(jnp.asarray, tree), slots=2,
                                          length=16))
    out = {}
    for arm in (False, "auto"):
        with server() as h:
            out[arm] = _episode_preds(client_cls, h.address, episode, shm=arm)
    assert out[False][1] == "tcp" and out["auto"][1] == "shm"
    np.testing.assert_allclose(out["auto"][0], out[False][0], atol=1e-5, rtol=1e-5)


def test_exactly_once_through_shm_chaos():
    """``tests/test_serve.py``'s shm arm on the port: a duplicated request
    stays on shm (the in-queue dedupe or the reply cache answers it), a
    dropped reply times out, demotes the channel and its same-mid retry is
    answered over ZMQ from the reply cache, and the channel re-upgrades
    onto a fresh ring generation.  Exactly one applied step per request:
    the linear model's position rides every prediction."""
    from blendjax_torch.btt.faults import FaultPolicy
    from blendjax_torch.serve import LinearModel, ServeClient, start_server_thread

    counters = EventCounters()
    ref = LinearModel(obs_dim=4, slots=2, seed=0)
    obs = np.arange(4, dtype=np.float32)
    chaos = shm_rpc.ShmChaos()
    with start_server_thread(LinearModel(obs_dim=4, slots=2, seed=0),
                             counters=counters) as h:
        client = ServeClient(
            h.address, counters=counters, timeoutms=400, shm_chaos=chaos,
            fault_policy=FaultPolicy(max_retries=4, backoff_base=0.02, backoff_max=0.1,
                                     circuit_threshold=0, seed=1))
        client.reset()
        ref.reset_rows(np.asarray([0]))
        preds = []
        for t in range(20):
            if t == 4:
                assert client.transport == "shm", "upgrade never happened"
                chaos.dup_next("up")      # duplicate a request in the ring
            if t == 8:
                chaos.drop_next("down")   # lose a reply: timeout, demote, retry
            preds.append(client.step(obs)["pred"])
        assert client.transport == "tcp"  # the dropped reply demoted the channel
        want = [ref.step_rows(np.asarray([0]), obs[None])[0] for _ in range(20)]
        np.testing.assert_array_equal(np.stack(preds), np.stack(want))
        snap = counters.snapshot()
        assert snap.get("retries", 0) >= 1
        assert snap.get("serve_cache_hits", 0) + snap.get("serve_dup_inflight", 0) >= 1, snap
        assert chaos.dropped >= 1 and chaos.duplicated >= 1
        # generation heal: once the live server answers on ZMQ and the
        # backoff has passed, the channel re-upgrades onto fresh rings
        time.sleep(1.1)
        for _ in range(3):
            preds.append(client.step(obs)["pred"])
        assert client.transport == "shm", "channel never re-upgraded"
        assert client._chan.generations == 2
        np.testing.assert_array_equal(
            np.stack(preds[-3:]),
            np.stack([ref.step_rows(np.asarray([0]), obs[None])[0] for _ in range(3)]))
        client.close()
