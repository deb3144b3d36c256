"""The port's duplex channels (``blendjax_torch._duplex``, ``btt.duplex``,
``btb.duplex``) on the cases of ``tests/test_duplex.py``: round trip and
stamping, the receive timeout, raw buffers, unique ordered ids, and the
fleet echo through the port's launcher with the port's fixture
``tests/blender/torch_duplex.blend.py``.  Then one round trip each way
between the JAX package's channel and the port's, on one wire."""

import threading

import numpy as np
import pytest

from blendjax.btb.duplex import DuplexChannel as JaxProducerDuplex
from blendjax.btt.duplex import DuplexChannel as JaxConsumerDuplex
from blendjax_torch import btb as tbtb
from blendjax_torch import btt as tbtt
from blendjax_torch.btb.duplex import DuplexChannel as ProducerDuplex
from blendjax_torch.btt.duplex import DuplexChannel as ConsumerDuplex
from blendjax_torch.btt.launcher import BlenderLauncher
from helpers import BLEND_SCRIPTS, FAKE_BLENDER
from helpers.producers import free_port


def _free_block(n):
    """The first of ``n`` consecutive free ports."""
    import socket

    for _ in range(50):
        base = free_port()
        try:
            for k in range(1, n):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", base + k))
            return base
        except OSError:
            continue
    raise RuntimeError(f"no {n} consecutive free ports")


def _pair(btid=7, raw=False, producer=ProducerDuplex, consumer=ConsumerDuplex):
    addr = f"tcp://127.0.0.1:{free_port()}"
    prod = producer(addr, btid=btid, raw_buffers=raw)
    cons = consumer(addr, btid=0, raw_buffers=raw)
    return prod, cons


def test_lazy_exports():
    assert tbtt.DuplexChannel is ConsumerDuplex and tbtb.DuplexChannel is ProducerDuplex
    assert tbtt.duplex.DuplexChannel is ConsumerDuplex
    assert tbtb.duplex.DuplexChannel is ProducerDuplex
    # each side keeps its own package's timeout, as the reference's
    assert ConsumerDuplex.DEFAULT_TIMEOUTMS == JaxConsumerDuplex.DEFAULT_TIMEOUTMS == 10000
    assert ProducerDuplex.DEFAULT_TIMEOUTMS == JaxProducerDuplex.DEFAULT_TIMEOUTMS == 5000


def test_roundtrip_and_stamping():
    prod, cons = _pair()
    try:
        mid = cons.send(payload={"x": 1})
        assert isinstance(mid, str) and len(mid) == 16
        msg = prod.recv(timeoutms=5000)
        assert msg["btid"] == 0 and msg["btmid"] == mid
        assert msg["payload"] == {"x": 1}

        mid2 = prod.send(reply=42)
        out = cons.recv(timeoutms=5000)
        assert out["btid"] == 7 and out["btmid"] == mid2 and out["reply"] == 42
    finally:
        prod.close()
        cons.close()


def test_recv_timeout_returns_none():
    prod, cons = _pair()
    try:
        assert cons.recv(timeoutms=0) is None
        assert cons.recv(timeoutms=100) is None
        assert prod.recv(timeoutms=0) is None
    finally:
        prod.close()
        cons.close()


def test_raw_buffer_arrays():
    prod, cons = _pair(raw=True)
    try:
        img = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
        cons.send(image=img)
        msg = prod.recv(timeoutms=5000)
        np.testing.assert_array_equal(msg["image"], img)
    finally:
        prod.close()
        cons.close()


def test_unique_message_ids():
    prod, cons = _pair()
    try:
        got = []

        def _drain():
            for _ in range(64):
                got.append(prod.recv(timeoutms=5000)["btmid"])

        t = threading.Thread(target=_drain)
        t.start()
        mids = [cons.send(i=i) for i in range(64)]
        t.join()
        assert len(set(mids)) == 64
        assert got == mids  # PAIR preserves order
    finally:
        prod.close()
        cons.close()


@pytest.mark.parametrize("consumer", [ConsumerDuplex, JaxConsumerDuplex],
                         ids=["port", "jax"])
def test_send_blocks_past_the_high_water_mark_then_times_out(consumer):
    """With nobody reading, sends of 256 KB queue up to the two sockets'
    HWMs (10 each) and the socket buffers, and then a send raises
    ``zmq.Again`` after the send timeout: the same backpressure in both
    packages."""
    import zmq

    addr = f"tcp://127.0.0.1:{free_port()}"
    prod = ProducerDuplex(addr, btid=1)
    cons = consumer(addr, btid=0, timeoutms=200)
    blob = bytes(256 << 10)
    try:
        sent = 0
        with pytest.raises(zmq.Again):
            for i in range(400):
                cons.send(i=i, blob=blob)
                sent += 1
        assert 10 <= sent < 400
        assert prod.recv(timeoutms=5000)["i"] == 0
    finally:
        prod.close()
        cons.close()


@pytest.mark.parametrize("num_instances", [2])
def test_fleet_echo(monkeypatch, num_instances):
    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)
    with BlenderLauncher(
        scene="",
        script=f"{BLEND_SCRIPTS}/torch_duplex.blend.py",
        num_instances=num_instances,
        named_sockets=["CTRL"],
        start_port=_free_block(num_instances),
        background=True,
        instance_args=[["--necho", "2"]] * num_instances,
    ) as bl:
        channels = [ConsumerDuplex(addr, btid=i)
                    for i, addr in enumerate(bl.launch_info.addresses["CTRL"])]
        try:
            for i, ch in enumerate(channels):
                m1 = ch.send(payload=f"hello-{i}")
                m2 = ch.send(payload=f"again-{i}")
                r1 = ch.recv(timeoutms=20000)
                r2 = ch.recv(timeoutms=20000)
                end = ch.recv(timeoutms=20000)
                assert r1["echo"] == f"hello-{i}" and r1["got_mid"] == m1
                assert r2["echo"] == f"again-{i}" and r2["got_mid"] == m2
                assert end["marker"] == "end"
                assert r1["btid"] == i  # stamped by producer instance
        finally:
            for ch in channels:
                ch.close()


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("direction", ["jax_producer", "port_producer"])
def test_round_trip_across_packages(direction, raw):
    """A port consumer against a JAX producer, and a JAX consumer against a
    port producer: each side reads what the other stamped."""
    if direction == "jax_producer":
        prod, cons = _pair(raw=raw, producer=JaxProducerDuplex, consumer=ConsumerDuplex)
    else:
        prod, cons = _pair(raw=raw, producer=ProducerDuplex, consumer=JaxConsumerDuplex)
    try:
        img = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
        mid = cons.send(shape_params=[4.0, 6.0], shape_id=3, image=img)
        msg = prod.recv(timeoutms=5000)
        assert msg["btid"] == 0 and msg["btmid"] == mid
        assert msg["shape_params"] == [4.0, 6.0] and msg["shape_id"] == 3
        np.testing.assert_array_equal(msg["image"], img)
        mid2 = prod.send(image=img * 2, shape_id=3)
        out = cons.recv(timeoutms=5000)
        assert out["btid"] == 7 and out["btmid"] == mid2 and out["shape_id"] == 3
        np.testing.assert_array_equal(out["image"], img * 2)
    finally:
        prod.close()
        cons.close()
