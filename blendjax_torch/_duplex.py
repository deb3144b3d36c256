"""Bidirectional PAIR-socket control channel, shared by both sides: a copy
of ``blendjax._duplex`` over the port's :mod:`blendjax_torch.wire`.

One class, and each side picks its role: the producer (Blender) binds,
the consumer connects.  This is the control plane over which a training
loop pushes new simulation parameters into running producers (the
densityopt workload, :mod:`blendjax_torch.densityopt`).  The wire format
is the JAX package's, byte for byte: either package's channel talks to the
other's.  Needs no torch.
"""

from __future__ import annotations

import zmq

from blendjax_torch import wire


class DuplexChannelBase:
    """PAIR socket with HWM-10 queues and send/recv timeouts.

    Params
    ------
    address: str
        ZMQ endpoint.
    btid: int | None
        Instance id stamped into outgoing messages.
    bind: bool
        Bind (producer side) instead of connect (consumer side).
    lingerms / timeoutms: int
        Socket teardown / send+recv timeouts.
    raw_buffers: bool
        Zero-copy multipart encoding for ndarray payloads.
    """

    DEFAULT_TIMEOUTMS = 10000

    def __init__(self, address, btid=None, bind=False, lingerms=0, timeoutms=None,
                 raw_buffers=False):
        if timeoutms is None:
            timeoutms = self.DEFAULT_TIMEOUTMS
        self.btid = btid
        self.raw_buffers = raw_buffers
        self._ctx = zmq.Context.instance()
        self.sock = self._ctx.socket(zmq.PAIR)
        self.sock.setsockopt(zmq.LINGER, lingerms)
        self.sock.setsockopt(zmq.RCVHWM, wire.DEFAULT_HWM)
        self.sock.setsockopt(zmq.SNDHWM, wire.DEFAULT_HWM)
        self.sock.setsockopt(zmq.SNDTIMEO, timeoutms)
        self.sock.setsockopt(zmq.RCVTIMEO, timeoutms)
        if bind:
            self.sock.bind(address)
        else:
            self.sock.connect(address)
        self.poller = zmq.Poller()
        self.poller.register(self.sock, zmq.POLLIN)

    def recv(self, timeoutms=None):
        """Next message dict, or None when ``timeoutms`` elapses.

        ``timeoutms=None`` blocks; ``0`` polls without blocking (the
        producer's per-frame pattern)."""
        if self.poller.poll(timeoutms):
            return wire.recv_message(self.sock)
        return None

    def send(self, **kwargs):
        """Send a message stamped with ``btid`` and a fresh message id
        (``btmid``); returns the id, for correlating replies.  Blocks up
        to the send timeout while :data:`wire.DEFAULT_HWM` messages wait
        for the peer, then raises ``zmq.Again``."""
        mid = wire.new_message_id()
        data = {wire.BTID_KEY: self.btid, wire.BTMID_KEY: mid, **kwargs}
        wire.send_message(self.sock, data, raw_buffers=self.raw_buffers)
        return mid

    def close(self):
        self.sock.close(0)
