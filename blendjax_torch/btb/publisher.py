"""Data-plane publisher running inside Blender.

A PUSH socket that **binds** (consumers connect to all producers, giving
M:N fan-in with ZMQ fair queuing).  ``SNDHWM`` is small and
``IMMEDIATE=1`` so a producer stalls when the trainer lags instead of
buffering frames unboundedly.  Needs no ``bpy``.  Set
``raw_buffers=True`` for the zero-copy multipart encoding of ndarray
payloads (see :mod:`blendjax_torch.wire`); leave it False for byte-compat
with blendtorch consumers.  A ``shm://`` address writes a same-host
shared-memory ring instead (:mod:`blendjax_torch.native.ring`): one copy
into the arena, no socket.
"""

from __future__ import annotations

import zmq

from blendjax_torch import wire


class DataPublisher:
    """Publishes message dicts to connected consumers.

    Params
    ------
    bind_address: str
        Address to bind, e.g. ``tcp://127.0.0.1:11000`` (from
        ``-btsockets DATA=...``).
    btid: int | None
        Producer id stamped into every message.
    send_hwm: int
        High-water mark; send blocks once this many messages queue.
    raw_buffers: bool
        Use zero-copy multipart encoding for ndarrays.
    sndtimeoms: int | None
        When set, :meth:`publish` returns False instead of blocking past
        this many milliseconds of backpressure.
    shm_capacity: int
        Ring size in bytes for a ``shm://`` address.
    """

    def __init__(
        self,
        bind_address,
        btid=None,
        send_hwm=wire.DEFAULT_HWM,
        raw_buffers=False,
        sndtimeoms=None,
        shm_capacity=64 << 20,
    ):
        self.btid = btid
        self.raw_buffers = raw_buffers
        self._sndtimeoms = -1 if sndtimeoms is None else sndtimeoms
        self.sock = None
        self._ring = None
        if bind_address.startswith("shm://"):
            from blendjax_torch.native import ShmRingWriter

            self._ring = ShmRingWriter(bind_address, capacity_bytes=shm_capacity)
            return
        self._ctx = zmq.Context.instance()
        self.sock = self._ctx.socket(zmq.PUSH)
        self.sock.setsockopt(zmq.SNDHWM, send_hwm)
        self.sock.setsockopt(zmq.IMMEDIATE, 1)
        self.sock.setsockopt(zmq.LINGER, 0)
        if sndtimeoms is not None:
            self.sock.setsockopt(zmq.SNDTIMEO, sndtimeoms)
        self.sock.bind(bind_address)

    def publish(self, **kwargs):
        """Send one message dict; blocks under backpressure.

        ``btid`` is stamped automatically.  With ``sndtimeoms`` set,
        returns False instead of blocking past the timeout.
        """
        data = {wire.BTID_KEY: self.btid, **kwargs}
        if self._ring is not None:
            frames = wire.encode(data, raw_buffers=self.raw_buffers)
            return self._ring.send_frames(frames, timeout_ms=self._sndtimeoms)
        try:
            wire.send_message(self.sock, data, raw_buffers=self.raw_buffers)
        except zmq.Again:
            return False
        return True

    def close(self):
        if self._ring is not None:
            self._ring.close(unlink=False)  # the reader may still drain
            self._ring = None
        if self.sock is not None:
            self.sock.close(0)
            self.sock = None
