"""Wire protocol shared by producer (Blender) and consumer (training host).

Byte-compatible with ``blendjax.wire`` and with blendtorch producers: every
socket carries one of two encodings, auto-detected per message.

1. **compat** — one frame holding ``pickle.dumps(dict)``, the encoding
   blendtorch's ``send_pyobj``/``recv_pyobj`` speak.
2. **raw-buffer** — multipart ``[header, buf0, buf1, ...]``: the header is
   a pickled dict with ndarray leaves replaced by placeholders, and the
   array payloads ride as separate zero-copy ZMQ frames.  Decoding is an
   ``np.frombuffer`` view per array instead of a pickle memcpy.

Pickle protocol is pinned to 4, the newest that Blender 2.8x's bundled
Python 3.7 reads.

zmq appears here only in annotations: the socket helpers call methods of
the socket they are handed, so the record/replay route (which encodes and
decodes without sockets) imports without pyzmq installed.
"""

from __future__ import annotations

import pickle
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - annotations only
    import zmq

#: Newest pickle protocol readable by every Blender >= 2.80 (Python >= 3.7).
PICKLE_PROTOCOL = 4

#: Default high-water mark on both ends of the data plane.  Small on purpose:
#: a slow trainer stalls producers (backpressure) instead of buffering
#: unboundedly.
DEFAULT_HWM = 10

#: Key stamped into every data-plane message identifying the producer.
BTID_KEY = "btid"

#: Key under which a raw-buffer header stores an ndarray leaf's payload
#: frame index.  The same string as ``blendjax.wire`` — it is protocol.
ARRAY_PLACEHOLDER = "__bjx_nd__"


def is_array_placeholder(obj) -> bool:
    """True for a raw-buffer header's stand-in for an ndarray leaf."""
    return isinstance(obj, dict) and ARRAY_PLACEHOLDER in obj


def dumps(obj) -> bytes:
    return pickle.dumps(obj, protocol=PICKLE_PROTOCOL)


# ---------------------------------------------------------------------------
# raw-buffer encoding
# ---------------------------------------------------------------------------


def _strip_arrays(obj, bufs: list):
    """Replace ndarray leaves in a nested container with placeholders.
    Non-contiguous arrays are copied once."""
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        bufs.append(arr)
        return {
            ARRAY_PLACEHOLDER: len(bufs) - 1,
            "dtype": arr.dtype.str,
            # the ORIGINAL shape: ascontiguousarray promotes 0-d arrays
            # to (1,), which would silently grow a rank on the receiver
            "shape": obj.shape,
        }
    if isinstance(obj, dict):
        return {k: _strip_arrays(v, bufs) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        seq = [_strip_arrays(v, bufs) for v in obj]
        return seq if isinstance(obj, list) else tuple(seq)
    return obj


def _restore_arrays(obj, frames):
    if isinstance(obj, dict):
        if ARRAY_PLACEHOLDER in obj:
            idx = obj[ARRAY_PLACEHOLDER]
            arr = np.frombuffer(frames[idx], dtype=np.dtype(obj["dtype"]))
            return arr.reshape(obj["shape"])
        return {k: _restore_arrays(v, frames) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        seq = [_restore_arrays(v, frames) for v in obj]
        return seq if isinstance(obj, list) else tuple(seq)
    return obj


def encode(data: dict, raw_buffers: bool = False) -> list:
    """Encode a message dict into a list of ZMQ frames."""
    if not raw_buffers:
        return [dumps(data)]
    bufs: list = []
    header = _strip_arrays(data, bufs)
    return [dumps(header)] + bufs


def decode(frames) -> dict:
    """Decode frames produced by :func:`encode` (either encoding)."""
    head = pickle.loads(frames[0])
    if len(frames) == 1:
        return head
    return _restore_arrays(head, [memoryview(f) for f in frames[1:]])


# ---------------------------------------------------------------------------
# socket send/recv
# ---------------------------------------------------------------------------


def send_message(socket: zmq.Socket, data: dict, raw_buffers: bool = False,
                 flags: int = 0):
    """Send one message."""
    frames = encode(data, raw_buffers=raw_buffers)
    if len(frames) == 1:
        socket.send(frames[0], flags=flags)
    else:
        socket.send_multipart(frames, flags=flags, copy=False)


def recv_message(socket: zmq.Socket, flags: int = 0) -> dict:
    """Receive and decode one message (zero-copy array views)."""
    frames = socket.recv_multipart(flags=flags, copy=False)
    return decode([f.buffer for f in frames])


def recv_message_raw(socket: zmq.Socket, flags: int = 0):
    """Receive without decoding; returns the raw frame list (bytes).  The
    stream recorder persists these verbatim."""
    return socket.recv_multipart(flags=flags, copy=True)
