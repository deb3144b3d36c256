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

import os
import pickle
import random as _random
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

#: Key stamped into an RPC request: a random per-message correlation id,
#: echoed in the reply.  The env layer matches pipelined replies by it, and
#: a producer answers a re-sent request carrying an id it has served from
#: its reply cache instead of simulating the frame twice.
BTMID_KEY = "btmid"

#: Key under which a tracing client stamps its span context into a request
#: (``{"trace": <correlation id>}``): a server that sees it records its own
#: recv->work->reply span and ships it back under :data:`SPANS_KEY`.
SPAN_KEY = "btspan"

#: Key under which a server piggybacks its recorded spans (a list of
#: chrome-tracing event dicts) on a reply.  Clients pop it before the reply
#: becomes user-visible data, whether or not they are tracing.
SPANS_KEY = "btspans"

#: Producer-side duplicate-suppression window, in replies: a retried
#: request (same :data:`BTMID_KEY`) is answered from the producer's reply
#: cache only while its reply is among the newest ``REPLY_CACHE_DEPTH``
#: served.  A protocol constant: the consumer's ``pipeline_depth`` must
#: stay within it, or a retry of the oldest in-flight request could
#: simulate a frame twice.
REPLY_CACHE_DEPTH = 8

#: Key under which a raw-buffer header stores an ndarray leaf's payload
#: frame index.  The same string as ``blendjax.wire`` — it is protocol.
ARRAY_PLACEHOLDER = "__bjx_nd__"


def is_array_placeholder(obj) -> bool:
    """True for a raw-buffer header's stand-in for an ndarray leaf."""
    return isinstance(obj, dict) and ARRAY_PLACEHOLDER in obj


#: process-local generator seeded once from the OS: message ids are drawn
#: without a syscall per message
_MID_RNG = _random.Random(os.urandom(16))


def new_message_id() -> str:
    """Random 8-byte hex message id.  The ids key the producer's reply
    cache, so the width keeps the chance that a fresh id collides with one
    of the :data:`REPLY_CACHE_DEPTH` cached ones negligible."""
    return f"{_MID_RNG.getrandbits(64):016x}"


def stamp_message_id(data: dict) -> str:
    """Stamp ``data`` with a fresh correlation id under :data:`BTMID_KEY`
    and return it.  Receivers that ignore the key keep working."""
    mid = new_message_id()
    data[BTMID_KEY] = mid
    return mid


def stamp_span_context(data: dict, trace: str) -> None:
    """Stamp a request with the span context that asks the server for a
    piggybacked span tagged ``trace`` (by convention the request's
    correlation id)."""
    data[SPAN_KEY] = {"trace": trace}


def pop_spans(reply: dict):
    """Remove and return a reply's piggybacked span list (None when the
    server attached none)."""
    return reply.pop(SPANS_KEY, None)


def dumps(obj) -> bytes:
    return pickle.dumps(obj, protocol=PICKLE_PROTOCOL)


def loads(buf):
    return pickle.loads(buf)


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


def frames_nbytes(frames) -> int:
    """Payload bytes of a frame list (the serve tier's wire accounting)."""
    return sum(memoryview(f).nbytes for f in frames)


def send_message(socket: zmq.Socket, data: dict, raw_buffers: bool = False,
                 flags: int = 0) -> int:
    """Send one message; returns its payload byte count."""
    frames = encode(data, raw_buffers=raw_buffers)
    if len(frames) == 1:
        socket.send(frames[0], flags=flags)
    else:
        socket.send_multipart(frames, flags=flags, copy=False)
    return frames_nbytes(frames)


def recv_message(socket: zmq.Socket, flags: int = 0) -> dict:
    """Receive and decode one message (zero-copy array views)."""
    return recv_message_sized(socket, flags)[0]


def recv_message_sized(socket: zmq.Socket, flags: int = 0):
    """:func:`recv_message` plus the payload byte count."""
    frames = socket.recv_multipart(flags=flags, copy=False)
    bufs = [f.buffer for f in frames]
    return decode(bufs), frames_nbytes(bufs)


def recv_message_raw(socket: zmq.Socket, flags: int = 0):
    """Receive without decoding; returns the raw frame list (bytes).  The
    stream recorder persists these verbatim."""
    return socket.recv_multipart(flags=flags, copy=True)


# ---------------------------------------------------------------------------
# DEALER <-> REP framing
# ---------------------------------------------------------------------------
#
# A DEALER socket talking to a REP peer emulates the REQ envelope: an empty
# delimiter frame ahead of the message body.  The REP socket strips it on
# the way in and restores it on the way out, so REP-socket producers
# (``btb.env.RemoteControlledAgent``) serve DEALER clients unmodified.
# Unlike REQ, a DEALER has no strict send/recv alternation: the pipelined
# EnvPool keeps several requests in flight per env over it.


def send_message_dealer(socket: zmq.Socket, data: dict, raw_buffers: bool = False,
                        flags: int = 0):
    """Send ``data`` from a DEALER socket to a REP peer (empty-delimiter
    framing)."""
    frames = encode(data, raw_buffers=raw_buffers)
    socket.send_multipart([b""] + frames, flags=flags, copy=not raw_buffers)


def recv_message_dealer(socket: zmq.Socket, flags: int = 0) -> dict:
    """Receive a REP peer's reply on a DEALER socket, stripping the empty
    delimiter frame the REP socket re-attached."""
    bufs = socket.recv_multipart(flags=flags, copy=True)
    if bufs and len(bufs[0]) == 0:
        bufs = bufs[1:]
    return decode(bufs)


# ---------------------------------------------------------------------------
# ROUTER <-> DEALER framing
# ---------------------------------------------------------------------------
#
# A ROUTER socket serves many DEALER clients: each request arrives behind
# the client's routing frame and the empty delimiter the client framed
# with, and the reply goes back behind both.  The same DEALER clients speak
# to REP and ROUTER servers unmodified.


def recv_message_router_sized(socket: zmq.Socket, flags: int = 0):
    """Receive one DEALER client's request on a ROUTER socket: returns
    ``(identity, message, payload bytes)``; ``identity`` is the routing
    frame to hand back to :func:`send_message_router`."""
    frames = socket.recv_multipart(flags=flags, copy=True)
    ident, body = frames[0], frames[1:]
    if body and len(body[0]) == 0:
        body = body[1:]
    return ident, decode(body), frames_nbytes(body)


def send_message_router(socket: zmq.Socket, ident: bytes, data: dict,
                        raw_buffers: bool = False, flags: int = 0) -> int:
    """Send ``data`` to the DEALER client behind routing frame ``ident``,
    restoring the empty delimiter; returns the payload byte count."""
    frames = encode(data, raw_buffers=raw_buffers)
    socket.send_multipart([ident, b""] + frames, flags=flags, copy=False)
    return frames_nbytes(frames)
