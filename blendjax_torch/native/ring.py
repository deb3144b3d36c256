"""ctypes bindings for the native SPSC shared-memory ring
(``ringbuf.cpp``) and the message framing it shares with the wire
protocol: the port's copy of ``blendjax.native.ring``.

Address scheme: ``shm://<name>``, accepted by
:class:`blendjax_torch.btb.publisher.DataPublisher` (the writer creates the
ring) and :class:`blendjax_torch.btt.dataset.RemoteIterableDataset` (the
reader opens it).  The launcher allocates these like tcp addresses when
``proto='shm'``.

Message framing inside a ring record re-uses the multipart wire encoding
(:func:`blendjax_torch.wire.encode`): ``u32 nframes``, then per frame
``u64 len``, then the bytes.  The layout is the JAX package's byte for
byte, so a writer of either package feeds a reader of the other.  Arrays
are copied out of the shared arena exactly once (the tcp path costs a
pickle copy and two kernel copies).

The library is the port's own, ``libblendjax_torch_ring.so``, built from
this directory's ``ringbuf.cpp`` with ``g++`` at first use into
``build/native/`` at the repository root (a directory ``.gitignore``
lists); it is written under a temporary name and renamed into place, so
producers and consumers racing through first use never load a partial
file.  If no compiler is available, ``native_available()`` returns False
and callers fall back to tcp.  Nothing here imports torch: the producer
side runs inside Blender.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "ringbuf.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
LIBRARY = os.path.join(BUILD_DIR, "libblendjax_torch_ring.so")
#: the reference's Makefile flags (``blendjax/native/Makefile``)
CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall"]
LDFLAGS = ["-shared", "-lrt"]
_BUILD_LOCK = threading.Lock()
_LIB = None
_LIB_ERR = None


def build_library():
    """Compile ``ringbuf.cpp`` into :data:`LIBRARY` unless an up-to-date
    build is there; returns the path.  Raises ``RuntimeError`` carrying the
    compiler's output when the build fails."""
    stale = not os.path.exists(LIBRARY) or (
        os.path.getmtime(SOURCE) > os.path.getmtime(LIBRARY))
    if stale:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{LIBRARY}.tmp.{os.getpid()}.{threading.get_ident()}"
        cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, SOURCE, "-o", tmp, *LDFLAGS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError(f"ring build: {' '.join(cmd)}: {exc}") from exc
        if proc.returncode != 0:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise RuntimeError(f"ring build failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, LIBRARY)  # atomic: a racing loader sees old or new
    return LIBRARY


def _load():
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is not None or _LIB_ERR is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(build_library())
            _bind(lib)
        except (OSError, RuntimeError, AttributeError) as exc:
            _LIB_ERR = exc
            return None
        _LIB = lib
        return _LIB


def load_error():
    """Why the library is unavailable (None when it loaded or was not
    tried yet)."""
    return _LIB_ERR


def _bind(lib):
    lib.bjr_create.restype = ctypes.c_void_p
    lib.bjr_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.bjr_open.restype = ctypes.c_void_p
    lib.bjr_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.bjr_write_v.restype = ctypes.c_int
    lib.bjr_write_v.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint32,
        ctypes.c_int,
    ]
    lib.bjr_read_acquire.restype = ctypes.c_int
    lib.bjr_read_acquire.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int,
    ]
    lib.bjr_read_release.argtypes = [ctypes.c_void_p]
    lib.bjr_vanished.restype = ctypes.c_int
    lib.bjr_vanished.argtypes = [ctypes.c_void_p]
    lib.bjr_pending.restype = ctypes.c_uint64
    lib.bjr_pending.argtypes = [ctypes.c_void_p]
    lib.bjr_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bjr_gather.restype = None
    lib.bjr_gather.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64,
    ]


def native_available() -> bool:
    return _load() is not None


def is_shm_address(address: str) -> bool:
    return isinstance(address, str) and address.startswith("shm://")


def shm_name_from_address(address: str) -> str:
    name = address[len("shm://"):]
    return name if name.startswith("/") else "/" + name


def _frame_ptr_len(obj):
    """(pointer, nbytes, keepalive) for a frame without copying.

    numpy arrays expose their data pointer directly; bytes via c_char_p.
    Anything else is materialized to bytes once.
    """
    import numpy as np

    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        return arr.ctypes.data, arr.nbytes, arr
    if not isinstance(obj, (bytes, bytearray)):
        obj = bytes(obj)
    buf = (ctypes.c_char * len(obj)).from_buffer_copy(obj) if isinstance(
        obj, bytearray
    ) else obj
    if isinstance(buf, bytes):
        ptr = ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value
        return ptr, len(buf), buf
    return ctypes.addressof(buf), len(obj), buf


#: Payload frames at or above this size copy out of the shm arena via the
#: native GIL-released memcpy; smaller ones use ``bytes`` (lower overhead).
_NATIVE_COPY_MIN_BYTES = 64 * 1024


def _split_record(buf: memoryview):
    """Parse a record written by ``bjr_write_v`` —
    ``u32 nframes | u64 len[n] | payloads`` — into (offset, length) pairs.
    The single source of truth for the record framing."""
    (nframes,) = struct.unpack_from("<I", buf, 0)
    lens = struct.unpack_from(f"<{nframes}Q", buf, 4)
    off = 4 + 8 * nframes
    spans = []
    for ln in lens:
        spans.append((off, ln))
        off += ln
    return spans


def _unpack_frames(lib, base_addr: int, buf: memoryview):
    """Copy a record's payloads out of the arena, exactly once each —
    large frames via ``bjr_gather`` with the GIL released (k loader
    threads copy on k cores), small ones via ``bytes``.
    """
    import numpy as np

    frames = []
    for off, ln in _split_record(buf):
        if ln >= _NATIVE_COPY_MIN_BYTES:
            out = np.empty(ln, np.uint8)
            ptrs = (ctypes.c_void_p * 1)(base_addr + off)
            lns = (ctypes.c_uint64 * 1)(ln)
            lib.bjr_gather(out.ctypes.data_as(ctypes.c_void_p), ptrs, lns, 1)
            frames.append(out)
        else:
            frames.append(bytes(buf[off : off + ln]))
    return frames


class ShmRingWriter:
    """Producer end of a shm ring (DataPublisher backend)."""

    def __init__(self, address, capacity_bytes=64 << 20):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                f"native ring unavailable (build failed: {_LIB_ERR}); use tcp"
            )
        self._lib = lib
        self.capacity_bytes = int(capacity_bytes)
        name = shm_name_from_address(address)
        self._h = lib.bjr_create(name.encode(), capacity_bytes)
        if not self._h:
            raise OSError(f"failed to create shm ring {name}")

    def send_frames(self, frames, timeout_ms=-1) -> bool:
        """Write one framed message; False on timeout (backpressure).

        Scatter-gather: each frame (numpy array or bytes) is memcpy'd once,
        directly into the shm arena by ``bjr_write_v`` with the GIL
        released — no Python-side join.
        """
        if self._h is None:
            # a closed writer must fail as an I/O error, not hand the
            # native layer a NULL handle (instant segfault): an RPC
            # server can race a reply against its own channel drop
            raise OSError("shm ring writer is closed")
        n = len(frames)
        ptrs = (ctypes.c_void_p * n)()
        lens = (ctypes.c_uint64 * n)()
        keep = []
        for i, f in enumerate(frames):
            ptr, ln, alive = _frame_ptr_len(f)
            ptrs[i] = ptr
            lens[i] = ln
            keep.append(alive)
        rc = self._lib.bjr_write_v(self._h, ptrs, lens, n, timeout_ms)
        del keep
        if rc == -2:
            raise ValueError("message larger than ring capacity")
        return rc == 0

    def close(self, unlink=True):
        if self._h:
            self._lib.bjr_close(self._h, int(unlink))
            self._h = None


class ShmRingReader:
    """Consumer end of a shm ring (dataset backend).

    Elasticity: a producer that crashes and is respawned (e.g. by
    :class:`blendjax_torch.btt.watchdog.FleetWatchdog`) recreates the ring under
    the same name — a new shm object the old mapping cannot see.  The
    native layer detects the identity change (rc -4) and, with
    ``auto_reopen`` (default), the reader transparently remaps the new
    generation and keeps streaming; ``reconnects`` counts generations for
    observability.  In-flight records of the dead generation that were
    fully written are drained first; partially-written ones were never
    visible (head publishes only complete records).

    ``poison=True`` (or ``BJX_SHM_POISON=1``) arms the use-after-release
    guard on :meth:`recv_frames_view`: :meth:`release_record` releases
    the handed-out memoryviews, so any access to a view after its ring
    slot was freed raises ``ValueError`` instead of silently reading
    bytes the producer may already be overwriting.
    """

    def __init__(self, address, open_timeout_ms=10000, auto_reopen=True,
                 poison=None):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                f"native ring unavailable (build failed: {_LIB_ERR}); use tcp"
            )
        self._lib = lib
        self._name = shm_name_from_address(address)
        self._auto_reopen = auto_reopen
        self._open_timeout_ms = open_timeout_ms
        self._poison = (
            os.environ.get("BJX_SHM_POISON", "") == "1"
            if poison is None else bool(poison)
        )
        self._out_views = None  # views handed out by recv_frames_view
        self.reconnects = 0
        self._h = lib.bjr_open(self._name.encode(), open_timeout_ms)
        if not self._h:
            raise OSError(f"failed to open shm ring {self._name}")

    def _acquire(self, data, length, timeout_ms):
        """read_acquire with vanished-ring reopen inside the deadline.

        ``timeout_ms < 0`` means wait forever (matching the C layer's
        convention): reopen attempts then loop on ``open_timeout_ms``
        slices with no deadline.  After a failed reopen the reader stays
        retryable — ``_h`` is None and the next call resumes the reopen
        instead of dereferencing a dead handle.
        """
        import time

        infinite = timeout_ms < 0
        deadline = None if infinite else time.monotonic() + timeout_ms / 1e3

        def remaining_ms():
            return -1 if infinite else int((deadline - time.monotonic()) * 1e3)

        while True:
            if self._h is None:
                # a previous generation vanished; always make at least one
                # (possibly non-blocking) reopen attempt — the timeout-0
                # rotation path heals exactly this way, one attempt per
                # sweep until the respawned producer's ring appears
                wait = self._open_timeout_ms if infinite else max(remaining_ms(), 0)
                h = self._lib.bjr_open(self._name.encode(), wait)
                if not h:
                    if infinite:
                        continue
                    raise ConnectionResetError(
                        f"shm ring {self._name} vanished; reopen timed out"
                    )
                self._h = h
                self.reconnects += 1
            rc = self._lib.bjr_read_acquire(
                self._h,
                ctypes.byref(data),
                ctypes.byref(length),
                -1 if infinite else max(remaining_ms(), 0),
            )
            if rc != -4:
                return rc
            if not self._auto_reopen:
                raise ConnectionResetError(
                    f"shm ring {self._name} vanished (producer died)"
                )
            self._lib.bjr_close(self._h, 0)
            self._h = None

    def recv_frames(self, timeout_ms):
        """Next framed message as a list of buffer-like frames, or None on
        timeout.

        Small frames are ``bytes``; frames >= 64 KiB are 1-D ``np.uint8``
        arrays (copied out of the arena with the GIL released).  Consumers
        must treat frames as buffers (``memoryview``-compatible), not as
        ``bytes`` specifically — :func:`blendjax_torch.wire.decode` does.

        Raises EOFError when the producer closed and the ring is drained,
        ConnectionResetError when the producer vanished and did not come
        back within the timeout.
        """
        data = ctypes.c_void_p()
        length = ctypes.c_uint64()
        rc = self._acquire(data, length, timeout_ms)
        if rc == -1:
            return None
        if rc == -3:
            raise EOFError("producer closed")
        try:
            buf = (ctypes.c_char * length.value).from_address(data.value)
            return _unpack_frames(self._lib, data.value, memoryview(buf))
        finally:
            self._lib.bjr_read_release(self._h)

    def recv_frames_view(self, timeout_ms):
        """Zero-copy variant of :meth:`recv_frames`: frames are memoryviews
        **into the shm arena**, valid only until :meth:`release_record` —
        which MUST be called before the next recv (it frees the ring slot;
        the producer may be blocked on it).  Use when the payload is copied
        exactly once into its final destination (e.g. a preallocated batch
        buffer) instead of through an intermediate frame buffer.
        """
        data = ctypes.c_void_p()
        length = ctypes.c_uint64()
        rc = self._acquire(data, length, timeout_ms)
        if rc == -1:
            return None
        if rc == -3:
            raise EOFError("producer closed")
        buf = (ctypes.c_char * length.value).from_address(data.value)
        mv = memoryview(buf)
        views = [mv[off : off + ln] for off, ln in _split_record(mv)]
        if self._poison:
            self._out_views = views + [mv]
        return views

    def release_record(self):
        """Release the record handed out by :meth:`recv_frames_view`.
        With poisoning armed, the handed-out views are released too, so
        a caller that kept one past this point gets ``ValueError`` on
        its next access instead of bytes a later producer write may
        already have clobbered."""
        if self._out_views is not None:
            views, self._out_views = self._out_views, None
            for v in views:
                try:
                    v.release()
                except BufferError:
                    # an np.frombuffer (or similar) still exports this
                    # view's buffer — Python cannot revoke an exported
                    # buffer, so such a view stays un-poisoned (the
                    # arrays built over it must be copied out before
                    # release, same contract as the views themselves)
                    pass
        if self._h is not None:
            self._lib.bjr_read_release(self._h)

    def pending_bytes(self):
        # _h is None between a failed reopen and the next recv retry; a
        # dead generation has nothing pending
        return 0 if self._h is None else self._lib.bjr_pending(self._h)

    def close(self, unlink=False):
        if self._h:
            self._lib.bjr_close(self._h, int(unlink))
            self._h = None
        elif unlink:
            # handle already gone (failed reopen); still honor the unlink
            _unlink_name(self._name)


def _unlink_name(name):
    """Best-effort removal of a shm object by name (POSIX shm objects live
    under /dev/shm on Linux)."""
    try:
        os.unlink(os.path.join("/dev/shm", name.lstrip("/")))
    except OSError:
        pass


def unlink_address(address):
    """Best-effort removal of a ring's shm backing file."""
    _unlink_name(shm_name_from_address(address))


class DoorBell:
    """A ``select()``-able wakeup line next to a shm ring: a named FIFO
    under ``/dev/shm`` the ring WRITER dings after publishing a record,
    so the reading process can park in one ``poll``/``select`` covering
    its ZMQ sockets AND its shm rings instead of sleep-polling the ring
    (the C layer's 100 µs nanosleep loop stays as the fallback when no
    bell is attached).  FIFOs are the portable fd-shaped doorbell here —
    unlike an eventfd they rendezvous by NAME across unrelated
    processes, and unlike a futex they compose with ``zmq.Poller``.

    Owner side (reader)::

        bell = DoorBell(path, create=True)   # mkfifo + open read end
        poller.register(bell.fd, zmq.POLLIN)
        ...
        bell.drain()                         # consume pending dings

    Remote side (writer)::

        bell = DoorBell(path)                # open write end lazily
        ring_writer.send_frames(frames)
        bell.ding()

    A ding can never be lost between a reader's empty-ring check and its
    park: the writer publishes the record BEFORE dinging, and the byte
    stays readable until drained — so ``select`` returns immediately if
    the ding already happened.  All failure modes (no reader yet, pipe
    full, reader gone) degrade to "no wakeup", which the reader's
    bounded poll timeout covers.
    """

    def __init__(self, path, create=False):
        self.path = path
        self.owner = bool(create)
        self.fd = None
        self._wfd = None
        if create:
            try:
                os.unlink(path)  # stale bell from a crashed predecessor
            except OSError:
                pass
            os.mkfifo(path, 0o600)
            # O_RDWR instead of O_RDONLY: keeps a write end open inside
            # this process, so writers never race ENXIO against the
            # reader and the fd never signals EOF-readable when the
            # last remote writer closes
            self.fd = os.open(path, os.O_RDWR | os.O_NONBLOCK)

    def ding(self):
        """One wakeup byte, best-effort (never blocks, never raises)."""
        try:
            if self._wfd is None:
                self._wfd = os.open(self.path, os.O_WRONLY | os.O_NONBLOCK)
            os.write(self._wfd, b"\x00")
        except OSError:
            # ENXIO (no reader yet), EAGAIN (pipe full: the reader is
            # awake and behind — a wakeup is already pending), or the
            # bell vanished: the reader's poll timeout covers all three
            if self._wfd is not None:
                try:
                    os.close(self._wfd)
                except OSError:
                    pass
                self._wfd = None

    def drain(self):
        """Consume pending dings (owner side), returning the byte count."""
        total = 0
        while self.fd is not None:
            try:
                got = os.read(self.fd, 4096)
            except (BlockingIOError, OSError):
                break
            if not got:
                break
            total += len(got)
        return total

    def close(self, unlink=None):
        for attr in ("fd", "_wfd"):
            f = getattr(self, attr)
            if f is not None:
                try:
                    os.close(f)
                except OSError:
                    pass
                setattr(self, attr, None)
        if unlink if unlink is not None else self.owner:
            try:
                os.unlink(self.path)
            except OSError:
                pass


def copy_into(dst, src):
    """memcpy one C-contiguous ndarray (or view) into another, GIL released
    for large payloads.  Shapes/dtypes must already match; ``dst`` must be
    C-contiguous (a leading-axis batch slot qualifies)."""
    import numpy as np

    lib = _load()
    if (
        lib is None
        or dst.nbytes < _NATIVE_COPY_MIN_BYTES
        or dst.dtype.hasobject
        or not (dst.flags["C_CONTIGUOUS"] and src.flags["C_CONTIGUOUS"])
    ):
        np.copyto(dst, src)
        return
    ptrs = (ctypes.c_void_p * 1)(src.ctypes.data)
    lens = (ctypes.c_uint64 * 1)(src.nbytes)
    lib.bjr_gather(dst.ctypes.data_as(ctypes.c_void_p), ptrs, lens, 1)


def _src_ptr_len(obj):
    """(pointer, nbytes, keepalive) for a read-only source buffer.

    ndarrays expose their data pointer directly (non-contiguous ones are
    compacted once); anything buffer-like (memoryview into a ZMQ frame or
    shm record, bytes) goes through a zero-copy ``np.frombuffer`` view,
    which also keeps the underlying buffer alive for the call.
    """
    import numpy as np

    if isinstance(obj, np.ndarray):
        if not obj.flags["C_CONTIGUOUS"]:
            obj = np.ascontiguousarray(obj)
        return obj.ctypes.data, obj.nbytes, obj
    arr = np.frombuffer(obj, np.uint8)
    return arr.ctypes.data, arr.nbytes, arr


def gather_into(dst, srcs):
    """Copy ``srcs`` (buffers/ndarrays) back-to-back into ``dst``, GIL
    released — ONE native call per batch leaf instead of one Python-level
    copy per sample, so large-frame scatters overlap with the recv thread
    and with other loader workers.

    ``dst`` must be a C-contiguous ndarray whose total bytes equal the
    summed source bytes (the batch-assembly contract: ``dst`` is an
    arena leaf ``(n, *shape)`` and ``srcs`` are the n per-sample
    payloads).  Falls back to numpy slice copies when the native library
    is unavailable.
    """
    import numpy as np

    if not dst.flags["C_CONTIGUOUS"] or dst.dtype.hasobject:
        raise ValueError("gather_into requires a C-contiguous non-object dst")
    n = len(srcs)
    ptrs = (ctypes.c_void_p * n)()
    lens = (ctypes.c_uint64 * n)()
    keep = []
    total = 0
    for i, s in enumerate(srcs):
        ptr, ln, alive = _src_ptr_len(s)
        ptrs[i] = ptr
        lens[i] = ln
        total += ln
        keep.append(alive)
    if total != dst.nbytes:
        raise ValueError(
            f"source bytes {total} != destination bytes {dst.nbytes}"
        )
    lib = _load()
    if lib is None:
        flat = dst.reshape(-1).view(np.uint8)
        off = 0
        for alive in keep:
            ln = alive.nbytes
            flat[off : off + ln] = alive.reshape(-1).view(np.uint8)
            off += ln
    elif n:
        lib.bjr_gather(dst.ctypes.data_as(ctypes.c_void_p), ptrs, lens, n)
    del keep
    return dst


def fast_stack(items, out=None):
    """Stack equal-shape ndarrays on a new leading axis, GIL released.

    ``np.stack`` holds the GIL for the whole copy, so concurrent
    :class:`blendjax_torch.btt.loader.BatchLoader` workers serialize their
    collation through one core.  This variant memcpys each source into the
    preallocated batch buffer via the native ``bjr_gather``
    (:func:`gather_into`); ctypes drops the GIL for the call, so k loader
    threads collate on k cores.  Falls back to ``np.stack`` when the
    native library is unavailable.
    """
    import numpy as np

    first = items[0]
    n = len(items)
    for a in items[1:]:
        if a.shape != first.shape or a.dtype != first.dtype:
            raise ValueError("fast_stack requires equal shapes and dtypes")
    if _load() is None or first.dtype.hasobject:
        # object dtypes hold PyObject pointers: a raw memcpy would skip the
        # increfs and corrupt refcounts
        return np.stack(items, out=out)
    if out is None:
        out = np.empty((n,) + first.shape, dtype=first.dtype)
    elif (
        out.shape != (n,) + first.shape
        or out.dtype != first.dtype
        or not out.flags["C_CONTIGUOUS"]
    ):
        raise ValueError(
            f"out must be C-contiguous with shape {(n,) + first.shape} and "
            f"dtype {first.dtype}, got {out.shape} {out.dtype}"
        )
    return gather_into(out, items)
