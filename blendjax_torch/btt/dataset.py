"""Streaming and replay datasets.

``RemoteIterableDataset`` pulls message dicts from N Blender producers over
a fan-in PULL socket (fair-queued across producers, HWM backpressure).
Worker parallelism is explicit — ``stream(worker_id, num_workers, ...)`` —
so any executor (threads in :class:`blendjax_torch.btt.loader.BatchLoader`
or torch DataLoader worker processes) can drive it.  Each worker yields
``max_items // num_workers`` items.

Two paths, as in the reference.  ``stream`` yields one decoded item at a
time (``item_transform`` and recording select it).  ``stream_batches``
assembles whole batches straight from the wire frames, into recycled
arena buffers when it is given an :class:`~blendjax_torch.btt.arena.ArenaPool`
(one host copy from frame to batch slot); it degrades per key to the
``collate`` rules for ragged, mixed-dtype and compat-pickle traffic.
Leaves of 64 KiB or more a row are gathered by the native GIL-released
``gather_into`` (:mod:`blendjax_torch.native.ring`), smaller ones row by
row.  ``shm://`` addresses read same-host shared-memory rings instead of
the socket: rings are single-consumer, so worker ``w`` of ``n`` (counted
over every data-parallel shard) reads ``addresses[w::n]``, and each record is copied into its batch buffer
before the ring slot is released.  zmq is imported where a stream opens
its socket, so the replay side (:class:`FileDataset`) works without pyzmq.
"""

from __future__ import annotations

import bisect
import numbers
import pickle
import sys
import time
from contextlib import ExitStack
from glob import glob

import numpy as np

from blendjax_torch import wire
from blendjax_torch.btt.collate import _NATIVE_STACK_MIN_BYTES
from blendjax_torch.btt.constants import DEFAULT_TIMEOUTMS
from blendjax_torch.btt.file import FileReader, FileRecorder
from blendjax_torch.utils.timing import fleet_counters


def _global_worker(worker_id, num_workers, shard_id, num_shards):
    """A (shard, worker) pair as one worker of ``num_shards * num_workers``:
    its id and the total."""
    if not 0 <= shard_id < num_shards:
        raise ValueError(f"shard_id {shard_id} outside [0, {num_shards})")
    return shard_id * num_workers + worker_id, num_workers * num_shards


def _identity(x):
    return x


def _torch_worker_info():
    """(worker_id, num_workers) when called inside a torch DataLoader
    worker.  Reads torch only if it is already loaded, so the dataset
    stays importable in a process without torch."""
    utils_data = sys.modules.get("torch.utils.data")
    if utils_data is None:
        return None
    wi = utils_data.get_worker_info()
    if wi is None:
        return None
    return wi.id, wi.num_workers


class RemoteIterableDataset:
    """Iterable over message dicts streamed from remote Blender instances.

    Params
    ------
    addresses: list[str]
        Producer addresses to connect to (fan-in over all of them).
    queue_size: int
        RCVHWM; producers stall once this many messages are in flight.
    timeoutms: int
        Max silence before :class:`TimeoutError`.
    max_items: int
        Artificial dataset length (and recorder capacity).
    item_transform: callable | None
        Applied to each received dict.
    record_path_prefix: str | None
        When set, worker ``w`` records raw messages to
        ``{prefix}_{w:02d}.btr`` while streaming.
    counters: EventCounters | None
        Sink for ``stream_timeouts`` events; defaults to the process-wide
        ``blendjax_torch.utils.timing.fleet_counters``.
    """

    def __init__(
        self,
        addresses,
        queue_size=10,
        timeoutms=DEFAULT_TIMEOUTMS,
        max_items=100000,
        item_transform=None,
        record_path_prefix=None,
        counters=None,
    ):
        self.addresses = list(addresses)
        self.queue_size = queue_size
        self.timeoutms = timeoutms
        self.max_items = max_items
        self.record_path_prefix = record_path_prefix
        self.item_transform = item_transform or _identity
        self.counters = counters if counters is not None else fleet_counters

    def enable_recording(self, fname):
        """Record while streaming (``record_path_prefix``); set before
        iteration starts."""
        self.record_path_prefix = fname

    def stream_length(self, max_items):
        """Set the artificial dataset length (``max_items``)."""
        self.max_items = max_items

    def __iter__(self):
        wi = _torch_worker_info()
        if wi is not None:
            return self.stream(worker_id=wi[0], num_workers=wi[1])
        return self.stream()

    def stream(self, worker_id=0, num_workers=1, shard_id=0, num_shards=1, stop_event=None):
        """Generator yielding ``max_items // (num_workers * num_shards)``
        transformed items for this (shard, worker): a data-parallel rank
        reads shard ``shard_id`` of ``num_shards``.

        ``stop_event`` (a ``threading.Event``) aborts the stream promptly —
        the poll loop checks it between messages so loaders can shut down
        without waiting out ``timeoutms``.

        ``shm://`` addresses take the native shared-memory path: rings are
        single-consumer, so they are partitioned over the (shard, worker)
        pairs, ``addresses[g::num_shards * num_workers]`` for the global
        worker ``g = shard_id * num_workers + worker_id``, instead of the
        ZMQ connect-to-all fan-in; use ``num_shards * num_workers <=
        len(addresses)``.
        """
        worker_id, num_workers = _global_worker(worker_id, num_workers, shard_id, num_shards)
        if self._is_shm():
            yield from self._stream_shm(worker_id, num_workers, stop_event)
            return
        socket, poller = self._open_socket()
        try:
            count = self.max_items // num_workers
            with ExitStack() as es:
                rec = None
                if self.record_path_prefix is not None:
                    rec = es.enter_context(
                        FileRecorder(
                            FileRecorder.filename(self.record_path_prefix, worker_id),
                            self.max_items,
                        )
                    )
                for _ in range(count):
                    if not self._poll_message(poller, stop_event):
                        return
                    if rec is not None:
                        frames = wire.recv_message_raw(socket)
                        rec.save_frames(frames)
                        obj = wire.decode(frames)
                    else:
                        obj = wire.recv_message(socket)
                    yield self._item(obj)
        finally:
            socket.close(0)

    def _open_socket(self):
        """A PULL socket connected to every producer, and its poller."""
        import zmq

        socket = zmq.Context.instance().socket(zmq.PULL)
        socket.setsockopt(zmq.RCVHWM, self.queue_size)
        socket.setsockopt(zmq.LINGER, 0)
        try:
            for addr in self.addresses:
                socket.connect(addr)
        except BaseException:
            socket.close(0)
            raise
        poller = zmq.Poller()
        poller.register(socket, zmq.POLLIN)
        return socket, poller

    def _poll_message(self, poller, stop_event):
        """Wait for the next message on the PULL socket: True when one is
        ready, False when ``stop_event`` fired; raises TimeoutError after
        ``timeoutms`` of silence.  Shared by the per-item and batched
        stream loops so the timeout/stop semantics cannot drift."""
        waited = 0
        slice_ms = 100 if stop_event is not None else self.timeoutms
        while True:
            if stop_event is not None and stop_event.is_set():
                return False
            if poller.poll(min(slice_ms, self.timeoutms)):
                return True
            waited += slice_ms
            if waited >= self.timeoutms:
                self.counters.incr("stream_timeouts")
                raise TimeoutError(
                    f"No message within {self.timeoutms} ms from "
                    f"{self.addresses}"
                )

    def _is_shm(self):
        return bool(self.addresses) and all(a.startswith("shm://") for a in self.addresses)

    def _shm_rotation(self, worker_id, num_workers, stop_event, consume, count):
        """The ring-rotation loop of the shm paths: opens this worker's
        rings, round-robins ``consume(reader, block_ms)`` over them, and
        owns the EOF / timeout / stop semantics.  ``consume`` returns a
        result to yield, None when no message arrived in its slice, or
        raises EOFError when its ring is closed and drained (the ring then
        leaves the rotation: producer exit ends the stream instead of
        raising a timeout)."""
        from blendjax_torch.native import ShmRingReader

        mine = self.addresses[worker_id::num_workers]
        if not mine:
            return
        # ring creation waits on producer startup: give it the stream timeout
        open_ms = max(self.timeoutms, 10000)
        readers = [ShmRingReader(a, open_timeout_ms=open_ms) for a in mine]
        # observable: the stream took the ring path
        self.counters.incr("stream_shm_rings", len(readers))
        try:
            delivered = 0
            waited_ms = 0
            # one ring (one worker per producer): block inside the C call,
            # 100 us wakeups; several: non-blocking rotation, short sleeps
            block_ms = 100 if len(readers) == 1 else 0
            while delivered < count and readers:
                progressed = False
                for reader in list(readers):
                    if stop_event is not None and stop_event.is_set():
                        return
                    try:
                        res = consume(reader, block_ms)
                    except EOFError:
                        reader.close(unlink=True)  # drained and closed
                        readers.remove(reader)
                        block_ms = 100 if len(readers) == 1 else 0
                        continue
                    except ConnectionResetError:
                        # the ring vanished and its producer is not back
                        # within this slice; the reader stays retryable, so
                        # keep rotating until the stream timeout (a
                        # watchdog respawn may land any moment)
                        self.counters.incr("stream_ring_vanished")
                        waited_ms += max(block_ms, 0)
                        continue
                    if res is None:
                        waited_ms += max(block_ms, 0)
                        continue
                    progressed = True
                    waited_ms = 0
                    yield res
                    delivered += 1
                    if delivered >= count:
                        return
                if not progressed:
                    if block_ms == 0:
                        time.sleep(0.001)
                        waited_ms += 1
                    if waited_ms >= self.timeoutms:
                        self.counters.incr("stream_timeouts")
                        raise TimeoutError(f"No message within {self.timeoutms} ms from {mine}")
        finally:
            for r in readers:
                r.close()

    def _stream_shm(self, worker_id, num_workers, stop_event):
        """The per-item stream loop over shm rings."""
        count = self.max_items // num_workers
        with ExitStack() as es:
            rec = None
            if self.record_path_prefix is not None:
                rec = es.enter_context(FileRecorder(
                    FileRecorder.filename(self.record_path_prefix, worker_id),
                    self.max_items))

            def consume(reader, block_ms):
                frames = reader.recv_frames(timeout_ms=block_ms)
                if frames is None:
                    return None
                if rec is not None:
                    rec.save_frames(frames)
                return (self._item(wire.decode(frames)),)

            for (item,) in self._shm_rotation(worker_id, num_workers, stop_event, consume,
                                              count):
                yield item

    def _item(self, item):
        """Override point; defaults to ``item_transform``."""
        return self.item_transform(item)

    # -- batched path: frames straight into (pooled) batch buffers -------------

    def supports_batched_stream(self):
        """True when :meth:`stream_batches` can assemble batches straight
        from the wire frames: no recording and no per-item transform."""
        return (
            bool(self.addresses)
            and self.record_path_prefix is None
            and self.item_transform is _identity
            and type(self)._item is RemoteIterableDataset._item
        )

    def stream_batches(self, batch_size, worker_id=0, num_workers=1, shard_id=0, num_shards=1,
                       stop_event=None, drop_last=True, timer=None, arena_pool=None):
        """Yield collated batches, bypassing per-item materialization.

        Each message's frames are held as zero-copy views until its batch
        is complete; then every array leaf is copied ONCE into its
        ``(batch_size, ...)`` batch buffer (:class:`_BatchBuilder`).  With
        ``arena_pool`` (an :class:`~blendjax_torch.btt.arena.ArenaPool`)
        the batch buffers are recycled: batches come out as
        :class:`~blendjax_torch.btt.arena.ArenaBatch`, and the consumer
        (normally the device feed) recycles each one once its bytes have
        been consumed; pool exhaustion backpressures the stream
        (``arena_wait`` stage).

        ``shard_id``/``num_shards`` split the stream over data-parallel
        ranks as :meth:`stream` does.

        Falls back to :meth:`stream` + ``collate`` when
        :meth:`supports_batched_stream` is False.  Schema drift between
        messages, ragged leaves and compat-pickle messages degrade per
        key to the ``collate`` rules instead of failing the stream.
        """
        from blendjax_torch.btt.collate import collate

        if timer is None:
            from blendjax_torch.utils.timing import StageTimer

            timer = StageTimer()
        if not self.supports_batched_stream():
            batch = []
            for item in self.stream(worker_id=worker_id, num_workers=num_workers,
                                    shard_id=shard_id, num_shards=num_shards,
                                    stop_event=stop_event):
                batch.append(item)
                if len(batch) == batch_size:
                    with timer.stage("collate"):
                        out = collate(batch)
                    yield out
                    batch = []
            if batch and not drop_last:
                with timer.stage("collate"):
                    out = collate(batch)
                yield out
            return
        g, total = _global_worker(worker_id, num_workers, shard_id, num_shards)
        if self._is_shm():
            yield from self._stream_shm_batches(batch_size, g, total, stop_event, drop_last,
                                                timer, arena_pool)
        else:
            yield from self._stream_zmq_batches(batch_size, g, total, stop_event, drop_last,
                                                timer, arena_pool, parallel=num_workers > 1)

    def _acquire_arena(self, arena_pool, timer, stop_event):
        """Next free arena from the pool (None without a pool).  Blocks
        under pool exhaustion — the backpressure seam — accounted to the
        ``arena_wait`` stage.  Raises TimeoutError if no arena frees up
        within the stream timeout (a stuck consumer looks exactly like a
        silent producer to the training loop)."""
        if arena_pool is None:
            return None, True
        with timer.stage("arena_wait"):
            arena = arena_pool.acquire(timeout=self.timeoutms / 1e3, stop_event=stop_event)
        if arena is None:
            if stop_event is not None and stop_event.is_set():
                return None, False
            raise TimeoutError(
                f"no batch arena freed within {self.timeoutms} ms "
                f"(pool size {arena_pool.pool_size}); the consumer has "
                "stalled or the pool is undersized"
            )
        return arena, True

    def _wrap_batch(self, data, arena):
        if arena is None:
            return data
        from blendjax_torch.btt.arena import ArenaBatch

        return ArenaBatch(data, arena)

    def _stream_zmq_batches(self, batch_size, worker_id, num_workers, stop_event,
                            drop_last, timer, arena_pool, parallel):
        """Batched ZMQ fan-in: the builder keeps each message's zero-copy
        frames until the batch completes, then gathers each leaf in one
        copy into the (optionally pooled) batch buffer.  ``parallel``: other
        stream threads of this process gather at the same time."""
        socket, poller = self._open_socket()
        # the decode plan is shared across this stream's batches
        builder = _BatchBuilder(batch_size, schema_cache={}, parallel=parallel)
        pending = False  # builder holds an unyielded (possibly empty) batch
        arena = None
        try:
            count = self.max_items // num_workers
            for _ in range(count):
                if not self._poll_message(poller, stop_event):
                    return
                frames = socket.recv_multipart(copy=False)
                if not pending:
                    arena, alive = self._acquire_arena(arena_pool, timer, stop_event)
                    if not alive:
                        return
                    builder.reset(arena)
                    pending = True
                builder.add_message([f.buffer for f in frames])
                if builder.full():
                    with timer.stage("scatter"):
                        data = builder.finish()
                    # drop the batch's wire frames now, not at the next
                    # message (array leaves are already copied; ragged
                    # fallback views hold their own frame references)
                    builder.reset()
                    # hand the arena to the batch BEFORE yielding: a
                    # generator closed at the yield would otherwise release
                    # it from the finally below while the batch still holds it
                    out, arena = self._wrap_batch(data, arena), None
                    pending = False
                    yield out
            if pending and builder.count and not drop_last:
                with timer.stage("scatter"):
                    data = builder.finish()
                builder.reset()
                out, arena = self._wrap_batch(data, arena), None
                pending = False
                yield out
        finally:
            if arena is not None:
                arena.release()  # acquired but never yielded (dropped tail)
            socket.close(0)

    def _stream_shm_batches(self, batch_size, worker_id, num_workers, stop_event, drop_last,
                            timer, arena_pool):
        """Batched shm rotation: each ring record is held only while its
        payloads are copied into the (optionally pooled) batch buffer
        (the builder's eager mode), then released, so no batch aliases
        ring memory."""
        count = self.max_items // num_workers
        state = {"builder": None, "arena": None}

        def consume(reader, block_ms):
            frames = reader.recv_frames_view(timeout_ms=block_ms)
            if frames is None:
                return None
            try:
                if state["builder"] is None:
                    arena, alive = self._acquire_arena(arena_pool, timer, stop_event)
                    if not alive:
                        # stopping mid-acquire: drop this record and let the
                        # rotation's own stop check end the stream
                        return None
                    state["arena"] = arena
                    state["builder"] = _BatchBuilder(batch_size, arena=arena, defer=False)
                with timer.stage("scatter"):
                    state["builder"].add_message(frames)
            finally:
                reader.release_record()
            return True

        try:
            for _ in self._shm_rotation(worker_id, num_workers, stop_event, consume, count):
                builder = state["builder"]
                if builder is not None and builder.full():
                    with timer.stage("scatter"):
                        data = builder.finish()
                    # ownership moves to the batch BEFORE the yield (a close
                    # at the yield must not release the arena again)
                    out = self._wrap_batch(data, state["arena"])
                    state["builder"], state["arena"] = None, None
                    yield out
            builder = state["builder"]
            if builder is not None and builder.count and not drop_last:
                with timer.stage("scatter"):
                    data = builder.finish()
                out = self._wrap_batch(data, state["arena"])
                state["builder"], state["arena"] = None, None
                yield out
        finally:
            if state["arena"] is not None:
                state["arena"].release()


class _BatchBuilder:
    """Assembles one collated batch directly from wire frames.

    Array leaves land in ``(batch_size, *shape)`` buffers — taken from a
    recycled :class:`~blendjax_torch.btt.arena.Arena` when one is supplied,
    freshly allocated otherwise — and everything else is collated.  Two
    modes, as the reference's:

    - **deferred** (``defer=True``, the default; the ZMQ transport):
      :meth:`add_message` references each message's zero-copy frames until
      the batch completes; :meth:`finish` then copies every array leaf
      ONCE into its buffer (the native ``gather_into`` for rows of
      :data:`_NATIVE_STACK_MIN_BYTES` or more, row by row below).  After
      the first message fixes the schema, later batches are decoded by a
      precompiled per-stream plan; any structural surprise falls back to
      the generic walk for that batch, preserving the collate semantics.
    - **eager** (``defer=False``; the shm transport): each message's
      payloads are copied into the batch buffer (``copy_into``) before
      :meth:`add_message` returns, so the ring record can be released.

    Semantics mirror ``stream() + collate``: a key whose shape/dtype
    drifts within a batch degrades to the ragged-list rules, keys absent
    from the batch's first message are dropped, and a message *missing* a
    first-message key raises KeyError (as dict collate would).
    """

    #: With several loader workers sharing the GIL, GIL time is the scarce
    #: resource: the native gather pays off from 16 KiB a row.
    _PARALLEL_GATHER_MIN_BYTES = 16 * 1024

    def __init__(self, batch_size, arena=None, schema_cache=None, defer=True,
                 parallel=False):
        self.batch_size = batch_size
        self.count = 0
        self._arena = arena
        self._defer = bool(defer)
        self._min_native = (self._PARALLEL_GATHER_MIN_BYTES if parallel
                            else _NATIVE_STACK_MIN_BYTES)
        self._msgs = []  # deferred: per-message frame lists (zero-copy)
        self._stacked = {}  # eager: path -> preallocated (B, ...) ndarray
        self._lists = {}  # eager: path -> leaves (collated at the end)
        self._paths = None  # eager: the schema from the first message
        # {'schema': {...}} shared across builders of one stream so the
        # decode plan survives batch boundaries
        self._schema_cache = schema_cache if schema_cache is not None else {}

    def full(self):
        return self.count >= self.batch_size

    def reset(self, arena=None):
        """Rewind for the next batch: the finished batch owns copies (or
        collate outputs), so the frame references drop while the stream's
        schema cache lives on.  Returns self."""
        self.count = 0
        self._arena = arena
        self._msgs.clear()
        self._stacked = {}
        self._lists = {}
        self._paths = None
        return self

    def _batch_buffer(self, path, leaf_shape, dtype):
        shape = (self.batch_size,) + tuple(leaf_shape)
        if self._arena is not None:
            return self._arena.get_buffer(path, shape, dtype)
        return np.empty(shape, dtype)

    # -- leaf walking ---------------------------------------------------------

    @staticmethod
    def _view(placeholder, payloads):
        """ndarray view into the payload frame of a raw-buffer leaf."""
        return np.frombuffer(
            payloads[placeholder[wire.ARRAY_PLACEHOLDER]],
            dtype=np.dtype(placeholder["dtype"]),
        ).reshape(placeholder["shape"])

    def _resolve(self, obj, payloads):
        """Deep-resolve placeholders inside a container: views over the
        payload frames in deferred mode (they outlive the batch), owned
        copies in eager mode (a ring record dies at its release)."""
        if wire.is_array_placeholder(obj):
            view = self._view(obj, payloads)
            return view if self._defer else np.array(view)
        if isinstance(obj, dict):
            return {k: self._resolve(v, payloads) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            seq = [self._resolve(v, payloads) for v in obj]
            return seq if isinstance(obj, list) else tuple(seq)
        return obj

    def _walk(self, obj, payloads, path=()):
        """Yield (path, leaf, is_array) with raw-buffer placeholders
        resolved to ndarray views over the payload frames.  list/tuple
        containers are resolved and treated as single leaves — the final
        ``collate`` recurses into them exactly as the generic path does."""
        if isinstance(obj, dict):
            if wire.is_array_placeholder(obj):
                yield path, self._view(obj, payloads), True
                return
            for k, v in obj.items():
                yield from self._walk(v, payloads, path + (k,))
            return
        if isinstance(obj, np.ndarray):
            yield path, obj, True
            return
        if isinstance(obj, (list, tuple)):
            yield path, self._resolve(obj, payloads), False
            return
        yield path, obj, False

    # -- columnar decode along the stream's plan ------------------------------

    def _make_schema(self, head):
        """Precompile ``head``'s structure into a columnar decode plan:
        one entry per leaf — (path, key-chain, kind, aux) — plus the arity
        of every dict node (so a key added or removed anywhere in a later
        message invalidates the plan).  Kinds: 'raw' (placeholder ->
        zero-copy payload frame), 'array' (materialized ndarray, compat
        pickles), 'container' (list/tuple, resolved per message), 'leaf'
        (plain value).  A batch that deviates from the plan in ANY way is
        re-processed by the generic per-message walk, so the plan is a
        fast path only, never a change of semantics."""
        plan = []
        dict_lens = []

        def build(obj, path, keys):
            if isinstance(obj, dict):
                if wire.is_array_placeholder(obj):
                    # the whole placeholder is static per schema: one dict
                    # equality per message checks it
                    plan.append((path, keys, "raw", (
                        dict(obj), obj[wire.ARRAY_PLACEHOLDER], tuple(obj["shape"]),
                        np.dtype(obj["dtype"]))))
                    return
                dict_lens.append((keys, len(obj)))
                for k, v in obj.items():
                    build(v, path + (k,), keys + (k,))
                return
            if isinstance(obj, np.ndarray):
                plan.append((path, keys, "array", None))
                return
            if isinstance(obj, (list, tuple)):
                plan.append((path, keys, "container", None))
                return
            plan.append((path, keys, "leaf", None))

        build(head, (), ())
        return {"plan": plan, "dict_lens": dict_lens}

    def _gather(self, dst, bufs, dtype):
        """Copy ``bufs`` (one row each) into ``dst``: the native gather for
        large rows, row by row below the threshold."""
        from blendjax_torch.native.ring import gather_into

        n = len(bufs)
        if n and dst.nbytes // n >= self._min_native and not dtype.hasobject:
            gather_into(dst, bufs)
            return
        rows = dst.reshape(n, -1)
        for i, b in enumerate(bufs):
            rows[i] = np.frombuffer(b, dtype) if not isinstance(b, np.ndarray) \
                else b.reshape(-1)

    def _columnar(self, heads, msgs, schema):
        """Collate the batch along the precompiled plan, column by column.
        Returns None on ANY deviation (changed arity, moved key, type
        change, drifted array geometry); the caller then runs the generic
        per-message walk, which applies the collate rules per key."""
        from blendjax_torch.btt.collate import collate

        n = self.count
        try:
            for keys, ln in schema["dict_lens"]:
                nodes = heads
                for k in keys:
                    nodes = [v[k] for v in nodes]
                if not all(len(v) == ln for v in nodes):
                    return None
            out = {}
            for path, keys, kind, aux in schema["plan"]:
                vals = heads
                for k in keys:
                    vals = [v[k] for v in vals]
                if kind == "raw":
                    template, idx, shape, dtype = aux
                    if not all(type(v) is dict and v == template for v in vals):
                        return None
                    fi = idx + 1  # payload frames start after the header
                    buf = self._batch_buffer(path, shape, dtype)
                    dst = buf if n == self.batch_size else buf[:n]
                    self._gather(dst, [m[fi] for m in msgs], dtype)
                elif kind == "leaf":
                    v0 = vals[0]
                    t0v = type(v0)
                    if all(type(v) is t0v for v in vals):
                        if isinstance(v0, (dict, np.ndarray, list, tuple)):
                            return None
                    elif any(isinstance(v, (dict, np.ndarray, list, tuple)) for v in vals):
                        return None
                    # the scalar collate rules, in collate's order
                    if isinstance(v0, bool):
                        dst = np.asarray(vals, dtype=bool)
                    elif isinstance(v0, numbers.Number):
                        dst = np.asarray(vals)
                    else:
                        dst = list(vals)
                elif kind == "array":
                    first = vals[0]
                    if not all(isinstance(v, np.ndarray) and v.shape == first.shape
                               and v.dtype == first.dtype for v in vals):
                        return None
                    buf = self._batch_buffer(path, first.shape, first.dtype)
                    dst = buf if n == self.batch_size else buf[:n]
                    for i, v in enumerate(vals):
                        dst[i] = v
                else:  # container
                    if not all(isinstance(v, (list, tuple)) for v in vals):
                        return None
                    dst = collate([self._resolve(v, msgs[i][1:]) for i, v in enumerate(vals)])
                if len(path) == 1:
                    out[path[0]] = dst
                else:
                    _set_path(out, path, dst)
            return out
        except (KeyError, TypeError, IndexError, ValueError):
            # ValueError covers ambiguous ndarray comparisons from type
            # drift; a malformed frame re-raises from the generic walk
            return None

    def _generic(self, heads, payload_lists):
        """Per-message walk for batches the plan cannot decode: the
        collate semantics (late-key drop, missing-key KeyError, per-key
        degrade to ragged/upcast rules).  Also rebuilds the stream's
        cached schema from this batch's first message."""
        from blendjax_torch.btt.collate import collate

        cols = {}
        paths = None
        for mi, (head, payloads) in enumerate(zip(heads, payload_lists)):
            seen = set()
            for path, leaf, is_array in self._walk(head, payloads):
                if paths is not None and path not in paths:
                    # collate keys the batch off its first item and drops
                    # keys that only appear later
                    continue
                seen.add(path)
                cols.setdefault(path, []).append((leaf, is_array))
            if paths is None:
                paths = seen
                self._schema_cache["schema"] = self._make_schema(head)
            elif seen != paths:
                missing = sorted(map(str, paths - seen))
                raise KeyError(
                    f"stream message {mi} of the current batch is missing "
                    f"key(s) {missing} present in the batch's first message"
                )
        n = self.count
        out = {}
        for path, col in cols.items():
            if col and all(is_arr for _, is_arr in col):
                first = col[0][0]
                if all(v.shape == first.shape and v.dtype == first.dtype for v, _ in col):
                    buf = self._batch_buffer(path, first.shape, first.dtype)
                    dst = buf if n == self.batch_size else buf[:n]
                    self._gather(dst, [v for v, _ in col], first.dtype)
                    _set_path(out, path, dst)
                    continue
            vals = [v for v, _ in col]
            _set_path(out, path, collate(vals) if vals else vals)
        return out

    def add_message(self, frames):
        """Consume one message's frames: deferred mode references them
        until :meth:`finish`; eager mode copies the payloads out before
        returning (a ring record's lifetime)."""
        if self._defer:
            self._msgs.append(frames)
            self.count += 1
            return
        from blendjax_torch.native import copy_into

        head = wire.loads(frames[0])
        payloads = frames[1:]
        i = self.count
        seen = set()
        for path, leaf, is_array in self._walk(head, payloads):
            if self._paths is not None and path not in self._paths:
                # collate keys the batch off its first item and drops keys
                # that only appear later
                continue
            seen.add(path)
            if path in self._lists:
                self._lists[path].append(np.array(leaf) if is_array else leaf)
                continue
            if is_array and i == 0:
                self._stacked[path] = self._batch_buffer(path, leaf.shape, leaf.dtype)
            buf = self._stacked.get(path)
            if buf is not None and leaf.shape == buf.shape[1:] and leaf.dtype == buf.dtype:
                copy_into(buf[i], leaf)
                continue
            # shape/dtype drift (or a non-array leaf): this key degrades to
            # list mode, earlier slots COPIED out (a view would alias the
            # recycled arena); the final collate applies the ragged rules
            prior = ([np.array(buf[j]) for j in range(i)] if buf is not None
                     else self._lists.get(path, []))
            self._stacked.pop(path, None)
            self._lists[path] = list(prior) + [np.array(leaf) if is_array else leaf]
        if self._paths is None:
            self._paths = seen
        elif seen != self._paths:
            missing = sorted(map(str, self._paths - seen))
            raise KeyError(
                f"stream message {i} of the current batch is missing "
                f"key(s) {missing} present in the batch's first message"
            )
        self.count += 1

    def finish(self):
        """The collated batch pytree (nested dict).  Deferred mode: the
        headers parsed in one pass, then collated column by column along
        the stream's cached plan, or by the generic walk where the plan
        does not fit."""
        if not self._defer:
            from blendjax_torch.btt.collate import collate

            n = self.count
            out = {}
            for path, buf in self._stacked.items():
                _set_path(out, path, buf if n == self.batch_size else buf[:n])
            for path, vals in self._lists.items():
                _set_path(out, path, collate(vals) if vals else vals)
            return out
        if not self._msgs:
            return {}
        msgs = self._msgs
        heads = [pickle.loads(f[0]) for f in msgs]
        schema = self._schema_cache.get("schema")
        if schema is not None:
            out = self._columnar(heads, msgs, schema)
            if out is not None:
                return out
        return self._generic(heads, [f[1:] for f in msgs])


def _set_path(tree, path, value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


class SingleFileDataset:
    """Map-style replay of one recording file."""

    def __init__(self, path, item_transform=None):
        self.reader = FileReader(path)
        self.item_transform = item_transform or _identity

    def __len__(self):
        return len(self.reader)

    def __getitem__(self, idx):
        return self.item_transform(self.reader[idx])


class FileDataset:
    """Concatenated replay over all files matching ``{prefix}_*.btr``,
    map-style so shuffling works."""

    def __init__(self, record_path_prefix, item_transform=None):
        fnames = sorted(glob(f"{record_path_prefix}_*.btr"))
        if not fnames:
            raise FileNotFoundError(
                f"Found no recording files with prefix {record_path_prefix}"
            )
        self.datasets = [SingleFileDataset(f) for f in fnames]
        self.cum_sizes = []
        total = 0
        for ds in self.datasets:
            total += len(ds)
            self.cum_sizes.append(total)
        self.item_transform = item_transform or _identity

    def __len__(self):
        return self.cum_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        ds_idx = bisect.bisect_right(self.cum_sizes, idx)
        start = 0 if ds_idx == 0 else self.cum_sizes[ds_idx - 1]
        return self.item_transform(self.datasets[ds_idx][idx - start])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
