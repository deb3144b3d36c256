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
``collate`` rules for ragged, mixed-dtype and compat-pickle traffic.  The
``shm://`` rings and the native gather are not ported: ``np.stack(out=)``
does the gather.  zmq is imported where a stream opens its socket, so the
replay side (:class:`FileDataset`) works without pyzmq.
"""

from __future__ import annotations

import bisect
import numbers
import pickle
import sys
from contextlib import ExitStack
from glob import glob

import numpy as np

from blendjax_torch import wire
from blendjax_torch.btt.constants import DEFAULT_TIMEOUTMS
from blendjax_torch.btt.file import FileReader, FileRecorder
from blendjax_torch.utils.timing import fleet_counters


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
        if any(a.startswith("shm://") for a in self.addresses):
            raise ValueError("the shm:// transport is not ported; use tcp")
        self.queue_size = queue_size
        self.timeoutms = timeoutms
        self.max_items = max_items
        self.record_path_prefix = record_path_prefix
        self.item_transform = item_transform or _identity
        self.counters = counters if counters is not None else fleet_counters

    def __iter__(self):
        wi = _torch_worker_info()
        if wi is not None:
            return self.stream(worker_id=wi[0], num_workers=wi[1])
        return self.stream()

    def stream(self, worker_id=0, num_workers=1, stop_event=None):
        """Generator yielding ``max_items // num_workers`` transformed
        items for this worker.

        ``stop_event`` (a ``threading.Event``) aborts the stream promptly —
        the poll loop checks it between messages so loaders can shut down
        without waiting out ``timeoutms``.
        """
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

    def stream_batches(self, batch_size, worker_id=0, num_workers=1, stop_event=None,
                       drop_last=True, timer=None, arena_pool=None):
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
        yield from self._stream_zmq_batches(batch_size, worker_id, num_workers, stop_event,
                                            drop_last, timer, arena_pool)

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
                            drop_last, timer, arena_pool):
        """Batched ZMQ fan-in: the builder keeps each message's zero-copy
        frames until the batch completes, then gathers each leaf in one
        copy into the (optionally pooled) batch buffer."""
        socket, poller = self._open_socket()
        # the decode plan is shared across this stream's batches
        builder = _BatchBuilder(batch_size, schema_cache={})
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


class _BatchBuilder:
    """Assembles one collated batch directly from wire frames.

    :meth:`add_message` references each message's zero-copy frames until
    the batch completes; :meth:`finish` then copies every array leaf ONCE
    into a ``(batch_size, *shape)`` buffer — taken from a recycled
    :class:`~blendjax_torch.btt.arena.Arena` when one is supplied, freshly
    allocated otherwise — with ``np.stack(out=)``, and collates everything
    else.  After the first message fixes the schema, later batches are
    decoded by a precompiled per-stream plan (no recursive walk on the hot
    path); any structural surprise falls back to the generic walk for that
    batch, preserving the collate semantics exactly.

    Semantics mirror ``stream() + collate``: a key whose shape/dtype
    drifts within a batch degrades to the ragged-list rules, keys absent
    from the batch's first message are dropped, and a message *missing* a
    first-message key raises KeyError (as dict collate would).
    """

    def __init__(self, batch_size, arena=None, schema_cache=None):
        self.batch_size = batch_size
        self.count = 0
        self._arena = arena
        self._msgs = []  # per-message frame lists (zero-copy)
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
        """Deep-resolve placeholders inside a container to views over the
        payload frames (which outlive the batch)."""
        if wire.is_array_placeholder(obj):
            return self._view(obj, payloads)
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
                    np.stack([np.frombuffer(m[fi], dtype).reshape(shape) for m in msgs],
                             out=dst)
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
                    np.stack([v for v, _ in col], out=dst)
                    _set_path(out, path, dst)
                    continue
            vals = [v for v, _ in col]
            _set_path(out, path, collate(vals) if vals else vals)
        return out

    def add_message(self, frames):
        """Reference one message's frames until :meth:`finish`."""
        self._msgs.append(frames)
        self.count += 1

    def finish(self):
        """The collated batch pytree (nested dict): the headers parsed in
        one pass, then collated column by column along the stream's cached
        plan, or by the generic walk where the plan does not fit."""
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
