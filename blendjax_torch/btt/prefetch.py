"""Device feed: pinned-memory, stream-overlapped host->device prefetch.

Batches coming off the stream are staged onto the card *while the previous
train step runs*, so the GPU does not wait on the host.  On CUDA a
background thread copies each host batch into one of a ring of
**page-locked** staging buffers and issues ``copy_(..., non_blocking=True)``
on a side CUDA stream, then records an event.  The consumer's stream waits
on that event before it touches the batch, and every tensor of the batch is
marked with ``record_stream`` so the caching allocator does not hand its
memory back to the side stream while the consumer's kernels still read it.
A staging buffer is refilled only after the event of the copy that last
read it has completed.

Arena batches (:mod:`blendjax_torch.btt.arena`, ``TorchStream(arena=)``)
go through the same ring.  The arena goes back to its pool only once the
batch's copy event has completed — the counterpart of
``block_until_ready`` before an arena recycle in
``blendjax.btt.prefetch`` — never on dispatch alone.

On the CPU, ``torch.from_numpy`` would alias the host batch, so a producer
that reuses its buffers (a recycled arena) would rewrite batches already
handed out; CPU batches are therefore copied into memory they own, and an
arena is recycled as soon as that copy is made.

With a ``sharding`` (:func:`blendjax_torch.parallel.mesh.data_sharding`)
each batch leaf becomes a DTensor on the mesh: with more than one rank the
batch a rank reads is its shard of the global batch
(``DTensor.from_local``, no communication), as the reference's
``make_array_from_process_local_data``; in a one-rank world the batch is
the global one and is placed by ``distribute_tensor``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from blendjax_torch.btt.arena import ArenaBatch, ArenaPool
from blendjax_torch.utils.device import resolve_device
from blendjax_torch.utils.timing import StageTimer

log = logging.getLogger("blendjax_torch")

_SENTINEL = object()

#: Staging buffer sets in the pinned ring: one being filled by the host
#: while the previous one's copy is in flight.
_STAGING_DEPTH = 2


class TransferGate:
    """Pauses feed workers while a host->device transfer is in flight.

    On core-starved hosts the thread that pumps the transfer shares its core
    with the collate and recv threads; serializing the two is then cheaper
    than letting them contend.  The gate refcounts in-flight transfers (a
    ``Condition`` over a counter), so one gate can be shared across several
    streams: it opens only when EVERY transfer holding it has finished.

    Params
    ------
    timeout: float
        Liveness backstop for :meth:`wait` — a crashed transfer thread must
        not freeze the feed forever.  Each fire increments the
        ``transfer_gate_backstops`` counter; a warning is logged once per
        stall episode.
    counters: EventCounters | None
        Backstop-fire sink; defaults to the process-wide
        ``blendjax_torch.utils.timing.fleet_counters``.
    """

    def __init__(self, timeout=5.0, counters=None):
        from blendjax_torch.utils.timing import fleet_counters

        self._cond = threading.Condition()
        self._inflight = 0
        self.timeout = timeout
        self._warned = False
        self._counters = counters if counters is not None else fleet_counters

    def wait(self, timeout=None, stop=None):
        """Feed-worker side: block while any transfer is in flight.

        Returns ``True`` when the gate actually opened, ``False`` when the
        wait ended because ``stop`` (an optional ``threading.Event``) was
        set or the liveness backstop expired."""
        deadline = time.monotonic() + (
            self.timeout if timeout is None else timeout
        )
        with self._cond:
            while self._inflight > 0:
                if stop is not None and stop.is_set():
                    return False
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._counters.incr("transfer_gate_backstops")
                    if not self._warned:
                        self._warned = True
                        log.warning(
                            "TransferGate backstop fired after %.1fs: a "
                            "transfer is outliving the gate timeout",
                            self.timeout,
                        )
                    return False
                self._cond.wait(min(0.1, remaining))
        return True

    @contextlib.contextmanager
    def transfer(self):
        """Transfer side: hold the gate closed for the duration of the
        block.  The gate opens when the LAST concurrent transfer exits."""
        with self._cond:
            self._inflight += 1
        try:
            yield
        finally:
            with self._cond:
                self._inflight -= 1
                if self._inflight <= 0:
                    self._warned = False
                    self._cond.notify_all()


def _resolve_gate(transfer_gate, num_workers, device):
    """'auto' enables the gate only where serializing wins: a transfer to
    an accelerator (``device.type != "cpu"``) on a host whose cores are
    outnumbered by feed threads + the transfer pump."""
    if transfer_gate == "auto":
        cores = os.cpu_count() or 1
        if cores <= num_workers + 1 and device.type != "cpu":
            return TransferGate()
        return None
    if transfer_gate is True:
        return TransferGate()
    if transfer_gate in (False, None):
        return None
    if isinstance(transfer_gate, TransferGate):
        return transfer_gate  # caller-supplied gate (shared across streams)
    raise ValueError(
        f"transfer_gate must be 'auto', a bool, None, or a TransferGate; "
        f"got {transfer_gate!r}"
    )


def _resolve_arena(arena, dataset, num_workers, prefetch):
    """Resolve TorchStream's ``arena`` option to an ArenaPool (or None).

    'auto' (the default) enables arena-pooled batch assembly whenever the
    dataset supports the batched stream path (no recording, no per-item
    transform): fixed-shape raw-buffer streams get recycled batch buffers
    out of the box, with the collate fallback applying per key for ragged
    or compat traffic.  Pool depth covers every place a batch can be in
    flight at once (loader queue + device queue + one in transfer + one
    building per worker).
    """
    # identity checks: `0 in (False, None)` is True, and arena=0 must hit
    # ArenaPool's pool_size validation below, not silently disable
    if arena is False or arena is None:
        return None
    if isinstance(arena, ArenaPool):
        return arena
    supported = (hasattr(dataset, "supports_batched_stream")
                 and dataset.supports_batched_stream())
    if arena == "auto":
        if not supported:
            return None
        return ArenaPool(pool_size=num_workers + prefetch + 3)
    if arena is True:
        if not supported:
            raise ValueError(
                "arena=True requires a dataset whose batched stream path "
                "is available (no recording/per-item transform)"
            )
        return ArenaPool(pool_size=num_workers + prefetch + 3)
    if isinstance(arena, int):
        return ArenaPool(pool_size=arena)
    raise ValueError(
        f"arena must be 'auto', a bool, None, an int pool size, or an "
        f"ArenaPool; got {arena!r}"
    )


def _map_leaves(fn, tree, leaf_type):
    """Apply ``fn`` to every ``leaf_type`` leaf of a dict/list/tuple tree;
    other leaves (strings, ragged lists' elements of other types) pass
    through unchanged."""
    if isinstance(tree, leaf_type):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, leaf_type) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [_map_leaves(fn, v, leaf_type) for v in tree]
        return seq if isinstance(tree, list) else tuple(seq)
    return tree


def _owned_cpu_batch(host_batch):
    """CPU placement: a tensor per array leaf, each owning its memory."""
    return _map_leaves(
        lambda a: torch.from_numpy(np.array(a, copy=True)), host_batch, np.ndarray
    )


class _PinnedStager:
    """Ring of page-locked staging buffer sets feeding non-blocking copies
    on a side CUDA stream."""

    def __init__(self, device, depth=_STAGING_DEPTH):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = [[] for _ in range(depth)]
        self.events = [None] * depth
        self.next = 0

    def put(self, host_batch):
        """Issue the copies of one host batch; returns ``(device_batch,
        event)`` where ``event`` completes when every copy has landed."""
        slot = self.next
        self.next = (slot + 1) % len(self.slots)
        if self.events[slot] is not None:
            # this slot's buffers are still being read by an earlier copy
            self.events[slot].synchronize()
        bufs = self.slots[slot]
        leaf = [0]

        def stage(arr):
            i = leaf[0]
            leaf[0] += 1
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            if i == len(bufs):
                bufs.append(None)
            pinned = bufs[i]
            if pinned is None or pinned.shape != arr.shape or pinned.dtype != dtype:
                pinned = bufs[i] = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
            np.copyto(pinned.numpy(), arr)
            out = torch.empty(arr.shape, dtype=dtype, device=self.device)
            out.copy_(pinned, non_blocking=True)
            return out

        with torch.cuda.stream(self.stream):
            dev_batch = _map_leaves(stage, host_batch, np.ndarray)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[slot] = event
        return dev_batch, event


def _hand_over(dev_batch, event, device):
    """Consumer side: order the current stream after the copies and tie
    each tensor's memory to it."""
    stream = torch.cuda.current_stream(device)
    stream.wait_event(event)
    _map_leaves(lambda t: t.record_stream(stream), dev_batch, torch.Tensor)
    return dev_batch


def _check_shardable(shape, sharding):
    """Raise, in the reference's words, when a dimension ``sharding``
    splits does not divide over its mesh axis."""
    mesh = sharding.mesh
    for i, (axis, placement) in enumerate(zip(mesh.mesh_dim_names, sharding.placements)):
        dim = getattr(placement, "dim", None)  # a Shard's
        if dim is None:
            continue
        n = mesh.size(i)
        if dim >= len(shape) or shape[dim] % n:
            why = (f"dimension {dim} of size {shape[dim]} does not divide over mesh "
                   f"axis {axis!r} of size {n}" if dim < len(shape)
                   else f"no dimension {dim} to shard over mesh axis {axis!r}")
            raise ValueError(
                f"batch of shape {tuple(shape)} not shardable as {sharding.spec}: {why}; "
                "pick batch/sequence sizes divisible by the mesh axes they shard over")


def _shard_leaves(batch, sharding):
    """A device batch's tensors as DTensors on ``sharding``'s mesh (module
    docstring: a rank's shard with several ranks, the global batch with
    one)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    mesh, placements = sharding.mesh, sharding.placements
    if dist.is_initialized() and dist.get_world_size() > 1:
        return _map_leaves(
            lambda t: DTensor.from_local(t, mesh, placements, run_check=False),
            batch, torch.Tensor)

    def place(t):
        _check_shardable(t.shape, sharding)
        return distribute_tensor(t, mesh, placements)

    return _map_leaves(place, batch, torch.Tensor)


def put_batch(batch, sharding=None, device="cuda"):
    """Place one host batch (a numpy or tensor tree) on ``device``, the card
    unless the caller asks for the CPU; with ``sharding``, on its mesh's
    device as DTensors (module docstring).  A global batch whose sharded
    dimension does not divide over its mesh axis is refused."""
    if sharding is not None:
        device = sharding.mesh.device_type
    dev = resolve_device(device)
    placed = _map_leaves(
        lambda a: torch.tensor(a, device=dev) if isinstance(a, np.ndarray) else a.to(dev),
        batch, (np.ndarray, torch.Tensor))
    return placed if sharding is None else _shard_leaves(placed, sharding)


def device_prefetch(iterator, size=2, device="cuda", transform=None, timer=None,
                    gate=None, sharding=None):
    """Wrap ``iterator`` (host batches) into an iterator of device batches.

    Params
    ------
    iterator: iterable of numpy pytrees
    size: int
        Batches kept in flight (2 = classic double buffering).
    device: str | torch.device
        Placement for every array leaf; CUDA unless the caller asks for
        the CPU.  Raises when CUDA is asked for and absent.
    transform: callable | None
        Host-side hook applied to each host batch (an ``ArenaBatch``'s
        ``data``) before it is staged (key selection, dtype cast, layout).
    timer: StageTimer | None
        Records ``device_put`` stage times (staging + copy issue) and, for
        arena batches, ``recycle``.
    gate: TransferGate | None
        When set, the gate is held closed for each transfer, including its
        completion — see :class:`TransferGate`.
    sharding: NamedSharding | None
        Each batch's tensors become DTensors on its mesh (module docstring),
        placed on the mesh's device type, which then replaces ``device``.
    """
    if size < 1:
        raise ValueError("prefetch size must be >= 1")
    device = resolve_device(device if sharding is None else sharding.mesh.device_type)
    timer = timer or StageTimer()
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    stager = _PinnedStager(device) if device.type == "cuda" else None
    if stager is not None:
        put = stager.put
    else:
        def put(host_batch):
            return _owned_cpu_batch(host_batch), None

    def _place(host_batch):
        if gate is None:
            return put(host_batch)
        with gate.transfer():
            dev_batch, event = put(host_batch)
            if event is not None:
                # the gate stays closed until the bytes have landed
                event.synchronize()
        return dev_batch, event

    def _producer():
        batch = None
        try:
            for batch in iterator:
                arena_batch = batch if isinstance(batch, ArenaBatch) else None
                if stop.is_set():
                    if arena_batch is not None:
                        arena_batch.recycle()
                    return
                host_batch = batch if arena_batch is None else batch.data
                if transform is not None:
                    host_batch = transform(host_batch)
                with timer.stage("device_put"):
                    item = _place(host_batch)
                if arena_batch is not None:
                    # the arena returns to the freelist only once its batch's
                    # copy has COMPLETED, never on dispatch alone; a slow
                    # trainer therefore backpressures into the pool
                    with timer.stage("recycle"):
                        if item[1] is not None:
                            item[1].synchronize()
                        arena_batch.recycle()
                while True:
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        if stop.is_set():
                            return
            q.put(_SENTINEL)
        except BaseException as exc:  # noqa: BLE001 - forwarded to consumer
            # a transform/put failure must not strand the in-hand arena;
            # copies it may have issued land first (recycle is idempotent)
            if isinstance(batch, ArenaBatch):
                if stager is not None:
                    stager.stream.synchronize()
                batch.recycle()
            q.put(exc)

    thread = threading.Thread(target=_producer, daemon=True, name="bjx-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            dev_batch, event = item
            if event is not None:
                dev_batch = _hand_over(dev_batch, event, device)
            if sharding is not None:
                dev_batch = _shard_leaves(dev_batch, sharding)
            yield dev_batch
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=5)


class TorchStream:
    """End-to-end feed: remote stream -> batches -> device, with timing::

        ds = btt.RemoteIterableDataset(addresses, max_items=...)
        stream = btt.TorchStream(ds, batch_size=8, num_workers=4)
        for batch in stream:          # torch tensors already on the card
            state, loss = train_step(state, batch)

    The counterpart of ``blendjax.btt.prefetch.JaxStream``.  ``device=``
    places every batch on one device (the card unless the caller asks for
    the CPU); ``sharding=`` (``data_sharding(mesh)``) makes each batch
    DTensors on the mesh instead, and a data-parallel rank reads its
    ``shard=(rank, n)`` of the stream (:func:`device_prefetch`).
    ``transform`` is applied to each collated host batch before it is
    staged (e.g. a cast to float16 that halves the copy).
    ``stream.timer.summary()`` exposes the per-stage feed times (recv /
    scatter / arena_wait / device_put / recycle on the arena path, recv /
    collate / device_put on the collate path), and
    ``stream.duty_cycle(name)`` the share of wall time in a stage.  Pass
    ``timer=StageTimer(trace=True)`` to keep a per-thread timeline of the
    feed (the workers, the prefetch thread, and whatever the caller
    records, such as its ``step``) for ``timer.export_chrome_trace``.

    ``arena='auto'`` (default) assembles batches into recycled arena
    buffers (:mod:`blendjax_torch.btt.arena`) whenever the dataset
    supports the batched stream path, each arena recycled only after its
    batch's copy to the card has completed.  Pass False to build each
    batch in fresh buffers instead, an int to size the pool, or a shared
    ``ArenaPool``.
    """

    def __init__(
        self,
        dataset,
        batch_size,
        num_workers=1,
        device="cuda",
        sharding=None,
        shard=(0, 1),
        prefetch=2,
        drop_last=True,
        transfer_gate="auto",
        transform=None,
        arena="auto",
        timer=None,
    ):
        from blendjax_torch.btt.loader import BatchLoader

        self.sharding = sharding
        self.device = resolve_device(device if sharding is None else sharding.mesh.device_type)
        self.gate = _resolve_gate(transfer_gate, num_workers, self.device)
        self.arena_pool = _resolve_arena(arena, dataset, num_workers, prefetch)
        self.loader = BatchLoader(
            dataset,
            batch_size,
            num_workers=num_workers,
            shard=shard,
            drop_last=drop_last,
            gate=self.gate,
            arena_pool=self.arena_pool,
            timer=timer,
        )
        self.prefetch = prefetch
        self.transform = transform
        self.timer = self.loader.timer

    def __len__(self):
        return len(self.loader)

    def duty_cycle(self, name):
        """Fraction of wall time since the timer's last reset spent in
        stage ``name`` (:meth:`StageTimer.duty_cycle`): ``device_put`` for
        the feed's copy share, a caller-recorded ``step`` for the train
        loop's."""
        return self.timer.duty_cycle(name)

    def __iter__(self):
        return device_prefetch(
            iter(self.loader),
            size=self.prefetch,
            device=self.device,
            transform=self.transform,
            timer=self.timer,
            gate=self.gate,
            sharding=self.sharding,
        )

    def close(self):
        self.loader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
