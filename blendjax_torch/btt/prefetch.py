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
read it has completed — the counterpart of ``block_until_ready`` before an
arena recycle in ``blendjax.btt.prefetch``.

On the CPU, ``torch.from_numpy`` would alias the host batch, so a producer
that reuses its buffers would rewrite batches already handed out; CPU
batches are therefore copied into memory they own.
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


def device_prefetch(iterator, size=2, device="cuda", transform=None, timer=None,
                    gate=None):
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
        Host-side hook applied to each host batch before it is staged
        (key selection, dtype cast, layout).
    timer: StageTimer | None
        Records ``device_put`` stage times (staging + copy issue).
    gate: TransferGate | None
        When set, the gate is held closed for each transfer, including its
        completion — see :class:`TransferGate`.
    """
    if size < 1:
        raise ValueError("prefetch size must be >= 1")
    device = resolve_device(device)
    timer = timer or StageTimer()
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    if device.type == "cuda":
        put = _PinnedStager(device).put
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
        try:
            for batch in iterator:
                if stop.is_set():
                    return
                if transform is not None:
                    batch = transform(batch)
                with timer.stage("device_put"):
                    item = _place(batch)
                while True:
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        if stop.is_set():
                            return
            q.put(_SENTINEL)
        except BaseException as exc:  # noqa: BLE001 - forwarded to consumer
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

    The counterpart of ``blendjax.btt.prefetch.JaxStream``: ``device=``
    takes the place of ``sharding=`` (one device; multi-device placement
    is not ported).  ``transform`` is applied to each collated host batch
    before it is staged (e.g. a cast to float16 that halves the copy).
    ``stream.timer.summary()`` exposes the per-stage feed times (recv /
    collate / device_put).
    """

    def __init__(
        self,
        dataset,
        batch_size,
        num_workers=1,
        device="cuda",
        prefetch=2,
        drop_last=True,
        transfer_gate="auto",
        transform=None,
    ):
        from blendjax_torch.btt.loader import BatchLoader

        self.device = resolve_device(device)
        self.gate = _resolve_gate(transfer_gate, num_workers, self.device)
        self.loader = BatchLoader(
            dataset,
            batch_size,
            num_workers=num_workers,
            drop_last=drop_last,
            gate=self.gate,
        )
        self.prefetch = prefetch
        self.transform = transform
        self.timer = self.loader.timer

    def __iter__(self):
        return device_prefetch(
            iter(self.loader),
            size=self.prefetch,
            device=self.device,
            transform=self.transform,
            timer=self.timer,
            gate=self.gate,
        )

    def close(self):
        self.loader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
