"""Streaming and replay datasets.

``RemoteIterableDataset`` pulls message dicts from N Blender producers over
a fan-in PULL socket (fair-queued across producers, HWM backpressure).
Worker parallelism is explicit — ``stream(worker_id, num_workers, ...)`` —
so any executor (threads in :class:`blendjax_torch.btt.loader.BatchLoader`
or torch DataLoader worker processes) can drive it.  Each worker yields
``max_items // num_workers`` items.

This is the per-item path, which ``item_transform`` selects in the
datagen workload; the arena batched stream and the ``shm://`` rings are
not ported.  zmq is imported where the stream opens its socket, so the
replay side (:class:`FileDataset`) works without pyzmq.
"""

from __future__ import annotations

import bisect
import sys
from contextlib import ExitStack
from glob import glob

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
        import zmq

        ctx = zmq.Context.instance()
        socket = ctx.socket(zmq.PULL)
        socket.setsockopt(zmq.RCVHWM, self.queue_size)
        socket.setsockopt(zmq.LINGER, 0)
        try:
            for addr in self.addresses:
                socket.connect(addr)
            poller = zmq.Poller()
            poller.register(socket, zmq.POLLIN)

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
                    yield self.item_transform(obj)
        finally:
            socket.close(0)

    def _poll_message(self, poller, stop_event):
        """Wait for the next message on the PULL socket: True when one is
        ready, False when ``stop_event`` fired; raises TimeoutError after
        ``timeoutms`` of silence."""
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
