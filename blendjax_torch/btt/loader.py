"""Threaded batch loader — the torch-DataLoader role in the feed.

Why threads instead of worker processes: the stream's hot path is ZMQ
``recv`` (GIL released in C) plus numpy buffer handling, so threads overlap
IO without the serialization tax of moving tensors between worker
processes.  Each worker thread runs its own PULL socket via
``RemoteIterableDataset.stream_batches(batch_size, worker_id,
num_workers)``.  Batches are assembled inside the worker threads
(DataLoader semantics: each worker emits whole batches), one queue element
per batch: straight from the wire frames (into recycled arenas with
``arena_pool``), or by ``stream()`` + collate where a per-item transform or
recording is set.

A data-parallel rank passes ``shard=(rank, n)``: the stream is then split
ranks x workers, each (rank, worker) taking ``max_items // (num_workers *
n)`` items of the fan-in.
"""

from __future__ import annotations

import queue
import sys
import threading

from blendjax_torch.utils.timing import StageTimer

_SENTINEL = object()


class BatchLoader:
    """Iterates collated batches pulled by ``num_workers`` stream threads.

    Params
    ------
    dataset: RemoteIterableDataset (or anything with ``.stream_batches(...)``)
    batch_size: int
    num_workers: int
        Stream threads; each takes ``1/num_workers`` of ``max_items``.
    shard: (int, int)
        ``(shard_id, num_shards)``: this process's share of the stream when
        several data-parallel ranks read it.
    drop_last: bool
        Drop the final partial batch.
    gate: TransferGate | None
        When set, workers pause at batch boundaries while a host->device
        transfer holds the gate closed (see ``prefetch.TransferGate``).
    arena_pool: blendjax_torch.btt.arena.ArenaPool | None
        When set (and the dataset takes the batched path), batches
        assemble into recycled arena buffers and come out as
        ``ArenaBatch`` objects; the consumer must recycle each one after
        its bytes are consumed (the device feed does this once the copy
        to the card has completed).  Pool exhaustion backpressures the
        workers.
    timer: StageTimer | None
        Where the workers record ``scatter``/``collate``/``arena_wait`` and
        the consumer ``recv`` (a fresh timer when None); pass
        ``StageTimer(trace=True)`` for a per-thread timeline.
    """

    def __init__(
        self,
        dataset,
        batch_size,
        num_workers=1,
        shard=(0, 1),
        drop_last=True,
        gate=None,
        arena_pool=None,
        timer=None,
    ):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.shard = shard
        self.drop_last = drop_last
        self.gate = gate
        self.arena_pool = arena_pool
        self.timer = timer or StageTimer()
        self._queue = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._threads = []
        self._started = False

        # Batching happens per worker: a worker that never accumulates a full
        # batch yields nothing under drop_last, which silently drops the whole
        # stream when batch_size exceeds the per-worker item count.
        max_items = getattr(dataset, "max_items", None)
        if drop_last and max_items is not None:
            per_worker = max_items // (num_workers * shard[1])
            if per_worker < batch_size:
                raise ValueError(
                    f"batch_size={batch_size} exceeds the per-worker item "
                    f"count {per_worker} ({max_items} items / {num_workers} "
                    f"workers / {shard[1]} shards); every batch would be "
                    "dropped. Lower batch_size/num_workers or pass "
                    "drop_last=False."
                )

    def __len__(self):
        """Batches this shard's workers yield, each worker taking
        ``max_items // (num_workers * num_shards)`` items."""
        _, num_shards = self.shard
        per_worker = self.dataset.max_items // (self.num_workers * num_shards)
        n, rem = divmod(per_worker, self.batch_size)
        if not self.drop_last and rem:
            n += 1
        return n * self.num_workers

    # -- worker machinery ---------------------------------------------------

    def _put(self, item):
        """Blocking put that aborts when the loader is being closed, so
        workers can never deadlock on a full queue nobody drains."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, worker_id):
        """One stream thread: the dataset assembles its batches (from the
        wire frames, or by its own ``stream()`` + collate fallback)."""
        try:
            batches = self.dataset.stream_batches(
                self.batch_size,
                worker_id=worker_id,
                num_workers=self.num_workers,
                shard_id=self.shard[0],
                num_shards=self.shard[1],
                stop_event=self._stop,
                drop_last=self.drop_last,
                timer=self.timer,
                arena_pool=self.arena_pool,
            )
            while True:
                if self.gate is not None:
                    # next() does this worker's heavy lifting (recv + batch
                    # assembly): hold it at the boundary while a transfer
                    # owns the core; stop-aware so close() never waits out
                    # the gate
                    self.gate.wait(stop=self._stop)
                try:
                    out = next(batches)
                except StopIteration:
                    break
                if not self._put(out):
                    # stop raced the enqueue: the batch is already detached
                    # from the stream generator, so recycle its arena here
                    # or nobody will
                    if hasattr(out, "recycle"):
                        out.recycle()
                    return
                if self._stop.is_set():
                    return
            self._put(_SENTINEL)
        except BaseException as exc:  # propagate to the consumer thread
            self._put(exc)

    def _start(self):
        self._started = True
        for w in range(self.num_workers):
            t = threading.Thread(
                target=self._worker, args=(w,), daemon=True, name=f"bjx-loader-{w}"
            )
            t.start()
            self._threads.append(t)

    def close(self):
        """Stop worker threads promptly (idempotent)."""
        self._stop.set()
        if sys.is_finalizing():
            # close() can run from generator finalization during interpreter
            # shutdown: the daemon workers are dead, nothing to drain or join
            return
        # drain so blocked put() calls can observe the stop flag; recycle
        # any arena batches stranded in the queue so a shared pool is not
        # starved by an early close
        try:
            while True:
                item = self._queue.get_nowait()
                if hasattr(item, "recycle"):
                    item.recycle()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=5)
        # keep hung workers visible instead of masking a leak
        self._threads = [t for t in self._threads if t.is_alive()]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- consumer side ------------------------------------------------------

    def __iter__(self):
        if self._started:
            raise RuntimeError(
                "BatchLoader is single-use; create a new one per epoch/stream"
            )
        self._start()
        finished = 0
        try:
            while finished < self.num_workers:
                # timed get so a cross-thread close() (which stops workers
                # before their sentinels land) can't strand this consumer
                with self.timer.stage("recv"):
                    while True:
                        if self._stop.is_set():
                            return
                        try:
                            item = self._queue.get(timeout=0.1)
                            break
                        except queue.Empty:
                            continue
                if item is _SENTINEL:
                    finished += 1
                    continue
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self.close()
