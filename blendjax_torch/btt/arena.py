"""Arena-pooled batch buffers: preallocated, recycled batch storage that
the stream assembles batches into straight from the wire frames.

Without an arena, ``collate`` stacks the per-item views of each batch into
freshly allocated storage.  An :class:`ArenaPool` removes that allocation
and caps host memory: it keeps a fixed set of :class:`Arena` objects, one
``(batch_size, *leaf_shape)`` numpy buffer per pytree leaf, recycled batch
over batch.  ``_BatchBuilder`` (:mod:`blendjax_torch.btt.dataset`) writes
each message's payloads into the acquired arena at their final batch
offset; the device feed (:mod:`blendjax_torch.btt.prefetch`) stages the
batch through its ring of page-locked buffers and returns the arena to the
freelist only once the batch's host->device copy has completed, so a slow
trainer backpressures into the pool instead of allocating without bound.

Stage timers recorded along this path (see
:class:`blendjax_torch.utils.timing.StageTimer`): ``arena_wait`` (time
blocked acquiring a free arena: pool exhaustion is trainer backpressure),
``scatter`` (frame decode and copy into the arena), ``recycle`` (the wait
for the device copy to complete, and the arena's return to the pool).
"""

from __future__ import annotations

import threading
import time


class Arena:
    """One recyclable set of batch buffers (one ndarray per pytree leaf).

    Buffers are created lazily on first sight of each leaf's
    ``(batch_size, *shape)`` / dtype and reused verbatim on later
    batches; a leaf whose schema drifts gets its buffer replaced (the
    old one is garbage collected with the batch that still views it).
    """

    __slots__ = ("buffers", "_pool")

    def __init__(self, pool=None):
        self.buffers = {}  # path -> ndarray (batch_size, *leaf_shape)
        self._pool = pool

    def get_buffer(self, path, shape, dtype):
        """The preallocated buffer for ``path``, (re)allocated on schema
        change.  ``shape`` includes the leading batch axis."""
        import numpy as np

        buf = self.buffers.get(path)
        if buf is None or buf.shape != tuple(shape) or buf.dtype != dtype:
            buf = np.empty(shape, dtype)
            self.buffers[path] = buf
        return buf

    def release(self):
        """Return this arena to its pool (no-op for pool-less arenas)."""
        if self._pool is not None:
            self._pool.release(self)


class ArenaPool:
    """Bounded freelist of :class:`Arena` objects shared by the feed
    threads.

    ``acquire`` blocks while every arena is checked out — the pool is
    the backpressure valve between the recv/scatter threads and the
    device copy: when the trainer falls behind, assembly stalls here
    instead of allocating new batch storage without bound.  Thread-safe
    (one pool is shared across all loader workers and the prefetch
    thread).
    """

    def __init__(self, pool_size=4):
        if pool_size < 1:
            raise ValueError(f"pool_size must be >= 1, got {pool_size}")
        self.pool_size = pool_size
        self._cond = threading.Condition()
        self._free = []
        self._created = 0

    @property
    def in_use(self):
        """Arenas currently checked out (diagnostics / tests)."""
        with self._cond:
            return self._created - len(self._free)

    def acquire(self, timeout=None, stop_event=None):
        """Next free arena; blocks while the pool is exhausted.

        Returns ``None`` when ``stop_event`` is set or ``timeout``
        (seconds) expires before an arena frees up — callers treat that
        as a shutdown/timeout signal, never as an empty batch.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._free:
                    return self._free.pop()
                if self._created < self.pool_size:
                    self._created += 1
                    return Arena(self)
                if stop_event is not None and stop_event.is_set():
                    return None
                wait = 0.1
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    wait = min(wait, remaining)
                self._cond.wait(wait)

    def release(self, arena):
        """Return ``arena`` to the freelist (idempotent per checkout)."""
        with self._cond:
            if arena not in self._free:
                self._free.append(arena)
                self._cond.notify()


class ArenaBatch:
    """A collated batch whose array leaves live in a pooled arena.

    ``data`` is the plain numpy pytree (exactly what the collate path
    yields); :meth:`recycle` returns the backing arena to its pool and
    MUST only be called once the batch's bytes have been consumed — the
    device feed calls it after the batch's copy to the card has
    completed.  Idempotent: a double recycle is a no-op.

    ``meta`` carries producer-side values that live outside the batch
    pytree — e.g. the replay sampler's ``(indices, weights)`` pair.  The
    device feed, which unwraps ``data``, ignores it; a direct consumer
    reads it before recycling.
    """

    __slots__ = ("data", "arena", "meta")

    def __init__(self, data, arena, meta=None):
        self.data = data
        self.arena = arena
        self.meta = meta

    def recycle(self):
        arena, self.arena = self.arena, None
        if arena is not None:
            arena.release()
