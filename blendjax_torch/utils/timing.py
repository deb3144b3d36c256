"""Lightweight per-stage timing and named event counters.

Usage::

    timer = StageTimer()
    with timer.stage("recv"):
        msg = sock.recv()
    ...
    timer.summary()   # {'recv': {'count': n, 'total_s': t, 'mean_ms': m,
                      #           'p50_ms': ..., 'p90_ms': ..., 'p99_ms': ...,
                      #           'max_ms': ...}, ...}

Every ``add`` also lands in a fixed-memory log-bucketed latency histogram
(:class:`blendjax_torch.obs.histogram.LatencyHistogram`), so the summary
carries per-stage percentiles.  The feed records ``recv`` (loader queue
wait), ``collate`` (batch assembly in a worker, collate path),
``arena_wait`` (a worker blocked on an exhausted arena pool), ``scatter``
(wire frames copied into an arena batch), ``device_put`` (staging +
host->device copy issue) and ``recycle`` (the wait for an arena's copy to
complete, and its return to the pool), under the reference's names.  The chrome-trace export of
``blendjax.utils.timing`` is not ported.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

from blendjax_torch.obs.histogram import LatencyHistogram


class EventCounters:
    """Thread-safe named event counters (stream timeouts, recorder drops,
    transfer-gate backstops; the env layer's retries, timeouts,
    quarantines and re-admissions).  :data:`fleet_counters` is the process-wide
    default; pass a fresh instance for isolated accounting."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = defaultdict(int)

    def incr(self, name, n=1):
        with self._lock:
            self._counts[name] += n

    def get(self, name):
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self):
        """Copy of all counters as a plain dict."""
        with self._lock:
            return dict(self._counts)

    def reset(self):
        with self._lock:
            self._counts.clear()


#: Process-wide default counter registry.  Component constructors take a
#: ``counters=`` override for isolated accounting.
fleet_counters = EventCounters()


class StageTimer:
    """Accumulates wall-clock time per named stage (thread-safe: stages are
    recorded from loader workers and the prefetch thread concurrently)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total = defaultdict(float)
        self._count = defaultdict(int)
        self._hist = defaultdict(LatencyHistogram)

    @contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name, seconds):
        with self._lock:
            self._total[name] += seconds
            self._count[name] += 1
            self._hist[name].add(seconds)

    def count(self, name):
        with self._lock:
            return self._count.get(name, 0)

    def percentiles(self, name):
        """``{"p50_ms","p90_ms","p99_ms","max_ms"}`` for a stage (zeros
        when unrecorded)."""
        with self._lock:
            h = self._hist.get(name)
            if h is None:
                return {"p50_ms": 0.0, "p90_ms": 0.0, "p99_ms": 0.0,
                        "max_ms": 0.0}
            return h.percentiles()

    def summary(self):
        with self._lock:
            out = {}
            for name, total in self._total.items():
                count = self._count[name]
                out[name] = {
                    "count": count,
                    "total_s": round(total, 6),
                    "mean_ms": round((total / count) * 1e3, 3),
                    **self._hist[name].percentiles(),
                }
            return out
