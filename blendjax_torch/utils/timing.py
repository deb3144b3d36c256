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
complete, and its return to the pool), under the reference's names; the
policy server records :data:`SERVE_STAGES`, the HA checkpointer
:data:`HA_STAGES`.  The chrome-trace export of
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


#: Canonical policy-serving event names
#: (:class:`blendjax_torch.serve.server.PolicyServer`), the reference's:
#: ``serve_requests`` / ``serve_replies`` — requests admitted, replies
#: sent; ``serve_batches`` — batched model calls (ticks);
#: ``serve_batch_pad`` — padding rows added to reach a bucket;
#: ``serve_cache_hits`` — retried requests answered from the reply cache;
#: ``serve_dup_inflight`` — duplicates of a still-queued request dropped at
#: admission; ``serve_resets`` / ``serve_closes`` — episodes admitted and
#: closed; ``serve_evictions`` — idle slots reclaimed; ``serve_slot_denied``
#: — resets refused for want of a slot; ``serve_errors`` — requests
#: answered with an error (or dropped as undecodable); ``serve_prefills``
#: — episodes admitted with an observation prefix; ``serve_wire_bytes`` —
#: request and reply payload bytes over the socket; ``serve_shm_bytes`` —
#: the same through shared-memory rings (no such transport in the port
#: yet: ROADMAP Queue 1, item 8).
SERVE_EVENTS = (
    "serve_requests", "serve_replies", "serve_batches",
    "serve_batch_pad", "serve_cache_hits", "serve_dup_inflight",
    "serve_resets", "serve_closes", "serve_evictions",
    "serve_slot_denied", "serve_errors", "serve_prefills",
    "serve_wire_bytes", "serve_shm_bytes",
)

#: Canonical policy-serving stage names (:class:`StageTimer`):
#: ``queue_wait`` (admission to batch dequeue), ``batch_assemble`` (drain,
#: pad to the bucket, host arrays), ``compute`` (the batched model call, to
#: its result on the host), ``reply`` (the batch's replies sent).
SERVE_STAGES = (
    "queue_wait", "batch_assemble", "compute", "reply",
)

#: Canonical learner-failover (HA) event names, the reference's:
#: ``ha_ckpt_saves`` — coordinated checkpoints committed (the manifest
#: written); ``ha_ckpt_bytes`` — bytes serialized into committed
#: checkpoints; ``ha_ckpt_skipped`` — due checkpoints skipped because the
#: previous background serialization was still in flight;
#: ``ha_ckpt_failures`` — checkpoint attempts that failed (counted and
#: logged, never raised into the update loop); ``ha_ckpt_evicted`` — old
#: cuts removed by retention; ``ha_restores`` — restores from a manifest;
#: ``ha_restore_fallbacks`` — restores that fell back to an older step or
#: manifest because the latest failed to load; ``ha_learner_deaths`` /
#: ``ha_learner_respawns`` — supervised learner-process deaths and
#: respawns; ``ha_resume_publishes`` — restored parameters republished on
#: a weight bus (no bus in the port yet: ROADMAP Queue 1, item 9).
HA_EVENTS = (
    "ha_ckpt_saves", "ha_ckpt_bytes", "ha_ckpt_skipped",
    "ha_ckpt_failures", "ha_ckpt_evicted",
    "ha_restores", "ha_restore_fallbacks",
    "ha_learner_deaths", "ha_learner_respawns", "ha_resume_publishes",
)

#: Canonical learner-failover stage names: ``ha_snapshot`` (the
#: synchronous barrier on the update loop: the TrainState copied to host
#: buffers, ordered after the update, plus the replay cut), ``ha_serialize``
#: (the background thread: npz writes, fsync, manifest commit, retention),
#: ``ha_restore`` (the train state restored in place from a manifest).
HA_STAGES = (
    "ha_snapshot", "ha_serialize", "ha_restore",
)

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
