"""Fixed-memory log-bucketed latency histograms.

:class:`LatencyHistogram` records durations into HdrHistogram-style
buckets — one power-of-two octave split into ``2**SUBBITS`` linear
sub-buckets — so memory is fixed, recording is O(1) with no syscalls, and
any quantile is recoverable within the bucket's relative width.  Pure
stdlib: it rides inside :class:`blendjax_torch.utils.timing.StageTimer` on
the feed hot path.  Not thread-safe by itself: the timer holds its own
lock around recording.
"""

from __future__ import annotations

import math

#: Sub-bucket resolution: each power-of-two octave is split into
#: ``2**SUBBITS`` linear sub-buckets.
SUBBITS = 3
_SUB = 1 << SUBBITS

#: Octaves covered above the 1 us floor (~2147 s); slower events clamp
#: into the top bucket (their exact maximum is still tracked).
OCTAVES = 31

#: Total bucket count: one underflow bucket (< 1 us) + the octave grid.
NBUCKETS = 1 + OCTAVES * _SUB


def bucket_index(seconds):
    """Bucket index for a duration (clamped into [0, NBUCKETS))."""
    us = seconds * 1e6
    if us < 1.0:
        return 0
    m, e = math.frexp(us)  # us = m * 2**e with m in [0.5, 1)
    idx = ((e - 1) << SUBBITS) + int((m + m - 1.0) * _SUB) + 1
    return idx if idx < NBUCKETS else NBUCKETS - 1


def bucket_bounds(idx):
    """``(lo_s, hi_s)`` duration range of bucket ``idx``."""
    if idx <= 0:
        return 0.0, 1e-6
    o, sub = (idx - 1) >> SUBBITS, (idx - 1) & (_SUB - 1)
    base = float(1 << o)
    return (
        base * (1.0 + sub / _SUB) * 1e-6,
        base * (1.0 + (sub + 1) / _SUB) * 1e-6,
    )


class LatencyHistogram:
    """Fixed-size log-bucketed duration histogram (seconds in,
    p50/p90/p99/max out)."""

    __slots__ = ("counts", "n", "sum_s", "max_s")

    def __init__(self):
        self.counts = [0] * NBUCKETS
        self.n = 0
        self.sum_s = 0.0
        self.max_s = 0.0

    def add(self, seconds):
        self.counts[bucket_index(seconds)] += 1
        self.n += 1
        self.sum_s += seconds
        if seconds > self.max_s:
            self.max_s = seconds

    def add_many(self, seconds, k):
        """``k`` events at the same duration in one update (the timer's
        ``add_bulk``: pre-aggregated intervals carry only their mean, so
        the bucket resolution is the mean's)."""
        self.counts[bucket_index(seconds)] += k
        self.n += k
        self.sum_s += seconds * k
        if seconds > self.max_s:
            self.max_s = seconds

    def merge(self, other):
        """Fold ``other``'s counts into this histogram (buckets are
        position-aligned by construction)."""
        counts = self.counts
        for i, c in enumerate(other.counts):
            if c:
                counts[i] += c
        self.n += other.n
        self.sum_s += other.sum_s
        if other.max_s > self.max_s:
            self.max_s = other.max_s
        return self

    def quantile(self, q):
        """The ``q``-quantile duration in seconds (bucket-midpoint
        estimate, clamped to the observed maximum; 0.0 while empty).
        Upper-rank convention: a q landing exactly on a mode boundary
        reports the slow side."""
        if self.n <= 0:
            return 0.0
        rank = q * self.n
        seen = 0
        for idx, c in enumerate(self.counts):
            if not c:
                continue
            seen += c
            if seen > rank:
                lo, hi = bucket_bounds(idx)
                return min((lo + hi) / 2.0, self.max_s)
        return self.max_s

    def percentiles(self):
        """``{"p50_ms", "p90_ms", "p99_ms", "max_ms"}``."""
        return {
            "p50_ms": round(self.quantile(0.50) * 1e3, 4),
            "p90_ms": round(self.quantile(0.90) * 1e3, 4),
            "p99_ms": round(self.quantile(0.99) * 1e3, 4),
            "max_ms": round(self.max_s * 1e3, 4),
        }

    def to_dict(self):
        """Sparse JSON-able snapshot (non-zero buckets only): the form a
        remote ``telemetry`` reply and the hub's merge carry."""
        return {
            "n": self.n,
            "sum_s": self.sum_s,
            "max_s": self.max_s,
            "counts": {str(i): c for i, c in enumerate(self.counts) if c},
        }

    @classmethod
    def from_dict(cls, d):
        h = cls()
        if not d:
            return h
        h.n = int(d.get("n", 0))
        h.sum_s = float(d.get("sum_s", 0.0))
        h.max_s = float(d.get("max_s", 0.0))
        for i, c in (d.get("counts") or {}).items():
            h.counts[int(i)] = int(c)
        return h

    def copy(self):
        h = LatencyHistogram()
        h.counts = list(self.counts)
        h.n, h.sum_s, h.max_s = self.n, self.sum_s, self.max_s
        return h


def fold_stage_snapshot(merged, snapshot):
    """Fold one ``StageTimer.snapshot()``-shaped dict into ``merged``
    (``{stage: [count, total_s, LatencyHistogram | None]}``).

    Histograms may arrive as live objects (local timers hand out copies)
    or serialized dicts (remote ``telemetry`` replies); the fold takes
    ownership and merges destructively.  The hub's scrape and the
    supervisor's ``aggregate_health`` share it.
    """
    for stage, rec in (snapshot or {}).items():
        slot = merged.setdefault(stage, [0, 0.0, None])
        slot[0] += int(rec.get("count", 0))
        slot[1] += float(rec.get("total_s", 0.0))
        hist = rec.get("hist")
        if hist is not None:
            if not isinstance(hist, LatencyHistogram):
                hist = LatencyHistogram.from_dict(hist)
            slot[2] = hist if slot[2] is None else slot[2].merge(hist)
    return merged


def stage_records(merged):
    """Render a :func:`fold_stage_snapshot` accumulator as reporting
    records: ``{stage: {"count", "total_s", "mean_ms", "p50_ms", "p90_ms",
    "p99_ms", "max_ms"}}`` (percentiles zero when no histogram
    contributed)."""
    out = {}
    for stage, (count, total_s, hist) in merged.items():
        rec = {
            "count": count,
            "total_s": round(total_s, 6),
            "mean_ms": round((total_s / count) * 1e3, 4) if count else 0.0,
        }
        rec.update(
            hist.percentiles() if hist is not None
            else {"p50_ms": 0.0, "p90_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0}
        )
        out[stage] = rec
    return out
