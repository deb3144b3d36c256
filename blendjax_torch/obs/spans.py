"""Cross-process trace spans over the wire's correlation ids, a copy of
``blendjax.obs.spans`` without its chrome-trace export.

Every env RPC already carries a ``wire.BTMID_KEY`` correlation id; a
tracing client (``EnvPool(trace=True)``) turns that id into a trace id:

- it stamps its request with a span context (``wire.SPAN_KEY``) and
  records a client-side span for the whole RPC, tagged with the id;
- a server (``btb.env.RemoteControlledAgent``) that sees the span context
  records its own recv->work->reply span and ships it back piggybacked on
  the reply (``wire.SPANS_KEY``);
- the client ingests the piggybacked spans into its :class:`SpanRecorder`,
  so one recorder holds both sides of every RPC on one timeline.

Timestamps are wall-clock epoch microseconds (``time.time_ns``), so spans
recorded in different processes on one host align.  Pure stdlib:
producers run it inside Blender's embedded Python.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque


def now_us():
    """Wall-clock epoch microseconds (the shared span timebase)."""
    return time.time_ns() // 1000


def make_span(name, t0_us, *, dur_us=None, trace=None, cat=None,
              pid=None, tid=None, args=None):
    """One chrome-tracing complete event (``ph: "X"``).  ``dur_us=None``
    closes the span now."""
    span = {
        "name": name,
        "ph": "X",
        "ts": t0_us,
        "dur": (now_us() - t0_us) if dur_us is None else dur_us,
        "pid": os.getpid() if pid is None else pid,
        "tid": threading.get_ident() if tid is None else tid,
    }
    if cat is not None:
        span["cat"] = cat
    a = dict(args) if args else {}
    if trace is not None:
        a["trace"] = trace
    if a:
        span["args"] = a
    return span


def span_trace(span):
    """The trace (correlation) id a span was tagged with, or None."""
    return (span.get("args") or {}).get("trace")


class SpanRecorder:
    """Thread-safe bounded ring of completed spans.  Overflow drops the
    oldest spans and counts them in :attr:`dropped`."""

    def __init__(self, capacity=8192):
        self._lock = threading.Lock()
        self._spans = deque(maxlen=int(capacity))
        self._dropped = 0

    @property
    def dropped(self):
        with self._lock:
            return self._dropped

    def __len__(self):
        with self._lock:
            return len(self._spans)

    def record(self, span):
        """Append one span dict (see :func:`make_span`)."""
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(span)

    def ingest(self, spans):
        """Absorb spans shipped back by a remote peer (a reply's
        ``wire.SPANS_KEY`` list); tolerant of None and []."""
        if not spans:
            return 0
        with self._lock:
            for s in spans:
                if isinstance(s, dict):
                    if len(self._spans) == self._spans.maxlen:
                        self._dropped += 1
                    self._spans.append(s)
        return len(spans)

    def snapshot(self):
        with self._lock:
            return list(self._spans)
