"""Cross-process trace spans over the wire's correlation ids, a copy of
``blendjax.obs.spans``.

Every env RPC already carries a ``wire.BTMID_KEY`` correlation id; a
tracing client (``EnvPool(trace=True)``) turns that id into a trace id:

- it stamps its request with a span context (``wire.SPAN_KEY``) and
  records a client-side span for the whole RPC, tagged with the id;
- a server (``btb.env.RemoteControlledAgent``) that sees the span context
  records its own recv->work->reply span and ships it back piggybacked on
  the reply (``wire.SPANS_KEY``);
- the client ingests the piggybacked spans into its :class:`SpanRecorder`,
  so one recorder holds both sides of every RPC on one timeline, and one
  :func:`export_chrome_trace` call writes them as a single Perfetto /
  ``chrome://tracing`` file where every pid has its own row.

Timestamps are wall-clock epoch microseconds (``time.time_ns``), so spans
recorded in different processes on one host align.  Pure stdlib:
producers run it inside Blender's embedded Python.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager


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
    def capacity(self):
        return self._spans.maxlen

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

    @contextmanager
    def span(self, name, *, trace=None, cat=None, args=None):
        """Record the ``with`` block as one span."""
        t0 = now_us()
        try:
            yield
        finally:
            self.record(make_span(name, t0, trace=trace, cat=cat, args=args))

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

    def drain(self):
        """Pop every recorded span."""
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
            return out

    def export_chrome_trace(self, path, extra=()):
        """Write this recorder's spans, and those of each source in
        ``extra`` (as :func:`export_chrome_trace` takes them), as one
        chrome-tracing JSON; returns the event count."""
        return export_chrome_trace(path, self.snapshot(), *extra)


def export_chrome_trace(path, *span_sources):
    """Merge span lists, :class:`SpanRecorder` instances and the paths of
    earlier exported files into one chrome-tracing JSON at ``path``, events
    sorted by ``(ts, pid)`` whatever order the sources came in.  Returns
    the number of events written."""
    events = []
    for src in span_sources:
        if src is None:
            continue
        if isinstance(src, SpanRecorder):
            events.extend(src.snapshot())
        elif isinstance(src, (str, os.PathLike)):
            events.extend(load_chrome_trace(src))
        else:
            events.extend(src)
    events.sort(key=lambda e: (e.get("ts", 0), e.get("pid", 0)))
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


def load_chrome_trace(path):
    """The events of a chrome-tracing JSON file, in its dict form
    (``{"traceEvents": [...]}``) or its bare-array form."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        return list(doc.get("traceEvents", []))
    return list(doc)
