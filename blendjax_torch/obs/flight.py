"""Flight recorders: the last N annotated events.  A copy of
``blendjax.obs.flight`` without its postmortem dump (the supervisors that
write one are not ported, ROADMAP Queue 1, item 9).

Counters say how many quarantines happened; after a failure the question
is which target, when, in what order relative to the retries and circuit
trips around it.  A :class:`FlightRecorder` keeps a bounded ring of recent
annotated events (quarantines, retries, circuit opens, re-admissions, with
wall-clock timestamps and payload digests) that costs nothing until
something goes wrong.

A process-wide default instance (:data:`flight_recorder`) is shared by the
fault layer the way ``utils.timing.fleet_counters`` is.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import deque


def _digest(payload):
    """Short stable digest of an event's details: two records (or a record
    and a log line) match without shipping the full payload twice."""
    blob = json.dumps(payload, sort_keys=True, default=repr)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


class FlightRecorder:
    """Thread-safe bounded ring of annotated events.

    Recording is cheap (one lock + dict append) and the ring is bounded,
    so hooks may fire on every fault-layer event of a multi-hour run;
    overflow drops the oldest events and counts them.
    """

    def __init__(self, capacity=512):
        self._lock = threading.Lock()
        self._events = deque(maxlen=int(capacity))
        self._dropped = 0

    @property
    def dropped(self):
        with self._lock:
            return self._dropped

    def __len__(self):
        with self._lock:
            return len(self._events)

    def note(self, event, target=None, **details):
        """Record one event (``target`` names what it happened to, e.g.
        ``"env3"`` / ``"shard1"`` / ``"fleet0"``)."""
        rec = {
            "ts": time.time(),
            "event": str(event),
            "target": None if target is None else str(target),
            "details": {k: v for k, v in details.items() if v is not None},
        }
        rec["digest"] = _digest(rec["details"])
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(rec)
        return rec

    def snapshot(self):
        with self._lock:
            return list(self._events)


#: Process-wide default ring (the fault layer's quarantines, retries and
#: circuit opens), the flight analog of ``utils.timing.fleet_counters``.
flight_recorder = FlightRecorder()
