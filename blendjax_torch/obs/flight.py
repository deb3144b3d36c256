"""Flight recorders: the last N annotated events, dumpable post-crash.  A
copy of ``blendjax.obs.flight``.

Counters say how many quarantines happened; after a failure the question
is which target, when, in what order relative to the retries and circuit
trips around it.  A :class:`FlightRecorder` keeps a bounded ring of recent
annotated events (quarantines, retries, circuit opens, re-admissions, with
wall-clock timestamps and payload digests) that costs nothing until
something goes wrong, and :meth:`FlightRecorder.dump` writes the ring as a
postmortem JSON the moment it does (the learner supervisor's death
handling calls it; ``BJX_POSTMORTEM_DIR`` names the default destination).

A process-wide default instance (:data:`flight_recorder`) is shared by the
fault layer the way ``utils.timing.fleet_counters`` is.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from collections import deque

logger = logging.getLogger("blendjax_torch")

#: Environment variable naming the default postmortem output directory;
#: unset, dumps without an explicit path are skipped (library code must not
#: scatter files by default).
POSTMORTEM_DIR_ENV = "BJX_POSTMORTEM_DIR"


def default_postmortem_dir():
    """The ``BJX_POSTMORTEM_DIR`` directory, or None when unset."""
    return os.environ.get(POSTMORTEM_DIR_ENV) or None


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

    def clear(self):
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def dump(self, path=None, *, reason="", extra=None, directory=None):
        """Write the ring as a postmortem JSON (the reference's format,
        ``"blendjax.postmortem/1"``); returns the path, or None when no
        destination is known (no ``path``, no ``directory``, no
        ``BJX_POSTMORTEM_DIR``).

        Never raises: the dump runs on failure paths (supervisor death
        callbacks) where a secondary I/O error must not mask the original
        fault.
        """
        try:
            if path is None:
                directory = directory or default_postmortem_dir()
                if directory is None:
                    return None
                os.makedirs(directory, exist_ok=True)
                slug = "".join(c if c.isalnum() else "-" for c in str(reason))[:48].strip("-")
                path = os.path.join(directory, f"postmortem-{int(time.time() * 1e3)}"
                                               f"-pid{os.getpid()}-{slug or 'event'}.json")
            with self._lock:
                events = list(self._events)
                dropped = self._dropped
            doc = {
                "format": "blendjax.postmortem/1",
                "ts": time.time(),
                "pid": os.getpid(),
                "reason": str(reason),
                "events": events,
                "events_dropped": dropped,
            }
            if extra:
                doc["extra"] = extra
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, default=repr)
            os.replace(tmp, path)
            logger.warning("flight recorder postmortem written: %s", path)
            return path
        except Exception:  # noqa: BLE001 - diagnostics must not cascade
            logger.exception("flight recorder dump failed")
            return None


#: Process-wide default ring (the fault layer's quarantines, retries and
#: circuit opens; the learner supervisor's deaths), the flight analog of
#: ``utils.timing.fleet_counters``.
flight_recorder = FlightRecorder()
