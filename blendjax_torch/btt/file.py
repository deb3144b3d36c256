"""Single-file message log for record/replay.

Format (the same as ``blendjax.btt.file`` and blendtorch's, so ``.btr``
files interoperate): a pickled int64 offsets array of fixed capacity
``max_messages`` as header, rewritten in place on close, followed by one
pickled message dict per record.  The fixed-capacity header has a stable
byte length, which is what makes the in-place rewrite sound.
"""

from __future__ import annotations

import io
import logging
import pickle
from pathlib import Path

import numpy as np

from blendjax_torch import wire

logger = logging.getLogger("blendjax_torch")

#: Default write-buffer size: one syscall per record costs a measurable
#: share of the record path at high message rates.
DEFAULT_WRITE_BUFFER = 1 << 20


class FileRecorder:
    """Context manager appending raw messages to an offset-indexed log.

    Params
    ------
    outpath: str | Path
        File to write.
    max_messages: int
        Capacity; further ``save`` calls are dropped — warned once per
        recorder, counted in ``dropped`` and as a ``record_drops`` event.
    buffering: int
        Passed to ``io.open``.
    counters: EventCounters | None
        Sink for ``record_drops``; defaults to the process-wide
        ``blendjax_torch.utils.timing.fleet_counters``.
    """

    def __init__(self, outpath="blendjax.btr", max_messages=100000,
                 buffering=DEFAULT_WRITE_BUFFER, counters=None):
        from blendjax_torch.utils.timing import fleet_counters

        outpath = Path(outpath)
        outpath.parent.mkdir(parents=True, exist_ok=True)
        self.outpath = outpath
        self.capacity = max_messages
        self.buffering = buffering
        self.file = None
        self.dropped = 0
        self.counters = counters if counters is not None else fleet_counters
        logger.info("Recording to %s, capacity %d messages.", outpath, max_messages)

    def __enter__(self):
        self.file = io.open(self.outpath, "wb", buffering=self.buffering)
        self.offsets = np.full(self.capacity, -1, dtype=np.int64)
        self.num_messages = 0
        self.dropped = 0
        self._write_header()
        return self

    def _write_header(self):
        self.file.write(pickle.dumps(self.offsets, protocol=wire.PICKLE_PROTOCOL))

    def save(self, data, is_pickled=False):
        """Append one message (dict, or already-pickled bytes).  Returns
        True when stored; False once ``capacity`` is reached."""
        if self.num_messages >= self.capacity:
            if self.dropped == 0:
                logger.warning(
                    "FileRecorder %s is full (%d messages): further "
                    "messages are DROPPED — the recording is truncated, "
                    "raise max_messages to keep them.",
                    self.outpath, self.capacity,
                )
            self.dropped += 1
            self.counters.incr("record_drops")
            return False
        self.offsets[self.num_messages] = self.file.tell()
        self.num_messages += 1
        if is_pickled:
            self.file.write(data)
        else:
            self.file.write(pickle.dumps(data, protocol=wire.PICKLE_PROTOCOL))
        return True

    def flush(self):
        """Push buffered records to the OS now.  The replay shard calls
        this before it acknowledges an ``append``, so every acked row is
        recoverable from the spill log even if the shard is SIGKILLed the
        next instant (:func:`scan_messages` reads an unfinalized log)."""
        if self.file is not None:
            self.file.flush()

    def save_frames(self, frames):
        """Append a message captured as raw ZMQ frames.  Single-frame
        (compat) messages hit disk verbatim; multipart raw-buffer messages
        are decoded and re-pickled so the file format does not depend on
        the wire encoding."""
        if len(frames) == 1:
            self.save(bytes(frames[0]), is_pickled=True)
        else:
            self.save(wire.decode(frames), is_pickled=False)

    def __exit__(self, *args):
        # every record byte lands before any header byte is replaced
        self.file.flush()
        self.file.seek(0)
        self._write_header()  # fixed byte length: same capacity, same protocol
        self.file.close()
        self.file = None
        return False

    @staticmethod
    def filename(prefix, worker_idx):
        """Per-worker file name ``{prefix}_{worker:02d}.btr``."""
        return f"{prefix}_{worker_idx:02d}.btr"


def scan_messages(path):
    """Yield messages from a ``.btr`` file sequentially, ignoring the
    offsets header: the crash-recovery read path.

    :class:`FileRecorder` rewrites its header only on a clean close; a
    recorder killed mid-stream leaves the header all ``-1``, which
    :class:`FileReader` reads as an empty file.  Records nonetheless lie
    back to back after the header, so this scanner recovers every fully
    written one.  A torn final record (the crash landed mid-``write``)
    ends the scan cleanly.
    """
    with io.open(path, "rb") as f:
        try:
            pickle.load(f)  # the (possibly unfinalized) offsets header
        except (EOFError, pickle.UnpicklingError):
            return
        while True:
            try:
                yield pickle.load(f)
            except (EOFError, pickle.UnpicklingError, AttributeError,
                    MemoryError, ValueError):
                return  # torn tail: the crash interrupted the last write


class FileReader:
    """Random access to messages written by :class:`FileRecorder`.  The
    file handle is opened lazily per process so readers cross
    worker-process boundaries safely."""

    def __init__(self, path):
        self.path = path
        self.offsets = FileReader.read_offsets(path)
        self._file = None

    def __len__(self):
        return len(self.offsets)

    def __getitem__(self, idx):
        if self._file is None:
            self._file = io.open(self.path, "rb")
        self._file.seek(self.offsets[idx])
        return pickle.load(self._file)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    @staticmethod
    def read_offsets(fname):
        """Load the header; trims unused (-1) capacity entries."""
        if not Path(fname).exists():
            raise FileNotFoundError(f"Cannot open {fname} for reading.")
        with io.open(fname, "rb") as f:
            offsets = pickle.load(f)
        unused = np.flatnonzero(offsets == -1)
        count = unused[0] if len(unused) else len(offsets)
        return offsets[:count]
