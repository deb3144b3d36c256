"""Versioned, checksummed parameter snapshots: a numpy-only copy of
``blendjax.weights.snapshot``, byte for byte the same wire format.

A snapshot is one model's parameter pytree flattened into an ordered
``{path: ndarray}`` leaf map (dicts recurse by sorted key, lists by ``#i``
index) with a monotonic version id, the learner ``step`` that produced it,
and a CRC digest per leaf plus one over the whole byte stream.  On the wire
it rides as ``begin`` / ``chunk``* / ``commit`` messages
(:func:`snapshot_messages`); ``begin`` carries the manifest and the paths
carried unchanged from a ``base`` version (leaf-level deltas).

:class:`SnapshotAssembler` accepts the stream in order and discards torn
(a superseding ``begin``, a sequence gap, a stalled stream) and
digest-mismatched snapshots without half-applying them; a delta whose base
it does not hold is refused with ``need_full``.
"""

from __future__ import annotations

import time
import zlib

import numpy as np

#: Default chunk payload size: big enough that framing is noise, small
#: enough that one chunk never stalls a serving tick's poll slice.
DEFAULT_CHUNK_BYTES = 256 * 1024


def _crc(data, crc=0):
    return zlib.crc32(data, crc) & 0xFFFFFFFF


def leaf_digest(arr):
    """CRC32 over a leaf's dtype, shape AND bytes (a reshaped or recast
    leaf with identical bytes must not collide)."""
    arr = np.ascontiguousarray(arr)
    head = f"{arr.dtype.str}:{arr.shape}".encode()
    return _crc(arr.tobytes(), _crc(head))


def flatten_tree(tree, prefix=""):
    """Pytree (nested dicts/lists/tuples of arrays) -> ordered
    ``{path: np.ndarray}``.  Dict levels flatten by sorted key, list
    levels by ``#i`` index, joined with ``/`` — deterministic order, so
    the byte stream (and its digest) is a pure function of the tree."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            if not isinstance(k, str) or "/" in k or k.startswith("#"):
                raise ValueError(f"unflattenable dict key {k!r}")
            out.update(flatten_tree(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}#{i}/"))
        return out
    arr = np.asarray(tree)
    if arr.dtype == object:
        raise TypeError(f"object-dtype leaf at {prefix[:-1]!r}")
    out[prefix[:-1]] = arr
    return out


def unflatten_tree(leaves):
    """Inverse of :func:`flatten_tree`: ``{path: arr}`` -> nested
    dicts/lists (``#i`` components rebuild lists)."""
    root = {}
    for path, arr in leaves.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            idx = sorted(node, key=lambda k: int(k[1:]))
            if [int(k[1:]) for k in idx] != list(range(len(idx))):
                raise ValueError(f"gappy list indices: {sorted(node)}")
            return [build(node[k]) for k in idx]
        return {k: build(v) for k, v in node.items()}

    return build(root)


class Snapshot:
    """One complete, verified parameter snapshot."""

    __slots__ = ("version", "step", "model", "leaves", "digests")

    def __init__(self, version, step, leaves, *, model=None,
                 digests=None):
        self.version = int(version)
        self.step = int(step)
        self.model = model
        #: ordered {path: C-contiguous np.ndarray}
        self.leaves = {
            p: np.ascontiguousarray(a) for p, a in leaves.items()
        }
        self.digests = digests or {
            p: leaf_digest(a) for p, a in self.leaves.items()
        }

    @classmethod
    def from_params(cls, params, version, step=0, *, model=None):
        return cls(version, step, flatten_tree(params), model=model)

    def tree(self):
        """The snapshot's pytree (what ``model.apply_weights`` takes)."""
        return unflatten_tree(self.leaves)

    @property
    def total_bytes(self):
        return sum(a.nbytes for a in self.leaves.values())


def snapshot_messages(snap, *, prev=None,
                      chunk_bytes=DEFAULT_CHUNK_BYTES):
    """The snapshot's wire messages (``begin``, ``chunk``*, ``commit``)
    as a list of dicts.  ``prev`` (the publisher's previously published
    :class:`Snapshot`) enables leaf-level deltas: leaves whose digest is
    unchanged ride as ``carry`` paths instead of bytes, and ``base``
    names the version the receiver must hold to fill them in."""
    shipped, carry = [], []
    for path, arr in snap.leaves.items():
        if prev is not None and prev.digests.get(path) == \
                snap.digests[path] and path in prev.leaves:
            carry.append(path)
        else:
            shipped.append(path)
    manifest = [
        [p, snap.leaves[p].dtype.str, list(snap.leaves[p].shape),
         int(snap.leaves[p].nbytes), snap.digests[p]]
        for p in shipped
    ]
    payload = b"".join(snap.leaves[p].tobytes() for p in shipped)
    chunk_bytes = max(1, int(chunk_bytes))
    nchunks = max(1, -(-len(payload) // chunk_bytes)) if payload else 0
    msgs = [{
        "wb": "begin",
        "version": snap.version,
        "step": snap.step,
        "model": snap.model,
        "base": prev.version if (prev is not None and carry) else None,
        "carry": carry if (prev is not None and carry) else [],
        "manifest": manifest,
        "carry_digests": (
            {p: snap.digests[p] for p in carry} if carry else {}
        ),
        "nchunks": nchunks,
        "total_bytes": len(payload),
    }]
    for seq in range(nchunks):
        msgs.append({
            "wb": "chunk",
            "version": snap.version,
            "seq": seq,
            "data": np.frombuffer(
                payload, np.uint8, offset=seq * chunk_bytes,
                count=min(chunk_bytes, len(payload) - seq * chunk_bytes),
            ),
        })
    msgs.append({
        "wb": "commit",
        "version": snap.version,
        "digest": _crc(payload),
    })
    return msgs


class SnapshotAssembler:
    """Reassemble ``begin``/``chunk``/``commit`` streams into verified
    :class:`Snapshot` objects.  Stateful: holds the last good snapshot
    as the delta base, and at most one in-flight assembly.

    :meth:`feed` returns one of
    ``(None, None)`` — message consumed, nothing completed;
    ``(snapshot, None)`` — a complete, digest-verified snapshot;
    ``(None, "torn" | "digest" | "need_full")`` — the in-flight
    assembly was discarded (the caller counts it; ``need_full`` also
    means: request a full snapshot, our delta base is missing).
    Torn or mismatched streams are *discarded*, never half-applied.
    """

    def __init__(self, *, stall_timeout_s=5.0):
        self.stall_timeout_s = float(stall_timeout_s)
        self.last = None          # last good Snapshot (the delta base)
        self._cur = None          # in-flight: dict of assembly state
        self._last_chunk_t = 0.0

    @property
    def version(self):
        return self.last.version if self.last is not None else None

    @property
    def in_flight(self):
        """True while an assembly is mid-stream (chunks still owed).
        The subscriber gates its periodic resync on this: a ``wb_sync``
        fired mid-assembly makes the publisher stream a duplicate full
        snapshot for nothing (and, were streams not serialized, its
        ``begin`` would tear the in-progress one).  A *dead* publisher
        mid-stream is :meth:`check_stalled`'s job, not the keepalive's.
        """
        return self._cur is not None

    def _discard(self, reason):
        self._cur = None
        return None, reason

    def check_stalled(self):
        """Poll-time tear detection: an assembly with no chunk for
        ``stall_timeout_s`` is torn (publisher died mid-stream) —
        discard it so the counter pins even before a successor
        publishes.  Returns the tear reason or None."""
        if self._cur is not None and self.stall_timeout_s > 0 and \
                time.monotonic() - self._last_chunk_t \
                > self.stall_timeout_s:
            self._cur = None
            return "torn"
        return None

    def feed(self, msg):
        kind = msg.get("wb")
        if kind == "begin":
            reason = None
            if self._cur is not None:
                # a superseding begin: the previous stream is torn
                reason = "torn"
                self._cur = None
            version = int(msg["version"])
            if self.last is not None and version <= self.last.version:
                # stale (re)publication — an old publisher's leftovers,
                # or a respawned publisher whose version base was not
                # raised past its predecessor: versions are monotonic,
                # never adopt backwards.  "stale" (when no assembly was
                # torn) lets the caller WARN: a persistently stale
                # publisher means the fleet is silently not updating
                return None, reason or (
                    "stale" if version < self.last.version else None
                )
            base = msg.get("base")
            carry = list(msg.get("carry") or [])
            if carry and (self.last is None
                          or self.last.version != base
                          or any(p not in self.last.leaves
                                 for p in carry)):
                # a delta whose base we do not hold (late joiner, or a
                # tear ate the base): refuse and ask for a full one
                self._cur = None
                return None, "need_full"
            self._cur = {
                "version": version,
                "step": int(msg.get("step", 0)),
                "model": msg.get("model"),
                "manifest": list(msg["manifest"]),
                "carry": carry,
                "carry_digests": dict(msg.get("carry_digests") or {}),
                "nchunks": int(msg["nchunks"]),
                "total_bytes": int(msg["total_bytes"]),
                "chunks": [],
                "next_seq": 0,
            }
            self._last_chunk_t = time.monotonic()
            return None, reason
        if kind == "chunk":
            cur = self._cur
            if cur is None or int(msg["version"]) != cur["version"]:
                return None, None  # stray chunk of a discarded stream
            if int(msg["seq"]) != cur["next_seq"]:
                return self._discard("torn")  # sequence gap
            cur["chunks"].append(np.asarray(msg["data"], np.uint8))
            cur["next_seq"] += 1
            self._last_chunk_t = time.monotonic()
            return None, None
        if kind == "commit":
            cur = self._cur
            if cur is None or int(msg["version"]) != cur["version"]:
                return None, None
            self._cur = None
            if cur["next_seq"] != cur["nchunks"]:
                return None, "torn"
            payload = b"".join(c.tobytes() for c in cur["chunks"])
            if len(payload) != cur["total_bytes"] or \
                    _crc(payload) != int(msg["digest"]):
                return None, "digest"
            leaves, digests, off = {}, {}, 0
            for path, dstr, shape, nbytes, digest in cur["manifest"]:
                arr = np.frombuffer(
                    payload, np.dtype(dstr), offset=off,
                    count=int(np.prod(shape, dtype=np.int64))
                    if shape else 1,
                ).reshape(shape).copy()
                off += int(nbytes)
                if leaf_digest(arr) != digest:
                    return None, "digest"
                leaves[path] = arr
                digests[path] = digest
            for path in cur["carry"]:
                leaves[path] = self.last.leaves[path]
                digests[path] = cur["carry_digests"].get(
                    path, self.last.digests[path]
                )
            snap = Snapshot(cur["version"], cur["step"], leaves,
                            model=cur["model"], digests=digests)
            self.last = snap
            return snap, None
        return None, None
