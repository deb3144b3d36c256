"""Columnar ring storage for transitions: preallocated per-key numpy
columns with O(1) row append and one gather per key for a batch.

The port of ``blendjax.replay.ring``.  One ``(capacity, *leaf_shape)``
array per transition key, allocated once on first sight of the schema,
rows written in place (``copy_into``: the native GIL-released copy for
rows of 64 KiB or more, ``np.copyto`` below) and batches gathered column
by column (the native ``gather_into`` for rows of
:data:`_NATIVE_GATHER_MIN_BYTES` or more, so a concurrent actor thread
keeps the GIL; ``np.take(..., out=)`` below).

The schema is fixed by the first row: replay is a homogeneous transition
log, so a key that later changes shape/dtype (or appears / disappears) is
a bug upstream and raises instead of degrading.

No locking here: the owning :class:`~blendjax_torch.replay.ReplayBuffer`
serializes row writes and gathers together with its index/priority state
(a gather racing a wraparound overwrite would tear rows).
"""

from __future__ import annotations

import numpy as np

from blendjax_torch.native.ring import copy_into, gather_into

#: Rows at or above this many bytes gather through the native GIL-released
#: call; below it the per-row pointer extraction (~3 us a row) costs more
#: than the copy saves and ``np.take`` wins.
_NATIVE_GATHER_MIN_BYTES = 16 * 1024


class ColumnStore:
    """Fixed-capacity columnar transition storage.

    Params
    ------
    capacity: int
        Ring size in transitions; row slots are reused modulo capacity
        (the caller owns the head/size bookkeeping).
    """

    def __init__(self, capacity):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.columns = {}  # key -> (capacity, *leaf_shape) ndarray
        self._schema = None  # key -> (shape, dtype), fixed by first row

    @property
    def keys(self):
        return tuple(self.columns)

    @property
    def nbytes(self):
        return sum(c.nbytes for c in self.columns.values())

    def _init_schema(self, row):
        schema = {}
        columns = {}
        for key, value in row.items():
            arr = np.asarray(value)
            if arr.dtype.hasobject or arr.dtype.kind in "USV":
                # strings would coerce to fixed-width unicode and then
                # "drift" on the first longer value — reject upfront
                # (before ANY allocation: a half-built column dict must
                # not leak into a retried append's smaller schema)
                raise TypeError(
                    f"transition key {key!r} has dtype {arr.dtype} "
                    f"({type(value).__name__}); replay columns hold "
                    "fixed-shape numeric/bool arrays only"
                )
            schema[key] = (arr.shape, arr.dtype)
            columns[key] = np.zeros((self.capacity,) + arr.shape, arr.dtype)
        self.columns = columns
        self._schema = schema

    def write_row(self, slot, row):
        """Write one transition dict into ring slot ``slot`` (O(1): a
        copy per key into preallocated storage, no allocation)."""
        if self._schema is None:
            self._init_schema(row)
        schema = self._schema
        if row.keys() != schema.keys():
            extra = sorted(set(map(str, row)) ^ set(map(str, schema)))
            raise KeyError(
                f"transition keys changed mid-stream (difference: {extra}); "
                "the replay schema is fixed by the first append"
            )
        for key, (shape, dtype) in schema.items():
            arr = np.asarray(row[key])
            if arr.shape != shape or arr.dtype != dtype:
                raise ValueError(
                    f"transition key {key!r} drifted to "
                    f"{arr.shape}/{arr.dtype} (schema: {shape}/{dtype})"
                )
            col = self.columns[key]
            if shape:
                copy_into(col[slot], np.ascontiguousarray(arr))
            else:
                col[slot] = arr

    def read_row(self, slot):
        """One transition dict, values COPIED out (a view would alias the
        ring slot and mutate under the caller after wraparound)."""
        return {k: np.array(c[slot]) for k, c in self.columns.items()}

    def gather(self, indices, out=None, keys=None):
        """Batched columnar read: ``{key: column[indices]}`` with one
        gather per key.

        ``out`` (optional) supplies preallocated ``(len(indices),
        *shape)`` destinations — either a dict keyed like the columns,
        or a callable ``out(key, shape, dtype) -> ndarray`` (the
        :meth:`blendjax_torch.btt.arena.Arena.get_buffer` signature, so a
        recycled arena plugs in directly) — written in place; otherwise
        fresh arrays are allocated.

        ``keys`` (optional) restricts the gather to those columns — a
        consumer that only reads a subset (e.g. an off-policy loss that
        never touches ``next_obs``) skips the copy for the rest.
        """
        idx = np.asarray(indices, np.int64)
        n = idx.size
        if keys is None:
            selected = self.columns
        else:
            missing = [k for k in keys if k not in self.columns]
            if missing:
                raise KeyError(
                    f"no such replay column(s) {missing}; stored keys: "
                    f"{sorted(self.columns)}"
                )
            selected = {k: self.columns[k] for k in keys}
        batch = {}
        for key, col in selected.items():
            row_shape = col.shape[1:]
            if out is None:
                dst = None
            elif callable(out):
                dst = out(key, (n,) + row_shape, col.dtype)
            else:
                dst = out.get(key)
            if dst is not None and (
                dst.shape != (n,) + row_shape or dst.dtype != col.dtype
            ):
                raise ValueError(
                    f"out[{key!r}] is {dst.shape}/{dst.dtype}, need "
                    f"{(n,) + row_shape}/{col.dtype}"
                )
            if row_shape and col[0].nbytes >= _NATIVE_GATHER_MIN_BYTES:
                if dst is None:
                    dst = np.empty((n,) + row_shape, col.dtype)
                gather_into(dst, [col[i] for i in idx])
            else:
                dst = np.take(col, idx, axis=0, out=dst)
            batch[key] = dst
        return batch

    # -- checkpoint surface --------------------------------------------------

    def state_arrays(self):
        """The raw column arrays, prefixed for a flat checkpoint namespace
        (``col.<key>`` -> array)."""
        return {f"col.{k}": v for k, v in self.columns.items()}

    def load_state_arrays(self, arrays):
        """Adopt checkpointed columns (inverse of :meth:`state_arrays`).
        Replaces any existing schema; capacity must match."""
        self.columns = {}
        self._schema = None
        schema = {}
        for name, arr in arrays.items():
            if not name.startswith("col."):
                continue
            key = name[len("col."):]
            if arr.shape[0] != self.capacity:
                raise ValueError(
                    f"checkpoint column {key!r} has capacity "
                    f"{arr.shape[0]}, store expects {self.capacity}"
                )
            self.columns[key] = np.array(arr)  # own the storage
            schema[key] = (arr.shape[1:], arr.dtype)
        if schema:
            self._schema = schema
