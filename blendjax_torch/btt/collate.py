"""Numpy batch collation — the torch ``default_collate`` role, but producing
plain numpy pytrees that the device feed (:mod:`blendjax_torch.btt.prefetch`)
stages into pinned memory and copies to the card.

Rules: a list of dicts becomes a dict of stacked leaves; ndarrays stack on
a new leading axis; numeric scalars become 1-D arrays; strings/bytes and
ragged leaves stay Python lists.  The same rules as ``blendjax.btt.collate``:
leaves of 64 KiB or more stack through the native GIL-released gather
(:func:`blendjax_torch.native.ring.fast_stack`), so loader threads collate
on several cores; smaller ones, and mixed dtypes, through ``np.stack``.
"""

from __future__ import annotations

import numbers

import numpy as np

#: Leaves at or above this many bytes (a row) go through the native
#: GIL-released gather; below it the ctypes call costs more than it saves.
_NATIVE_STACK_MIN_BYTES = 64 * 1024


def _stack(items):
    first = items[0]
    if first.nbytes >= _NATIVE_STACK_MIN_BYTES and all(
            it.dtype == first.dtype for it in items[1:]):
        from blendjax_torch.native.ring import fast_stack

        return fast_stack(items)
    return np.stack(items)  # handles mixed dtypes via upcast


def collate(items):
    """Collate a non-empty list of samples into one batched pytree."""
    if not items:
        raise ValueError("cannot collate an empty batch")
    elem = items[0]
    if isinstance(elem, dict):
        return {k: collate([it[k] for it in items]) for k in elem}
    if isinstance(elem, tuple):
        return tuple(collate(list(vals)) for vals in zip(*items))
    if isinstance(elem, list):
        return [collate(list(vals)) for vals in zip(*items)]
    if isinstance(elem, np.ndarray):
        if any(it.shape != elem.shape for it in items[1:]):
            return list(items)  # ragged: leave unstacked
        return _stack(items)
    if isinstance(elem, numbers.Number) and not isinstance(elem, bool):
        return np.asarray(items)
    if isinstance(elem, bool):
        return np.asarray(items, dtype=bool)
    return list(items)
