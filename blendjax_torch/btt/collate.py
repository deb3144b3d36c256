"""Numpy batch collation — the torch ``default_collate`` role, but producing
plain numpy pytrees that the device feed (:mod:`blendjax_torch.btt.prefetch`)
stages into pinned memory and copies to the card.

Rules: a list of dicts becomes a dict of stacked leaves; ndarrays stack on
a new leading axis; numeric scalars become 1-D arrays; strings/bytes and
ragged leaves stay Python lists.  The same rules as ``blendjax.btt.collate``,
stacked with numpy alone (the native gather is not ported).
"""

from __future__ import annotations

import numbers

import numpy as np


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
        return np.stack(items)  # handles mixed dtypes via upcast
    if isinstance(elem, numbers.Number) and not isinstance(elem, bool):
        return np.asarray(items)
    if isinstance(elem, bool):
        return np.asarray(items, dtype=bool)
    return list(items)
