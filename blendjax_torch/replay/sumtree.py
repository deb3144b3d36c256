"""Sum tree for O(log n) prioritized sampling (Schaul et al. 2015,
"Prioritized Experience Replay", arXiv:1511.05952).

A flat-array binary tree over ``capacity`` leaves: internal node ``i``
holds the sum of its children ``2i``/``2i+1``, leaves live at
``[capacity, 2*capacity)``.  ``set`` updates one leaf and its ancestors;
``prefix_search(m)`` descends from the root to the leaf where the
running prefix sum crosses ``m`` — sampling a leaf with probability
``p_i / total`` takes one uniform draw plus one descent.

A copy of ``blendjax.replay.sumtree``.  Pure numpy, no locking: the owning
:class:`~blendjax_torch.replay.ReplayBuffer`
serializes access (the tree and the ring columns must mutate under one
lock anyway, or a sampled index could dangle past a wraparound evict).
"""

from __future__ import annotations

import numpy as np


class SumTree:
    """Fixed-capacity sum tree over non-negative leaf priorities."""

    __slots__ = ("capacity", "_tree")

    def __init__(self, capacity):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        # float64 throughout: a float32 running sum drifts after ~1e7
        # incremental updates and prefix_search then dereferences leaves
        # whose true mass is zero
        self._tree = np.zeros(2 * self.capacity, np.float64)

    @property
    def total(self):
        """Sum of all leaf priorities (the sampling normalizer)."""
        return float(self._tree[1])

    def get(self, idx):
        """Priority of leaf ``idx``."""
        return float(self._tree[self.capacity + idx])

    def leaves(self):
        """Copy of all leaf priorities, index-aligned with the ring."""
        return self._tree[self.capacity:].copy()

    def set(self, idx, priority):
        """Set leaf ``idx`` to ``priority`` (>= 0), refreshing ancestors."""
        if priority < 0 or not np.isfinite(priority):
            raise ValueError(f"priority must be finite and >= 0: {priority}")
        i = self.capacity + int(idx)
        delta = float(priority) - self._tree[i]
        if delta == 0.0:
            return
        while i >= 1:
            self._tree[i] += delta
            i >>= 1

    def prefix_search(self, mass):
        """Leaf index where the running prefix sum first exceeds ``mass``.

        ``mass`` must lie in ``[0, total)``; the descent clamps against
        float round-off at the last leaf so a draw of ``total - eps``
        cannot fall off the end.
        """
        tree = self._tree
        i = 1
        while i < self.capacity:
            left = 2 * i
            if mass < tree[left]:
                i = left
            else:
                mass -= tree[left]
                i = left + 1
        return i - self.capacity

    def get_many(self, indices):
        """Vectorized :meth:`get`: priorities of ``indices`` leaves."""
        return self._tree[self.capacity + np.asarray(indices, np.int64)]

    def prefix_search_batch(self, masses):
        """Vectorized :meth:`prefix_search` over an array of masses.

        One level-synchronous descent: every mass walks down in lockstep
        with numpy ops per level instead of a Python loop per mass.  For
        non-power-of-two capacities leaves sit at mixed depths, so each
        element freezes (``active`` mask) as soon as its node index
        crosses into leaf territory.  Bit-identical to the scalar
        descent — same comparisons, same float subtraction order — so a
        draw stream is unchanged by batching.
        """
        tree = self._tree
        m = np.array(masses, np.float64)
        i = np.ones(m.shape, np.int64)
        active = i < self.capacity
        while active.any():
            left = 2 * i
            # inactive lanes read node 1 (harmless) to keep the take legal
            lv = tree[np.where(active, left, 1)]
            go_left = active & (m < lv)
            go_right = active & ~go_left
            m = np.where(go_right, m - lv, m)
            i = np.where(go_left, left, np.where(go_right, left + 1, i))
            active = i < self.capacity
        return i - self.capacity

    def rebuild(self, leaf_priorities):
        """Reinitialize every leaf at once (checkpoint restore): one
        bottom-up pass instead of ``capacity`` ancestor walks."""
        leaves = np.asarray(leaf_priorities, np.float64)
        if leaves.shape != (self.capacity,):
            raise ValueError(
                f"expected {self.capacity} leaf priorities, got {leaves.shape}"
            )
        if leaves.size and ((leaves < 0).any() or not np.isfinite(leaves).all()):
            raise ValueError("priorities must be finite and >= 0")
        self._tree[self.capacity:] = leaves
        # level-synchronous bottom-up: internal nodes [2^k, 2^{k+1}) hold
        # children strictly deeper, so each level is one vectorized add —
        # log2(capacity) numpy ops instead of a capacity-sized Python
        # loop (restore at 1M leaves: ~ms, not ~0.5s)
        tree = self._tree
        top = (self.capacity - 1).bit_length() - 1 if self.capacity > 1 else -1
        for k in range(top, -1, -1):
            lo = 1 << k
            hi = min(lo << 1, self.capacity)
            tree[lo:hi] = (
                tree[2 * lo:2 * hi:2] + tree[2 * lo + 1:2 * hi:2]
            )
