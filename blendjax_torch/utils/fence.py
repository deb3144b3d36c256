"""Completion fences for timing and synchronization: the counterpart of
``blendjax.utils.fence``.

A value fetch cannot finish before the work that produced the value: the
bytes of a result reach the host only after its kernels (and every copy
they were ordered after) have run.  This module bills throughput windows
by such fetches:

- :func:`value_fence` reduces every array leaf of a tree to one scalar
  and fetches it, which waits for the leaves' work;
- :class:`fence_chain` folds each dispatched result into an accumulator
  on the card without waiting (no ``.item()``, no host copy, no
  synchronize), and :meth:`fence_chain.sync` fetches it at a measurement
  boundary, fencing every result folded so far;
- :func:`fences_valid` checks a fence against a known-FLOPs matmul: if the
  rate it implies beats the card's peak, the fence returned early.

What a fetch fences on CUDA: ``.item()`` waits for the stream that
produced the value and for what that stream waited on.  A batch the feed
copied on its own stream is fenced through the event the consumer's
stream waited on (``btt/prefetch.py::_hand_over``), so folding the step's
loss fences the copy too.  A captured step's outputs live in static
buffers that each replay rewrites in stream order; folding them after the
replay reads that replay's values.  ``fold`` refuses to run inside a CUDA
graph capture, where it would be recorded instead of run.

Placement: a leaf on the card is reduced where it lies.  A host leaf (a
numpy array or a CPU tensor) is already final: it is reduced on the host
and enters the sum as a number (a kernel argument for a chain on the
card, no copy and no wait).  ``value_fence`` fetches one scalar per
device that holds a leaf, and a chain refuses a leaf on another device
than its own (moving it would copy through the host or fence nothing).

torch is imported inside the functions: ``blendjax_torch.utils`` is
imported by the torch-free producers and services.
"""

from __future__ import annotations

import time


def _leaves(tree):
    """The leaves of a dict/list/tuple tree that have a ``dtype`` (tensors,
    numpy arrays and scalars), dict keys in sorted order; None and other
    leaves are ignored."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if hasattr(tree, "dtype") else []


def _mean(torch, leaf):
    """The leaf's mean in float32, as a tensor where the leaf lies (numpy
    leaves on the host), outside autograd: a chain folds many steps."""
    if not isinstance(leaf, torch.Tensor):
        import numpy as np

        leaf = torch.from_numpy(np.asarray(leaf, np.float32))
    return leaf.detach().to(torch.float32).mean()


def _by_device(torch, leaves):
    """{device: float32 sum of the means of the leaves on it}."""
    sums = {}
    for leaf in leaves:
        m = _mean(torch, leaf)
        sums[m.device] = m if m.device not in sums else sums[m.device] + m
    return sums


def value_fence(tree):
    """Wait until every array leaf of ``tree`` is computed, by fetching a
    scalar that depends on all of them: the sum of the leaves' float32
    means (one fetch per device that holds a leaf).  Returns that sum (a
    checksum); 0.0 when no leaf has a dtype."""
    leaves = _leaves(tree)
    if not leaves:
        return 0.0
    import torch

    return sum(float(s.item()) for s in _by_device(torch, leaves).values())


class fence_chain:
    """Streaming fence: :meth:`fold` each dispatched result into a float32
    accumulator on ``device``, :meth:`sync` at the measurement boundary::

        chain = fence_chain()
        t0 = time.perf_counter()
        for batch in stream:
            state, loss = train_step(state, batch)
            chain.fold(loss)
        chain.sync()                      # every step has run
        elapsed = time.perf_counter() - t0

    ``fold`` enqueues the reduction on the current stream and returns; fold
    and sync on one stream.  ``device`` is the card unless the caller asks
    for the CPU; asking for CUDA where there is none raises."""

    def __init__(self, device="cuda"):
        import torch

        from blendjax_torch.utils.device import resolve_device

        self._acc = torch.zeros((), dtype=torch.float32, device=resolve_device(device))
        self.device = self._acc.device  # with its index: leaves are compared to it

    def fold(self, tree):
        """Add the sum of ``tree``'s leaf means to the accumulator, without
        waiting (module docstring: placement, captures)."""
        leaves = _leaves(tree)
        if not leaves:
            return
        import torch

        if self.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("fence_chain.fold inside a CUDA graph capture; fold "
                               "the captured step's outputs after its replay")
        for dev, s in _by_device(torch, leaves).items():
            if dev == self.device:
                self._acc += s
            elif dev.type == "cpu":
                self._acc += float(s)  # a host value: a kernel argument, no copy
            else:
                raise ValueError(f"fence_chain on {self.device} was given a leaf on {dev}")

    def sync(self):
        """Fetch the accumulator: returns once everything folded has run."""
        return float(self._acc.item())


#: :func:`fences_valid`'s check: the matmul's side, its timed repetitions
#: (the best is kept) and the headroom over the peak before a rate counts
#: as impossible.
FENCE_CHECK_N = 2048
FENCE_CHECK_REPS = 2
FENCE_CHECK_SLACK = 1.02


def fences_valid(peak_flops_per_sec, device="cuda"):
    """Is ``torch.cuda.synchronize`` a real fence on this card?

    Times one square bf16 matmul of side :data:`FENCE_CHECK_N` (inputs
    from seeded generators, after a warm-up that creates the BLAS handle)
    ending in ``synchronize``; if the FLOP/s it implies beat
    ``peak_flops_per_sec`` times :data:`FENCE_CHECK_SLACK` the fence
    returned early.  Returns ``(ok, {"min_s", "implied_flops_per_sec",
    "peak_flops_per_sec"})``.  On the CPU the matmul itself is
    synchronous."""
    import torch

    from blendjax_torch.utils.device import resolve_device

    dev = resolve_device(device)
    n = FENCE_CHECK_N
    gens = [torch.Generator(device=dev).manual_seed(seed) for seed in (0, 1)]
    x, w = (torch.randn((n, n), generator=g, device=dev, dtype=torch.bfloat16)
            for g in gens)
    value_fence(torch.matmul(x, w))  # warm-up: the handle, the operands
    fence = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    best = float("inf")
    for _ in range(FENCE_CHECK_REPS):
        t0 = time.perf_counter()
        torch.matmul(x, w)
        fence()
        best = min(best, time.perf_counter() - t0)
    implied = 2.0 * n ** 3 / max(best, 1e-9)
    ok = implied <= peak_flops_per_sec * FENCE_CHECK_SLACK
    return ok, {"min_s": best, "implied_flops_per_sec": implied,
                "peak_flops_per_sec": peak_flops_per_sec}
