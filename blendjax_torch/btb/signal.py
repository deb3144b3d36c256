"""Minimal multicast callback registry: the lifecycle hooks of
:class:`blendjax_torch.btb.animation.AnimationController` (pre_frame,
post_frame, ...).  A copy of ``blendjax.btb.signal``.  Handlers may be
registered with pre-bound leading args; ``add`` returns a handle that
unregisters.
"""

from __future__ import annotations

import functools


class Signal:
    """An ordered list of callables invoked with ``invoke(*args, **kwargs)``."""

    def __init__(self):
        self._slots = []

    def add(self, fn, *bound_args, **bound_kwargs):
        """Register ``fn``; returns a handle accepted by :meth:`remove`.

        Extra args are pre-bound before any invoke-time args, so
        ``sig.add(fn, x)`` then ``sig.invoke(y)`` calls ``fn(x, y)``.
        """
        if bound_args or bound_kwargs:
            fn = functools.partial(fn, *bound_args, **bound_kwargs)
        self._slots.append(fn)
        return fn

    def add_first(self, fn, *bound_args, **bound_kwargs):
        """Register ``fn`` ahead of every existing handler: for hooks that
        must observe or change state before the frame's regular handlers
        run (a parameter push applying before the agent's action)."""
        if bound_args or bound_kwargs:
            fn = functools.partial(fn, *bound_args, **bound_kwargs)
        self._slots.insert(0, fn)
        return fn

    def remove(self, handle):
        self._slots.remove(handle)

    def clear(self):
        self._slots.clear()

    def invoke(self, *args, **kwargs):
        # iterate over a copy: handlers may (un)register during dispatch
        for fn in list(self._slots):
            fn(*args, **kwargs)

    def __len__(self):
        return len(self._slots)
