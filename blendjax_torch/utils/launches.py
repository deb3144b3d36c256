"""Launch counters of the port's hand-written kernels.

Each kernel wrapper counts the launches it makes in attributes of its own:
``fn.launches``, and ``fn.launches_by_route`` (route -> count) where the
kernel has more than one route.  :func:`counted` sets them up and enrolls
the wrapper here.

A captured CUDA graph launches its kernels at every replay without passing
through the wrappers, and its capture passes through them once without
launching anything.  A captured step therefore takes :func:`snapshot`
before its capture, turns the difference into launches per replay with
:func:`since`, takes them back out (:func:`add` with ``times=-1``) and adds
them again at every replay: the counters go on counting launches on the
card.
"""

from __future__ import annotations

_COUNTED = []


def counted(fn, routes=None):
    """Enroll kernel wrapper ``fn``: ``fn.launches = 0`` and, with
    ``routes``, ``fn.launches_by_route = {route: 0, ...}``.  Returns fn."""
    fn.launches = 0
    if routes is not None:
        fn.launches_by_route = {route: 0 for route in routes}
    _COUNTED.append(fn)
    return fn


def snapshot():
    """Every enrolled wrapper's counts as they stand."""
    return {fn: (fn.launches, dict(getattr(fn, "launches_by_route", {})))
            for fn in _COUNTED}


def since(before):
    """The launches counted since ``before`` (a :func:`snapshot`), as
    ``[(fn, n, {route: n})]`` for the wrappers that counted any."""
    out = []
    for fn, (n, by_route) in snapshot().items():
        n0, by_route0 = before.get(fn, (0, {}))
        if n != n0:
            out.append((fn, n - n0,
                        {r: k - by_route0.get(r, 0) for r, k in by_route.items()}))
    return out


def add(delta, times=1):
    """Add ``times`` x ``delta`` (from :func:`since`) to the counters."""
    for fn, n, by_route in delta:
        fn.launches += n * times
        for route, k in by_route.items():
            fn.launches_by_route[route] += k * times
