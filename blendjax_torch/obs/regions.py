"""Region ranges in the program, and where a captured step's device time goes.

A captured train step (:mod:`blendjax_torch.models.train`) is one CUDA
graph.  Its replay runs no Python, so a profiler sees the graph's kernels
hang off one ``cudaGraphLaunch`` with nothing to say which model code
launched them.  This module names the code, then carries the names over to
the replayed kernels:

- :func:`region` opens a profiler range around a region of the model or
  of the step while a profiler is recording, and costs one check
  otherwise.  The ranges run where Python
  runs: at eager steps, at the capture and in the step's host dispatch.
  Nothing is recorded on the device, and the captured graph holds the same
  kernels with or without a profiler.
- :func:`kernel_table` reads one eager step profiled with CPU and CUDA
  activity: each device operation in order, with the region of the code
  that launched it.  A backward kernel takes the region of the forward op
  whose autograd node launched it.
- :func:`place` gives each replayed device operation the region at its
  position in that table where the name sequences match, and aligns the two
  by name where they do not.
- :func:`split` does both over a profiled run of replays.

Usage on the card::

    from torch.profiler import ProfilerActivity, profile
    from blendjax_torch.obs import regions

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    step = make_train_step(loss_fn)
    state, _ = step(state, batch)               # eager warm-up 1
    with profile(activities=acts) as prof:        # eager warm-up 2
        state, _ = step(state, batch)
    table = regions.kernel_table(prof.events())
    state, _ = step(state, batch)               # the capture, its first replay
    with profile(activities=acts) as prof:
        for _ in range(10):
            state, _ = step(state, batch)
    steps, by_region = regions.split(prof.events(), table)

Torch is imported lazily, as everywhere in :mod:`blendjax_torch.obs`.
"""

from __future__ import annotations

import contextlib
import difflib
import re
import sys

#: the model's regions: the innermost range around an op names its region
MODEL = ("seqformer.norm", "seqformer.attention", "seqformer.mlp", "seqformer.io")
#: the DeepSeekMoE layer's regions, inside ``seqformer.mlp``: the gate, the
#: sigmoid, the top-k choice and the dispatch; the held experts' grouped
#: products and SwiGLU; the shared experts; the combine
MOE = ("seqformer.router", "seqformer.experts", "seqformer.shared", "seqformer.combine")
#: the train step's regions around its optimizer and backward calls, and
#: the routing biases' update
STEP = ("train.zero_grad", "train.backward", "train.adam", "train.balance")
#: the captured step's host dispatch, one range each on every call
DISPATCH = ("train.guard", "train.copy_inputs", "train.replay", "train.output")
NAMES = frozenset(MODEL + MOE + STEP + DISPATCH)
#: the entry of :func:`place` for replayed operations the table has not
UNPLACED = "unplaced"

_NULL = contextlib.nullcontext()
_BACKWARD = "autograd::engine::evaluate_function: "
# the CUDA API's launch calls (cudaLaunchKernel, cuLaunchKernelEx,
# cudaGraphLaunch, cudaMemcpyAsync...): a device operation shares its id
_RUNTIME = re.compile(r"cu(da)?[A-Z]")


def region(name):
    """A profiler range named ``name`` while a profiler records, else a
    shared null context (``name=None`` always gives the null context).

    The range is a function range (the profiler's record of an op), not a
    user annotation (``torch.profiler.record_function``): for a user
    annotation the profiler also puts an event of its own on the device,
    spanning the kernels inside it, which a reader of device events would
    count as work.  For a function range it puts none."""
    torch = sys.modules.get("torch")
    if name is None or torch is None or not torch.autograd._profiler_enabled():
        return _NULL
    return torch._C._profiler._RecordFunctionFast(name)


def _chain(e):
    while e is not None:
        yield e
        e = e.cpu_parent


class _Profile:
    """A profile's events read for attribution: its device ops in start
    order (a user annotation's device event is not one), the runtime call
    that launched each (the host event that shares its id), and the
    region of a host event (:meth:`region`)."""

    def __init__(self, events):
        from torch.autograd import DeviceType

        cpu = DeviceType.CPU
        events = list(events)
        self.host = [e for e in events if e.device_type == cpu]
        self.device = sorted((e for e in events if e.device_type != cpu
                              and not getattr(e, "is_user_annotation", False)),
                             key=lambda e: e.time_range.start)
        self.launches = {e.id: e for e in self.host if _RUNTIME.match(e.name)}
        self.ranges = sorted((e for e in self.host if e.name in NAMES),
                             key=lambda e: e.time_range.start)
        # ops that create no autograd node record the number the next node
        # will take, so the last op to record a number is the node's
        self.forward = {}
        for e in sorted(self.host, key=lambda e: e.time_range.start):
            if e.sequence_nr >= 0 and not any(p.name.startswith(_BACKWARD) for p in _chain(e)):
                self.forward[(e.sequence_nr, e.thread)] = next(
                    (p.name for p in _chain(e.cpu_parent) if p.name in NAMES), None)

    def region(self, e):
        """The innermost region range around host event ``e``; for an op of
        the backward pass the region of the forward op whose autograd node
        ran it; failing both, the innermost region range open, on any
        thread, when it started; else None."""
        if e is None:
            return None
        for p in _chain(e):
            if p is not e and p.name in NAMES:
                return p.name
            if p.name.startswith(_BACKWARD):
                linked = self.forward.get((p.sequence_nr, p.fwd_thread))
                if linked is not None:
                    return linked
        t = e.time_range.start
        open_ = [r for r in self.ranges if r.time_range.start <= t < r.time_range.end]
        return open_[-1].name if open_ else None


def kernel_table(events):
    """``[(device op name, region)]`` in start order for one eager step
    profiled with CPU and CUDA activity (``prof.events()``).  A device op
    takes the region of the runtime call that launched it; with no device
    op in ``events`` (a CPU-only profile), the leaf ``aten::`` ops stand in
    for them.  Adam's kernels take ``train.adam``; what nothing links is
    ``None``."""
    prof = _Profile(events)
    if not prof.device:
        ops = sorted((e for e in prof.host if e.name.startswith("aten::")
                      and not any(c.name.startswith("aten::") for c in e.cpu_children)),
                     key=lambda e: e.time_range.start)
        return [(e.name, prof.region(e)) for e in ops]
    return [(d.name, prof.region(prof.launches.get(d.id))) for d in prof.device]


def _add(out, label, name, seconds, ops, classify):
    acc = out.setdefault(label if classify is None else (label, classify(name)), [0.0, 0])
    acc[0] += seconds
    acc[1] += ops


def place(replays, table, classify=None):
    """``{region: [seconds, ops]}`` a step over ``replays``, each a list of
    one replay's device ops ``(name, seconds)`` in start order.  An op takes
    the region at its position in ``table`` (:func:`kernel_table`) when the
    name sequences match exactly, else the region of the table's op that
    :class:`difflib.SequenceMatcher` aligns it with; an op with no such
    partner counts under :data:`UNPLACED`.  With ``classify(name) -> key``
    the keys are ``(region, key)``."""
    names = [n for n, _ in table]
    out = {UNPLACED: [0.0, 0]} if classify is None else {}
    for ops in replays:
        got = [n for n, _ in ops]
        if got == names:
            labels = [r for _, r in table]
        else:
            labels = [UNPLACED] * len(got)
            matcher = difflib.SequenceMatcher(None, names, got, autojunk=False)
            for a, b, size in matcher.get_matching_blocks():
                labels[b:b + size] = [r for _, r in table[a:a + size]]
        for (name, seconds), label in zip(ops, labels):
            _add(out, label, name, seconds, 1, classify)
    k = max(len(replays), 1)
    return {key: [s / k, n / k] for key, (s, n) in out.items()}


def split(events, table, lo=None, hi=None, classify=None):
    """``(steps, {region: [seconds, ops]} a step)`` over profiled replays
    (``prof.events()``), device ops starting at or after ``lo`` and ending
    by ``hi`` (the profile's microseconds) alone.  Each ``cudaGraphLaunch``
    is a step, its ops placed by :func:`place`; every other device op (the
    input copies, the output's clone) takes the region of the host call
    that launched it, ``None`` where none."""
    prof = _Profile(events)
    graphs, other = {}, []
    for d in prof.device:
        if ((lo is not None and d.time_range.start < lo)
                or (hi is not None and d.time_range.end > hi)):
            continue
        op = (d.name, d.time_range.elapsed_us() / 1e6)
        launch = prof.launches.get(d.id)
        if launch is not None and launch.name.startswith("cudaGraphLaunch"):
            graphs.setdefault(d.id, []).append(op)
        else:
            other.append((op, prof.region(launch)))
    steps = len(graphs)
    by_region = place(list(graphs.values()), table, classify) if steps else {}
    for (name, seconds), label in other:
        _add(by_region, label, name, seconds / max(steps, 1), 1 / max(steps, 1), classify)
    return steps, by_region
