"""Training- and eval-step builders.

The port of ``blendjax.models.train``::

    state = TrainState.create(params)            # torch.optim.Adam(lr=1e-3)
    state = TrainState.create(params, lr=3e-4)   # another rate
    step = make_train_step(loss_fn)
    state, loss = step(state, batch)
    evaluate = make_eval_step(loss_fn)
    loss = evaluate(state.params, batch)

``torch.optim.Adam``'s defaults (betas (0.9, 0.999), eps 1e-8, eps inside
the square root 0) are ``optax.adam``'s, and its update ``m_hat /
(sqrt(v_hat) + eps)`` is the same formula.

**On the card the step is one captured program**, the counterpart of the
reference's ``jax.jit(step, donate_argnums=(0,))``.  For a batch signature
(tree structure, shapes, dtypes) it has not seen, the step first runs
:data:`WARMUP_STEPS` real eager steps on a side stream, then captures one
whole step — zero-grad, forward, backward, Adam — in a
``torch.cuda.CUDAGraph``; every later call copies the batch into the
graph's static inputs, replays the graph and returns a fresh copy of the
loss.  A new signature gets its own capture (and its own graph memory
pool), as a jit retraces.  Parameters and Adam's state are updated in
place, the counterpart of donation: the state passed in is the state
returned, and Adam is built ``capturable=True`` for CUDA parameters.  If
``state.params`` no longer holds the tensors that were captured (the caller
rebound them, e.g. to load weights), ``state.optimizer`` is another object,
or the optimizer's state tensors were replaced (``load_state_dict``), the
step drops its graphs and captures anew (after new warm-up steps): it
never replays against stale addresses.  A failed capture
raises; nothing falls back to the eager step.  The kernels' launch
counters (:mod:`blendjax_torch.utils.launches`) go on counting at every
replay.  The eval step is captured the same way, under ``torch.no_grad()``.

The train step names its parts for a profiler
(:mod:`blendjax_torch.obs.regions`): ``train.zero_grad``,
``train.backward`` and ``train.adam`` around the optimizer's and
autograd's calls, ``train.balance`` around the routing biases' update,
and on every call of a captured step its host dispatch:
``train.guard`` (the address checks and the batch signature),
``train.copy_inputs``, ``train.replay`` (the graph's launch) and
``train.output`` (the loss's clone).  Each range costs one check while no
profiler is recording; a replay runs no Python, so the ranges add nothing
to the captured graph.  The eval step opens none.

With parameters on the CPU both steps run eagerly: that is the device the
caller asked for, and there is no CUDA graph on a CPU.  ``capture=False``
runs them eagerly on the card too (an explicit choice, used to hold the
captured step against the eager one); ``capture=True`` raises unless the
parameters are on a CUDA device.  DTensor parameters (a mesh-sharded state,
:mod:`blendjax_torch.parallel.sharding`) run eagerly on purpose: their
collectives go over gloo, which a CUDA graph cannot capture, so
``capture=None`` resolves to eager for them and ``capture=True`` raises.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor

from blendjax_torch.obs.regions import region
from blendjax_torch.utils import launches

#: eager steps a batch signature runs (on a side stream) before its capture:
#: they create Adam's state and the libraries' handles and workspaces, and
#: load every kernel, none of which may happen inside a capture
WARMUP_STEPS = 2


@dataclass
class TrainState:
    """Parameters (a ``{path: tensor}`` dict), their optimizer, step count."""

    params: dict
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, params, lr=1e-3):
        """Adam(``lr``) over ``params``, built ``capturable`` for CUDA
        tensors that a step captures (not for DTensors, which run eager)."""
        params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        captures = (bool(params) and all(v.is_cuda for v in params.values())
                    and not any(isinstance(v, DTensor) for v in params.values()))
        return cls(params=params,
                   optimizer=torch.optim.Adam(params.values(), lr=lr, capturable=captures))


def _captures(capture, tensors):
    """Whether a step over ``tensors`` (its parameters) runs captured."""
    if capture is False:
        return False
    tensors = list(tensors)
    if any(isinstance(t, DTensor) for t in tensors):
        if capture:
            raise RuntimeError("capture=True over DTensor parameters: their collectives "
                               "run over gloo, which a CUDA graph cannot capture; the "
                               "sharded step runs eager")
        return False
    if tensors and all(t.is_cuda for t in tensors):
        return True
    if capture:
        if not torch.cuda.is_available():
            raise RuntimeError("capture=True needs a CUDA device, and CUDA is not available")
        raise RuntimeError("capture=True needs the parameters on a CUDA device")
    return False


def _leaves(tree, path=()):
    """``(path, tensor)`` for every leaf of a dict/list/tuple tree; a
    captured step takes tensor leaves only (any other value would be baked
    into the graph)."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        raise TypeError(f"a captured step takes tensor leaves only; batch{list(path)} is "
                        f"a {type(tree).__name__} (drop it in the stream's transform, or "
                        "pass capture=False)")


def _rebuild(tree, tensors):
    """``tree`` with its tensor leaves replaced, in order, from ``tensors``."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if isinstance(tree, dict):
        return {k: _rebuild(v, tensors) for k, v in tree.items()}
    seq = [_rebuild(v, tensors) for v in tree]
    return seq if isinstance(tree, list) else tuple(seq)


class _Graph:
    """One captured step: the graph, its static inputs (in leaf order), its
    static output, and the kernel launches each replay makes."""

    __slots__ = ("graph", "inputs", "output", "launches")

    def __init__(self, graph, inputs, output, launches):
        self.graph, self.inputs, self.output, self.launches = graph, inputs, output, launches


def _pinned_down(objects):
    """``{key: (object, data_ptr or None)}``: what a graph's addresses
    depend on."""
    return {k: (x, x.data_ptr() if isinstance(x, torch.Tensor) else None)
            for k, x in objects.items()}


def _moved(old, now):
    """Keys of ``old`` that ``now`` lacks or holds as another object or at
    another address."""
    return [k for k, (x, ptr) in old.items()
            if k not in now or now[k][0] is not x or now[k][1] != ptr]


def _optimizer_tensors(optimizer):
    """Every tensor the optimizer keeps (its per-parameter state, and any
    tensor hyperparameter), keyed by parameter group and position."""
    out = {}
    for g, group in enumerate(optimizer.param_groups):
        for name, v in group.items():
            if isinstance(v, torch.Tensor):
                out[(g, name)] = v
        for i, p in enumerate(group["params"]):
            for name, v in optimizer.state.get(p, {}).items():
                if isinstance(v, torch.Tensor):
                    out[(g, i, name)] = v
    return out


class Captured:
    """The captured graphs of one step function, keyed by batch signature
    (the train and eval steps', and the policy server's per-bucket decode
    tick).  With a ``name`` each call's host dispatch opens the region
    ranges ``<name>.guard``, ``.copy_inputs``, ``.replay`` and ``.output``
    (:func:`blendjax_torch.obs.regions.region`)."""

    def __init__(self, name=None):
        self.graphs = {}  # signature -> _Graph
        self._ranges = [name and f"{name}.{part}"
                        for part in ("guard", "copy_inputs", "replay", "output")]
        self._warm = {}  # signature -> eager warm-up steps run
        self._bound = None  # (bound, made) as _pinned_down at the last call
        #: graphs captured so far, recaptures included
        self.captures = 0

    def __call__(self, run, batch, bound, made=None):
        """``run(batch) -> tensor`` does one step's device work on the
        current stream.  ``bound`` maps a key to each object it works on
        besides the batch (the optimizer, the parameters); ``made`` maps a
        key to each tensor the step creates on its first run (Adam's
        state), which may appear between calls but, once there, must stay
        the tensor the graphs were captured over."""
        guard, copy_inputs, replay, output = self._ranges
        with region(guard):
            now, created = _pinned_down(bound), _pinned_down(made or {})
            if self._bound is not None:
                old, old_made = self._bound
                if now.keys() != old.keys() or _moved(old, now) or _moved(old_made, created):
                    # rebound state: the graphs hold the old addresses
                    self.graphs.clear()
                    self._warm.clear()
            self._bound = now, created
            device = next(x for x in bound.values() if isinstance(x, torch.Tensor)).device
            leaves = list(_leaves(batch))
            sig = tuple((p, tuple(t.shape), t.dtype) for p, t in leaves)
            entry = self.graphs.get(sig)
        if entry is None:
            done = self._warm.get(sig, 0)
            if done < WARMUP_STEPS:
                self._warm[sig] = done + 1
                return _on_side_stream(run, batch, leaves, device)
            entry = self.graphs[sig] = _capture(run, batch, leaves, device)
            self.captures += 1
        with region(copy_inputs):
            for (_, src), dst in zip(leaves, entry.inputs):
                dst.copy_(src, non_blocking=True)
        with region(replay):
            entry.graph.replay()
            launches.add(entry.launches)
        with region(output):
            # the next replay overwrites the static output
            return entry.output.clone()


def _on_side_stream(run, batch, leaves, device):
    """One eager warm-up step on a side stream (as CUDA graph capture asks
    of the steps before it), ordered after and before the current stream."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = run(batch)
    for _, t in leaves:
        if t.is_cuda:
            t.record_stream(side)
    current.wait_stream(side)
    out.record_stream(current)
    return out


class CaptureGate:
    """Holds other threads' device work off while a step is captured.

    The feed's threads may run through a capture (see :func:`_capture`),
    but a thread that copies between pageable host memory and the card
    while another captures makes torch refuse the copy ("Cannot copy
    between CPU and CUDA tensors during CUDA graph capture unless the CPU
    tensor is pinned").  An actor's sampling (obs to the card, actions
    back) is such work: it runs inside :meth:`device_work`, which waits
    while a capture is open, and a capture opens only once no such work
    is in flight.

    While any capture is open, Python's cyclic collector is also held off
    (``gc.disable``; torch no longer collects before a capture): a dead
    cycle that holds an old ``CUDAGraph``, collected inside the capturing
    thread, would destroy that graph mid-capture, which CUDA does not
    permit, and the capture would fail ("operation failed due to a
    previous error during capture")."""

    def __init__(self):
        self._cond = threading.Condition()
        self._capturing = 0
        self._working = 0
        self._gc_was_enabled = False

    @contextlib.contextmanager
    def capturing(self):
        with self._cond:
            self._capturing += 1
            if self._capturing == 1:
                self._gc_was_enabled = gc.isenabled()
                gc.disable()
            self._cond.wait_for(lambda: self._working == 0)
        try:
            yield
        finally:
            with self._cond:
                self._capturing -= 1
                if self._capturing == 0 and self._gc_was_enabled:
                    gc.enable()
                self._cond.notify_all()

    @contextlib.contextmanager
    def device_work(self):
        with self._cond:
            self._cond.wait_for(lambda: self._capturing == 0)
            self._working += 1
        try:
            yield
        finally:
            with self._cond:
                self._working -= 1
                self._cond.notify_all()


#: the process's one gate (:class:`CaptureGate`)
capture_gate = CaptureGate()


def _capture(run, batch, leaves, device):
    """Capture ``run`` over static copies of ``batch``'s leaves."""
    inputs = [torch.empty(t.shape, dtype=t.dtype, device=device) for _, t in leaves]
    for (_, t), dst in zip(leaves, inputs):
        dst.copy_(t)
    static = _rebuild(batch, iter(inputs))
    graph = torch.cuda.CUDAGraph()
    before = launches.snapshot()
    # "thread_local": the feed's threads keep running while the step is
    # captured (the loader's recv and arena writes, the device feed's
    # pinned staging allocations, event waits and side-stream copies);
    # under the default "global" mode any of those calls, made by
    # another thread during the capture, would invalidate it.  They touch
    # no tensor of the captured stream, so only this thread's calls are
    # held to the capture's rules.
    # pageable copies of other threads (an actor's sampling) wait at the gate
    with capture_gate.capturing(), torch.cuda.graph(graph, capture_error_mode="thread_local"):
        output = run(static)
    per_replay = launches.since(before)
    launches.add(per_replay, times=-1)  # the capture itself launched nothing
    return _Graph(graph, inputs, output.detach(), per_replay)


def make_train_step(loss_fn, capture=None, balance=None):
    """Build ``step(state, batch) -> (state, loss)`` for
    ``loss_fn(params, batch) -> scalar``; ``loss`` is detached.  Captured
    on the card, eager on the CPU (see the module docstring); the step's
    graphs, by batch signature, are in ``step.graphs``.

    ``balance`` (a :class:`blendjax_torch.models.moe.Balance` whose layers
    ``loss_fn``'s DeepSeekMoE layers route with) has its ``update`` run
    once a step after Adam, outside autograd: the routing biases' step
    from the loads the forward counted, on the device and, on the card,
    inside the captured graph."""
    graphs = Captured("train")

    def step(state, batch):
        def run(b):
            with region("train.zero_grad"):
                state.optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(state.params, b)
            with region("train.backward"):
                loss.backward()
            with region("train.adam"):
                state.optimizer.step()
            if balance is not None:
                with region("train.balance"):
                    balance.update()
            return loss.detach()

        if _captures(capture, state.params.values()):
            bound = {("param", k): v for k, v in state.params.items()}
            if balance is not None:
                bound.update({("balance", k): v for k, v in balance.tensors().items()})
            bound["optimizer"] = state.optimizer
            loss = graphs(run, batch, bound, made=_optimizer_tensors(state.optimizer))
        else:
            loss = run(batch)
        state.step += 1
        return state, loss

    step.graphs = graphs.graphs
    return step


def make_eval_step(loss_fn, capture=None):
    """Build ``evaluate(params, batch) -> loss``: ``loss_fn`` under
    ``torch.no_grad()``, captured on the card as the train step is, eager
    on the CPU.  The counterpart of the reference's ``jax.jit(loss_fn)``."""
    graphs = Captured()

    def evaluate(params, batch):
        def run(b):
            with torch.no_grad():
                return loss_fn(params, b)

        if _captures(capture, params.values()):
            return graphs(run, batch, params)
        return run(batch)

    evaluate.graphs = graphs.graphs
    return evaluate
