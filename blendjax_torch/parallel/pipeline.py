"""Pipeline parallelism over a mesh axis of torch ranks: GPipe and 1F1B
microbatch pipelining; the port of ``blendjax.parallel.pipeline``.

The model is split into S stages, one per rank of the mesh's ``pipe_axis``
(the reference shards a leading stage axis ``P(pipe_axis)``); microbatches
flow stage to stage through :func:`blendjax_torch.parallel.p2p.rotate`,
which stands in for ``lax.ppermute`` (staged through pinned host buffers
on CUDA tensors, ``p2p.CUDA_ROUTES["rotate"]``).  The reference's
``shard_map`` body is each rank's own code here: with M microbatches and S
stages the forward runs M + S - 1 ticks, and at tick t stage s works on
microbatch t - s.

**Every rank makes every exchange, every tick, in the same order**, bubble
ticks included: a rank that skips one rotation hangs its partner.  What
differs by role (first, middle or last stage) is plain Python on each rank
and holds no exchange; the rotations and the all-reduces sit outside it.

- :func:`make_pipeline`: the forward, and its gradient by autograd (the
  rotation's backward rotates the gradients back).  The stages' inputs
  are chosen with ``torch.where``, so that every rank's graph holds every
  rotation and the backward makes them all, in one order, on every rank.
- :func:`make_pipeline_train` ``"gpipe"``: the same forward reduced to the
  mean microbatch loss, and ``torch.autograd.grad`` for the reverse
  schedule (every microbatch's activations live across the sweep).
- :func:`make_pipeline_train` ``"1f1b"``: the eager schedule, each stage
  running microbatch ``k - s``'s forward and microbatch ``k - (2(S-1) -
  s)``'s backward at tick k, so at most ``2S - 1`` stage inputs are held
  (a ring buffer); the backward recomputes the stage from its saved input.
  Bubble ticks compute nothing and send zeros.

The last stage's outputs and losses reach every rank of the axis through
an all-reduce whose backward passes the gradient through unchanged: every
rank then holds the same result, as the reference's ``psum`` replicates
it, and the gradient is that of one copy of the loss (each rank seeds its
own copy; summing those seeds over the axis would count the loss S times).

Usage::

    stage_fn(stage_params, x) -> y            # one stage, same x/y shape
    stacked = stack_stage_params([p0, p1, ...])   # leading stage axis
    apply = make_pipeline(stage_fn, mesh, pipe_axis='pipe')
    y = apply(stacked, x)                     # x: (M, mb, ...) microbatched

Parameters are dicts of tensors.  ``stacked`` holds every stage, and each
rank computes with its own row.  One stage per rank of the axis, and stage
inputs and outputs of one shape (they ride one rotation buffer).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from blendjax_torch.parallel import p2p
from blendjax_torch.parallel.mesh import P, placements


def stack_stage_params(stage_params_list):
    """Stack per-stage param dicts on a new leading stage axis."""
    return {k: torch.stack([p[k] for p in stage_params_list])
            for k in stage_params_list[0]}


def unstack_stage_params(stacked, n_stages):
    """Inverse of :func:`stack_stage_params`."""
    return [{k: v[i] for k, v in stacked.items()} for i in range(n_stages)]


class _SumToAll(torch.autograd.Function):
    """All-reduce (sum) over ``group``, whose backward passes the gradient
    through: the result is the same on every rank, and each rank's copy
    of what follows is one copy of it (module docstring)."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _stage_rows(stacked, n, me, pipe_axis):
    """This rank's stage params: row ``me`` of each stacked tensor."""
    n_stages = next(iter(stacked.values())).shape[0]
    if n_stages != n:
        raise ValueError(
            f"stacked params have {n_stages} stages but mesh axis "
            f"{pipe_axis!r} has size {n} (need exactly one per shard)"
        )
    return {k: v[me] for k, v in stacked.items()}


def pipeline(stage_params, x, stage_fn, group):
    """The pipeline forward on this rank of ``group``.

    ``stage_params``: this rank's stage.  ``x``: the microbatched input
    (M, mb, ...), the same on every rank of the group.  Returns (M, mb,
    ...) last-stage outputs on every rank of the group, differentiable
    into every stage's params."""
    n, me = p2p.group_rank(group)
    m = x.shape[0]
    first = torch.tensor(me == 0, device=x.device)
    state = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    rows = []
    for t in range(m + n - 1):
        # stage 0 ingests microbatch t (clamped on bubble ticks); the others
        # the neighbour's previous output
        inp = torch.where(first, x[min(t, m - 1)], state)
        out = stage_fn(stage_params, inp)
        # the last stage finished microbatch t - (n - 1) this tick
        if t >= n - 1:
            rows.append(out)
        (state,) = p2p.Rotate.apply(group, 1, out)
    acc = torch.stack(rows)
    # only the last stage holds real outputs: mask, then sum over the axis
    return _SumToAll.apply(torch.where(torch.tensor(me == n - 1, device=x.device), acc,
                                       torch.zeros_like(acc)), group)


def _split(x, x_spec, mesh):
    """``(local block, placements or None)`` of an input: a DTensor's local
    block and placements (its result is placed alike), or a plain tensor
    that already is this rank's block under ``x_spec``."""
    if isinstance(x, DTensor):
        return x.to_local(), x.placements
    placements(mesh, x_spec)  # names only axes of the mesh
    return x, None


def make_pipeline(stage_fn, mesh, pipe_axis="pipe", x_spec=None):
    """``apply(stacked_params, x)``: :func:`pipeline` over ``mesh``'s
    ``pipe_axis``, on every rank of the mesh.

    ``x_spec``: PartitionSpec of the microbatched input *excluding* the
    pipe axis (e.g. ``P(None, 'data')`` to keep the per-microbatch batch
    dimension data-sharded); replicated by default.  ``x`` is this rank's
    block of the input under ``x_spec`` (the whole input when it
    replicates), or a DTensor so placed; the result is this rank's block of
    the output, or a DTensor placed as ``x``."""
    x_spec = x_spec if x_spec is not None else P()
    n = mesh.size(mesh.mesh_dim_names.index(pipe_axis))
    group = mesh.get_group(pipe_axis)
    me = mesh.get_local_rank(pipe_axis)

    def apply(stacked_params, x):
        local, place = _split(x, x_spec, mesh)
        y = pipeline(_stage_rows(stacked_params, n, me, pipe_axis), local, stage_fn, group)
        if place is None:
            return y
        return DTensor.from_local(y, mesh, place, run_check=False)

    return apply


def _identity_proj(_params, x):
    return x


def _as_dict(params):
    return {} if params is None else params


def _fwd_loss(params, ep, rp, x, targets, *, stage_fn, loss_fn, in_proj, out_proj, group):
    """The GPipe forward reduced to the mean microbatch loss, on every rank
    of ``group``; autograd through it is the GPipe backward (every
    microbatch's activations live across the sweep, the memory profile
    1F1B avoids)."""
    n, me = p2p.group_rank(group)
    m = x.shape[0]
    dev = x.device
    first, last = torch.tensor(me == 0, device=dev), torch.tensor(me == n - 1, device=dev)
    with torch.no_grad():
        wire = in_proj(ep, x[0])
    state = torch.zeros(wire.shape, dtype=wire.dtype, device=dev)
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(m + n - 1):
        # the received state stays in every rank's graph (torch.where), so
        # every rank's backward makes every rotation
        fed = in_proj(ep, x[min(t, m - 1)]) if me == 0 else torch.zeros_like(state)
        out = stage_fn(params, torch.where(first, fed, state))
        widx = t - (n - 1)
        if widx >= 0:
            lj = loss_fn(out_proj(rp, out), targets[widx])
            loss_acc = loss_acc + torch.where(last, lj.to(torch.float32),
                                              torch.zeros_like(loss_acc))
        (state,) = p2p.Rotate.apply(group, 1, out)
    return _SumToAll.apply(loss_acc, group) / m


def _grad(outputs, inputs, grad_outputs=None):
    """``torch.autograd.grad`` over a dict of inputs, zeros for unused ones."""
    keys = list(inputs)
    got = torch.autograd.grad(outputs, [inputs[k] for k in keys], grad_outputs=grad_outputs,
                              allow_unused=True)
    return {k: torch.zeros_like(inputs[k]) if g is None else g for k, g in zip(keys, got)}


def _with_grad(params):
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def _1f1b_grads(params, ep, rp, x, targets, *, stage_fn, loss_fn, in_proj, out_proj, group):
    """The 1F1B (eager-backward) step on this rank of ``group``.

    Tick ``k`` runs the forward of microbatch ``k - s`` on stage ``s`` and
    the backward of microbatch ``k - (2(n-1) - s)``: the last stage
    backpropagates a microbatch the tick its forward completes, so at most
    ``2(n-1-s) + 1`` inputs are live on stage s (a ring buffer of ``2n -
    1``) whatever M.  The backward recomputes the stage from its saved
    input.

    Returns ``(loss, stage_grads, (d_in_proj, d_out_proj))``, averaged over
    the microbatches: the stage's gradients with a leading axis of 1 (this
    rank's row of the stacked gradient); the projections' summed over the
    axis once at the end, so every rank returns them whole."""
    n, me = p2p.group_rank(group)
    m = x.shape[0]
    dev = x.device
    depth = 2 * n - 1
    role = "first" if me == 0 else "last" if me == n - 1 else "mid"
    with torch.no_grad():
        wire = in_proj(ep, x[0])
    zero_wire = torch.zeros(wire.shape, dtype=wire.dtype, device=dev)
    saved = [None] * depth
    fwd_wire, bwd_wire = zero_wire, zero_wire
    acc_p = {k: torch.zeros_like(v) for k, v in params.items()}
    acc_e = {k: torch.zeros_like(v) for k, v in ep.items()}
    acc_r = {k: torch.zeros_like(v) for k, v in rp.items()}
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    p, e, r = _with_grad(params), _with_grad(ep), _with_grad(rp)
    for k in range(m + 2 * n - 2):
        # forward unit: microbatch k - me (the last stage's output is not
        # needed: its backward recomputes it this same tick)
        j_f = k - me
        out = zero_wire
        if 0 <= j_f < m:
            with torch.no_grad():
                inp = in_proj(ep, x[j_f]) if role == "first" else fwd_wire
                if role != "last":
                    out = stage_fn(params, inp)
            saved[j_f % depth] = inp
        # backward unit: microbatch k - (2(n-1) - me)
        j_b = k - (2 * (n - 1) - me)
        dx = zero_wire
        if 0 <= j_b < m:
            with torch.enable_grad():
                if role == "first":
                    y = stage_fn(p, in_proj(e, x[j_b]))
                    g = _grad(y, {**_tagged("p", p), **_tagged("e", e)}, bwd_wire)
                elif role == "mid":
                    a = saved[j_b % depth].detach().requires_grad_(True)
                    y = stage_fn(p, a)
                    g = _grad(y, {**_tagged("p", p), "a": a}, bwd_wire)
                    dx = g["a"]
                else:
                    a = saved[j_b % depth].detach().requires_grad_(True)
                    lj = loss_fn(out_proj(r, stage_fn(p, a)), targets[j_b])
                    g = _grad(lj, {**_tagged("p", p), **_tagged("r", r), "a": a})
                    dx = g["a"]
                    loss_acc = loss_acc + lj.detach().to(torch.float32)
            for name, acc in (("p", acc_p), ("e", acc_e), ("r", acc_r)):
                for key in acc:
                    if (name, key) in g:
                        acc[key] += g[(name, key)]
            saved[j_b % depth] = None
        (fwd_wire,) = p2p.rotate([out], group, 1)
        (bwd_wire,) = p2p.rotate([dx], group, -1)
    loss = loss_acc.clone()
    dist.all_reduce(loss, group=group)
    _sum_over(list(acc_e.values()) + list(acc_r.values()), group)
    stage_grads = {k: (g / m)[None] for k, g in acc_p.items()}
    return (loss / m, stage_grads,
            ({k: g / m for k, g in acc_e.items()}, {k: g / m for k, g in acc_r.items()}))


def _tagged(name, params):
    return {(name, k): v for k, v in params.items()}


def _sum_over(tensors, group):
    """Sum ``tensors`` in place over ``group``: one all-reduce per dtype."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))


def make_pipeline_train(stage_fn, loss_fn, mesh, pipe_axis="pipe", schedule="1f1b",
                        in_proj=None, out_proj=None):
    """Pipeline-parallel training step factory.

    ``stage_fn(stage_params, wire) -> wire`` runs one stage at the common
    wire width; ``in_proj(proj_params[0], microbatch) -> wire`` and
    ``out_proj(proj_params[1], wire) -> pred`` lift the equal-shape
    constraint at the model's boundary; ``loss_fn(pred, target) ->
    scalar``.

    ``schedule``:
      - ``"gpipe"``: forward sweep, then autograd's backward; activation
        memory grows with the microbatch count M.
      - ``"1f1b"``: eager backward, at most ``2*stages-1`` stage inputs
        held per stage whatever M (:func:`_1f1b_grads`).

    Returns ``train(stacked_params, proj_params, x, targets) -> (loss,
    (stage_grads, proj_grads))`` for ``x``/``targets`` microbatched ``(M,
    mb, ...)`` (:func:`microbatch`), the same on every rank of the axis.
    ``proj_params`` is a pair of param dicts (None for an identity
    projection).  Gradients are averaged over microbatches: M is the
    gradient accumulation.  ``loss`` and ``proj_grads`` are the same on
    every rank; ``stage_grads`` is this rank's row of the stacked gradient
    (a leading axis of 1), the reference's ``P(pipe_axis)`` shard."""
    n = mesh.size(mesh.mesh_dim_names.index(pipe_axis))
    if n < 2:
        raise ValueError(f"pipeline needs mesh axis {pipe_axis!r} >= 2, got {n}")
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown schedule {schedule!r}")
    in_proj = in_proj if in_proj is not None else _identity_proj
    out_proj = out_proj if out_proj is not None else _identity_proj
    group = mesh.get_group(pipe_axis)
    me = mesh.get_local_rank(pipe_axis)
    common = dict(stage_fn=stage_fn, loss_fn=loss_fn, in_proj=in_proj, out_proj=out_proj,
                  group=group)

    def train(stacked_params, proj_params, x, targets):
        params = _stage_rows(stacked_params, n, me, pipe_axis)
        ep, rp = (_as_dict(p) for p in proj_params)
        if schedule == "1f1b":
            loss, gs, gp = _1f1b_grads(params, ep, rp, x, targets, **common)
            return loss, (gs, gp)
        p, e, r = _with_grad(params), _with_grad(ep), _with_grad(rp)
        with torch.enable_grad():
            loss = _fwd_loss(p, e, r, x, targets, **common)
            g = _grad(loss, {**_tagged("p", p), **_tagged("e", e), **_tagged("r", r)})
        ge = {k: g[("e", k)] for k in e}
        gr = {k: g[("r", k)] for k in r}
        # each stage holds its own projections' share: sum them over the axis
        _sum_over(list(ge.values()) + list(gr.values()), group)
        return loss.detach(), ({k: g[("p", k)][None] for k in p}, (ge, gr))

    return train


def microbatch(batch, num_microbatches):
    """Reshape (B, ...) -> (M, B/M, ...) for the pipeline, on a tensor or an
    array, or on each of a (nested) dict of them.

    Every leaf's leading axis must split evenly: a ragged split would
    silently change the per-microbatch loss weighting, so it raises naming
    the leaf's shape."""
    m = int(num_microbatches)
    if m < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {num_microbatches}")

    def split(x):
        b = x.shape[0]
        if b % m:
            raise ValueError(
                f"batch leaf of shape {tuple(x.shape)} not splittable into "
                f"{m} microbatches: leading axis {b} leaves remainder "
                f"{b % m}; pick batch/num_microbatches divisible "
                f"(e.g. batch {b - b % m} or {b + m - b % m})"
            )
        return x.reshape((m, b // m) + tuple(x.shape[1:]))

    if isinstance(batch, dict):
        return {k: microbatch(v, m) for k, v in batch.items()}
    return split(batch)
