"""Sharding rules and the mesh-sharded train steps; the port of
``blendjax.parallel.sharding``.

- **data axis**: each rank is fed its shard of the stream
  (``BatchLoader(shard=(rank, n))``), the batch is a DTensor ``Shard(0)``
  over ``'data'`` (``TorchStream(sharding=data_sharding(mesh))``), and the
  step computes the loss on this rank's rows and averages the gradients
  over the axis with one all-reduce, as DDP does.
- **seq axis**: a batch ``P('data', 'seq')`` gives each rank a block of
  rows and sequence positions; attention crosses the sequence shards
  (:mod:`blendjax_torch.parallel.ring_attention`), and the gradients are
  averaged over ``'seq'`` as over ``'data'``
  (:func:`make_seqformer_train_step`).
- **model axis**: wide dense layers shard their output features
  (``P(None, 'model')``); DTensor inserts the collectives between them.

Rules map suffixes of the port's dotted parameter paths (as tuples,
``("fc", "w")``) to :class:`~blendjax_torch.parallel.mesh.PartitionSpec`;
anything unmatched replicates.

Only the step knows about the mesh: the loss, the model's layers and the
kernel wrappers see plain tensors (a rank's rows of the batch, its local
parameters), and on a mesh with a model axis the sharded parameters as
DTensors over that axis alone.  DTensor's own pad and convolution would
otherwise see a batch split over ``'data'``, and gather it or refuse a
strided SAME convolution; a kernel wrapper cannot take a DTensor at all.

The sharded step runs **eager**.  Ranks that share one card talk over
gloo, whose collectives go through the host and cannot be captured in a
CUDA graph; a capture request on DTensor parameters raises
(:func:`blendjax_torch.models.train.make_train_step`).
"""

from __future__ import annotations

import functools
import math
from contextlib import nullcontext

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from blendjax_torch.btt.prefetch import _map_leaves
from blendjax_torch.models.train import TrainState
from blendjax_torch.parallel.mesh import NamedSharding, P, placements

#: the mesh axes a batch is split over: its rows ('data') and its sequence
#: positions ('seq'); parameters replicate over both
BATCH_AXES = ("data", "seq")


def detector_rules(axis="model"):
    """Tensor-parallel rules for :mod:`blendjax_torch.models.detector`: the
    two dense layers carry the parameter mass and split their features;
    the convs replicate."""
    return {
        ("fc", "w"): P(None, axis),
        ("fc", "b"): P(axis),
        ("head", "w"): P(axis, None),  # row-parallel: consumes fc's sharded out
        ("head", "b"): P(),
    }


def seqformer_rules(model_axis="model", expert_axis=None):
    """Sharding rules for :mod:`blendjax_torch.models.seqformer`: attention
    projections over the head axis (head-major layout), the MLP column-
    then row-parallel, the MoE expert stacks over ``expert_axis`` (the
    model axis when the mesh has no expert axis)."""
    e = expert_axis or model_axis
    return {
        ("wq", "w"): P(None, model_axis, None),
        ("wq", "b"): P(model_axis, None),
        ("wk", "w"): P(None, model_axis, None),
        ("wk", "b"): P(model_axis, None),
        ("wv", "w"): P(None, model_axis, None),
        ("wv", "b"): P(model_axis, None),
        ("wo", "w"): P(model_axis, None, None),
        ("wo", "b"): P(),
        ("mlp", "fc", "w"): P(None, model_axis),
        ("mlp", "fc", "b"): P(model_axis),
        ("mlp", "proj", "w"): P(model_axis, None),
        ("mlp", "proj", "b"): P(),
        ("moe", "w1"): P(e, None, None),
        ("moe", "b1"): P(e, None),
        ("moe", "w2"): P(e, None, None),
        ("moe", "b2"): P(e, None),
    }


def param_specs(params, rules):
    """``{path: PartitionSpec}`` for flat ``params``: each path (split on
    ``.``) against the rules' keys as suffixes, the longest match winning;
    unmatched paths replicate."""
    ordered = sorted(rules.items(), key=lambda kv: -len(kv[0]))

    def spec_for(path):
        key = tuple(path.split("."))
        for rule_key, spec in ordered:
            if key[-len(rule_key):] == tuple(rule_key):
                return spec
        return P()

    return {path: spec_for(path) for path in params}


def shard_pytree(tree, mesh, specs):
    """Place flat ``tree`` on ``mesh`` by ``specs`` (:func:`param_specs`):
    each tensor becomes a DTensor, broadcast whole from the mesh's first
    rank on each axis and then cut to its shards on every rank (no scatter:
    gloo's CUDA scatter and gathers are not used).  A replica's local
    tensor may be the tensor given (broadcast in place), so a state built
    on it updates that tensor, as :class:`TrainState` updates its
    parameters in place."""
    whole = [Replicate()] * mesh.ndim

    def place(v, spec):
        dt = distribute_tensor(v, mesh, whole)
        target = placements(mesh, spec)
        return dt if list(target) == whole else dt.redistribute(mesh, target)

    return {k: place(v, specs[k]) for k, v in tree.items()}


def gather_whole(t):
    """``t`` whole, as a plain tensor on every rank of its mesh.

    Each mesh dimension a DTensor is sharded over is gathered with c10d's
    ``all_gather`` on that dimension's group and concatenated along the
    placement's tensor dimension; a replicated DTensor gives its local
    tensor, a plain tensor itself.  A collective where ``t`` is sharded,
    so every rank of the mesh calls it.  DTensor's ``Shard`` cuts as
    ``torch.chunk`` does, so shards can differ in length: each is padded to
    the longest, gathered, then trimmed.  (DTensor's own ``full_tensor()``
    goes through the functional all-gather, which torch 2.11's gloo
    cannot run on CUDA tensors; c10d's ``all_gather`` can.)"""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    whole = t.to_local().detach()
    for mesh_dim, placement in enumerate(t.placements):
        if not placement.is_shard():
            continue
        dim, n = placement.dim, mesh.size(mesh_dim)
        size = t.shape[dim]
        chunk = -(-size // n)
        lengths = [max(0, min(chunk, size - i * chunk)) for i in range(n)]
        pad = list(whole.shape)
        pad[dim] = chunk - whole.shape[dim]
        padded = torch.cat([whole, whole.new_zeros(pad)], dim) if pad[dim] else whole
        parts = [torch.empty_like(padded) for _ in range(n)]
        dist.all_gather(parts, padded.contiguous(), group=mesh.get_group(mesh_dim))
        whole = torch.cat([p.narrow(dim, 0, length) for p, length in zip(parts, lengths)],
                          dim)
    return whole


class _ReplicatePlain(TorchFunctionMode):
    """Where a call mixes plain tensors with DTensors, the plain ones join
    ``mesh`` as replicated DTensors (``DTensor.from_local``, above
    autograd: a gradient that comes back partial is summed over the mesh
    before it reaches the plain tensor's producer, and arrives plain)."""

    def __init__(self, mesh):
        super().__init__()
        self.whole = [Replicate()] * mesh.ndim
        self.mesh = mesh

    def __torch_function__(self, func, types, args=(), kwargs=None):
        flat, spec = tree_flatten((args, kwargs or {}))
        if any(isinstance(a, DTensor) for a in flat):
            flat = [DTensor.from_local(a, self.mesh, self.whole, run_check=False)
                    if isinstance(a, torch.Tensor) and not isinstance(a, DTensor) else a
                    for a in flat]
            args, kwargs = tree_unflatten(flat, spec)
        return func(*args, **(kwargs or {}))


def _batch_axes(mesh):
    """``(dims, groups, size)`` of ``mesh``'s batch axes (:data:`BATCH_AXES`):
    their mesh dimensions, process groups, and the product of their sizes."""
    names = mesh.mesh_dim_names
    dims = [i for i, n in enumerate(names) if n in BATCH_AXES]
    return dims, [mesh.get_group(names[i]) for i in dims], math.prod(mesh.size(i) for i in dims)


def make_sharded_train_step(loss_fn, mesh, rules=None, lr=1e-3):
    """Build ``(init_sharded, step)`` for SPMD training over ``mesh``.

    ``init_sharded(params)`` places the params by ``rules``
    (:func:`shard_pytree`) and gives them the port's Adam(``lr``) in a
    :class:`~blendjax_torch.models.train.TrainState`; its moments take
    their parameters' placements.  ``step(state, batch) -> (state,
    loss)`` runs eager (module docstring).  The batch arrives as DTensors
    over the batch axes, ``Shard(0)`` over ``'data'`` and ``Shard(1)``
    over ``'seq'`` where the mesh has them
    (``TorchStream(sharding=data_sharding(mesh))``, or
    :func:`blendjax_torch.btt.prefetch.put_batch`); ``loss_fn`` gets this
    rank's block as plain tensors, and the parameters as plain tensors
    where they replicate over every other axis, as DTensors over those
    axes where a rule shards them (a plain tensor meeting one of those joins
    their mesh replicated).  ``loss_fn`` must be a mean over its block, and
    the ranks' blocks equal in size: the gradients and the loss are
    averaged over the batch axes, which then equals one process's step on
    the global batch (the mean of equal blocks' means is the global mean;
    over ``'seq'``, attention's backward sends each rank the gradients its
    keys and values took in the other ranks' losses).  ``loss`` comes back a
    plain tensor, the same on every rank.  Parameters may not be sharded
    over a batch axis."""
    rules = rules or {}
    names = mesh.mesh_dim_names
    batch_dims, groups, n_batch = _batch_axes(mesh)
    others = tuple(n for n in names if n not in BATCH_AXES)
    model = None if not others else (mesh if not batch_dims else mesh[others])

    def init_sharded(params):
        return TrainState.create(shard_pytree(params, mesh, param_specs(params, rules)),
                                 lr=lr)

    def view(path, p):
        """``p`` as ``loss_fn`` sees it; differentiable into ``p``."""
        kept = list(p.placements)
        for i in reversed(batch_dims):
            if not kept.pop(i).is_replicate():
                raise ValueError(f"{path} is sharded over the batch axis {names[i]!r}; the "
                                 "sharded step replicates parameters there")
        if all(q.is_replicate() for q in kept):
            return p.to_local()
        return DTensor.from_local(p.to_local(), model, kept, run_check=False,
                                  shape=p.shape, stride=p.stride())

    def average(tensors):
        """Average ``tensors`` in place over the batch axes, one all-reduce
        per dtype and axis."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            for group in groups:
                dist.all_reduce(flat, group=group)
            flat /= n_batch
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view_as(t))

    def step(state, batch):
        state.optimizer.zero_grad(set_to_none=True)
        local = _map_leaves(lambda t: t.to_local() if isinstance(t, DTensor) else t,
                            batch, torch.Tensor)
        with _ReplicatePlain(model) if model is not None else nullcontext():
            loss = loss_fn({k: view(k, p) for k, p in state.params.items()}, local)
            if isinstance(loss, DTensor):
                loss = loss.full_tensor()
            loss.backward()
        loss = loss.detach().clone()
        if n_batch > 1:
            with torch.no_grad():
                average([p.grad.to_local() for p in state.params.values()
                         if p.grad is not None] + [loss])
        state.optimizer.step()
        state.step += 1
        return state, loss

    return init_sharded, step


def batch_mean(mesh):
    """``mean(x)``: a tensor of this rank's means to the mean over every
    rank of ``mesh``'s batch axes (equal shares), with no gradient; the
    sharded SeqFormer's routed layers take their load-balance fractions
    through it (``moe_apply_topk(token_mean=)``)."""
    _, groups, n = _batch_axes(mesh)

    def mean(x):
        if isinstance(x, DTensor):  # a statistic over a model axis's replicas
            x = x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim).to_local()
        x = x.detach().clone()
        for group in groups:
            dist.all_reduce(x, group=group)
        return x / n

    return mean


def make_seqformer_train_step(mesh, lr=1e-3, model_axis="model", expert_axis=None,
                              attn_impl="ring", moe_impl="dense", moe_k=2,
                              moe_capacity_factor=1.25, moe_aux_weight=0.0,
                              compute_dtype=None, attn_window=None):
    """The 4-way-parallel SeqFormer step: the batch over ``'data'``, the
    sequence over ``'seq'``, attention heads and the MLP over
    ``model_axis`` (ring schemes only), MoE experts over ``expert_axis``
    (:func:`seqformer_rules`), on whichever of these axes ``mesh`` has.

    ``attn_impl`` picks the sequence scheme
    (:func:`~blendjax_torch.parallel.ring_attention.make_ring_attention`):
    ``'ring'``, ``'ring_flash'`` (the flash kernels per ring pair),
    ``'zigzag_flash'``, ``'ulysses'`` or ``'ulysses_flash'`` (the flash
    kernels as Ulysses' per-head-group attention).  ``moe_impl='topk'``
    routes the experts, with their load-balance statistics over the whole
    batch (:func:`batch_mean`; capacity stays per rank).  ``attn_window``
    is sliding-window attention through the scheme; ``compute_dtype``
    passes to the loss (the model's bf16 by default).

    Each rank runs the model on its block ``(B/dp, T/sp)``: the loss reads
    the positions from ``T/sp`` times its ``'seq'`` index, and the step
    averages the gradients of the replicated parameters over ``'data'``
    and ``'seq'`` (:func:`make_sharded_train_step`: the blocks are equal,
    so the mean of the local MSE means is the global mean).  It runs eager,
    as every sharded step does.  Returns ``(init_sharded, step,
    batch_sharding)``; place batches with ``batch_sharding``, ``P('data',
    'seq')``."""
    from blendjax_torch.models import seqformer
    from blendjax_torch.parallel.ring_attention import make_ring_attention

    names = mesh.mesh_dim_names
    inner_attn = None
    if attn_impl == "ulysses_flash":
        from blendjax_torch.ops.flash_attention import flash_attention, flash_block_size

        attn_impl = "ulysses"

        def inner_attn(q, k, v, causal=False, scale=None, window=None):
            blk = flash_block_size(q.shape[1])
            return flash_attention(q, k, v, causal, scale, blk, blk, window)

    ring = attn_impl in ("ring", "ring_flash", "zigzag_flash")
    attn = make_ring_attention(
        mesh, seq_axis="seq", causal=True, impl=attn_impl,
        head_axis=model_axis if ring and model_axis in names else None,
        inner_attn=inner_attn, window=attn_window)
    kwargs = dict(attn_fn=attn, moe_impl=moe_impl, moe_k=moe_k,
                  moe_capacity_factor=moe_capacity_factor, moe_aux_weight=moe_aux_weight,
                  token_mean=batch_mean(mesh))
    if compute_dtype is not None:
        kwargs["compute_dtype"] = compute_dtype
    seq_index = mesh.get_local_rank("seq")
    loss = functools.partial(seqformer.loss_fn, **kwargs)

    def shard_loss(params, batch):
        return loss(params, batch, pos_offset=seq_index * batch["obs"].shape[1])

    # a rule naming an axis the mesh lacks replicates (a {"seq": 2} mesh shards nothing)
    rules = {k: spec for k, spec in seqformer_rules(model_axis, expert_axis).items()
             if all(a is None or a in names for a in spec)}
    init_sharded, step = make_sharded_train_step(shard_loss, mesh, rules=rules, lr=lr)
    spec = P("data" if "data" in names else None, "seq", None)
    return init_sharded, step, NamedSharding(mesh, spec)
