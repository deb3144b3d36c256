"""Routed top-k mixture of experts with a fixed per-expert capacity; the port
of ``blendjax.models.moe``.

The SeqFormer's dense mixture (``seqformer._moe_apply``) runs every expert
on every token.  Here each token goes to its ``k`` most probable experts,
each expert takes at most ``capacity`` tokens (so every shape is static and
the step can be captured), the tokens an expert cannot take contribute
nothing (the block's residual carries them), and the ``k`` outputs of a
token are summed under its renormalized gate weights.  At ``k ==
n_experts`` with ample capacity the output equals the dense mixture.

Two ways to build the per-expert slot arena, with the same routing policy:
``dispatch="sort"`` (a stable sort of the choice-major assignment rows by
expert, then gathers) and ``dispatch="scatter"`` (a scatter of each row to
its slot).  The expert products are ``torch.einsum``; no kernel of the port
is on this path (the reference leaves them to XLA too).

Where the port differs from the reference in mechanism, and why:

- **Top-k ties.**  ``jax.lax.top_k`` returns the lower expert first among
  equal probabilities; ``torch.topk`` promises no order.  The choice is a
  stable descending sort, so the assignment rows equal the reference's.
- **Counts without a host read.**  ``jnp.bincount(idx, length=e)`` becomes
  a one-hot sum (``torch.bincount`` reads its maximum back to the host,
  which a captured step cannot do).
- **Gradients without order-dependent sums.**  The sort path's arena is
  gathered from the ``k*n`` choice-major rows (each token repeated ``k``
  times, a zero row after them for the empty slots), not from the ``n``
  tokens: every real arena row then reads a distinct source row, so the
  gather's backward adds at most one value into each, and the ``k``
  copies of a token are summed by the repeat's backward.  The combine
  gathers distinct slots too, but for the dropped rows' zero sentinel.
  The gathers are ``index_select``, whose backward is one ``index_add``
  (on the card, one atomic add into each real row, so its order cannot
  matter): advanced indexing's backward sorts its indices first and took
  87 of a 130 ms flagship step on an H100.  The scatter path's
  ``index_add`` has distinct destinations but for the sentinel, which is
  discarded.  A captured step stays bit-equal to an eager one.
"""

from __future__ import annotations

import math

import torch

from blendjax_torch.models.layers import dense_apply, gelu


def expert_capacity(n_tokens, n_experts, k, capacity_factor):
    """Static per-expert slot count: perfectly balanced load times the
    capacity factor (>= 1 leaves headroom for imbalance)."""
    return max(1, math.ceil(k * n_tokens / n_experts * capacity_factor))


def _one_hot(idx, n, dtype):
    """``jax.nn.one_hot``: indices outside ``[0, n)`` give a zero row, and
    nothing is read back to the host."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _topk_gates(probs, k):
    """The routing policy's weights: the top-k probabilities renormalized
    to sum 1 (n, k), and the choice-major assignment rows' expert ids (row
    ``j*n + i`` is token i's j-th choice, so first choices claim capacity
    slots first).  Ties go to the lower expert id, as ``jax.lax.top_k``."""
    n = probs.shape[0]
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_idx = vals[:, :k], idx[:, :k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return gate_idx.T.reshape(k * n), gate_w


def topk_assignments(probs, k, capacity):
    """Top-k routing with capacity-bounded slot assignment, in the cumsum
    (scatter-dispatch) form.

    probs: (n, e) float32 router probabilities (full softmax).  Returns
    ``(idx, pos, keep, gate_w)``, choice-major over ``k*n`` assignment
    rows: the chosen expert, the slot within it, whether the row won a
    slot, and the renormalized gate weights (n, k)."""
    e = probs.shape[1]
    idx, gate_w = _topk_gates(probs, k)
    oh_i = _one_hot(idx, e, torch.int64)
    # prior assignments per expert; the scan runs along each expert's row
    # (a scan down the k*n rows of e columns took 11.5 of a 55 ms flagship
    # step on an H100)
    pos = torch.cumsum(oh_i.T, dim=1).T - oh_i
    pos = (pos * oh_i).sum(-1)  # (k*n,) slot index within the expert
    keep = pos < capacity
    return idx, pos, keep, gate_w


def route_topk(probs, k, capacity):
    """One-hot matrix view of :func:`topk_assignments`: ``(dispatch,
    combine, keep)``, the (k*n, e, capacity) one-hot dispatch, the dispatch
    scaled by the renormalized gate weight, and the slot-won mask."""
    n, e = probs.shape
    idx, pos, keep, gate_w = topk_assignments(probs, k, capacity)
    capacity = int(capacity)
    oh = _one_hot(idx, e, probs.dtype) * keep[:, None]
    slot = _one_hot(pos, capacity, probs.dtype)
    dispatch = oh[:, :, None] * slot[:, None, :]
    combine = dispatch * gate_w.T.reshape(k * n)[:, None, None]
    return dispatch, combine, keep


def load_balance_loss(probs, gate_idx_top1):
    """Switch-Transformer auxiliary loss ``e * sum_e(f_e * p_e)``: ``f_e``
    the fraction of tokens whose first choice is expert e, ``p_e`` the
    mean router probability.  1 at uniform load."""
    e = probs.shape[-1]
    f = _one_hot(gate_idx_top1, e, probs.dtype).mean(0)
    p = probs.mean(0)
    return e * torch.sum(f * p)


def _dispatch_scatter(xf, idx, pos, keep, n, e, d, capacity, dtype):
    """Scatter dispatch: each assignment row added into its slot of an
    arena with one sentinel row (``e*capacity``) for the dropped rows.
    Returns ``(expert_in (e, capacity, d), row_slot (k*n,))``."""
    k = idx.shape[0] // n
    slot = torch.where(keep, idx * capacity + pos, e * capacity)
    x_rep = xf.repeat(k, 1).to(dtype)
    arena = torch.zeros((e * capacity + 1, d), dtype=dtype, device=xf.device)
    arena = arena.index_add(0, slot, x_rep)
    return arena[:-1].reshape(e, capacity, d), slot


def _dispatch_sort(xf, probs, k, capacity, dtype):
    """Sort dispatch: a stable argsort of the choice-major assignment rows
    by expert groups each expert's rows in row order, so the rank within
    the group is :func:`topk_assignments`' cumsum slot; slot ``(q, r)``
    then gathers sorted position ``start[q] + r``.  The only scatter is the
    (k*n,) int64 inverse permutation.  Returns ``(expert_in, row_slot,
    keep, gate_w)``."""
    n, e = probs.shape
    kn = k * n
    device = xf.device
    idx, gate_w = _topk_gates(probs, k)

    order = torch.argsort(idx, stable=True)  # sorted position -> row
    sorted_e = idx[order]
    counts = _one_hot(idx, e, torch.int64).sum(0)
    start = torch.cumsum(counts, dim=0) - counts  # each group's first position
    rank = torch.arange(kn, device=device) - start[sorted_e]
    slot_sorted = torch.where(rank < capacity, sorted_e * capacity + rank, e * capacity)
    row_slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    keep = row_slot < e * capacity

    slots = torch.arange(e * capacity, device=device)
    q, r = slots // capacity, slots % capacity
    valid = r < counts[q]
    src = torch.where(valid, start[q] + r, 0)
    # the slot's assignment row, or the zero row after the k*n rows
    row = torch.where(valid, order[src], kn)
    rows = torch.cat([xf.to(dtype).repeat(k, 1),
                      torch.zeros((1, xf.shape[-1]), dtype=dtype, device=device)])
    expert_in = rows.index_select(0, row).reshape(e, capacity, xf.shape[-1])
    return expert_in, row_slot, keep, gate_w


def moe_apply_topk(p, x, dtype, k=2, capacity_factor=1.25, dispatch="sort",
                   token_mean=None):
    """Routed MoE layer forward over the dense mixture's parameters
    (``gate``/``w1``/``b1``/``w2``/``b2``, expert-stacked), so routing is
    an apply-time choice.  ``dispatch`` is ``'sort'`` or ``'scatter'``
    (module docstring).  The gate runs in float32, the experts in
    ``dtype``.

    Returns ``(y, aux)``: ``y`` (b, t, d), and ``aux`` with ``aux_loss``
    (the load balance) and ``dispatch_fraction`` (the share of assignment
    rows that won a slot).

    ``token_mean`` (a shard's layer, when the batch's tokens are spread
    over ranks in equal shares) takes a tensor of per-rank means to the
    mean over every rank's tokens, without a gradient.  The first-choice
    fractions ``f`` of the load-balance loss are then global, and its
    mean probabilities ``p`` stay this rank's: the mean over ranks of the
    ranks' ``e * sum(f * p)``, which the sharded step takes, is the
    global loss and its gradient.  Capacity stays per rank
    (``expert_capacity`` of this rank's tokens), so a capacity drop
    follows this rank's order of assignments, not the global one."""
    b, t, d = x.shape
    n = b * t
    e = p["w1"].shape[0]
    k = min(k, e)
    xf = x.reshape(n, d)

    probs = torch.softmax(dense_apply(p["gate"], xf, dtype=torch.float32), dim=-1)
    capacity = expert_capacity(n, e, k, capacity_factor)

    if dispatch == "sort":
        expert_in, row_slot, keep, gate_w = _dispatch_sort(xf, probs, k, capacity, dtype)
    elif dispatch == "scatter":
        idx, pos, keep, gate_w = topk_assignments(probs, k, capacity)
        expert_in, row_slot = _dispatch_scatter(xf, idx, pos, keep, n, e, d, capacity, dtype)
    else:
        raise ValueError(f"unknown dispatch {dispatch!r}")

    h = gelu(torch.einsum("ecd,edf->ecf", expert_in, p["w1"].to(dtype))
             + p["b1"][:, None, :].to(dtype))
    out = torch.einsum("ecf,efd->ecd", h, p["w2"].to(dtype))
    out = out + p["b2"][:, None, :].to(dtype)
    out_flat = torch.cat([out.reshape(e * capacity, d),
                          torch.zeros((1, d), dtype=dtype, device=x.device)])
    scale = (gate_w.T.reshape(k * n) * keep).to(dtype)
    y = (out_flat.index_select(0, row_slot) * scale[:, None]).reshape(k, n, d).sum(0)

    fraction = keep.to(torch.float32).mean()
    if token_mean is None:
        aux_loss = load_balance_loss(probs, torch.argmax(probs, dim=-1))
    else:
        f = token_mean(_one_hot(torch.argmax(probs, dim=-1), e, probs.dtype).mean(0))
        aux_loss = e * torch.sum(f * probs.mean(0))
        fraction = token_mean(fraction)
    aux = {"aux_loss": aux_loss, "dispatch_fraction": fraction}
    return y.reshape(b, t, d), aux
