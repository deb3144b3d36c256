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

**DeepSeekMoE** (:func:`deepseek_moe_apply`; DeepSeek-V3, arXiv
2412.19437, eqs. 12-16, as Moonlight-16B-A3B configures it) is a layer of
its own beside the top-k mixture, which keeps its behaviour: sigmoid
scores in f32 over all routed experts, the top ``k`` chosen on score plus
a balancing bias that decides only the choice, weights from the unbiased
scores normalised over the chosen and scaled, SwiGLU experts without
biases, and shared experts that every token takes.  The layer is told
which experts it holds (one card's share under expert parallelism) and
routes over all of them; it computes its held experts' part of the result
and drops no assignment: the held rows go into one arena whose bound is
every held assignment the tokens can make (:func:`arena_rows`), grouped by
expert, and the expert products are torch's grouped matrix products over
the per-expert row ends, which stay on the device (:func:`grouped_mm`), so
their work follows the rows actually routed.  :class:`Balance` holds the
balancing biases and the layer's device counters, and its ``update`` is
the auxiliary-loss-free bias step that the train step runs once a step
(:func:`blendjax_torch.models.train.make_train_step`'s ``balance``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from blendjax_torch.models.layers import dense_apply, gelu
from blendjax_torch.obs.regions import region


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


# -- DeepSeekMoE ----------------------------------------------------------------


def arena_rows(n_tokens, k, held):
    """The held share's arena bound: every held assignment ``n_tokens``
    tokens can make (a token takes an expert once, so at most ``min(k,
    held)`` of the held ones).  No routing overflows it."""
    return n_tokens * min(k, held)


def grouped_mm(x, w, ends):
    """``y[rows of e] = x[rows of e] @ w[e]`` over the arena ``x`` (R, K),
    expert ``e`` owning rows ``ends[e - 1]`` to ``ends[e]`` of it, with ``w``
    (E, K, N) cast to ``x``'s dtype: torch's grouped matrix product
    (``torch._grouped_mm``), differentiable in ``x`` and ``w``, its
    problem sizes read on the device.  Rows past ``ends[-1]`` are neither
    read nor written, in the output or in ``x``'s gradient: they hold
    whatever their allocation held, and the callers read none of them."""
    return torch._grouped_mm(x, w.to(x.dtype), offs=ends)


def sigmoid_topk(scores, bias, k):
    """DeepSeek-V3's choice: the ``k`` experts of largest ``scores + bias``
    (lower expert id first among equal values, as :func:`_topk_gates`
    breaks ties), and their weights from the unbiased scores, normalised
    over the chosen: ``(idx (n, k), weights (n, k))``, weights before the
    routed scaling factor."""
    _, idx = torch.sort(scores + bias, dim=-1, descending=True, stable=True)
    idx = idx[:, :k]
    chosen = scores.gather(1, idx)
    return idx, chosen / chosen.sum(-1, keepdim=True)


def sequence_balance_loss(scores, idx, batch, k):
    """DeepSeek-V3's sequence-wise balance loss (eqs. 17-20) without its
    weight alpha, averaged over the batch's sequences: ``sum_i f_i P_i`` with
    ``f_i = E / (k T) * (choices of expert i in the sequence)`` and ``P_i``
    the sequence's mean of the scores normalised over all experts."""
    n, e = scores.shape
    t = n // batch
    chosen = torch.zeros_like(scores).scatter_(1, idx, 1.0)
    f = chosen.reshape(batch, t, e).sum(1) * (e / (k * t))
    p = (scores / scores.sum(-1, keepdim=True)).reshape(batch, t, e).mean(1)
    return (f * p).sum(-1).mean()


class Balance:
    """The balancing state of a model's DeepSeekMoE layers, on the device:
    per layer the bias over all routed experts (f32, not a gradient leaf)
    and the step's load, and the counters that are read only after a run:
    rows per held expert (summed over every forward),
    the largest max/mean load over all experts at an update, the largest
    held share of a forward (its held rows over ``k * n * held / experts``),
    the last sequence-wise balance loss, and the updates made.

    :meth:`update` is auxiliary-loss-free balancing (DeepSeek-V3, section
    2.1.2): ``b_i += gamma * sign(mean load - load_i)`` from the loads the
    forwards since the last update counted over all routed experts, then
    the loads start again.  Nothing is read back to the host."""

    def __init__(self, layers, n_experts, held, gamma, device):
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.gamma = gamma
        self.layers = {name: {"bias": zeros(n_experts), "load": zeros(n_experts),
                              "rows": zeros(held, dtype=torch.int64),
                              "max_over_mean": zeros(), "max_held_share": zeros(),
                              "balance_loss": zeros()}
                       for name in layers}
        self.updates = zeros(dtype=torch.int64)

    def tensors(self):
        """``{name: tensor}``: every buffer, for a captured step's address
        checks."""
        out = {f"{layer}.{k}": v for layer, bufs in self.layers.items() for k, v in bufs.items()}
        out["updates"] = self.updates
        return out

    @torch.no_grad()
    def update(self):
        for bufs in self.layers.values():
            load = bufs["load"]
            mean = load.mean()
            bufs["bias"].add_(torch.sign(mean - load), alpha=self.gamma)
            torch.maximum(bufs["max_over_mean"], load.max() / mean.clamp_min(1e-30),
                          out=bufs["max_over_mean"])
            load.zero_()
        self.updates.add_(1)

    def read(self):
        """The counters as host numbers (synchronises): per layer the rows
        of each held expert, the largest max/mean load
        and held share, the last balance loss, and the spread (max - min)
        of the bias."""
        out = {}
        for name, b in self.layers.items():
            out[name] = {"rows": [int(x) for x in b["rows"].tolist()],
                         "max_over_mean": float(b["max_over_mean"]),
                         "max_held_share": float(b["max_held_share"]),
                         "balance_loss": float(b["balance_loss"]),
                         "bias_spread": float(b["bias"].max() - b["bias"].min())}
        return {"layers": out, "updates": int(self.updates)}


def _swiglu(p, x, dtype):
    """``w2(silu(w1 x) * w3 x)`` over (.., d) ``x``, bias-free (d, f) /
    (f, d) weights."""
    h1 = x.to(dtype) @ p["w1"].to(dtype)
    h3 = x.to(dtype) @ p["w3"].to(dtype)
    return (F.silu(h1) * h3) @ p["w2"].to(dtype)


def _held_dispatch(idx, weights, first, held, rows):
    """The held share's arena from the choices (n, k): for each of the
    ``rows`` arena rows the token it reads (``n`` where none: the zero row)
    and its gate weight (0 where none), the held experts' (held,) int32 row
    ends (the ``ends`` of :func:`grouped_mm`) and the rows each took.  The
    assignments sorted by expert, each expert's in token order, put the
    held ones first, and ``rows`` from :func:`arena_rows` holds them all."""
    n, k = idx.shape
    local = idx - first
    flat = torch.where((local >= 0) & (local < held), local, held).reshape(-1)
    counts = torch.zeros(held + 1, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    order = torch.argsort(flat, stable=True)[:rows]
    is_held = flat[order] < held
    tok = torch.where(is_held, order // k, n)
    w = torch.where(is_held, weights.reshape(-1)[order], 0.0)
    return tok, w, torch.cumsum(counts[:held], 0).to(torch.int32), counts[:held]


def deepseek_moe_apply(p, x, dtype, k, scale, first, n_experts, state=None, batch=1):
    """The DeepSeekMoE layer's forward over the normed (n, d) ``x``:
    ``sum_shared FFN_s(x) + sum_(chosen and held) g_i FFN_i(x)``.

    ``p``: ``gate`` ({'w': (d, n_experts)}, all routed experts), the held
    experts' ``w1``/``w3`` (held, d, f) and ``w2`` (held, f, d), and
    ``shared`` ({'w1', 'w3', 'w2'}, the shared experts as one SwiGLU).  The
    held experts are ids ``first`` to ``first + held - 1``.  ``scale`` is
    the routed scaling factor.  ``state`` (one layer of
    :class:`Balance`) gives the bias and takes the load and the counters;
    without it the bias is 0.  ``batch`` sequences make up the rows, for
    the sequence-wise balance loss.  Returns ``(y (n, d) in dtype,
    {'balance_loss', 'rows'})``.

    The arena's rows past the routed ones are never computed (:func:`grouped_mm`):
    what they hold reaches only the zero row ``n`` of the combine, which is
    cut off, and their gradients only that row of the gather's."""
    n, d = x.shape
    held = p["w1"].shape[0]
    with region("seqformer.router"):
        scores = torch.sigmoid(x.to(torch.float32) @ p["gate"]["w"])
        bias = state["bias"] if state is not None else torch.zeros_like(scores[0])
        idx, weights = sigmoid_topk(scores, bias, k)
        balance_loss = sequence_balance_loss(scores, idx, batch, k)
        rows = arena_rows(n, k, held)
        tok, w, ends, counts = _held_dispatch(idx, weights * scale, first, held, rows)
        xa = torch.cat([x.to(dtype), x.new_zeros((1, d), dtype=dtype)]).index_select(0, tok)
        if state is not None:
            with torch.no_grad():
                state["load"].scatter_add_(0, idx.reshape(-1),
                                           torch.ones(idx.numel(), device=idx.device))
                state["rows"].add_(counts)
                torch.maximum(state["max_held_share"], counts.sum() * n_experts / (n * k * held),
                              out=state["max_held_share"])
                state["balance_loss"].copy_(balance_loss.detach())
    with region("seqformer.experts"):
        act = F.silu(grouped_mm(xa, p["w1"], ends)) * grouped_mm(xa, p["w3"], ends)
        out = grouped_mm(act * w[:, None].to(dtype), p["w2"], ends)
    with region("seqformer.shared"):
        shared = _swiglu(p["shared"], x, dtype)
    with region("seqformer.combine"):
        routed = torch.zeros((n + 1, d), dtype=torch.float32, device=x.device)
        routed = routed.index_add(0, tok, out.to(torch.float32))[:n]
        y = shared + routed.to(dtype)
    return y, {"balance_loss": balance_loss, "rows": counts}
