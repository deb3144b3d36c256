"""Sequence parallelism: ring attention and Ulysses all-to-all; the port of
``blendjax.parallel.ring_attention``.

Every scheme takes this rank's contiguous sequence shard ``(B, S/n, H, D)``
of q, k and v and the ``'seq'`` process group (where the reference takes
an ``axis_name`` inside ``shard_map``), and returns this rank's shard of
the output.  Ranks are processes: the reference's ``lax.ppermute`` is a
rotation between the group's ranks and its ``lax.all_to_all`` an
all-to-all over the group (:mod:`blendjax_torch.parallel.p2p`, which
stages the ops that gloo does not serve on CUDA tensors through the host).

- :func:`ring_attention`: K/V blocks rotate around the ring while each
  rank accumulates its queries' attention with an online softmax, in plain
  PyTorch (autograd through the rotations).
- :func:`ring_flash_attention`: the same ring with the flash kernels as
  the per-pair attention, a ``torch.autograd.Function`` whose backward
  rotates K/V and their gradient accumulators and runs the dQ and dK/dV
  kernels per visible pair.  Each pair is one call of the port's flash
  wrappers (:mod:`blendjax_torch.ops.flash_attention`): K2-K4 on the card
  (bf16 on the tensor-core route, f32 on the CUDA-core one), their plain
  passes on the CPU; partial outputs and gradients are f32 and combined in
  f32.
- :func:`zigzag_flash_attention`: ring + flash over the load-balanced
  layout for causal attention (shard ``d`` holds chunks ``d`` and
  ``2n-1-d`` of ``2n``).
- :func:`ulysses_attention`: an all-to-all reshards ``[seq-sharded, all
  heads]`` to ``[all seq, head-sharded]``, attends, and reshards back.

:func:`make_ring_attention` builds the ``attn_fn`` that a model calls on
its local shards.  Causal masks use global positions from the rank's index
in the group.  A row that sees no key in a pair gets O = 0 and lse = -1e30
from the flash passes, which weighs 0 in the f32 logsumexp combine.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from blendjax_torch.parallel import p2p

_NEG = -1e30  # finite mask value, as the reference's


def full_attention(q, k, v, causal=False, scale=None, q_offset=0, k_offset=0,
                   window=None):
    """q: (B, Sq, H, D), k/v: (B, Sk, H_kv, D) -> (B, Sq, H, D).

    ``*_offset`` give the global position of element 0 along the sequence
    axis; ``window=W`` (causal only) lets query i see keys in ``(i - W, i]``.
    k/v with fewer heads than q (GQA) are repeated per group.  Scores are
    in q's dtype, and the default scale ``1/sqrt(d)`` is cast to q's dtype
    first (rounded to bf16 for bf16 inputs), as the reference does."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if k.shape[2] != q.shape[2]:
        if q.shape[2] % k.shape[2]:
            raise ValueError(
                f"q heads {q.shape[2]} must be a multiple of kv heads "
                f"{k.shape[2]}"
            )
        rep = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(d))).to(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, _NEG))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _window_ring_deltas(window, s_loc, n):
    """How many earlier shards a sliding window reaches: shard ``me`` needs
    shard ``me-d`` iff ``(d-1)*s_loc + 2 <= window``, so a windowed ring
    rotates only this many times (0 for W = 1)."""
    if window < 2:
        return 0
    return min(n - 1, (window - 2) // s_loc + 1)


def _check_no_gqa(q, k, impl):
    if k.shape[2] != q.shape[2]:
        raise ValueError(
            f"{impl} does not support GQA (kv heads != q heads); "
            "use impl='ulysses' or repeat kv heads before the ring"
        )


def ring_attention(q, k, v, group, causal=False, scale=None, window=None):
    """Exact blockwise attention over a ring of sequence shards, in plain
    PyTorch: q/k/v are this rank's shards ``(B, S/n, H, D)``.

    ``window=W`` (causal only): the ring rotates backward and stops after
    :func:`_window_ring_deltas` rotations, so traffic scales with the
    window, not the sequence."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    _check_no_gqa(q, k, "ring")
    n, me = p2p.group_rank(group)
    b, s_loc, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float()
    qpos = me * s_loc + torch.arange(s_loc, device=q.device)

    def accumulate(o, m, l, kb, vb, blk):
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
        if causal:
            kpos = blk * s_loc + torch.arange(s_loc, device=q.device)
            mask = kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask &= kpos[None, :] > qpos[:, None] - window
            scores = torch.where(mask[None, None], scores, torch.full_like(scores, _NEG))
        m_new = torch.maximum(m, scores.amax(-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p, vb.float())
        return o * corr[..., None] + pv, m_new, l

    o = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_loc), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device)
    # own block first: every query sees itself, so m is finite before any
    # all-masked pair, which then contributes exp(-1e30 - m) = 0
    o, m, l = accumulate(o, m, l, k, v, me)
    kb, vb = k, v
    if window is None:
        # receive from the next rank: after t rotations block (me + t) % n
        for t in range(1, n):
            kb, vb = p2p.Rotate.apply(group, -1, kb, vb)
            o, m, l = accumulate(o, m, l, kb, vb, (me + t) % n)
    else:
        # backward: after t rotations the earlier shard (me - t) % n; on
        # ranks me < t it is a wrapped future shard, all masked
        for t in range(1, _window_ring_deltas(window, s_loc, n) + 1):
            kb, vb = p2p.Rotate.apply(group, 1, kb, vb)
            o, m, l = accumulate(o, m, l, kb, vb, (me - t) % n)
    out = o / l[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _ring_blk(s_loc):
    """Flash tile for a local shard, the shared policy of
    :func:`blendjax_torch.ops.flash_attention.flash_block_size`."""
    from blendjax_torch.ops.flash_attention import flash_block_size

    return flash_block_size(s_loc)


def _lse_combine(o, lse, o_b, lse_b):
    """Merge a normalized partial (o_b, lse_b) into the running (o, lse)
    by logsumexp reweighting, in f32.  ``o`` (B, S, H, D), ``lse`` (B, H,
    S).  Every lse is finite (a dead row's is -1e30), so no -inf meets an
    exp difference."""
    lse_new = torch.logaddexp(lse, lse_b)
    w_old = torch.exp(lse - lse_new).permute(0, 2, 1)[..., None]
    w_new = torch.exp(lse_b - lse_new).permute(0, 2, 1)[..., None]
    return o * w_old + o_b * w_new, lse_new


def _pair_fwd(q, kb, vb, causal, scale, blk, window=None, q_offset=0):
    """One pair through the forward kernel (K2 on the card): the f32
    partial (B, S, H, D) and its lse (B, H, S)."""
    from blendjax_torch.ops.flash_attention import _flash_fwd_impl

    b, s, h, _ = q.shape
    o_b, res = _flash_fwd_impl(q, kb, vb, causal, scale, blk, blk, out_dtype=torch.float32,
                               window=window, q_offset=q_offset)
    return o_b, res[4].reshape(b, h, s)


def _pair_grads(qf, kf, vf, dof, lse_f, delta, causal, scale, blk, window=None, q_offset=0):
    """One pair through the dQ and dK/dV kernels (K3, K4 on the card), f32
    out."""
    from blendjax_torch.ops.flash_attention import _dkv_pass, _dq_pass

    dq = _dq_pass(qf, kf, vf, dof, lse_f, delta, causal, scale, blk, blk,
                  out_dtype=torch.float32, window=window, q_offset=q_offset)
    dk, dv = _dkv_pass(qf, kf, vf, dof, lse_f, delta, causal, scale, blk, blk,
                       out_dtype=torch.float32, window=window, q_offset=q_offset)
    return dq, dk, dv


def _visible(blk_idx, me):
    """A causal pair's mode: None (a later block, all masked: skipped; a
    kernel would renormalize over masked columns), False (an earlier block,
    unmasked) or True (the own block, the causal diagonal)."""
    if blk_idx > me:
        return None
    return blk_idx == me


def _bwd_inputs(q, g, out, lse):
    """The flat q, dO and O, delta = rowsum(dO * O) in f32, and lse as the
    passes read them."""
    from blendjax_torch.ops.flash_attention import _flat

    b, s, h, _ = q.shape
    qf, dof, of = _flat(q), _flat(g.to(q.dtype)), _flat(out)
    delta = (dof.float() * of.float()).sum(-1, keepdim=True)
    return qf, dof, delta, lse.reshape(b * h, s, 1)


def _ring_flash_fwd(q, k, v, group, causal, scale):
    n, me = p2p.group_rank(group)
    b, s_loc, h, d = q.shape
    blk = _ring_blk(s_loc)
    o = torch.zeros((b, s_loc, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, s_loc), _NEG, dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for t in range(n):
        # the next block's transfer goes out before this pair's kernel
        nxt = p2p.rotate_async([kb, vb], group, -1) if t < n - 1 else None
        mode = _visible((me + t) % n, me) if causal else False
        if mode is not None:
            o, lse = _lse_combine(o, lse, *_pair_fwd(q, kb, vb, mode, scale, blk))
        if nxt is not None:
            kb, vb = nxt.wait()
    return o.to(q.dtype), lse


def _ring_flash_fwd_windowed(q, k, v, group, scale, window):
    """Sliding-window ring forward: rotation ``t`` holds shard ``(me - t) %
    n``, an earlier shard at offset ``t * s_loc`` on ranks ``me >= t`` (a
    wrapped future shard, skipped, elsewhere); each pair runs the windowed
    kernel with that ``q_offset``.  Rows beyond a pair's window emit lse =
    -1e30 and weigh 0."""
    n, me = p2p.group_rank(group)
    b, s_loc, h, d = q.shape
    blk = _ring_blk(s_loc)
    dmax = _window_ring_deltas(window, s_loc, n)
    o, lse = _pair_fwd(q, k, v, True, scale, blk, window=window)
    kb, vb = k, v
    for t in range(1, dmax + 1):
        kb, vb = p2p.rotate([kb, vb], group, 1)
        if me >= t:
            o, lse = _lse_combine(o, lse, *_pair_fwd(q, kb, vb, True, scale, blk,
                                                     window=window, q_offset=t * s_loc))
    return o.to(q.dtype), lse


def _ring_flash_bwd(group, causal, scale, q, k, v, out, lse, g):
    from blendjax_torch.ops.flash_attention import _flat, _unflat

    n, me = p2p.group_rank(group)
    b, s_loc, h, d = q.shape
    blk = _ring_blk(s_loc)
    qf, dof, delta, lse_f = _bwd_inputs(q, g, out, lse)
    dq = torch.zeros((b * h, s_loc, d), dtype=torch.float32, device=q.device)
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    kbf, vbf = _flat(k), _flat(v)
    for t in range(n):
        # the held block's dK/dV accumulators travel WITH the block: after
        # n rotations each is home; the K/V blocks skip their last one
        nxt = p2p.rotate_async([kbf, vbf], group, -1) if t < n - 1 else None
        mode = _visible((me + t) % n, me) if causal else False
        if mode is not None:
            dq_c, dk_c, dv_c = _pair_grads(qf, kbf, vbf, dof, lse_f, delta, mode, scale, blk)
            dq, dk, dv = dq + dq_c, dk + dk_c, dv + dv_c
        dk, dv = p2p.rotate([dk, dv], group, -1)
        if nxt is not None:
            kbf, vbf = nxt.wait()
    return (_unflat(dq, b, h).to(q.dtype), _unflat(dk, b, h).to(k.dtype),
            _unflat(dv, b, h).to(v.dtype))


def _ring_flash_bwd_windowed(group, scale, window, q, k, v, out, lse, g):
    """Backward of the windowed ring: the dK/dV accumulators travel with
    their shard for the ``dmax`` rotations, then one rotation by ``-dmax``
    sends each straight home."""
    from blendjax_torch.ops.flash_attention import _flat, _unflat

    n, me = p2p.group_rank(group)
    b, s_loc, h, d = q.shape
    blk = _ring_blk(s_loc)
    dmax = _window_ring_deltas(window, s_loc, n)
    qf, dof, delta, lse_f = _bwd_inputs(q, g, out, lse)
    kbf, vbf = _flat(k), _flat(v)
    dq, dk_t, dv_t = _pair_grads(qf, kbf, vbf, dof, lse_f, delta, True, scale, blk,
                                 window=window)
    for t in range(1, dmax + 1):
        kbf, vbf, dk_t, dv_t = p2p.rotate([kbf, vbf, dk_t, dv_t], group, 1)
        if me >= t:
            dq_c, dk_c, dv_c = _pair_grads(qf, kbf, vbf, dof, lse_f, delta, True, scale,
                                           blk, window=window, q_offset=t * s_loc)
            dq, dk_t, dv_t = dq + dq_c, dk_t + dk_c, dv_t + dv_c
    if dmax > 0:
        dk_t, dv_t = p2p.rotate([dk_t, dv_t], group, -dmax)
    return (_unflat(dq, b, h).to(q.dtype), _unflat(dk_t, b, h).to(k.dtype),
            _unflat(dv_t, b, h).to(v.dtype))


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, window):
        from blendjax_torch.ops.flash_attention import _default_scale

        _check_no_gqa(q, k, "ring_flash")
        scale = _default_scale(scale, q.shape[-1])
        if window is not None:
            if not causal:
                raise ValueError("window requires causal=True")
            out, lse = _ring_flash_fwd_windowed(q, k, v, group, scale, window)
        else:
            out, lse = _ring_flash_fwd(q, k, v, group, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.meta = (group, causal, scale, window)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale, window = ctx.meta
        if window is not None:
            grads = _ring_flash_bwd_windowed(group, scale, window, q, k, v, out, lse, g)
        else:
            grads = _ring_flash_bwd(group, causal, scale, q, k, v, out, lse, g)
        return grads + (None, None, None, None)


def ring_flash_attention(q, k, v, group, causal=False, scale=None, window=None):
    """:func:`ring_attention` with the flash kernels per block pair: no
    (S/n, S/n) score matrix, and a ring-level backward that rotates K/V and
    their gradient accumulators.  Causal: earlier blocks attend unmasked,
    the own block on the causal diagonal, later blocks are skipped.
    ``window=W`` (causal only) rotates backward and stops after
    :func:`_window_ring_deltas` rotations, each pair at its static
    ``q_offset``; W = 1 rotates nothing."""
    return _RingFlash.apply(q, k, v, group, causal, scale, window)


def _zigzag_perm(seq_len, n):
    """Global index permutation laying the sequence out so contiguous
    shard ``d`` holds chunks ``(d, 2n-1-d)`` of ``2n``."""
    c = 2 * n
    if seq_len % c:
        raise ValueError(
            f"zigzag layout needs sequence length {seq_len} divisible "
            f"by 2*n_devices = {c}"
        )
    chunk = seq_len // c
    order = []
    for dd in range(n):
        order += [dd, c - 1 - dd]
    return np.concatenate([np.arange(o * chunk, (o + 1) * chunk) for o in order])


def _zz_fwd(q, k, v, group, scale):
    n, me = p2p.group_rank(group)
    b, s_loc, h, d = q.shape
    half = s_loc // 2
    c = 2 * n
    blk = _ring_blk(half)
    q_halves = (q[:, :half], q[:, half:])
    q_idx = (me, c - 1 - me)  # chunk indices of this rank's query halves
    accs = [(torch.zeros((b, half, h, d), dtype=torch.float32, device=q.device),
             torch.full((b, h, half), _NEG, dtype=torch.float32, device=q.device))
            for _ in range(2)]
    kb, vb = k, v
    for t in range(n):
        nxt = p2p.rotate_async([kb, vb], group, -1) if t < n - 1 else None
        src = (me + t) % n
        k_halves, v_halves = (kb[:, :half], kb[:, half:]), (vb[:, :half], vb[:, half:])
        for a, (qh, qi) in enumerate(zip(q_halves, q_idx)):
            for kh, vh, ki in zip(k_halves, v_halves, (src, c - 1 - src)):
                mode = _visible(ki, qi)
                if mode is not None:
                    accs[a] = _lse_combine(*accs[a], *_pair_fwd(
                        qh.contiguous(), kh.contiguous(), vh.contiguous(), mode, scale, blk))
        if nxt is not None:
            kb, vb = nxt.wait()
    (oa, lse_a), (ob, lse_b) = accs
    return torch.cat([oa, ob], 1).to(q.dtype), torch.cat([lse_a, lse_b], 2)


def _zz_bwd(group, scale, q, k, v, out, lse, g):
    from blendjax_torch.ops.flash_attention import _flat, _unflat

    n, me = p2p.group_rank(group)
    b, s_loc, h, d = q.shape
    half = s_loc // 2
    c = 2 * n
    blk = _ring_blk(half)

    def half_flat(x, i):
        return _flat(x[:, i * half:(i + 1) * half])

    ins = [_bwd_inputs(q[:, i * half:(i + 1) * half], g[:, i * half:(i + 1) * half],
                       out[:, i * half:(i + 1) * half], lse[:, :, i * half:(i + 1) * half]
                       .contiguous()) for i in range(2)]
    q_idx = (me, c - 1 - me)
    zeros = torch.zeros((b * h, half, d), dtype=torch.float32, device=q.device)
    dqs = [zeros.clone(), zeros.clone()]
    dks, dvs = [zeros.clone(), zeros.clone()], [zeros.clone(), zeros.clone()]
    kbf = [half_flat(k, 0), half_flat(k, 1)]
    vbf = [half_flat(v, 0), half_flat(v, 1)]
    for t in range(n):
        nxt = p2p.rotate_async(kbf + vbf, group, -1) if t < n - 1 else None
        src = (me + t) % n
        for a, qi in enumerate(q_idx):
            qf, dof, delta, lse_f = ins[a]
            for kk, ki in enumerate((src, c - 1 - src)):
                mode = _visible(ki, qi)
                if mode is None:
                    continue
                dq_c, dk_c, dv_c = _pair_grads(qf, kbf[kk], vbf[kk], dof, lse_f, delta, mode,
                                               scale, blk)
                dqs[a] = dqs[a] + dq_c
                dks[kk] = dks[kk] + dk_c
                dvs[kk] = dvs[kk] + dv_c
        moved = p2p.rotate(dks + dvs, group, -1)
        dks, dvs = moved[:2], moved[2:]
        if nxt is not None:
            moved = nxt.wait()
            kbf, vbf = moved[:2], moved[2:]

    def join(halves, dtype):
        return _unflat(torch.cat(halves, 1), b, h).to(dtype)

    return join(dqs, q.dtype), join(dks, k.dtype), join(dvs, v.dtype)


class _ZigzagFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        from blendjax_torch.ops.flash_attention import _default_scale

        _check_no_gqa(q, k, "zigzag_flash")
        scale = _default_scale(scale, q.shape[-1])
        out, lse = _zz_fwd(q, k, v, group, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.meta = (group, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, scale = ctx.meta
        return _zz_bwd(group, scale, q, k, v, out, lse, g.contiguous()) + (None, None)


def zigzag_flash_attention(q, k, v, group, scale=None):
    """Load-balanced CAUSAL ring attention with the flash kernels.  The
    local shards must already be in zigzag layout (shard ``d`` holds chunks
    ``d`` and ``2n-1-d``; :func:`make_ring_attention` moves them there and
    back).  Each rotation runs up to 4 pairs (2 query halves x 2 held KV
    halves), each unmasked, on the causal diagonal or skipped by chunk
    index; the backward rotates K/V and the per-half dK/dV accumulators."""
    return _ZigzagFlash.apply(q, k, v, group, scale)


def _all_to_all_dims(x, group, split_dim, concat_dim):
    """``lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)`` over ``group``: ``x`` cut in ``n`` along ``split_dim``,
    part ``j`` to rank ``j``, the parts received concatenated along
    ``concat_dim`` in rank order.  Differentiable."""
    n, _ = p2p.group_rank(group)
    parts = x.chunk(n, dim=split_dim)
    flat = torch.cat([p.reshape(-1) for p in parts])
    got = p2p.AllToAll.apply(flat, [parts[0].numel()] * n, [parts[0].numel()] * n, group)
    return torch.cat([blk.reshape(parts[0].shape) for blk in got.chunk(n)], dim=concat_dim)


def ulysses_attention(q, k, v, group, causal=False, scale=None, inner_attn=None,
                      window=None):
    """All-to-all (DeepSpeed-Ulysses) sequence-parallel attention on local
    shards ``(B, S/n, H, D)``: needs each of q's and k/v's head counts
    divisible by the group's size.  ``inner_attn(q, k, v, causal=...,
    scale=...)`` (``window=`` only when set) replaces the full-sequence
    attention per head group, e.g. the flash kernels."""
    inner = inner_attn or full_attention
    n, _ = p2p.group_rank(group)
    for name, arr in (("q", q), ("k", k), ("v", v)):
        if arr.shape[2] % n:
            raise ValueError(
                f"ulysses needs {name}'s head count ({arr.shape[2]}) "
                f"divisible by the sequence axis size ({n}); under GQA "
                "pick n_kv_heads as a multiple of the axis, or repeat "
                "kv heads upstream"
            )
    kwargs = dict(causal=causal, scale=scale)
    if window is not None:
        kwargs["window"] = window
    qh, kh, vh = (_all_to_all_dims(x, group, 2, 1) for x in (q, k, v))
    out = inner(qh, kh, vh, **kwargs)
    return _all_to_all_dims(out, group, 1, 2)


def _zigzag_exchange(x, group, forward):
    """Move contiguous local shards (shard ``d`` holds chunks ``2d``,
    ``2d+1``) into the zigzag layout (``forward``) or back, over one
    differentiable all-to-all."""
    n, me = p2p.group_rank(group)
    chunks = x.chunk(2, dim=1)

    def zz_owner(c):  # rank and half holding chunk c in the zigzag layout
        return (c, 0) if c < n else (2 * n - 1 - c, 1)

    if forward:
        mine = [(c, zz_owner(c)) for c in (2 * me, 2 * me + 1)]
        theirs = [(c, (c // 2, c % 2)) for c in (me, 2 * n - 1 - me)]
    else:
        mine = [(c, (c // 2, c % 2)) for c in (me, 2 * n - 1 - me)]
        theirs = [(c, zz_owner(c)) for c in (2 * me, 2 * me + 1)]
    mine_by_chunk = dict(zip([c for c, _ in mine], chunks))
    # what goes to each rank, in (rank, half) order; what comes, likewise
    sends = sorted(((dst, half, c) for c, (dst, half) in mine))
    # the chunks this rank receives, keyed by where they came from: a chunk
    # c held in the other layout at (rank, half)
    recvs = sorted(((src, half, c) for c, (src, half) in theirs))
    numel = chunks[0].numel()
    flat = torch.cat([mine_by_chunk[c].reshape(-1) for _, _, c in sends])
    send_splits = [numel * sum(1 for dst, _, _ in sends if dst == r) for r in range(n)]
    recv_splits = [numel * sum(1 for src, _, _ in recvs if src == r) for r in range(n)]
    got = p2p.AllToAll.apply(flat, send_splits, recv_splits, group).chunk(len(recvs))
    by_chunk = {c: blk.reshape(chunks[0].shape) for (_, _, c), blk in zip(recvs, got)}
    order = (me, 2 * n - 1 - me) if forward else (2 * me, 2 * me + 1)
    return torch.cat([by_chunk[c] for c in order], dim=1)


def make_ring_attention(mesh, seq_axis="seq", causal=False, impl="ring", batch_axis=None,
                        head_axis=None, inner_attn=None, window=None):
    """The ``attn_fn(q, k, v) -> out`` of one scheme over ``mesh``'s
    ``seq_axis``, for a model that runs on this rank's shards ``(B_loc,
    S/n, H_loc, D)`` of arrays sharded ``P(batch_axis, seq_axis,
    head_axis, None)``.

    ``impl``: ``'ring'``, ``'ring_flash'``, ``'zigzag_flash'`` (causal
    only, no window; the zigzag permutation is applied around the call and
    undone after it, each one all-to-all over the sequence group) or
    ``'ulysses'`` (``inner_attn`` replaces its per-head-group attention;
    ``head_axis`` is refused, the all-to-all uses the head dimension).
    ``window=W`` (causal only) is sliding-window attention.

    The batch axis needs nothing here: each rank holds its own rows.  With
    ``head_axis`` the q/k/v a rule-sharded projection makes are DTensors
    over the head axis: the closure rings over their local heads and
    returns a DTensor with the same placements, so nothing inside the ring
    sees a DTensor.  Without ``head_axis``, head-sharded DTensor inputs are
    gathered over their mesh first (CPU ranks only: torch 2.11's gloo
    cannot gather a sharded DTensor on the card, ROADMAP Queue 3)."""
    from torch.distributed.tensor import DTensor, Replicate

    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    group = mesh.get_group(seq_axis)
    del batch_axis  # each rank's rows are its own: the scheme needs no batch axis
    if impl == "ring":
        def inner(q, k, v):
            return ring_attention(q, k, v, group, causal=causal, window=window)
    elif impl == "ring_flash":
        def inner(q, k, v):
            return ring_flash_attention(q, k, v, group, causal, None, window)
    elif impl == "zigzag_flash":
        if not causal:
            raise ValueError(
                "zigzag_flash balances the CAUSAL ring's load; a "
                "non-causal ring has no imbalance — use ring_flash"
            )
        if window is not None:
            raise ValueError(
                "zigzag_flash + window is pointless: the windowed ring "
                "is already load-balanced — use impl='ring_flash'"
            )

        def inner(q, k, v):
            n, _ = p2p.group_rank(group)
            _zigzag_perm(q.shape[1] * n, n)  # the layout's divisibility check
            _check_no_gqa(q, k, "zigzag_flash")
            q, k, v = (_zigzag_exchange(x, group, True) for x in (q, k, v))
            return _zigzag_exchange(zigzag_flash_attention(q, k, v, group), group, False)
    elif impl == "ulysses":
        if head_axis is not None:
            raise ValueError("ulysses uses the head dim for its all-to-all; "
                             "head_axis sharding is ring-only")

        def inner(q, k, v):
            return ulysses_attention(q, k, v, group, causal=causal, inner_attn=inner_attn,
                                     window=window)
    else:
        raise ValueError(f"unknown impl {impl!r} (want 'ring', "
                         "'ring_flash', 'zigzag_flash' or 'ulysses')")

    def attn(q, k, v):
        if not isinstance(q, DTensor):
            return inner(q, k, v)
        like = q
        if head_axis is None:
            if q.device.type == "cuda":
                raise RuntimeError(
                    "a head-sharded DTensor reached a scheme without head_axis on the "
                    "card: gathering it over gloo crashes torch 2.11 (ROADMAP Queue 3); "
                    "pass head_axis or replicate the projections")
            q, k, v = (x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
                       for x in (q, k, v))
        out = inner(*(x.to_local() for x in (q, k, v)))
        return DTensor.from_local(out, like.device_mesh,
                                  like.placements if head_axis else q.placements,
                                  run_check=False)

    return attn
