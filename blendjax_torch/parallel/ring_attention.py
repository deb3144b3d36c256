"""Plain softmax attention, the single-device reference of
``blendjax.parallel.ring_attention``: the SeqFormer's default ``attn_fn``
and the f32 baseline the flash kernels are held against.

The ring, zigzag and Ulysses schemes of the reference module are not
ported yet (ROADMAP Queue 1, item 7).
"""

from __future__ import annotations

import torch

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
