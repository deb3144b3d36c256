"""SeqFormer — the causal temporal transformer world model over streamed
episodes: it reads an episode's observation sequence and predicts the next
observation at every step.  The port of ``blendjax.models.seqformer``'s
training path.

Parameters are a flat ``{path: tensor}`` dict whose paths follow the
reference's pytree (``blocks.0.wq.w``), so
:func:`blendjax_torch.models.convert.params_from_jax` carries a JAX
checkpoint across unchanged.  The attention projections are head-major,
``wq/wk/wv`` (d, H, Dh) and ``wo`` (H, Dh, d).  Compute runs in
``compute_dtype`` (bf16 by default) over f32 parameters, with layer norms
and the head in f32.

Attention is pluggable: ``apply(..., attn_fn=...)`` takes any
``(q, k, v) -> out`` on (B, T, H, Dh) tensors; the default is
:func:`blendjax_torch.parallel.ring_attention.full_attention`, and
:func:`blendjax_torch.ops.flash_attention.make_flash_attention` gives the
flash kernels.

Not ported yet: the mixture-of-experts MLP (ROADMAP Queue 1, item 7,
with ``models/moe.py``) and the KV-cache decode path ``init_cache`` /
``decode_step`` / ``rollout`` (ROADMAP Queue 1, item 5).
"""

from __future__ import annotations

import math

import torch

from blendjax_torch.models.layers import (
    apply_rope,
    dense_apply,
    dense_init,
    gelu,
    rope_table,
)
from blendjax_torch.parallel.ring_attention import full_attention
from blendjax_torch.utils.device import resolve_device

_MOE_MISSING = (
    "mixture-of-experts SeqFormer params (a 'moe' block) are not ported "
    "yet: models/moe.py waits in ROADMAP Queue 1, item 7 (parallel layer)"
)


def _nest(params):
    """Flat ``{path: tensor}`` -> nested dicts (block indices stay string
    keys); the tensors are the same objects."""
    tree: dict = {}
    for path, t in params.items():
        *parents, leaf = path.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def _blocks(tree):
    blocks = tree.get("blocks", {})
    out = [blocks[str(i)] for i in range(len(blocks))]
    if any("moe" in blk for blk in out):
        raise ValueError(_MOE_MISSING)
    return out


def _proj(p, x, eq, dtype):
    """Head-major attention projection in ``dtype``, bias included."""
    return torch.einsum(eq, x, p["w"].to(dtype)) + p["b"].to(dtype)


def _ln_init(d, device):
    return {"scale": torch.ones((d,), device=device), "bias": torch.zeros((d,), device=device)}


def _ln_apply(p, x):
    """LayerNorm in f32 with eps 1e-6 and the population variance, cast
    back to ``x``'s dtype."""
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + 1e-6)
    return (out * p["scale"] + p["bias"]).to(x.dtype)


def init(generator, obs_dim=8, d_model=64, n_heads=4, n_layers=2, d_ff=None,
         n_experts=0, max_len=1024, n_kv_heads=None, pos_encoding="learned",
         device="cuda"):
    """SeqFormer params as a flat dict of f32 tensors on ``device``, drawn
    from ``generator`` (which must live on ``device``).

    ``n_kv_heads < n_heads`` is grouped-query attention.
    ``pos_encoding='rope'`` replaces the learned position table with
    rotary embeddings on q/k (the params then have no ``pos``)."""
    if n_experts:
        raise ValueError(_MOE_MISSING)
    device = resolve_device(device)
    d_ff = d_ff or 4 * d_model
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} not divisible by n_heads {n_heads}")
    n_kv_heads = n_kv_heads or n_heads
    if n_heads % n_kv_heads:
        raise ValueError(f"n_heads {n_heads} not divisible by n_kv_heads {n_kv_heads}")
    dh = d_model // n_heads
    if pos_encoding == "rope" and dh % 2:
        raise ValueError(f"rope needs an even head dim, got {dh}")
    if pos_encoding not in ("learned", "rope"):
        raise ValueError(f"unknown pos_encoding {pos_encoding!r}")

    def normal(*shape, std):
        return torch.randn(shape, generator=generator, device=device) * std

    def dense(d_in, d_out):
        return dense_init(d_in, d_out, generator=generator, device=device)

    params = {}

    def put(prefix, tree):
        for name, t in tree.items():
            params[f"{prefix}.{name}"] = t

    put("embed", dense(obs_dim, d_model))
    if pos_encoding == "learned":
        params["pos"] = normal(max_len, d_model, std=0.02)
    scale = math.sqrt(1.0 / d_model)
    for i in range(n_layers):
        blk = f"blocks.{i}"
        put(f"{blk}.ln1", _ln_init(d_model, device))
        for name, heads in (("wq", n_heads), ("wk", n_kv_heads), ("wv", n_kv_heads)):
            put(f"{blk}.{name}", {"w": normal(d_model, heads, dh, std=scale),
                                  "b": torch.zeros((heads, dh), device=device)})
        put(f"{blk}.wo", {"w": normal(n_heads, dh, d_model, std=scale),
                          "b": torch.zeros((d_model,), device=device)})
        put(f"{blk}.ln2", _ln_init(d_model, device))
        put(f"{blk}.mlp.fc", dense(d_model, d_ff))
        put(f"{blk}.mlp.proj", dense(d_ff, d_model))
    put("ln_f", _ln_init(d_model, device))
    put("head", dense(d_model, obs_dim))
    return params


def _forward(params, obs, attn_fn, compute_dtype):
    if attn_fn is None:
        def attn_fn(q, k, v):
            return full_attention(q, k, v, causal=True)

    tree = _nest(params)
    blocks = _blocks(tree)
    t = obs.shape[1]
    use_rope = "pos" not in tree
    x = dense_apply(tree["embed"], obs.to(compute_dtype), compute_dtype)
    if use_rope:
        dh = blocks[0]["wq"]["w"].shape[-1]
        cos, sin = rope_table(torch.arange(t, device=obs.device), dh)
    else:
        x = x + tree["pos"][:t].to(compute_dtype)[None]
    for blk in blocks:
        h = _ln_apply(blk["ln1"], x)
        q, k, v = (_proj(blk[n], h, "btd,dhk->bthk", compute_dtype)
                   for n in ("wq", "wk", "wv"))
        if use_rope:
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        a = attn_fn(q, k, v)
        x = x + _proj(blk["wo"], a, "bthk,hkd->btd", compute_dtype)
        h = _ln_apply(blk["ln2"], x)
        h = gelu(dense_apply(blk["mlp"]["fc"], h, compute_dtype))
        x = x + dense_apply(blk["mlp"]["proj"], h, compute_dtype)
    x = _ln_apply(tree["ln_f"], x)
    return dense_apply(tree["head"], x, torch.float32)


def apply(params, obs, attn_fn=None, compute_dtype=torch.bfloat16):
    """Forward pass: (B, T, obs_dim) -> (B, T, obs_dim) f32 next-obs
    prediction.  ``attn_fn(q, k, v) -> out`` on (B, T, H, Dh) tensors;
    defaults to causal :func:`full_attention`."""
    return _forward(params, obs, attn_fn, compute_dtype)


def loss_fn(params, batch, attn_fn=None, compute_dtype=torch.bfloat16):
    """MSE next-observation loss over ``batch = {'obs': (B,T,D), 'target':
    (B,T,D)}``; the target is compared in f32."""
    pred = _forward(params, batch["obs"], attn_fn, compute_dtype)
    err = pred - batch["target"].to(torch.float32)
    return torch.mean(err * err)


def make_episode_batch(obs_seq):
    """Episode array (B, T+1, D) -> {'obs', 'target'} views."""
    return {"obs": obs_seq[:, :-1], "target": obs_seq[:, 1:]}


def episode_loss_fn(params, batch, **kwargs):
    """:func:`loss_fn` over a wire-efficient batch ``{'episode': (B, T+1,
    D)}``, sliced into obs/target on the device.  An episode that rode the
    wire as float16 gives f32 targets made from f16 values, as the
    reference measures."""
    return loss_fn(params, make_episode_batch(batch["episode"]), **kwargs)


def train_flops(batch_size, seq_len, obs_dim, d_model, n_heads, n_layers, d_ff=None):
    """Closed-form FLOPs of one training step of the dense model (matmul
    terms only, training = 3x forward).  Attention is counted over the
    full T^2, not the causal half the flash kernels compute."""
    B, T, d = batch_size, seq_len, d_model
    d_ff = d_ff or 4 * d
    tok = B * T
    fwd = 2.0 * tok * obs_dim * d  # embed
    per_layer = 8.0 * d * d + 4.0 * T * d  # qkvo + scores/apply per token
    fwd += tok * n_layers * (per_layer + 4.0 * d * d_ff)
    fwd += 2.0 * tok * d * obs_dim  # head
    return 3.0 * fwd
