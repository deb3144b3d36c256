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
and the head in f32; on the card each layer norm is one kernel forward and
one backward (:mod:`blendjax_torch.ops.layer_norm`).

Attention is pluggable: ``apply(..., attn_fn=...)`` takes any
``(q, k, v) -> out`` on (B, T, H, Dh) tensors; the default is
:func:`blendjax_torch.parallel.ring_attention.full_attention`, and
:func:`blendjax_torch.ops.flash_attention.make_flash_attention` gives the
flash kernels.

The forward opens the regions of :mod:`blendjax_torch.obs.regions`
(``seqformer.io``, ``seqformer.attention``, ``seqformer.mlp``, and
``seqformer.norm`` inside them) while a profiler records, so that a
profile can say which of them launched each kernel; otherwise each costs
one check.  :func:`decode_step` opens none.

The inference path: :func:`init_cache` (a batch-uniform position, or one
per row for serving), :func:`decode_step` (one position through a ring
KV cache) and :func:`rollout` (one teacher-forced prefill, then the
model's own predictions fed back step by step, a Python loop where the
reference runs ``lax.scan``).  Every projection dispatches on its weight
dict, so the int8 params of
:func:`blendjax_torch.ops.quant.quantize_seqformer` serve through the same
code.

The optional mixture-of-experts MLP (``init(n_experts=...)``: a block's
``moe`` in place of its ``mlp``, expert weights stacked on a leading axis)
has two apply-time modes over the same parameters: ``moe_impl='dense'``
(every expert on every token, gate-weighted) and ``moe_impl='topk'``
(routed, capacity-bounded: :mod:`blendjax_torch.models.moe`).

The DeepSeek-V3 block (``init(mla=...)``; the params then hold
``blocks.i.wkv_a``): multi-head latent attention without query
compression (DeepSeek-V2, arXiv 2405.04434, section 2.1: q (H, Dnope +
Drope), a shared compressed kv latent under its own RMSNorm and one
rotary key for all heads, expanded to per-head keys and values, attention
over q/k of Dnope + Drope and v of Dv through the flash kernels), RMSNorm
(K5's RMS mode on the card), a dense SwiGLU MLP in the first
``n_dense`` blocks and the DeepSeekMoE layer
(:func:`blendjax_torch.models.moe.deepseek_moe_apply`) in the rest, and an
RMSNorm ``ln_f``; no biases inside the blocks.  Its settings at apply time
are one ``arch`` dict (:func:`_forward_mla`).  The decode path
(:func:`decode_step`, :func:`rollout`) does not take it.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from blendjax_torch.models import moe
from blendjax_torch.models.layers import (
    apply_rope,
    apply_rope_rows,
    dense_apply,
    dense_init,
    gelu,
    rope_table,
)
from blendjax_torch.obs.regions import region
from blendjax_torch.ops import layer_norm
from blendjax_torch.ops.quant import maybe_quantized_einsum
from blendjax_torch.parallel.ring_attention import full_attention
from blendjax_torch.utils.device import resolve_device

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
    return [blocks[str(i)] for i in range(len(blocks))]


def _dense_mq(p, x, dtype):
    """``dense_apply`` of a float ``{'w', 'b'}`` or an int8 ``{'w_q',
    'w_scale', 'b'}`` weight dict."""
    if "w_q" not in p:
        return dense_apply(p, x, dtype)
    out = maybe_quantized_einsum("...d,df->...f", x, p, dtype)
    return (out + p["b"]).to(dtype)


def _proj_mq(p, x, eq, dtype):
    """Head-major attention projection with the same float/int8 dispatch,
    bias included."""
    out = maybe_quantized_einsum(eq, x, p, dtype)
    b = p["b"].to(dtype if "w_q" not in p else torch.float32)
    return (out + b).to(dtype)


def _wq_head_dim(blocks):
    wq = blocks[0]["wq"]
    return (wq["w"] if "w" in wq else wq["w_q"]).shape[-1]


def _ln_init(d, device):
    return {"scale": torch.ones((d,), device=device), "bias": torch.zeros((d,), device=device)}


def _ln_apply(p, x):
    """LayerNorm in f32 with eps 1e-6 and the population variance, cast
    back to ``x``'s dtype: the kernels of :mod:`blendjax_torch.ops.layer_norm`
    on a plain CUDA tensor, the composition of tensor ops on a CPU tensor
    and on a DTensor (no kernel wrapper takes one)."""
    scale, bias = p["scale"], p["bias"]
    if x.is_cuda and not any(isinstance(t, DTensor) for t in (x, scale, bias)):
        return layer_norm.LayerNorm.apply(x, scale, bias)
    return layer_norm.layer_norm_fwd_plain(x, scale, bias)[0]


def _norm(p, x):
    """:func:`_ln_apply` in the ``seqformer.norm`` region."""
    with region("seqformer.norm"):
        return _ln_apply(p, x)


def _rms(p, x, eps):
    """RMSNorm in f32 cast back to ``x``'s dtype, in the ``seqformer.norm``
    region: K5's RMS mode on a plain CUDA tensor, the plain composition
    on a CPU tensor and on a DTensor."""
    with region("seqformer.norm"):
        scale = p["scale"]
        if x.is_cuda and not any(isinstance(t, DTensor) for t in (x, scale)):
            return layer_norm.RMSNorm.apply(x, scale, eps)
        return layer_norm.rms_norm_fwd_plain(x, scale, eps)[0]


def _moe_init(n_experts, d, d_ff, generator, device):
    """An expert-stacked MLP: the gate (d, e), ``w1`` (e, d, d_ff), ``w2``
    (e, d_ff, d), He-normal, zero biases."""
    return {
        "gate": dense_init(d, n_experts, generator=generator, device=device),
        "w1": torch.randn((n_experts, d, d_ff), generator=generator, device=device)
        * math.sqrt(2.0 / d),
        "b1": torch.zeros((n_experts, d_ff), device=device),
        "w2": torch.randn((n_experts, d_ff, d), generator=generator, device=device)
        * math.sqrt(2.0 / d_ff),
        "b2": torch.zeros((n_experts, d), device=device),
    }


def _moe_apply(p, x, dtype):
    """The dense mixture: every expert on every token, weighted by the f32
    gate's softmax."""
    gates = torch.softmax(dense_apply(p["gate"], x, dtype=torch.float32), dim=-1)
    h = torch.einsum("btd,edf->betf", x.to(dtype), p["w1"].to(dtype))
    # contiguous: with the experts sharded over a model axis, torch's DTensor
    # einsum views a strided local shard here and raises
    h = gelu(h + p["b1"][None, :, None, :].to(dtype)).contiguous()
    y = torch.einsum("betf,efd->betd", h, p["w2"].to(dtype))
    y = y + p["b2"][None, :, None, :].to(dtype)
    return torch.einsum("bte,betd->btd", gates.to(dtype), y)


def _mlp(blk, h, dtype, moe_impl, moe_k, moe_capacity_factor, moe_dispatch, auxs,
         token_mean=None):
    """A block's MLP on the normed (B, T, d) ``h``: the dense MLP, or its
    MoE (a routed layer's aux record appended to ``auxs``)."""
    if "moe" not in blk:
        return _dense_mq(blk["mlp"]["proj"], gelu(_dense_mq(blk["mlp"]["fc"], h, dtype)), dtype)
    if moe_impl == "topk":
        y, aux = moe.moe_apply_topk(blk["moe"], h, dtype, k=moe_k,
                                    capacity_factor=moe_capacity_factor,
                                    dispatch=moe_dispatch, token_mean=token_mean)
        auxs.append(aux)
        return y
    if moe_impl == "dense":
        return _moe_apply(blk["moe"], h, dtype)
    raise ValueError(f"unknown moe_impl {moe_impl!r}")


def _drop_free(params, moe_k, moe_capacity_factor):
    """The capacity factor that gives every routed assignment a slot
    (``max(cf, e / min(k, e))``): decode-time routing must not depend on
    how many tokens share the call, so the incremental decode and the
    teacher-forced prefill agree."""
    for path, t in params.items():
        if path.endswith(".moe.w1"):
            e = t.shape[0]
            return max(moe_capacity_factor, e / min(moe_k, e))
    return moe_capacity_factor


def init(generator, obs_dim=8, d_model=64, n_heads=4, n_layers=2, d_ff=None,
         n_experts=0, max_len=1024, n_kv_heads=None, pos_encoding="learned",
         device="cuda", mla=None):
    """SeqFormer params as a flat dict of f32 tensors on ``device``, drawn
    from ``generator`` (which must live on ``device``).

    ``n_kv_heads < n_heads`` is grouped-query attention.
    ``pos_encoding='rope'`` replaces the learned position table with
    rotary embeddings on q/k (the params then have no ``pos``).
    ``n_experts > 0`` gives each block an ``moe`` (gate, w1, b1, w2, b2) in
    place of its ``mlp``.  ``mla`` (a dict of :func:`init_mla`'s sizes)
    gives the DeepSeek-V3 blocks instead; ``d_ff``, ``n_experts``,
    ``max_len``, ``n_kv_heads`` and ``pos_encoding`` then do not apply."""
    if mla is not None:
        return init_mla(generator, obs_dim, d_model, n_heads, n_layers, device=device, **mla)
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
        if n_experts > 0:
            m = _moe_init(n_experts, d_model, d_ff, generator, device)
            put(f"{blk}.moe.gate", m.pop("gate"))
            put(f"{blk}.moe", m)
        else:
            put(f"{blk}.mlp.fc", dense(d_model, d_ff))
            put(f"{blk}.mlp.proj", dense(d_ff, d_model))
    put("ln_f", _ln_init(d_model, device))
    put("head", dense(d_model, obs_dim))
    return params


def init_mla(generator, obs_dim, d_model, n_heads, n_layers, *, kv_lora_rank,
             qk_nope_head_dim, qk_rope_head_dim, v_head_dim, n_dense, dense_ff, moe_ff,
             n_routed, n_shared, device="cuda"):
    """The DeepSeek-V3 blocks' params (module docstring) as a flat dict of
    f32 tensors: ``n_dense`` blocks with a dense SwiGLU of ``dense_ff``,
    then DeepSeekMoE blocks whose router scores ``n_routed`` experts and
    which hold ``moe.w1``/``w3``/``w2`` of the held experts (as many as
    the router's outputs unless the caller cuts the arrays to its share)
    and the ``n_shared`` shared experts as one SwiGLU of ``n_shared *
    moe_ff``.  Matrices are normal(1/sqrt(fan in)), the embedding and the
    head He-normal with zero biases, norm scales 1."""
    device = resolve_device(device)
    h, dq = n_heads, qk_nope_head_dim + qk_rope_head_dim

    def normal(*shape, fan_in):
        return torch.randn(shape, generator=generator, device=device) / math.sqrt(fan_in)

    def ones(n):
        return torch.ones((n,), device=device)

    def swiglu(prefix, d_in, f, *lead):
        return {f"{prefix}.w1": normal(*lead, d_in, f, fan_in=d_in),
                f"{prefix}.w3": normal(*lead, d_in, f, fan_in=d_in),
                f"{prefix}.w2": normal(*lead, f, d_in, fan_in=f)}

    params = {f"embed.{k}": v for k, v in dense_init(obs_dim, d_model, generator=generator,
                                                     device=device).items()}
    for i in range(n_layers):
        blk = f"blocks.{i}"
        params.update({
            f"{blk}.attn_norm.scale": ones(d_model),
            f"{blk}.wq.w": normal(d_model, h, dq, fan_in=d_model),
            f"{blk}.wkv_a.w": normal(d_model, kv_lora_rank + qk_rope_head_dim, fan_in=d_model),
            f"{blk}.kv_norm.scale": ones(kv_lora_rank),
            f"{blk}.wkv_b.w": normal(kv_lora_rank, h, qk_nope_head_dim + v_head_dim,
                                     fan_in=kv_lora_rank),
            f"{blk}.wo.w": normal(h, v_head_dim, d_model, fan_in=h * v_head_dim),
            f"{blk}.mlp_norm.scale": ones(d_model),
        })
        if i < n_dense:
            params.update(swiglu(f"{blk}.mlp", d_model, dense_ff))
        else:
            params[f"{blk}.moe.gate.w"] = normal(d_model, n_routed, fan_in=d_model)
            params.update(swiglu(f"{blk}.moe", d_model, moe_ff, n_routed))
            params.update(swiglu(f"{blk}.moe.shared", d_model, n_shared * moe_ff))
    params["ln_f.scale"] = ones(d_model)
    params.update({f"head.{k}": v for k, v in dense_init(d_model, obs_dim, generator=generator,
                                                         device=device).items()})
    return params


def _is_mla(tree):
    """Whether nested params hold the DeepSeek-V3 blocks (latent attention)."""
    return "wkv_a" in tree.get("blocks", {}).get("0", {})


def _refuse_mla(tree, what):
    if _is_mla(tree):
        raise ValueError(f"{what} does not take latent attention (MLA) params: the decode "
                         "path of the DeepSeek-V3 blocks is not ported; train and evaluate "
                         "them through loss_fn / episode_loss_fn with arch=")


def _mla(blk, x, attn_fn, cos, sin, compute_dtype, arch):
    """Multi-head latent attention of one block on the residual (B, T, d)
    ``x``, its RMSNorm included: (B, T, d)."""
    eps = arch["norm_eps"]
    h = _rms(blk["attn_norm"], x, eps)
    wkv_b = blk["wkv_b"]["w"]
    nope = wkv_b.shape[-1] - blk["wo"]["w"].shape[1]
    q = torch.einsum("btd,dhk->bthk", h, blk["wq"]["w"].to(compute_dtype))
    kv_a = h @ blk["wkv_a"]["w"].to(compute_dtype)
    rank = wkv_b.shape[0]
    c = _rms(blk["kv_norm"], kv_a[..., :rank], arch["kv_norm_eps"])
    kv = torch.einsum("btc,chk->bthk", c, wkv_b.to(compute_dtype))
    k_rope = apply_rope(kv_a[..., None, rank:], cos, sin)
    q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], cos, sin)], dim=-1)
    k = torch.cat([kv[..., :nope], k_rope.expand(*kv.shape[:3], k_rope.shape[-1])], dim=-1)
    a = attn_fn(q, k, kv[..., nope:])
    return torch.einsum("bthk,hkd->btd", a, blk["wo"]["w"].to(compute_dtype))


def _forward_mla(tree, obs, attn_fn, compute_dtype, arch):
    """The DeepSeek-V3 blocks' forward (module docstring): returns
    (prediction, the DeepSeekMoE layers' aux records).  ``arch``:
    ``norm_eps`` (the block norms and ``ln_f``), ``kv_norm_eps`` (the
    latent's), ``rope_theta``, ``moe_k`` (experts a token),
    ``moe_scale`` (the routed scaling factor), ``moe_experts`` (the
    router's outputs), ``moe_first`` (the first held expert's id) and
    ``balance`` (a :class:`blendjax_torch.models.moe.Balance` or None)."""
    blocks = _blocks(tree)
    b, t = obs.shape[:2]
    balance = arch.get("balance")
    auxs = []
    with region("seqformer.io"):
        x = _dense_mq(tree["embed"], obs.to(compute_dtype), compute_dtype)
        # the rotary part: wkv_a's outputs past the latent
        rope_dim = blocks[0]["wkv_a"]["w"].shape[-1] - blocks[0]["kv_norm"]["scale"].shape[0]
        cos, sin = rope_table(torch.arange(t, device=obs.device), rope_dim,
                              base=float(arch["rope_theta"]))
    for i, blk in enumerate(blocks):
        with region("seqformer.attention"):
            x = x + _mla(blk, x, attn_fn, cos, sin, compute_dtype, arch)
        with region("seqformer.mlp"):
            h = _rms(blk["mlp_norm"], x, arch["norm_eps"])
            if "moe" not in blk:
                x = x + moe._swiglu(blk["mlp"], h, compute_dtype)
                continue
            state = balance.layers[f"blocks.{i}"] if balance is not None else None
            y, aux = moe.deepseek_moe_apply(
                blk["moe"], h.reshape(b * t, -1), compute_dtype, arch["moe_k"],
                arch["moe_scale"], arch["moe_first"], arch["moe_experts"], state=state,
                batch=b)
            auxs.append(aux)
            x = x + y.reshape(b, t, -1)
    x = _rms(tree["ln_f"], x, arch["norm_eps"])
    with region("seqformer.io"):
        return _dense_mq(tree["head"], x, torch.float32), auxs


def _forward(params, obs, attn_fn, compute_dtype, moe_impl="dense", moe_k=2,
             moe_capacity_factor=1.25, moe_dispatch="sort", kv_sink=None, pos_offset=0,
             token_mean=None, arch=None):
    """The shared forward: returns (prediction, the routed MoE layers' aux
    records).  ``kv_sink`` (a list) collects each layer's (k, v), rotated:
    :func:`rollout`'s prefill fills its caches from one teacher-forced
    pass.  ``pos_offset`` is the global position of ``obs``'s first step
    (a sequence shard's); ``token_mean`` makes the routed layers' batch
    statistics global (:func:`blendjax_torch.models.moe.moe_apply_topk`)."""
    if attn_fn is None:
        def attn_fn(q, k, v):
            return full_attention(q, k, v, causal=True)

    tree = _nest(params)
    if _is_mla(tree):
        if arch is None:
            raise ValueError("params with latent attention (blocks.0.wkv_a) need arch=, the "
                             "DeepSeek-V3 block's settings")
        return _forward_mla(tree, obs, attn_fn, compute_dtype, arch)
    blocks = _blocks(tree)
    t = obs.shape[1]
    auxs = []
    use_rope = "pos" not in tree
    with region("seqformer.io"):
        x = _dense_mq(tree["embed"], obs.to(compute_dtype), compute_dtype)
        if use_rope:
            cos, sin = rope_table(torch.arange(pos_offset, pos_offset + t, device=obs.device),
                                  _wq_head_dim(blocks))
        else:
            x = x + tree["pos"][pos_offset:pos_offset + t].to(compute_dtype)[None]
    for blk in blocks:
        with region("seqformer.attention"):
            h = _norm(blk["ln1"], x)
            q, k, v = (_proj_mq(blk[n], h, "btd,dhk->bthk", compute_dtype)
                       for n in ("wq", "wk", "wv"))
            if use_rope:
                q = apply_rope(q, cos, sin)
                k = apply_rope(k, cos, sin)
            if kv_sink is not None:
                kv_sink.append((k, v))
            a = attn_fn(q, k, v)
            x = x + _proj_mq(blk["wo"], a, "bthk,hkd->btd", compute_dtype)
        with region("seqformer.mlp"):
            x = x + _mlp(blk, _norm(blk["ln2"], x), compute_dtype, moe_impl, moe_k,
                         moe_capacity_factor, moe_dispatch, auxs, token_mean)
    x = _norm(tree["ln_f"], x)
    with region("seqformer.io"):
        return _dense_mq(tree["head"], x, torch.float32), auxs


def apply(params, obs, attn_fn=None, compute_dtype=torch.bfloat16, moe_impl="dense",
          moe_k=2, moe_capacity_factor=1.25, moe_dispatch="sort", arch=None):
    """Forward pass: (B, T, obs_dim) -> (B, T, obs_dim) f32 next-obs
    prediction.  ``attn_fn(q, k, v) -> out`` on (B, T, H, Dh) tensors;
    defaults to causal :func:`full_attention`.  ``moe_impl``: 'dense'
    evaluates every expert, 'topk' routes each token to ``moe_k`` experts
    under a capacity bound (:mod:`blendjax_torch.models.moe`).  ``arch``:
    the DeepSeek-V3 blocks' settings (:func:`_forward_mla`)."""
    return _forward(params, obs, attn_fn, compute_dtype, moe_impl, moe_k,
                    moe_capacity_factor, moe_dispatch, arch=arch)[0]


def loss_fn(params, batch, attn_fn=None, compute_dtype=torch.bfloat16, moe_impl="dense",
            moe_k=2, moe_capacity_factor=1.25, moe_aux_weight=0.0, moe_dispatch="sort",
            pos_offset=0, token_mean=None, arch=None):
    """MSE next-observation loss over ``batch = {'obs': (B,T,D), 'target':
    (B,T,D)}``; the target is compared in f32.  With ``moe_impl='topk'``
    and ``moe_aux_weight`` the mean over layers of the load-balance loss is
    added, weighted.  ``pos_offset`` and ``token_mean`` serve a sequence
    shard's loss (:func:`_forward`; the sequence-sharded step,
    :func:`blendjax_torch.parallel.sharding.make_seqformer_train_step`).
    ``arch`` takes the DeepSeek-V3 blocks (:func:`_forward_mla`); their
    DeepSeekMoE layers' sequence-wise balance losses are added, summed over
    the layers and weighted by ``arch['balance_alpha']``."""
    pred, auxs = _forward(params, batch["obs"], attn_fn, compute_dtype, moe_impl, moe_k,
                          moe_capacity_factor, moe_dispatch, pos_offset=pos_offset,
                          token_mean=token_mean, arch=arch)
    with region("seqformer.io"):
        err = pred - batch["target"].to(torch.float32)
        loss = torch.mean(err * err)
        if arch is not None and auxs:
            loss = loss + arch["balance_alpha"] * sum(a["balance_loss"] for a in auxs)
        elif auxs and moe_aux_weight:
            loss = loss + moe_aux_weight * sum(a["aux_loss"] for a in auxs) / len(auxs)
    return loss


def moe_stats(params, batch, attn_fn=None, compute_dtype=torch.bfloat16, moe_k=2,
              moe_capacity_factor=1.25, moe_dispatch="sort"):
    """Measured routing of the topk path: ``{'dispatch_fraction',
    'aux_loss'}``, each the mean over layers (0-d tensors) of the share of
    assignments that won a capacity slot and of the load-balance loss."""
    _, auxs = _forward(params, batch["obs"], attn_fn, compute_dtype, "topk", moe_k,
                       moe_capacity_factor, moe_dispatch)
    if not auxs:
        raise ValueError("moe_stats needs params built with n_experts > 0: these params "
                         "hold no MoE block, so there is no routing to measure")
    n = len(auxs)
    return {"dispatch_fraction": sum(a["dispatch_fraction"] for a in auxs) / n,
            "aux_loss": sum(a["aux_loss"] for a in auxs) / n}


def make_episode_batch(obs_seq):
    """Episode array (B, T+1, D) -> {'obs', 'target'} views."""
    return {"obs": obs_seq[:, :-1], "target": obs_seq[:, 1:]}


def episode_loss_fn(params, batch, **kwargs):
    """:func:`loss_fn` over a wire-efficient batch ``{'episode': (B, T+1,
    D)}``, sliced into obs/target on the device.  An episode that rode the
    wire as float16 gives f32 targets made from f16 values, as the
    reference measures."""
    with region("seqformer.io"):
        batch = make_episode_batch(batch["episode"])
    return loss_fn(params, batch, **kwargs)


def train_flops(batch_size, seq_len, obs_dim, d_model, n_heads, n_layers, d_ff=None,
                n_experts=0, moe_impl="dense", moe_k=2, moe_capacity_factor=1.25):
    """Closed-form FLOPs of one training step (matmul terms only, training
    = 3x forward).  Attention is counted over the full T^2, not the causal
    half the flash kernels compute.  MoE: 'dense' runs every expert (plus
    the gate); 'topk' fills ``e * capacity`` arena rows, so its expert
    compute is that many rows through one MLP whatever the routing."""
    B, T, d = batch_size, seq_len, d_model
    d_ff = d_ff or 4 * d
    tok = B * T
    fwd = 2.0 * tok * obs_dim * d  # embed
    per_layer = 8.0 * d * d + 4.0 * T * d  # qkvo + scores/apply per token
    if n_experts > 0:
        mlp = 2.0 * d * n_experts  # the gate
        if moe_impl == "topk":
            rows = n_experts * moe.expert_capacity(tok, n_experts, moe_k, moe_capacity_factor)
            mlp += 4.0 * d * d_ff * (rows / tok)
        else:
            mlp += n_experts * 4.0 * d * d_ff
    else:
        mlp = 4.0 * d * d_ff
    fwd += tok * n_layers * (per_layer + mlp)
    fwd += 2.0 * tok * d * obs_dim  # head
    return 3.0 * fwd


# -- autoregressive decode (KV cache) -------------------------------------------


def init_cache(params, batch_size, dtype=torch.bfloat16, length=None, per_row=False):
    """Per-layer KV caches on the params' device: ``{'k': [(B, L, Hkv,
    Dh)], 'v': [...], 'pos': 0}``.  ``length`` defaults to the learned
    position table's; rope models have none, so it is required there.

    ``per_row=True`` makes ``pos`` a (B,) int64 tensor: each row then
    decodes at its own position (the serving path), and resetting one row
    is setting its position to 0 (its stale k/v sit at negative slot
    positions, which :func:`_attn_one` masks).  The batch-uniform position
    is a Python int."""
    tree = _nest(params)
    _refuse_mla(tree, "init_cache")
    if length is None:
        if "pos" not in tree:
            raise ValueError("rope models have no max_len; pass the decode horizon "
                             "as length=")
        length = tree["pos"].shape[0]
    elif "pos" in tree and length > tree["pos"].shape[0]:
        raise ValueError(
            f"cache length {length} exceeds the learned position table "
            f"({tree['pos'].shape[0]}); use pos_encoding='rope' for longer horizons"
        )
    device = tree["ln_f"]["scale"].device
    caches = {"k": [], "v": [],
              "pos": torch.zeros((batch_size,), dtype=torch.int64, device=device)
              if per_row else 0}
    for blk in _blocks(tree):
        wk = blk["wk"]
        _, h_kv, dh = (wk["w"] if "w" in wk else wk["w_q"]).shape
        shape = (batch_size, length, h_kv, dh)
        caches["k"].append(torch.zeros(shape, dtype=dtype, device=device))
        caches["v"].append(torch.zeros(shape, dtype=dtype, device=device))
    return caches


def _attn_one(q, kc, vc, pos, scale, window=None):
    """Single-query attention over a ring cache: q (B, H, Dh), kc/vc (B, C,
    Hkv, Dh), in f32.  Slot ``s`` holds absolute position ``pos - ((pos -
    s) mod C)`` (a floor modulo), the latest position congruent to ``s``;
    masking on it covers both the unwrapped cache and the windowed ring,
    and never-written slots sit at negative positions.  ``pos`` is the
    batch-uniform int or a (B,) tensor (one position per row).  GQA
    contracts grouped queries against the un-repeated cache."""
    b, c, h_kv, dh = kc.shape
    h = q.shape[1]
    slots = torch.arange(c, device=kc.device)
    if isinstance(pos, torch.Tensor):
        p_col = pos[:, None]
        slot_pos = p_col - ((p_col - slots[None]) % c)
        keep = slot_pos >= 0                # (B, C)
        if window is not None:
            keep = keep & (slot_pos > p_col - window)
        keep_g = keep[:, None, None, :]
        keep_h = keep[:, None, :]
    else:
        slot_pos = pos - ((pos - slots) % c)
        keep = slot_pos >= 0                # (C,)
        if window is not None:
            keep = keep & (slot_pos > pos - window)
        keep_g = keep[None, None, None]
        keep_h = keep[None, None]
    if h_kv != h:
        g = h // h_kv
        qg = q.reshape(b, h_kv, g, dh).to(torch.float32)
        s = torch.einsum("bkgd,blkd->bkgl", qg, kc.to(torch.float32)) * scale
        s = torch.where(keep_g, s, -1e30)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgl,blkd->bkgd", p, vc.to(torch.float32))
        return out.reshape(b, h, dh)
    s = torch.einsum("bhd,blhd->bhl", q.to(torch.float32), kc.to(torch.float32)) * scale
    s = torch.where(keep_h, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhl,blhd->bhd", p, vc.to(torch.float32))


def decode_step(params, cache, obs_t, compute_dtype=torch.bfloat16, moe_impl="dense",
                moe_k=2, moe_capacity_factor=1.25, moe_dispatch="sort", window=None):
    """One incremental step: consume ``obs_t`` (B, obs_dim) at the cache's
    position and return ``(prediction (B, obs_dim) f32, cache)``.  The
    block math is :func:`_forward`'s at one position.

    The cache is a ring: each row's k/v are written at slot ``pos % C`` and
    attention masks by slot position (:func:`_attn_one`), so ``C >=
    window`` slots serve an unbounded horizon.  The cache is advanced in
    place — its k/v tensors written, its ``pos`` moved on — and returned,
    where the reference returns a new one (the counterpart of donating
    it).  With a (B,) ``pos`` every row embeds, rotates, writes and masks
    at its own position; a learned table is read at positions clamped into
    range, as the reference's lookups clamp.

    Routed MoE layers route drop-free here (:func:`_drop_free`): a
    capacity that depends on how many tokens share the call would make the
    incremental decode disagree with the full-sequence forward."""
    tree = _nest(params)
    _refuse_mla(tree, "decode_step")
    if moe_impl == "topk":
        moe_capacity_factor = _drop_free(params, moe_k, moe_capacity_factor)
    blocks = _blocks(tree)
    pos = cache["pos"]
    per_row = isinstance(pos, torch.Tensor) and pos.ndim == 1
    if not per_row:
        pos = int(pos)
    use_rope = "pos" not in tree
    x = _dense_mq(tree["embed"], obs_t.to(compute_dtype), compute_dtype)
    device = x.device
    if use_rope:
        at = pos if per_row else torch.full((1,), pos, device=device)
        cos, sin = rope_table(at, _wq_head_dim(blocks))
    else:
        table = tree["pos"]
        if per_row:
            x = x + table[pos.clamp(0, table.shape[0] - 1)].to(compute_dtype)
        else:
            x = x + table[min(max(pos, 0), table.shape[0] - 1)].to(compute_dtype)[None]
    rows = torch.arange(obs_t.shape[0], device=device) if per_row else None
    for i, blk in enumerate(blocks):
        h = _ln_apply(blk["ln1"], x)
        q = _proj_mq(blk["wq"], h, "bd,dhk->bhk", compute_dtype)
        k_new = _proj_mq(blk["wk"], h, "bd,dhk->bhk", compute_dtype)
        v_new = _proj_mq(blk["wv"], h, "bd,dhk->bhk", compute_dtype)
        if use_rope:
            rotate = apply_rope_rows if per_row else apply_rope
            q = rotate(q, cos, sin)
            k_new = rotate(k_new, cos, sin)
        kc, vc = cache["k"][i], cache["v"][i]
        slot = pos % kc.shape[1]
        if per_row:
            kc[rows, slot] = k_new.to(kc.dtype)
            vc[rows, slot] = v_new.to(vc.dtype)
        else:
            kc[:, slot] = k_new.to(kc.dtype)
            vc[:, slot] = v_new.to(vc.dtype)
        dh = q.shape[-1]
        a = _attn_one(q, kc, vc, pos, 1.0 / math.sqrt(dh), window=window).to(compute_dtype)
        x = x + _proj_mq(blk["wo"], a, "bhk,hkd->bd", compute_dtype)
        h = _ln_apply(blk["ln2"], x)[:, None]  # the MLPs take (B, T, d)
        x = x + _mlp(blk, h, compute_dtype, moe_impl, moe_k, moe_capacity_factor,
                     moe_dispatch, [])[:, 0]
    cache["pos"] = pos + 1
    x = _ln_apply(tree["ln_f"], x)
    return _dense_mq(tree["head"], x, torch.float32), cache


def prefill_cache(params, prefix, cache, rows, compute_dtype, window=None,
                  moe_impl="dense", moe_k=2, moe_capacity_factor=1.25, moe_dispatch="sort"):
    """One teacher-forced pass over ``prefix`` (B, T0, obs_dim) that fills
    rows ``rows`` of ``cache`` (every row for ``rows=None``) with its
    rotated k/v: only the last ``C`` positions that fit the ring, each at
    its slot.  The rows' positions become ``T0``.  Returns the pass's
    predictions (B, T0, obs_dim) f32.  Routed MoE layers route drop-free,
    as in :func:`decode_step`."""
    if moe_impl == "topk":
        moe_capacity_factor = _drop_free(params, moe_k, moe_capacity_factor)
    kvs = []
    preds, _ = _forward(
        params, prefix,
        lambda q, k, v: full_attention(q, k, v, causal=True, window=window),
        compute_dtype, moe_impl, moe_k, moe_capacity_factor, moe_dispatch, kv_sink=kvs)
    t0 = prefix.shape[1]
    ring = cache["k"][0].shape[1]
    keep_n = min(t0, ring)
    slots = (torch.arange(keep_n, device=prefix.device) + (t0 - keep_n)) % ring
    sel = slice(None) if rows is None else rows[:, None]
    for i, (k, v) in enumerate(kvs):
        cache["k"][i][sel, slots] = k[:, t0 - keep_n:].to(cache["k"][i].dtype)
        cache["v"][i][sel, slots] = v[:, t0 - keep_n:].to(cache["v"][i].dtype)
    if rows is None:
        cache["pos"] = t0
    else:
        cache["pos"][rows] = t0
    return preds


def rollout(params, prefix, n_steps, compute_dtype=torch.bfloat16, moe_impl="dense",
            moe_k=2, moe_capacity_factor=1.25, moe_dispatch="sort", window=None,
            cache_dtype=None):
    """Autoregressive rollout ("dreaming"): consume the ``prefix`` episode
    (B, T0, obs_dim), then feed the model its own next-observation
    predictions for ``n_steps`` more steps.  Returns (B, n_steps, obs_dim)
    f32 predictions for positions T0 .. T0+n_steps-1.

    One teacher-forced pass fills the caches (:func:`prefill_cache`), then
    :func:`decode_step` runs ``n_steps - 1`` times; under a ``window`` the
    cache is a ring of ``window`` slots.  Routed MoE layers route drop-free
    in both phases."""
    _refuse_mla(_nest(params), "rollout")
    b, t0, _ = prefix.shape
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if t0 < 1:
        raise ValueError("prefix must contain at least one observation")
    if "pos" in params and t0 + n_steps > params["pos"].shape[0]:
        raise ValueError(
            f"prefix {t0} + rollout {n_steps} exceeds max_len {params['pos'].shape[0]}"
        )
    total = t0 + n_steps
    length = total if window is None else min(total, window)
    cache = init_cache(params, b, dtype=cache_dtype or compute_dtype, length=length)
    routing = dict(moe_impl=moe_impl, moe_k=moe_k, moe_capacity_factor=moe_capacity_factor,
                   moe_dispatch=moe_dispatch)
    preds = prefill_cache(params, prefix, cache, None, compute_dtype, window=window, **routing)
    obs = preds[:, -1]  # the prediction for position t0
    out = [obs]
    for _ in range(n_steps - 1):
        obs, cache = decode_step(params, cache, obs, compute_dtype=compute_dtype,
                                 window=window, **routing)
        out.append(obs)
    return torch.stack(out, dim=1)
