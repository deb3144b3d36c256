"""Plain reference of the DeepSeek-V3 blocks' training step (Moonlight-16B-A3B
cut to one card), as the world model trains them.

A frozen, independent copy of the architecture the program trains, from
the published equations: multi-head latent attention without query
compression (DeepSeek-V2, arXiv 2405.04434, section 2.1.2-2.1.3), RMSNorm,
a dense SwiGLU MLP in the first ``first_k_dense_replace`` blocks and the
DeepSeekMoE layer in the rest (DeepSeek-V3, arXiv 2412.19437, eqs. 12-16:
sigmoid scores, the top ``k`` chosen on score plus bias, weights from the
unbiased scores normalised over the chosen and scaled, shared experts),
the sequence-wise balance loss (eqs. 17-20), the next-observation MSE
loss, Adam, and the balancing bias step after each Adam step (section
2.1.2), from the biases that the weights bring
(:func:`calibrated_biases`, ``portbench/harness/weights_mla.py``).
The layer holds experts ``first_held_expert`` onwards, as many as
``n_routed_experts``, and routes over ``router_experts``: the other
experts' part of the result is left out, as in the program.  Plain
``torch`` operations over a flat ``{path: tensor}`` parameter dict in
float32 (``portbench/harness/weights_mla.py``'s layout), attention over
full score matrices in blocks of query rows, each held expert's tokens
found with ``nonzero``, autograd for the gradients.  Nothing here imports
the program.

``mm`` is applied to both operands of every product that the
configuration computes in its compute type (the embedding, the attention
projections and products, the MLP, the experts; the router and the head
are float32), as in :mod:`portbench.reference.seqformer`.  TF32 must be
off while the reference runs (``exact_matmuls``).
"""

from __future__ import annotations

import math

import torch

from portbench.reference.seqformer import Adam, exact_matmuls  # noqa: F401

#: query rows of one block of attention's score matrices
Q_BLOCK = 2048


def _same(x):
    return x


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """Rotate-half RoPE over (B, T, H, D): position t, frequency pair i of
    ``theta ** (-2i / D)``."""
    t, d = x.shape[1], x.shape[-1]
    freqs = theta ** (-torch.arange(d // 2, dtype=torch.float32, device=x.device) / (d // 2))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs[None]
    c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def causal_attention(q, k, v, mm):
    """(B, T, H, Dq) q and k, (B, T, H, Dv) v -> (B, T, H, Dv): softmax of
    the causal scores over sqrt(Dq), a sequence at a time in blocks of
    :data:`Q_BLOCK` query rows."""
    t, dq = q.shape[1], q.shape[-1]
    seqs = []
    for i in range(q.shape[0]):
        out = []
        for at in range(0, t, Q_BLOCK):
            qb = q[i:i + 1, at:at + Q_BLOCK]
            s = torch.einsum("bqhd,bkhd->bhqk", mm(qb), mm(k[i:i + 1])) / math.sqrt(dq)
            rows = torch.arange(at, at + qb.shape[1], device=q.device)[:, None]
            future = torch.arange(t, device=q.device)[None, :] > rows
            s = s.masked_fill(future, float("-inf"))
            out.append(torch.einsum("bhqk,bkhd->bqhd", mm(torch.softmax(s, dim=-1)),
                                    mm(v[i:i + 1])))
        seqs.append(torch.cat(out, dim=1))
    return torch.cat(seqs)


def mla(p, blk, x, cfg, mm):
    """Multi-head latent attention over the normed (B, T, d) ``x``."""
    nope, rope_d, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["kv_lora_rank"]
    q = torch.einsum("btd,dhk->bthk", mm(x), mm(p[blk + ".wq.w"]))
    kv_a = mm(x) @ mm(p[blk + ".wkv_a.w"])
    c = rms_norm(kv_a[..., :rank], p[blk + ".kv_norm.scale"], cfg["kv_norm_eps"])
    kv = torch.einsum("btc,chk->bthk", mm(c), mm(p[blk + ".wkv_b.w"]))
    k_rope = rope(kv_a[..., None, rank:], cfg["rope_theta"])
    h = q.shape[2]
    q = torch.cat([q[..., :nope], rope(q[..., nope:], cfg["rope_theta"])], dim=-1)
    k = torch.cat([kv[..., :nope], k_rope.expand(-1, -1, h, rope_d)], dim=-1)
    a = causal_attention(q, k, kv[..., nope:], mm)
    return torch.einsum("bthk,hkd->btd", mm(a), mm(p[blk + ".wo.w"]))


def swiglu(p, prefix, x, mm, expert=None):
    def w(name):
        t = p[f"{prefix}.{name}"]
        return t if expert is None else t[expert]

    h = torch.nn.functional.silu(mm(x) @ mm(w("w1"))) * (mm(x) @ mm(w("w3")))
    return mm(h) @ mm(w("w2"))


def deepseek_moe(p, blk, x, cfg, bias, batch, mm):
    """The DeepSeekMoE layer over the normed (n, d) ``x``: ``(y, the loads
    of all routed experts (E,), the sequence-wise balance loss)``."""
    n, e = x.shape[0], cfg["router_experts"]
    k, first = cfg["num_experts_per_tok"], cfg["first_held_expert"]
    scores = torch.sigmoid(x @ p[blk + ".moe.gate.w"])
    chosen = torch.argsort(scores + bias, dim=-1, descending=True, stable=True)[:, :k]
    top = scores.gather(1, chosen)
    weights = top / top.sum(-1, keepdim=True) * cfg["routed_scaling_factor"]
    y = swiglu(p, blk + ".moe.shared", x, mm)
    for j in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(chosen == first + j, as_tuple=True)
        out = swiglu(p, blk + ".moe", x[tok], mm, expert=j) * weights[tok, slot][:, None]
        y = y.index_add(0, tok, out)
    load = torch.zeros(e, device=x.device).scatter_add_(
        0, chosen.reshape(-1), torch.ones(chosen.numel(), device=x.device))
    t = n // batch
    f = torch.zeros_like(scores).scatter_(1, chosen, 1.0).reshape(batch, t, e).sum(1)
    f = f * (e / (k * t))
    share = (scores / scores.sum(-1, keepdim=True)).reshape(batch, t, e).mean(1)
    return y, load, (f * share).sum(-1).mean()


def forward(p, obs, cfg, biases, mm=_same):
    """(B, T, obs_dim) -> ((B, T, obs_dim) prediction, {layer: load}, the
    sum over layers of the balance loss)."""
    b, t, _ = obs.shape
    eps = cfg["rms_norm_eps"]
    x = mm(obs) @ mm(p["embed.w"]) + p["embed.b"]
    loads, balance = {}, 0.0
    for i in range(cfg["num_hidden_layers"]):
        blk = f"blocks.{i}"
        x = x + mla(p, blk, rms_norm(x, p[blk + ".attn_norm.scale"], eps), cfg, mm)
        h = rms_norm(x, p[blk + ".mlp_norm.scale"], eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + swiglu(p, blk + ".mlp", h, mm)
            continue
        y, loads[blk], bal = deepseek_moe(p, blk, h.reshape(b * t, -1), cfg, biases[blk], b, mm)
        balance = balance + bal
        x = x + y.reshape(b, t, -1)
    x = rms_norm(x, p["ln_f.scale"], eps)
    return x @ p["head.w"] + p["head.b"], loads, balance


def episode_loss(p, episode, cfg, biases, mm=_same):
    """Next-observation MSE over an episode batch (B, T+1, obs_dim) plus the
    weighted balance loss; returns (loss, {layer: load})."""
    episode = episode.to(torch.float32)
    pred, loads, balance = forward(p, episode[:, :-1], cfg, biases, mm)
    return torch.mean((pred - episode[:, 1:]) ** 2) + cfg["balance_alpha"] * balance, loads


def loss_and_grads(leaves, episode, cfg, biases, mm=_same, chunk=None):
    """The batch's loss, its gradients over ``leaves`` and the loads, over
    blocks of ``chunk`` rows (all rows when None), each block's loss
    weighted by its share of the rows.  The balance loss is a mean over
    sequences, so it splits over the blocks in the same shares."""
    n = episode.shape[0]
    chunk = n if chunk is None else chunk
    total, grads, loads = 0.0, None, None
    for at in range(0, n, chunk):
        part = episode[at:at + chunk]
        loss, got_loads = episode_loss(leaves, part, cfg, biases, mm)
        loss = loss * (part.shape[0] / n)
        got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        got = [torch.zeros_like(v) if g is None else g for g, v in zip(got, leaves.values())]
        grads = got if grads is None else [a + b for a, b in zip(grads, got)]
        loads = got_loads if loads is None else {k: loads[k] + v for k, v in got_loads.items()}
        total += float(loss.detach())
        del loss, got
    return total, dict(zip(leaves, grads)), loads


def balance_step(biases, loads, gamma):
    """``b_i += gamma * sign(mean load - load_i)`` for each layer."""
    for name, load in loads.items():
        biases[name] = biases[name] + gamma * torch.sign(load.mean() - load)


def train_readings(params, batches, cfg, lr, mm=_same, rows=None, chunk=None, biases=None):
    """Adam steps over ``batches`` (one per step) from ``params`` (updated
    in place), each followed by the balancing bias step from ``biases``
    ({layer: (router_experts,)}; zero for every MoE layer when None):
    ``{'losses', 'first_grads', 'grad_norms', 'change_norms'}`` as
    :func:`portbench.reference.seqformer.train_readings` gives them.
    ``rows`` trains on that slice of each batch (a planted fault); ``chunk``
    rows at a time go through the model."""
    device = next(iter(params.values())).device
    moe_layers = range(cfg["first_k_dense_replace"], cfg["num_hidden_layers"])
    biases = ({f"blocks.{i}": torch.zeros(cfg["router_experts"], device=device)
               for i in moe_layers} if biases is None
              else {k: v.clone() for k, v in biases.items()})
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = Adam(params, lr)
    losses, grad_norms, first_grads = [], {}, {}
    for i, episode in enumerate(batches):
        if rows is not None:
            episode = episode[rows]
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss, grads, loads = loss_and_grads(leaves, episode, cfg, biases, mm, chunk)
        losses.append(loss)
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
            first_grads = {k: g.to("cpu") for k, g in grads.items()}
        opt.update(params, grads)
        balance_step(biases, loads, cfg["bias_update_speed"])
        del leaves, grads
    change = {k: float(torch.linalg.vector_norm(params[k] - start[k])) for k in params}
    return {"losses": losses, "first_grads": first_grads, "grad_norms": grad_norms,
            "change_norms": change}
