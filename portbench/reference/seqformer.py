"""Plain reference of the SeqFormer world model's training step.

A frozen, independent copy of the architecture the program trains: the
causal temporal transformer over pendulum episodes (learned positions,
pre-norm blocks with head-major attention projections, a GELU MLP) with
its next-observation MSE loss, and Adam.  Plain ``torch`` operations over a
flat ``{path: tensor}`` parameter dict in float32, attention over the full
score matrix, autograd for the gradients.  Nothing here imports the
program.

``mm`` is applied to both operands of every product that the
configuration computes in its compute type (the embedding, the attention
projections and products, the MLP; the head is float32): the identity for the float32 reference, or a
fake quantizer (:mod:`portbench.reference.fp8`) for the control, which puts
the reference in the program's place at a lower precision.  TF32 must be
off while the reference runs (:func:`exact_matmuls`).
"""

from __future__ import annotations

import contextlib
import math

import torch

LN_EPS = 1e-6
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def _same(x):
    return x


@contextlib.contextmanager
def exact_matmuls():
    """float32 products without TF32 on the card."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def layer_norm(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * scale + bias


def gelu(x):
    """GELU, tanh form."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def dense(p, prefix, x, mm):
    return mm(x) @ mm(p[prefix + ".w"]) + p[prefix + ".b"]


def causal_attention(q, k, v, mm):
    """(B, T, H, Dh) each -> (B, T, H, Dh): softmax over the causal scores."""
    t, dh = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", mm(q), mm(k)) / math.sqrt(dh)
    future = torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1)
    s = s.masked_fill(future, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", mm(torch.softmax(s, dim=-1)), mm(v))


def forward(p, obs, cfg, mm=_same):
    """(B, T, obs_dim) -> (B, T, obs_dim) prediction."""
    t = obs.shape[1]
    x = dense(p, "embed", obs, mm) + p["pos"][:t]
    for i in range(cfg["n_layers"]):
        blk = f"blocks.{i}"
        h = layer_norm(x, p[blk + ".ln1.scale"], p[blk + ".ln1.bias"])
        q, k, v = (torch.einsum("btd,dhk->bthk", mm(h), mm(p[f"{blk}.{n}.w"])) + p[f"{blk}.{n}.b"]
                   for n in ("wq", "wk", "wv"))
        a = causal_attention(q, k, v, mm)
        x = x + torch.einsum("bthk,hkd->btd", mm(a), mm(p[blk + ".wo.w"])) + p[blk + ".wo.b"]
        h = layer_norm(x, p[blk + ".ln2.scale"], p[blk + ".ln2.bias"])
        x = x + dense(p, blk + ".mlp.proj", gelu(dense(p, blk + ".mlp.fc", h, mm)), mm)
    x = layer_norm(x, p["ln_f.scale"], p["ln_f.bias"])
    return dense(p, "head", x, _same)


def episode_loss(p, episode, cfg, mm=_same):
    """Next-observation MSE over an episode batch (B, T+1, obs_dim)."""
    episode = episode.to(torch.float32)
    pred = forward(p, episode[:, :-1], cfg, mm)
    return torch.mean((pred - episode[:, 1:]) ** 2)


def loss_and_grads(leaves, episode, cfg, mm=_same, chunk=None):
    """The batch's loss and its gradients over ``leaves``, computed over
    blocks of ``chunk`` rows (all rows when None), each block's mean weighted
    by its share of the rows, so that a large batch fits the device."""
    n = episode.shape[0]
    chunk = n if chunk is None else chunk
    total, grads = 0.0, None
    for at in range(0, n, chunk):
        part = episode[at:at + chunk]
        loss = episode_loss(leaves, part, cfg, mm) * (part.shape[0] / n)
        got = torch.autograd.grad(loss, list(leaves.values()))
        grads = got if grads is None else [a + b for a, b in zip(grads, got)]
        total += float(loss.detach())
        del loss, got
    return total, dict(zip(leaves, grads))


class Adam:
    """Adam over a flat parameter dict: ``p -= lr * m_hat / (sqrt(v_hat) +
    eps)``, betas (0.9, 0.999), eps 1e-8."""

    def __init__(self, params, lr):
        self.lr = lr
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def update(self, params, grads):
        b1, b2 = BETAS
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        with torch.no_grad():
            for k, g in grads.items():
                self.m[k] = b1 * self.m[k] + (1 - b1) * g
                self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
                params[k] -= self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + ADAM_EPS)


def train_readings(params, batches, cfg, lr, mm=_same, rows=None, chunk=None):
    """Adam steps over ``batches`` (one per step) from ``params`` (updated
    in place): ``{'losses': [...], 'first_grads': {leaf: host tensor} and
    'grad_norms': {leaf: norm} of the first step's gradient, 'change_norms': {leaf: norm of the parameters' change
    over all steps}}``.  ``rows`` trains on that slice of each batch (a
    planted fault); ``chunk`` rows at a time go through the model."""
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = Adam(params, lr)
    losses, grad_norms, first_grads = [], {}, {}
    for i, episode in enumerate(batches):
        if rows is not None:
            episode = episode[rows]
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss, grads = loss_and_grads(leaves, episode, cfg, mm, chunk)
        losses.append(loss)
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
            first_grads = {k: g.to("cpu") for k, g in grads.items()}
        opt.update(params, grads)
        del leaves, grads
    change = {k: float(torch.linalg.vector_norm(params[k] - start[k])) for k in params}
    return {"losses": losses, "first_grads": first_grads, "grad_norms": grad_norms,
            "change_norms": change}
