"""The yardstick's arithmetic for the DeepSeek-V3 blocks (Moonlight-16B-A3B
cut to one card), from the configuration alone, so no change to the
program can move it.

Matrix products count 2 FLOPs a multiply-add.  Attention counts the causal
half of the score matrix, QK^T over the q/k head dim and PV over v's.
The routed experts count the expected ``k * held / router_experts``
assignments a token (the held share's work under balanced routing), the
router its product over all routed experts.  Training is three forward
passes.  Elementwise work, normalisation, softmax, routing's sorts and
the optimizer count nothing.
"""

from __future__ import annotations

from portbench.harness.weights_mla import sizes
from portbench.harness.work import causal_pairs


def swiglu_flops(d, f):
    """A token's forward through a bias-free SwiGLU of width f."""
    return 2 * 3 * d * f


def forward_flops(cfg, batch, seq_len):
    s = sizes(cfg)
    d, h, dq, dv, rank = s["d"], s["h"], s["nope"] + s["rope"], s["dv"], s["rank"]
    n = batch * seq_len
    proj = 2 * n * (d * h * dq + d * (rank + s["rope"]) + rank * h * (s["nope"] + dv) + h * dv * d)
    core = 2 * causal_pairs(batch, seq_len, h) * (dq + dv)
    attention = proj + core
    dense = n * swiglu_flops(d, s["dense_ff"])
    routed = n * cfg["num_experts_per_tok"] * s["held"] * swiglu_flops(d, s["moe_ff"])
    moe = (2 * n * d * s["router"] + n * swiglu_flops(d, s["shared"] * s["moe_ff"])
           + routed // s["router"])
    n_moe = s["layers"] - s["dense"]
    ends = 2 * n * s["obs"] * d * 2  # the embedding and the head
    return s["layers"] * attention + s["dense"] * dense + n_moe * moe + ends


def train_flops(cfg, batch, seq_len):
    return 3 * forward_flops(cfg, batch, seq_len)


def flash_work(b, t, h, dq, dv, elt):
    """``{kernel: (FLOPs, least bytes)}`` of K2-K4 at (B, T, H) causal with
    q/k head dim ``dq`` and v's ``dv``, ``elt``-byte inputs and outputs:
    each input read once and each output written once, every tensor at its
    own width."""
    pairs = causal_pairs(b, t, h)
    wq = b * h * t * dq * elt  # one q, k, dQ or dK tensor
    wv = b * h * t * dv * elt  # one v, O, dO or dV tensor
    rows = b * h * t * 4  # one f32 lse or delta vector
    return {
        "flash_fwd": (2 * pairs * (dq + dv), 2 * wq + wv + wv + rows),  # QK^T, PV
        "flash_dq": (2 * pairs * (2 * dq + dv), 2 * wq + 2 * wv + 2 * rows + wq),
        "flash_dkv": (2 * pairs * (2 * dq + 2 * dv), 2 * wq + 2 * wv + 2 * rows + wq + wv),
    }
