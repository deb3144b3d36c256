"""The yardstick's arithmetic: the work the model requires, from its
configuration alone, so no change to the program can move it.

Matrix products count 2 FLOPs a multiply-add.  Attention counts the causal
half of the score matrix (the pairs ``(i, j)`` with ``j <= i``).
Training is three forward passes.  Elementwise work,
normalisation, softmax and the optimizer count nothing.
"""

from __future__ import annotations


def causal_pairs(b, t, h):
    return b * h * t * (t + 1) // 2


def forward_flops(cfg, batch, seq_len):
    d, obs, h = cfg["d_model"], cfg["obs_dim"], cfg["n_heads"]
    dh, dff = d // h, cfg["d_ff"]
    n = batch * seq_len
    per_layer = 2 * n * d * d * 4  # q, k, v and the output projection
    per_layer += 2 * 2 * causal_pairs(batch, seq_len, h) * dh  # QK^T and PV
    per_layer += 2 * 2 * n * d * dff  # the MLP's two products
    return 2 * n * obs * d + cfg["n_layers"] * per_layer + 2 * n * d * obs


def train_flops(cfg, batch, seq_len):
    return 3 * forward_flops(cfg, batch, seq_len)


def flash_work(b, t, h, d, elt):
    """``{kernel: (FLOPs, least bytes)}`` of the three flash kernels at (B,
    T, H, Dh) causal, ``elt``-byte inputs and outputs: each input read once
    and each output written once."""
    pairs = causal_pairs(b, t, h)
    tile = b * h * t * d * elt  # one q, k, v, O or dO tensor
    rows = b * h * t * 4  # one f32 lse or delta vector
    return {
        "flash_fwd": (2 * 2 * pairs * d, 3 * tile + tile + rows),  # QK^T, PV
        "flash_dq": (3 * 2 * pairs * d, 4 * tile + 2 * rows + tile),  # QK^T, dO V^T, dS K
        "flash_dkv": (4 * 2 * pairs * d, 4 * tile + 2 * rows + 2 * tile),  # + P^T dO, dS^T Q
    }


def least_seconds(flops, nbytes, peak):
    """The roofline's bound: the larger of the compute and the memory time."""
    return max(flops / peak["bf16_flops_per_s"], nbytes / peak["hbm_bytes_per_s"])
