"""TinyDetector — the supervised model of the datagen workload.

Stride-2 SAME convs with GELU, a global-average-pool, a GELU dense layer
and a head regressing K keypoints in normalized [0,1] image coordinates;
the port of ``blendjax.models.detector``.  Parameters are a flat
``{path: tensor}`` dict whose keys follow the reference's pytree paths
(``convs.0.w``, ``fc.b``, ...), so :mod:`blendjax_torch.models.convert`
maps one onto the other leaf by leaf.  Compute is bf16 over f32
parameters by default.
"""

from __future__ import annotations

import torch

from blendjax_torch.models.layers import (
    conv_apply,
    conv_init,
    dense_apply,
    dense_init,
    gelu,
    layer,
    num_layers,
    prefixed,
)
from blendjax_torch.utils.device import resolve_device


def init(generator, num_keypoints=8, channels=(32, 64, 128), in_channels=3,
         hidden=256, device="cuda"):
    """Initialize detector params for ``num_keypoints`` (x, y) outputs,
    drawn from ``generator`` (a ``torch.Generator`` on ``device``)."""
    device = resolve_device(device)
    params = {}
    c_in = in_channels
    for i, c_out in enumerate(channels):
        params.update(prefixed(f"convs.{i}", conv_init(
            c_in, c_out, ksize=3, generator=generator, device=device)))
        c_in = c_out
    params.update(prefixed("fc", dense_init(c_in, hidden, generator=generator,
                                         device=device)))
    params.update(prefixed("head", dense_init(hidden, num_keypoints * 2,
                                           generator=generator, device=device)))
    return params


def apply(params, images, compute_dtype=torch.bfloat16, conv_fn=None, dense_fn=None):
    """Forward pass.

    images: (N, H, W, C) float in [0, 1].
    conv_fn / dense_fn: layer-apply overrides ``(p, x, stride) -> y`` /
        ``(p, x) -> y``, the seam :mod:`blendjax_torch.ops.quant` injects
        its int8 layers through.
    Returns (N, K, 2) predicted keypoints in [0, 1] normalized coordinates,
    float32 (the sigmoid runs in float32).
    """
    if conv_fn is None:
        def conv_fn(p, x, stride):
            return conv_apply(p, x, stride=stride, dtype=compute_dtype)
    if dense_fn is None:
        def dense_fn(p, x):
            return dense_apply(p, x, dtype=compute_dtype)
    x = images.to(compute_dtype)
    for i in range(num_layers(params, "convs")):
        x = gelu(conv_fn(layer(params, f"convs.{i}"), x, 2))
    x = x.mean(dim=(1, 2))  # global average pool
    x = gelu(dense_fn(layer(params, "fc"), x))
    out = dense_fn(layer(params, "head"), x)
    out = torch.sigmoid(out.to(torch.float32))
    return out.reshape(*out.shape[:-1], out.shape[-1] // 2, 2)


def loss_fn(params, batch, compute_dtype=torch.bfloat16):
    """MSE over normalized keypoints.

    ``batch`` = {'image': (N,H,W,C) float [0,1], 'xy': (N,K,2) normalized}.
    """
    pred = apply(params, batch["image"], compute_dtype)
    err = pred - batch["xy"].to(torch.float32)
    return torch.mean(err * err)


def train_flops(batch_size, height, width, num_keypoints=8,
                channels=(32, 64, 128), in_channels=3, hidden=256):
    """Closed-form FLOPs of one training step (matmul/conv terms only):
    each stride-2 SAME conv is ``2 * B*Ho*Wo * 9 * Cin * Cout``, each dense
    layer ``2 * B * in * out``, and training counts 3x forward."""
    fwd = 0.0
    h, w, c_in = height, width, in_channels
    for c_out in channels:
        h, w = (h + 1) // 2, (w + 1) // 2
        fwd += 2.0 * batch_size * h * w * 9 * c_in * c_out
        c_in = c_out
    fwd += 2.0 * batch_size * c_in * hidden
    fwd += 2.0 * batch_size * hidden * num_keypoints * 2
    return 3.0 * fwd
