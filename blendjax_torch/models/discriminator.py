"""Patch discriminator of the densityopt workload; the port of
``blendjax.models.discriminator``.

It scores rendered supershape images as real or simulated; its loss on the
simulated ones is the signal the score-function estimator pushes back
into the producers' scene parameters.  Stride-2 SAME 4x4 convs with
leaky-ReLU(0.2), a mean over H and W, a dense head to one logit.
Parameters are a flat ``{path: tensor}`` dict keyed by the reference's
pytree paths (``convs.0.w``, ``head.b``), so
:mod:`blendjax_torch.models.convert` maps one onto the other leaf by leaf.
Compute is bf16 over f32 parameters by default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from blendjax_torch.models.layers import (
    conv_apply,
    conv_init,
    dense_apply,
    dense_init,
    layer,
    num_layers,
    prefixed,
)
from blendjax_torch.utils.device import resolve_device

def init(generator, in_channels=1, widths=(32, 64, 128), device="cuda"):
    """Discriminator params drawn from ``generator`` (a ``torch.Generator``
    on ``device``): a 4x4 conv per width, then a dense head to 1."""
    device = resolve_device(device)
    params = {}
    c_in = in_channels
    for i, c_out in enumerate(widths):
        params.update(prefixed(f"convs.{i}", conv_init(c_in, c_out, ksize=4,
                                                    generator=generator, device=device)))
        c_in = c_out
    params.update(prefixed("head", dense_init(c_in, 1, generator=generator, device=device)))
    return params


def apply(params, images, compute_dtype=torch.bfloat16):
    """(N, H, W, C) float -> (N,) real/fake logits, float32."""
    x = images.to(compute_dtype)
    for i in range(num_layers(params, "convs")):
        x = F.leaky_relu(conv_apply(layer(params, f"convs.{i}"), x, stride=2,
                                    dtype=compute_dtype), 0.2)
    # the mean accumulates in f32 and rounds once to the compute dtype, as
    # XLA reduces a bf16 mean
    x = x.to(torch.float32).mean(dim=(1, 2)).to(compute_dtype)
    return dense_apply(layer(params, "head"), x, dtype=compute_dtype).to(torch.float32)[..., 0]


def bce_logits(logits, targets):
    """Numerically stable binary cross entropy on logits, averaged."""
    return torch.mean(torch.clamp_min(logits, 0.0) - logits * targets
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def d_loss_fn(params, real_images, fake_images, compute_dtype=torch.bfloat16):
    """Discriminator loss: real -> 1, simulated -> 0.  The two batches go
    through the network separately (their sizes may differ)."""
    logits_real = apply(params, real_images, compute_dtype)
    logits_fake = apply(params, fake_images, compute_dtype)
    return (bce_logits(logits_real, torch.ones_like(logits_real))
            + bce_logits(logits_fake, torch.zeros_like(logits_fake)))


def sim_scores(params, fake_images, compute_dtype=torch.bfloat16):
    """Per-sample 'fool the discriminator' losses, -log D(fake), for the
    score-function estimator."""
    logits = apply(params, fake_images, compute_dtype)
    return torch.clamp_min(logits, 0.0) - logits + torch.log1p(torch.exp(-torch.abs(logits)))
