"""Consumer-side data augmentation on NHWC batches, the port of
``blendjax.ops.augment``.

Domain randomization happens producer-side in Blender; these add cheap
augmentation on the card.  Each op is a draw (from an explicit
``torch.Generator``, on the generator's device; without one, on the
images' device) and a deterministic function of the draws, which it
moves to the images' device — a flip mask, crop offsets, brightness deltas,
contrast factors — so a caller can replay or share the draws, and the
tests hold the deterministic part to the JAX functions fed the same draws.
Plain PyTorch: a gather and elementwise passes, as the JAX package
computes them outside any Pallas kernel.
"""

from __future__ import annotations

import torch


def _draw_device(images, generator):
    return generator.device if generator is not None else images.device


def _uniform(n, low, high, generator, device):
    u = torch.rand(n, generator=generator, device=device)
    return low + (high - low) * u


def flip_draw(n, generator=None, device=None):
    """Per-sample flip mask, each True with probability 0.5."""
    return torch.rand(n, generator=generator, device=device) < 0.5


def hflip(images, flip, keypoints_xy=None):
    """Flip the samples of a NHWC batch where ``flip`` (N,) is True; with
    pixel-space ``keypoints_xy`` (N, K, 2), flip them consistently and
    return ``(images, keypoints)``."""
    mask = flip.to(images.device).view(-1, 1, 1, 1)
    flipped = torch.where(mask, images.flip(2), images)
    if keypoints_xy is None:
        return flipped
    w = images.shape[2]
    kmask = flip.to(keypoints_xy.device).view(-1, 1)
    kx = torch.where(kmask, (w - 1) - keypoints_xy[..., 0], keypoints_xy[..., 0])
    return flipped, torch.stack([kx, keypoints_xy[..., 1]], dim=-1)


def random_hflip(images, generator=None, keypoints_xy=None):
    """Flip a NHWC batch horizontally with per-sample probability 0.5."""
    return hflip(images, flip_draw(images.shape[0], generator, _draw_device(images, generator)),
                 keypoints_xy)


def crop_draw(n, hw, crop_hw, generator=None, device=None):
    """Per-sample ``(tops, lefts)``, uniform over the valid offsets."""
    (h, w), (ch, cw) = hw, crop_hw
    tops = torch.randint(0, h - ch + 1, (n,), generator=generator, device=device)
    lefts = torch.randint(0, w - cw + 1, (n,), generator=generator, device=device)
    return tops, lefts


def crop(images, tops, lefts, crop_hw):
    """Crop each sample of a NHWC batch to ``crop_hw`` at its offset."""
    ch, cw = crop_hw
    dev = images.device
    rows = tops.to(dev).view(-1, 1) + torch.arange(ch, device=dev)
    cols = lefts.to(dev).view(-1, 1) + torch.arange(cw, device=dev)
    batch = torch.arange(images.shape[0], device=dev).view(-1, 1, 1)
    return images[batch, rows[:, :, None], cols[:, None, :]]


def random_crop(images, crop_hw, generator=None):
    """Random spatial crop of a NHWC batch to ``crop_hw``."""
    tops, lefts = crop_draw(images.shape[0], images.shape[1:3], crop_hw, generator,
                            _draw_device(images, generator))
    return crop(images, tops, lefts, crop_hw)


def brightness_draw(n, max_delta=0.2, generator=None, device=None):
    """Per-sample additive deltas, uniform in ``[-max_delta, max_delta)``."""
    return _uniform(n, -max_delta, max_delta, generator, device)


def brightness(images, delta):
    """Add each sample's delta to a [0, 1] float NHWC batch, clipped."""
    return (images + delta.to(images.device).view(-1, 1, 1, 1)).clamp(0.0, 1.0)


def random_brightness(images, max_delta=0.2, generator=None):
    """Additive brightness jitter on [0, 1] float images."""
    return brightness(images, brightness_draw(images.shape[0], max_delta, generator,
                                              _draw_device(images, generator)))


def contrast_draw(n, lower=0.8, upper=1.2, generator=None, device=None):
    """Per-sample contrast factors, uniform in ``[lower, upper)``."""
    return _uniform(n, lower, upper, generator, device)


def contrast(images, factor):
    """Scale each sample around its own mean by its factor, clipped."""
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    return ((images - mean) * factor.to(images.device).view(-1, 1, 1, 1) + mean).clamp(0.0, 1.0)


def random_contrast(images, lower=0.8, upper=1.2, generator=None):
    """Multiplicative contrast jitter around the per-image mean."""
    return contrast(images, contrast_draw(images.shape[0], lower, upper, generator,
                                          _draw_device(images, generator)))
