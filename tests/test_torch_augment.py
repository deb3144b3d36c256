"""The port's augmentation (``blendjax_torch.ops.augment``) against
``blendjax.ops.augment`` on the CPU.

Each JAX function runs with a fixed key; its draws (the flip mask, crop
offsets, brightness deltas, contrast factors) are recomputed from the same
key the way it draws them and fed to the port's deterministic part.
Tolerances: flips and crops exact (they move values); brightness exact
(one f32 add and a clip); contrast within 1e-6 absolute (the per-image
mean is a reduction whose order differs between the libraries).  The
port's own draws are checked for range, shape and determinism per seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax.ops import augment as jaug
from blendjax_torch.ops import augment as taug

N, H, W, C = 6, 12, 10, 3


def _images(seed=0):
    return np.random.default_rng(seed).random((N, H, W, C)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hflip_matches_reference(seed):
    key = jax.random.PRNGKey(seed)
    x = _images(seed)
    kps = np.random.default_rng(seed + 9).random((N, 4, 2)).astype(np.float32) * W
    want, want_k = jaug.random_hflip(key, jnp.asarray(x), jnp.asarray(kps))
    flip = np.array(jax.random.bernoulli(key, 0.5, (N,)))
    got, got_k = taug.hflip(torch.from_numpy(x), torch.from_numpy(flip), torch.from_numpy(kps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(
        taug.hflip(torch.from_numpy(x), torch.from_numpy(flip)).numpy(),
        np.asarray(jaug.random_hflip(key, jnp.asarray(x))))


@pytest.mark.parametrize("crop_hw", [(8, 6), (12, 10), (1, 1)])
def test_crop_matches_reference(crop_hw):
    key = jax.random.PRNGKey(4)
    x = _images(4)
    want = jaug.random_crop(key, jnp.asarray(x), crop_hw)
    ky, kx = jax.random.split(key)
    tops = np.array(jax.random.randint(ky, (N,), 0, H - crop_hw[0] + 1))
    lefts = np.array(jax.random.randint(kx, (N,), 0, W - crop_hw[1] + 1))
    got = taug.crop(torch.from_numpy(x), torch.from_numpy(tops), torch.from_numpy(lefts),
                    crop_hw)
    assert tuple(got.shape) == (N, *crop_hw, C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("max_delta", [0.2, 0.6])
def test_brightness_matches_reference(max_delta):
    key = jax.random.PRNGKey(5)
    x = _images(5)
    want = jaug.random_brightness(key, jnp.asarray(x), max_delta)
    delta = np.array(jax.random.uniform(key, (N, 1, 1, 1), minval=-max_delta,
                                          maxval=max_delta)).reshape(N)
    got = taug.brightness(torch.from_numpy(x), torch.from_numpy(delta))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bounds", [(0.8, 1.2), (0.2, 3.0)])
def test_contrast_matches_reference(bounds):
    key = jax.random.PRNGKey(6)
    x = _images(6)
    want = jaug.random_contrast(key, jnp.asarray(x), *bounds)
    factor = np.array(jax.random.uniform(key, (N, 1, 1, 1), minval=bounds[0],
                                           maxval=bounds[1])).reshape(N)
    got = taug.contrast(torch.from_numpy(x), torch.from_numpy(factor))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_draws_range_shape_and_determinism():
    x = torch.from_numpy(_images(7))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return (taug.random_hflip(x, g), taug.random_crop(x, (5, 4), g),
                taug.random_brightness(x, 0.3, g), taug.random_contrast(x, 0.5, 1.5, g))

    a, b, c = run(1), run(1), run(2)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not all(torch.equal(u, v) for u, v in zip(a, c))
    assert tuple(a[1].shape) == (N, 5, 4, C)
    g = torch.Generator().manual_seed(0)
    flips = taug.flip_draw(4000, g)
    assert flips.dtype == torch.bool and 0.45 < flips.float().mean() < 0.55
    tops, lefts = taug.crop_draw(4000, (H, W), (8, 6), g)
    assert int(tops.min()) == 0 and int(tops.max()) == H - 8
    assert int(lefts.min()) == 0 and int(lefts.max()) == W - 6
    d = taug.brightness_draw(4000, 0.2, g)
    assert float(d.min()) >= -0.2 and float(d.max()) < 0.2
    f = taug.contrast_draw(4000, 0.8, 1.2, g)
    assert float(f.min()) >= 0.8 and float(f.max()) < 1.2
    for out in a[2:]:
        assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


def test_draws_follow_the_generator_and_move_to_the_images():
    """A generator on one device with images on another: each draw is made
    on the generator's device and moved to the images' (keypoints
    included).  The images lie on the ``meta`` device, which no CPU
    generator can draw on, so a draw made on the images' device raises."""
    g = torch.Generator().manual_seed(3)
    x = torch.empty((N, H, W, C), device="meta")
    kps = torch.from_numpy(np.random.default_rng(3).random((N, 4, 2)).astype(np.float32) * W)
    flipped, got_k = taug.random_hflip(x, g, kps)
    assert flipped.device.type == "meta" and got_k.device.type == "cpu"
    assert taug.random_crop(x, (5, 4), g).shape == (N, 5, 4, C)
    assert taug.random_brightness(x, 0.3, g).device.type == "meta"
    assert taug.random_contrast(x, 0.5, 1.5, g).device.type == "meta"
    # the keypoints' flip is the images' flip: replay the draw on the CPU
    flip = taug.flip_draw(N, torch.Generator().manual_seed(3))
    xc = torch.from_numpy(_images(3))
    want_x, want_k = taug.hflip(xc, flip, kps)
    got_x, got_k2 = taug.random_hflip(xc, torch.Generator().manual_seed(3), kps)
    assert torch.equal(got_x, want_x) and torch.equal(got_k2, want_k)
    assert torch.equal(got_k, want_k)
