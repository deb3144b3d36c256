"""The port's image ops against the JAX package's: the plain decode against
``blendjax.ops.image.decode_frames`` and the Pallas kernel (interpret mode),
the sRGB curves and mean/std, and the CUDA kernel's wrapper contract.

The CUDA kernel itself runs only on a GPU: ``chip_smoke.py`` holds it
against the plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax.ops import image as jimage
from blendjax_torch.ops import image as timage

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _frames():
    rng = np.random.default_rng(0)
    return {
        "odd": rng.integers(0, 256, size=(2, 13, 17, 3), dtype=np.uint8),
        "ramp": np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1),
    }


def _np(x):
    """Tensor or jax array -> float32 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("name", ["odd", "ramp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("linearize", [False, True])
def test_plain_decode_matches_jax(name, dtype, linearize):
    frames = _frames()[name]
    atol = 1e-6 if linearize else 1e-7
    out = timage.decode_frames(torch.from_numpy(frames), dtype=dtype,
                               linearize=linearize)
    assert out.dtype == dtype and tuple(out.shape) == frames.shape
    ref = jimage.decode_frames(jnp.asarray(frames), dtype=_JDT[dtype],
                               linearize=linearize)
    pallas = jimage.decode_frames_pallas(jnp.asarray(frames), dtype=_JDT[dtype],
                                         linearize=linearize, interpret=True)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=atol)
    np.testing.assert_allclose(_np(out), _np(pallas), rtol=0, atol=atol)


def test_decode_multiplies_by_reciprocal():
    """``x * (1/255)`` and ``x / 255`` differ in the last bit for some
    bytes; the port must take the reference's form exactly."""
    ramp = np.arange(256, dtype=np.uint8)
    out = timage.decode_frames(torch.from_numpy(ramp)).numpy()
    expect = ramp.astype(np.float32) * np.float32(1.0 / 255.0)
    np.testing.assert_array_equal(out, expect)
    assert np.any(expect != ramp.astype(np.float32) / np.float32(255.0))


def test_srgb_curves_match_jax():
    x = np.linspace(0.0, 1.0, 1001, dtype=np.float32)
    lin = timage.srgb_to_linear(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(lin, np.asarray(jimage.srgb_to_linear(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    enc = timage.linear_to_srgb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(enc, np.asarray(jimage.linear_to_srgb(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(timage.linear_to_srgb(torch.from_numpy(lin)).numpy(),
                               x, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mean_std_match_jax(dtype):
    frames = _frames()["odd"]
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    out = timage.decode_frames(torch.from_numpy(frames), dtype=dtype,
                               linearize=True, mean=mean, std=std)
    ref = jimage.decode_frames(jnp.asarray(frames), dtype=_JDT[dtype],
                               linearize=True, mean=mean, std=std)
    if dtype == torch.float32:
        # the linearize limit 1e-6, scaled by 1/std after normalization
        np.testing.assert_allclose(_np(out), _np(ref), rtol=0,
                                   atol=1e-6 / min(std))
    else:  # one bf16 rounding of the same float32 value
        np.testing.assert_allclose(_np(out), _np(ref), rtol=2.0 ** -8)
    x = np.random.default_rng(1).random((4, 3), dtype=np.float32)
    np.testing.assert_allclose(
        timage.normalize(torch.from_numpy(x), mean, std).numpy(),
        np.asarray(jimage.normalize(jnp.asarray(x), mean, std)), atol=1e-6)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    u8 = torch.zeros((2, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        timage.decode_frames_cuda(u8)  # a CPU tensor never reaches the kernel
    before = timage.decode_frames_cuda.launches
    timage.decode_frames(u8)  # CPU dispatch: plain version, no launch
    assert timage.decode_frames_cuda.launches == before
