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


# The CUDA kernel's launch plan (``decode_plan``), walked on the CPU as the
# kernel walks it: every element once, every bulk copy 16-byte aligned and
# inside its buffer, and each chunk decoded from the bytes its load brings.

_IN_BASE = 0x7F00_0000_0000  # 16-byte aligned; a case adds its offset
_OUT_BASE = 0x7F40_0000_0000
_C = timage.DECODE_CHUNK
_SIZES = {"1": 1, "15": 15, "16": 16, "17": 17, "1326": 1326, "chunk-1": _C - 1,
          "chunk": _C, "chunk+1": _C + 1, "132chunk+7": 132 * _C + 7,
          "7372800": 7_372_800}
_plan_grid = pytest.mark.parametrize("offset", range(16))
_plan_sizes = pytest.mark.parametrize("size", list(_SIZES))
_plan_dtypes = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
_plan_sms = pytest.mark.parametrize("sms", [1, 132])


def _plan(size, offset, dtype, sms):
    n = _SIZES[size]
    return n, timage.decode_plan(n, _IN_BASE + offset, _OUT_BASE, dtype, sms)


@_plan_grid
@_plan_sizes
@_plan_dtypes
@_plan_sms
def test_decode_plan_covers_each_element_once_with_aligned_bulk_copies(offset, size,
                                                                       dtype, sms):
    n, plan = _plan(size, offset, dtype, sms)
    esize = torch.tensor([], dtype=dtype).element_size()
    counts = np.zeros(n, dtype=np.int16)
    counts[:plan.lo] += 1
    counts[plan.hi:] += 1
    per_block = {}
    for (b, _, start, length, _, _, in_off, in_bytes, out_off,
         out_bytes) in timage.plan_copies(plan, dtype):
        counts[start:start + length] += 1
        per_block[b] = per_block.get(b, 0) + 1
        assert (_IN_BASE + offset + in_off) % 16 == 0 and in_bytes % 16 == 0
        assert (_OUT_BASE + out_off) % 16 == 0 and out_bytes % 16 == 0
        assert 0 <= in_off <= start and start + length <= in_off + in_bytes <= n
        assert in_bytes <= plan.chunk + 16 and out_bytes <= plan.chunk * esize
        assert out_off == start * esize and out_bytes == length * esize
    np.testing.assert_array_equal(counts, 1)
    assert plan.lo <= 31 and n - plan.hi <= 31  # the scalar head and tail stay short
    assert plan.grid <= sms and plan.smem <= timage.SMEM_PER_BLOCK
    if plan.chunks:
        assert sorted(per_block) == list(range(plan.grid))
        assert max(per_block.values()) - min(per_block.values()) <= 1
        assert 1 <= plan.stages <= max(per_block.values())
        assert plan.stages >= 2 or max(per_block.values()) == 1


@_plan_grid
@_plan_sizes
@_plan_dtypes
@_plan_sms
def test_decode_plan_emulated_chunk_by_chunk_equals_plain(offset, size, dtype, sms):
    """The kernel's dataflow on the CPU: each stage of the ring is loaded
    with a chunk's aligned input bytes and completes one barrier phase;
    the chunk waits for its stage's phase, decodes its bytes from
    ``shift`` on with the plain decode, and is stored at its output
    offset.  The head and tail go plain.  Bit-equal to the plain decode
    of the whole buffer."""
    n, plan = _plan(size, offset, dtype, sms)
    esize = torch.tensor([], dtype=dtype).element_size()
    x = np.random.default_rng(n + offset).integers(0, 256, size=n, dtype=np.uint8)

    def plain(a):
        return timage.decode_frames_plain(torch.from_numpy(a), dtype)

    out = torch.full((n,), float("nan"), dtype=dtype)
    out[:plan.lo] = plain(x[:plan.lo])
    out[plan.hi:] = plain(x[plan.hi:])
    copies = {}
    for c in timage.plan_copies(plan, dtype):
        copies.setdefault(c[0], []).append(c)
    for chunks in copies.values():
        ring, phases = [None] * plan.stages, [0] * plan.stages

        def load(c):
            ring[c[4]] = (c[1], x[c[6]:c[6] + c[7]])
            phases[c[4]] += 1

        for c in chunks[:plan.stages]:
            load(c)
        for j, (_, _, _, length, stage, parity, _, _, out_off, _) in enumerate(chunks):
            held, smem = ring[stage]
            assert held == j and (phases[stage] - 1) & 1 == parity
            out[out_off // esize:out_off // esize + length] = plain(
                smem[plan.shift:plan.shift + length])
            if j + plan.stages < len(chunks):
                load(chunks[j + plan.stages])
    want = plain(x)
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(view), want.view(view))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("blocks_per_sm", [1, 2])
def test_decode_plan_fits_shared_memory_and_refuses_what_the_kernel_cannot_take(
        dtype, blocks_per_sm):
    plan = timage.decode_plan(7_372_800, _IN_BASE, _OUT_BASE, dtype, 132,
                              blocks_per_sm=blocks_per_sm)
    budget = timage.SMEM_PER_SM // blocks_per_sm - timage.SMEM_RESERVED
    assert plan.smem <= min(budget, timage.SMEM_PER_BLOCK) and plan.stages >= 2
    assert plan.grid == 132 * blocks_per_sm
    with pytest.raises(ValueError, match="aligned"):
        timage.decode_plan(100, _IN_BASE, _OUT_BASE + 1, dtype, 132)
    with pytest.raises(ValueError, match="multiple of 128"):
        timage.decode_plan(100, _IN_BASE, _OUT_BASE, dtype, 132, chunk=48)
    with pytest.raises(ValueError, match="stages"):
        timage.decode_plan(100, _IN_BASE, _OUT_BASE, dtype, 132, chunk=1 << 16)
