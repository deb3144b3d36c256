"""Image ops for the device-side input pipeline.

The hot path of the datagen workload is: uint8 frames off the wire ->
float (optionally linearized) feeding a conv net.  Frames ship as uint8
(4x less bandwidth than float32) and are decoded on the card.

Two implementations of the decode:

- :func:`decode_frames_plain` — plain PyTorch, the arithmetic of
  ``blendjax.ops.image.decode_frames``; what a CPU tensor gets.
- :func:`decode_frames_cuda` — the hand-written CUDA kernel
  (``csrc/decode.cu``) that replaces the Pallas TPU kernel
  ``blendjax.ops.image._decode_kernel``.

:func:`decode_frames` dispatches on the tensor's device: a CUDA tensor
always goes through the kernel (a failed build or launch raises, there is
no fallback), a CPU tensor through the plain version.  The kernel's launch
(grid, each block's chunks, the ring's depth, the unaligned head and tail)
is planned here in Python by :func:`decode_plan`, and :func:`plan_copies`
walks it as the kernel does, so the CPU tests reach the partition.
"""

from __future__ import annotations

import ctypes

import torch

_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_ELEMENT_SIZE = {torch.float32: 4, torch.bfloat16: 2}


# sRGB <-> linear (IEC 61966-2-1)


def srgb_to_linear(x):
    """Decode sRGB-encoded [0,1] floats to linear light."""
    return torch.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x):
    """Encode linear-light [0,1] floats to sRGB."""
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, x * 12.92, 1.055 * x ** (1 / 2.4) - 0.055)


def normalize(x, mean, std):
    """(x - mean) / std with broadcasting over the channel axis."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def decode_frames_plain(frames_u8, dtype=torch.float32, linearize=False):
    """Plain PyTorch decode: ``x * (1/255)`` in f32 (not ``x / 255``, which
    differs in the last bit for some values), optional sRGB -> linear,
    cast to ``dtype``."""
    x = frames_u8.to(torch.float32) * (1.0 / 255.0)
    if linearize:
        x = srgb_to_linear(x)
    return x.to(dtype)


#: Hopper's shared memory: 228 KB on each SM, at most 227 KB for one
#: block, and 1 KB of each block's kept by the system.
SMEM_PER_SM = 233_472
SMEM_PER_BLOCK = 232_448
SMEM_RESERVED = 1_024
#: input bytes (elements) per chunk of the decode's bulk-copy ring: with one
#: block per SM the ring holds a block's whole share of (8, 480, 640, 3)
#: in bf16; 4,096 to 16,384 measured within 0.3 us of each other there
DECODE_CHUNK = 8192


class DecodePlan(ctypes.Structure):
    """The decode kernel's launch, as ``csrc/decode.cu``'s ``Plan`` reads it.

    Chunks of ``chunk`` elements cover ``[lo, hi)`` (the last one short);
    ``[0, lo)`` and ``[hi, n)`` go through plain loads and stores.  Block
    ``b`` of ``grid`` takes the contiguous chunks from ``b*q + min(b, r)``,
    ``q + (b < r)`` of them (``q, r = divmod(chunks, grid)``), through a
    ring of ``stages`` stages.  A chunk's input is loaded from the 16-byte
    granule holding its first byte, ``shift`` bytes before it; ``smem`` is
    the block's dynamic shared memory."""

    _fields_ = [(name, ctypes.c_longlong) for name in
                ("lo", "hi", "chunk", "chunks", "grid", "stages", "shift", "smem")]


def decode_plan(n, in_addr, out_addr, dtype, sm_count, chunk=DECODE_CHUNK,
                blocks_per_sm=1):
    """The decode kernel's launch for ``n`` elements from byte address
    ``in_addr`` to ``dtype`` outputs at ``out_addr`` on a card of
    ``sm_count`` SMs: a :class:`DecodePlan`.  Every bulk copy it implies
    (see :func:`plan_copies`) has 16-byte addresses and sizes and stays
    inside the two buffers.  Raises ValueError for an output address that
    is not a multiple of the element size, a chunk that is not a positive
    multiple of 128, or one too large for two stages in shared memory."""
    esize = _ELEMENT_SIZE[dtype]
    if out_addr % esize:
        raise ValueError(f"decode output address {out_addr:#x} is not {esize}-byte aligned")
    if chunk <= 0 or chunk % 128:
        raise ValueError(f"decode chunk {chunk} is not a positive multiple of 128")
    unit = 16 // esize  # elements per 16-byte output unit
    in_mod, out_mod = in_addr % 16, out_addr % 16
    # the first element whose output is 16-byte aligned and whose input
    # granule starts inside the buffer
    lo = next(e for e in range((16 - in_mod) % 16, 32)
              if (out_mod + e * esize) % 16 == 0)
    # the last one whose input granule ends inside it, whole units from lo
    hi_max = (in_mod + n) // 16 * 16 - in_mod
    if hi_max - lo < unit:
        return DecodePlan(0, 0, chunk, 0, 1, 0, 0, 0)
    hi = lo + (hi_max - lo) // unit * unit
    # input (chunk + 16 bytes, each stage on 128 bytes), output, mbarrier
    stage_bytes = chunk + 128 + chunk * esize + 8
    budget = min(SMEM_PER_BLOCK, SMEM_PER_SM // blocks_per_sm - SMEM_RESERVED)
    if budget // stage_bytes < 2:
        raise ValueError(f"decode chunk {chunk} leaves fewer than 2 stages in "
                         f"{budget} bytes of shared memory")
    chunks = -(-(hi - lo) // chunk)
    grid = min(sm_count * blocks_per_sm, chunks)
    stages = min(budget // stage_bytes, -(-chunks // grid))
    return DecodePlan(lo, hi, chunk, chunks, grid, stages, (in_mod + lo) % 16,
                      stages * stage_bytes)


def plan_copies(plan, dtype):
    """What the kernel does under ``plan``, block by block and chunk by
    chunk, as ``(block, j, start, length, stage, parity, in_offset,
    in_bytes, out_offset, out_bytes)``: chunk ``j`` of ``block`` holds
    elements ``[start, start + length)``, waits for phase ``parity`` of its
    ``stage``'s barrier, and is loaded from ``in_offset`` (bytes past the
    input's base) and stored to ``out_offset`` (bytes past the output's)."""
    esize = _ELEMENT_SIZE[dtype]
    q, r = divmod(plan.chunks, plan.grid)
    for b in range(plan.grid):
        first = b * q + min(b, r)
        for j in range(q + (b < r)):
            start = plan.lo + (first + j) * plan.chunk
            length = min(plan.chunk, plan.hi - start)
            in_bytes = -(-(length + plan.shift) // 16) * 16
            yield (b, j, start, length, j % plan.stages, (j // plan.stages) & 1,
                   start - plan.shift, in_bytes, start * esize, length * esize)


def _kernel():
    from blendjax_torch.ops._build import load_library

    lib = load_library()
    fn = lib.bjx_decode_u8
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(DecodePlan), ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def decode_frames_cuda(frames_u8, dtype=torch.bfloat16, linearize=False):
    """Launch the CUDA decode kernel on a contiguous uint8 CUDA tensor of
    any shape; returns a new tensor of ``dtype`` (float32 or bfloat16) and
    the same shape.  Raises ValueError for anything else.  Launches on the
    current stream without synchronising, under :func:`decode_plan` for
    the card's SM count; :attr:`launches` counts launches."""
    if not isinstance(frames_u8, torch.Tensor) or not frames_u8.is_cuda:
        raise ValueError("decode_frames_cuda needs a CUDA tensor")
    if frames_u8.dtype != torch.uint8:
        raise ValueError(f"decode_frames_cuda needs uint8 input, got {frames_u8.dtype}")
    if dtype not in _ELEMENT_SIZE:
        raise ValueError(f"decode_frames_cuda outputs float32 or bfloat16, not {dtype}")
    if not frames_u8.is_contiguous():
        raise ValueError("decode_frames_cuda needs a contiguous input")
    out = torch.empty(frames_u8.shape, dtype=dtype, device=frames_u8.device)
    n = frames_u8.numel()
    if n == 0:
        return out
    sms = torch.cuda.get_device_properties(frames_u8.device).multi_processor_count
    plan = decode_plan(n, frames_u8.data_ptr(), out.data_ptr(), dtype, sms)
    fn = _kernel()
    with torch.cuda.device(frames_u8.device):
        stream = torch.cuda.current_stream(frames_u8.device).cuda_stream
        err = fn(frames_u8.data_ptr(), out.data_ptr(), n, _OUT_KINDS[dtype],
                 int(bool(linearize)), ctypes.byref(plan), stream)
    if err != 0:
        raise RuntimeError(f"decode kernel launch failed: cudaError_t {err}")
    decode_frames_cuda.launches += 1
    return out


decode_frames_cuda.launches = 0


def decode_frames(frames_u8, dtype=torch.float32, linearize=False, mean=None,
                  std=None):
    """uint8 [0,255] frames -> ``dtype`` floats.

    Params
    ------
    frames_u8: uint8 tensor, any shape (typically NHWC).
    dtype: output dtype (``torch.bfloat16`` feeds bf16 convs directly).
    linearize: apply sRGB -> linear decode.
    mean/std: optional per-channel normalization (broadcast over the
        trailing channel axis), applied in float32 before the final cast.
    """
    if mean is None and std is None:
        if frames_u8.is_cuda:
            return decode_frames_cuda(frames_u8.contiguous(), dtype, linearize)
        return decode_frames_plain(frames_u8, dtype, linearize)
    if frames_u8.is_cuda:
        x = decode_frames_cuda(frames_u8.contiguous(), torch.float32, linearize)
    else:
        x = decode_frames_plain(frames_u8, torch.float32, linearize)
    if mean is not None:
        x = x - torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    if std is not None:
        x = x / torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return x.to(dtype)
