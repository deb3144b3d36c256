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
no fallback), a CPU tensor through the plain version.
"""

from __future__ import annotations

import ctypes

import torch

_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}


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


def _kernel():
    from blendjax_torch.ops._build import load_library

    lib = load_library()
    fn = lib.bjx_decode_u8
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def decode_frames_cuda(frames_u8, dtype=torch.bfloat16, linearize=False):
    """Launch the CUDA decode kernel on a contiguous uint8 CUDA tensor of
    any shape; returns a new tensor of ``dtype`` (float32 or bfloat16) and
    the same shape.  Raises ValueError for anything else.  Launches on the
    current stream without synchronising; :attr:`launches` counts
    launches."""
    if not isinstance(frames_u8, torch.Tensor) or not frames_u8.is_cuda:
        raise ValueError("decode_frames_cuda needs a CUDA tensor")
    if frames_u8.dtype != torch.uint8:
        raise ValueError(f"decode_frames_cuda needs uint8 input, got {frames_u8.dtype}")
    if dtype not in _OUT_KINDS:
        raise ValueError(f"decode_frames_cuda outputs float32 or bfloat16, not {dtype}")
    if not frames_u8.is_contiguous():
        raise ValueError("decode_frames_cuda needs a contiguous input")
    out = torch.empty(frames_u8.shape, dtype=dtype, device=frames_u8.device)
    fn = _kernel()
    with torch.cuda.device(frames_u8.device):
        stream = torch.cuda.current_stream(frames_u8.device).cuda_stream
        err = fn(frames_u8.data_ptr(), out.data_ptr(), frames_u8.numel(),
                 _OUT_KINDS[dtype], int(bool(linearize)), stream)
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
