"""blendjax_torch.ops — image ops and flash attention, with the hand-written
CUDA kernels (``csrc/``, built at first use by :mod:`blendjax_torch.ops._build`)."""
