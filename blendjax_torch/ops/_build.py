"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel source under ``csrc/`` exposes a plain C entry point and
includes no PyTorch header, so ``nvcc`` compiles it in seconds.  All of
them go into one shared library, built by
``torch.utils.cpp_extension.load`` (ninja, one ``nvcc`` per source, run in
parallel) for ``sm_90a`` into ``build/kernels`` at the repository root — a
directory ``.gitignore`` lists — the first time a wrapper launches a
kernel, and loaded once per process.  Nothing is prebuilt or fetched.  No
``--use_fast_math``: it would change ``powf``, ``expf`` and division and
break parity with the reference.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17"]
#: every kernel source of the port, under ``csrc/``
SOURCES = ["decode.cu", "flash_fwd.cu", "flash_fwd_tc.cu", "flash_bwd.cu",
           "flash_bwd_tc.cu", "layer_norm_fwd.cu", "layer_norm_bwd.cu"]

_lock = threading.Lock()
_library = None


def load_library() -> ctypes.CDLL:
    """Compile :data:`SOURCES` into the port's kernel library unless this
    process already has it, and return it.  A failed build raises; callers
    do not catch it."""
    global _library
    with _lock:
        if _library is None:
            from torch.utils.cpp_extension import load

            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            path = load(
                name="blendjax_torch_kernels",
                sources=[str(CSRC / s) for s in SOURCES],
                build_directory=str(BUILD_DIR),
                extra_cuda_cflags=CUDA_FLAGS,
                is_python_module=False,
                verbose=False,
            )
            _library = ctypes.CDLL(path)
        return _library
