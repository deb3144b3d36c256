"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel source under ``csrc/`` exposes a plain C entry point and
includes no PyTorch header, so ``nvcc`` compiles it in seconds.  It is
built by ``torch.utils.cpp_extension.load`` (ninja) for ``sm_90a`` into
``build/kernels`` at the repository root — a directory ``.gitignore``
lists — the first time a wrapper launches it, and loaded once per process.
Nothing is prebuilt or fetched.  No ``--use_fast_math``: it would change
``powf`` and division and break parity with the reference.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17"]

_lock = threading.Lock()
_libraries: dict = {}


def load_library(name, sources) -> ctypes.CDLL:
    """Compile ``sources`` (file names under ``csrc/``) into the shared
    library ``name`` unless this process already has it, and return it.
    A failed build raises; callers do not catch it."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            from torch.utils.cpp_extension import load

            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            path = load(
                name=name,
                sources=[str(CSRC / s) for s in sources],
                build_directory=str(BUILD_DIR),
                extra_cuda_cflags=CUDA_FLAGS,
                is_python_module=False,
                verbose=False,
            )
            lib = _libraries[name] = ctypes.CDLL(path)
        return lib
