"""blendjax_torch — the PyTorch/CUDA port of blendjax.

N Blender processes render randomized scenes and stream images and
annotations over ZMQ into a PyTorch training pipeline on an NVIDIA GPU.
The package mirrors ``blendjax``'s layout module for module but imports
nothing from it: where it needs one of blendjax's framework-free modules
(``wire``, ``btb``, the dataset/loader side of ``btt``) it keeps its own
copy, trimmed to what the port uses.

Subpackages
-----------
- ``blendjax_torch.btt``    consumer side: launcher, streaming dataset,
  record/replay, threaded loader, the pinned-memory CUDA device feed.
- ``blendjax_torch.btb``    producer side (runs inside Blender's Python);
  needs neither torch nor a GPU.
- ``blendjax_torch.ops``    image ops, incl. the hand-written CUDA decode
  kernel for the uint8 -> bf16/f32 frame path.
- ``blendjax_torch.models`` TinyDetector, its layers and the train step.
- ``blendjax_torch.obs`` / ``blendjax_torch.utils``  stage timing and
  latency histograms.

Importing this package pulls in neither torch nor zmq (PEP 562 lazy
attributes), so the same tree serves Blender's embedded Python.
"""

__version__ = "0.1.0"

_SUBMODULES = ("btt", "btb", "datagen", "models", "obs", "ops", "utils", "wire")


def __getattr__(name):  # PEP 562 lazy subpackage access
    if name in _SUBMODULES:
        import importlib

        mod = importlib.import_module(f"blendjax_torch.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'blendjax_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
