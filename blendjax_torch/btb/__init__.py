"""blendjax_torch.btb — producer-side package, runs inside Blender's Python.

The port's copy of the part of ``blendjax.btb`` its slices use: the
launcher argument protocol and the data publisher, plus the pendulum
dynamics the world-model producer integrates (``pendulum``).  Attribute access
is lazy (PEP 562), and nothing here imports torch, so producer scripts run
under Blender's bundled interpreter.  The camera, offscreen and animation
modules are not ported yet.
"""

__version__ = "0.1.0"

_LAZY = {
    # name -> (module, attr)
    "parse_blendtorch_args": ("blendjax_torch.btb.arguments", "parse_blendtorch_args"),
    "BlendJaxArgs": ("blendjax_torch.btb.arguments", "BlendJaxArgs"),
    "DataPublisher": ("blendjax_torch.btb.publisher", "DataPublisher"),
}

_LAZY_MODULES = ("arguments", "publisher", "constants")


def __getattr__(name):
    import importlib

    if name in _LAZY:
        module, attr = _LAZY[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value
        return value
    if name in _LAZY_MODULES:
        mod = importlib.import_module(f"blendjax_torch.btb.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'blendjax_torch.btb' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list(_LAZY) + list(_LAZY_MODULES)))
