"""blendjax_torch.btb — producer-side package, runs inside Blender's Python.

The port's copy of the part of ``blendjax.btb`` its slices use: the
launcher argument protocol, the data publisher and the duplex channel;
the animation event loop and the env layer (``BaseEnv``,
``RemoteControlledAgent``); the camera (``Camera`` over the pure
``camera_math``), the scene helpers (``utils``) and the offscreen
renderer (``OffScreenRenderer``); and the dynamics two producers
integrate without a scene (``pendulum`` for the world model, ``cartpole``
for control).  Attribute access is lazy (PEP 562), and nothing here
imports torch, so producer scripts run under Blender's bundled
interpreter; ``bpy``, ``gpu`` and ``mathutils`` are imported only inside
the functions that touch Blender, so every module imports anywhere.
"""

__version__ = "0.1.0"

_LAZY = {
    # name -> (module, attr)
    "parse_blendtorch_args": ("blendjax_torch.btb.arguments", "parse_blendtorch_args"),
    "BlendJaxArgs": ("blendjax_torch.btb.arguments", "BlendJaxArgs"),
    "DataPublisher": ("blendjax_torch.btb.publisher", "DataPublisher"),
    "DuplexChannel": ("blendjax_torch.btb.duplex", "DuplexChannel"),
    "Camera": ("blendjax_torch.btb.camera", "Camera"),
    "OffScreenRenderer": ("blendjax_torch.btb.offscreen", "OffScreenRenderer"),
    "BaseEnv": ("blendjax_torch.btb.env", "BaseEnv"),
    "RemoteControlledAgent": ("blendjax_torch.btb.env", "RemoteControlledAgent"),
    "AnimationController": ("blendjax_torch.btb.animation", "AnimationController"),
    "Signal": ("blendjax_torch.btb.signal", "Signal"),
}

_LAZY_MODULES = ("arguments", "publisher", "constants", "env", "animation", "signal",
                 "pendulum", "cartpole", "duplex", "camera", "camera_math", "utils",
                 "offscreen")


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
