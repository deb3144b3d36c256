"""blendjax_torch.utils — stage timing, completion fences, device selection
and train-state checkpoints.

Import-light (PEP 562 lazy attributes): the torch-free producers and
services import ``blendjax_torch.utils.timing`` through this package, and
the fences import torch only when called.
"""

_EXPORTS = {
    "StageTimer": ("blendjax_torch.utils.timing", "StageTimer"),
    "value_fence": ("blendjax_torch.utils.fence", "value_fence"),
    "fence_chain": ("blendjax_torch.utils.fence", "fence_chain"),
    "fences_valid": ("blendjax_torch.utils.fence", "fences_valid"),
    "save_pytree": ("blendjax_torch.utils.checkpoint", "save_pytree"),
    "load_pytree": ("blendjax_torch.utils.checkpoint", "load_pytree"),
    "save_train_state": ("blendjax_torch.utils.checkpoint", "save_train_state"),
    "load_train_state": ("blendjax_torch.utils.checkpoint", "load_train_state"),
}


def __getattr__(name):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'blendjax_torch.utils' has no attribute {name!r}"
        ) from None
    import importlib

    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))
