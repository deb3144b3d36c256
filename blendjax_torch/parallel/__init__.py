"""blendjax_torch.parallel — attention across the sequence axis, and the
multi-fleet actor-learner's segment fan-in and fleet sets.  Of the
attention schemes only the single-device reference,
:func:`ring_attention.full_attention`, is ported so far; the ring,
zigzag and Ulysses schemes and the mesh wait for the parallel layer
(ROADMAP Queue 1, item 7).  Attribute access is lazy."""

_LAZY = {
    "FleetSet": ("blendjax_torch.parallel.podracer", "FleetSet"),
    "SegmentFanIn": ("blendjax_torch.parallel.podracer", "SegmentFanIn"),
    "make_segment_loss": ("blendjax_torch.parallel.podracer", "make_segment_loss"),
    "padded_size": ("blendjax_torch.parallel.podracer", "padded_size"),
}


def __getattr__(name):
    import importlib

    if name in _LAZY:
        module, attr = _LAZY[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'blendjax_torch.parallel' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list(_LAZY)))
