"""blendjax_torch.parallel — meshes over torch ranks, sharding rules and the
sharded train step, the multi-fleet actor-learner's segment fan-in and
fleet sets, and attention across the sequence axis.  Of the attention
schemes only the single-device reference,
:func:`ring_attention.full_attention`, is ported so far; the ring, zigzag
and Ulysses schemes, ``make_seqformer_train_step`` and the pipeline wait
for ROADMAP Queue 1, item 7 (7c and 7d).  Attribute access is lazy."""

_LAZY = {
    "data_mesh": ("blendjax_torch.parallel.mesh", "data_mesh"),
    "data_sharding": ("blendjax_torch.parallel.mesh", "data_sharding"),
    "make_mesh": ("blendjax_torch.parallel.mesh", "make_mesh"),
    "replicated": ("blendjax_torch.parallel.mesh", "replicated"),
    "FleetSet": ("blendjax_torch.parallel.podracer", "FleetSet"),
    "SegmentFanIn": ("blendjax_torch.parallel.podracer", "SegmentFanIn"),
    "make_segment_loss": ("blendjax_torch.parallel.podracer", "make_segment_loss"),
    "padded_size": ("blendjax_torch.parallel.podracer", "padded_size"),
    "detector_rules": ("blendjax_torch.parallel.sharding", "detector_rules"),
    "seqformer_rules": ("blendjax_torch.parallel.sharding", "seqformer_rules"),
    "make_sharded_train_step": ("blendjax_torch.parallel.sharding", "make_sharded_train_step"),
    "make_seqformer_train_step": ("blendjax_torch.parallel.sharding",
                                  "make_seqformer_train_step"),
    "param_specs": ("blendjax_torch.parallel.sharding", "param_specs"),
    "shard_pytree": ("blendjax_torch.parallel.sharding", "shard_pytree"),
    "full_attention": ("blendjax_torch.parallel.ring_attention", "full_attention"),
}

__all__ = sorted(_LAZY)


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
