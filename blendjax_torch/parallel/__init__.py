"""blendjax_torch.parallel — meshes over torch ranks, sharding rules and the
sharded train steps, the multi-fleet actor-learner's segment fan-in and
fleet sets, attention across the sequence axis (ring, ring + flash,
zigzag and Ulysses, :mod:`ring_attention`, over the rank exchange of
:mod:`p2p`), and pipeline parallelism: the SPMD GPipe and 1F1B pipeline
over a mesh axis (:mod:`pipeline`) and the MPMD stage processes
(:mod:`mpmd`, :mod:`stage`).  Attribute access is lazy."""

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
    "make_ring_attention": ("blendjax_torch.parallel.ring_attention", "make_ring_attention"),
    "ring_attention": ("blendjax_torch.parallel.ring_attention", "ring_attention"),
    "ring_flash_attention": ("blendjax_torch.parallel.ring_attention",
                             "ring_flash_attention"),
    "ulysses_attention": ("blendjax_torch.parallel.ring_attention", "ulysses_attention"),
    "zigzag_flash_attention": ("blendjax_torch.parallel.ring_attention",
                               "zigzag_flash_attention"),
    "make_pipeline": ("blendjax_torch.parallel.pipeline", "make_pipeline"),
    "make_pipeline_train": ("blendjax_torch.parallel.pipeline", "make_pipeline_train"),
    "microbatch": ("blendjax_torch.parallel.pipeline", "microbatch"),
    "stack_stage_params": ("blendjax_torch.parallel.pipeline", "stack_stage_params"),
    "unstack_stage_params": ("blendjax_torch.parallel.pipeline", "unstack_stage_params"),
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
