"""blendjax_torch.replay — experience replay: columnar ring storage,
prioritized sampling and ``.btr`` prefill, the port of ``blendjax.replay``::

    from blendjax_torch.replay import ReplayBuffer, prefill_from_btr

    buf = ReplayBuffer(100_000, seed=0, prioritized=True)
    buf.append({"obs": o, "action": a, "reward": r,
                "next_obs": o2, "done": d}, healthy=True)
    data, idx, w = buf.sample(32)
    buf.update_priorities(idx, errors)

The sharded replay service: :class:`ShardedReplay` over shard processes
(:mod:`blendjax_torch.replay.service`, ``ShardFleet``).  Attribute access
is lazy, so a shard process imports none of the learner's modules.
"""

_LAZY = {
    "HEALTHY_KEY": ("blendjax_torch.replay.buffer", "HEALTHY_KEY"),
    "SCENARIO_KEY": ("blendjax_torch.replay.buffer", "SCENARIO_KEY"),
    "ReplayBuffer": ("blendjax_torch.replay.buffer", "ReplayBuffer"),
    "ColumnStore": ("blendjax_torch.replay.ring", "ColumnStore"),
    "SumTree": ("blendjax_torch.replay.sumtree", "SumTree"),
    "ShardedReplay": ("blendjax_torch.replay.shard_client", "ShardedReplay"),
    "ShardClient": ("blendjax_torch.replay.shard_client", "ShardClient"),
    "ShardRPCError": ("blendjax_torch.replay.shard_client", "ShardRPCError"),
    "ReplayShard": ("blendjax_torch.replay.service", "ReplayShard"),
    "ShardFleet": ("blendjax_torch.replay.service", "ShardFleet"),
    "start_shard_thread": ("blendjax_torch.replay.service", "start_shard_thread"),
    "prefill_from_btr": ("blendjax_torch.replay.prefill", "prefill_from_btr"),
    "iter_btr_transitions": ("blendjax_torch.replay.prefill", "iter_btr_transitions"),
    "transition_to_message": ("blendjax_torch.replay.prefill", "transition_to_message"),
    "message_to_transition": ("blendjax_torch.replay.prefill", "message_to_transition"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    import importlib

    if name in _LAZY:
        module, attr = _LAZY[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'blendjax_torch.replay' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list(_LAZY)))
