"""blendjax_torch.replay — experience replay: columnar ring storage,
prioritized sampling and ``.btr`` prefill, the port of ``blendjax.replay``::

    from blendjax_torch.replay import ReplayBuffer, prefill_from_btr

    buf = ReplayBuffer(100_000, seed=0, prioritized=True)
    buf.append({"obs": o, "action": a, "reward": r,
                "next_obs": o2, "done": d}, healthy=True)
    data, idx, w = buf.sample(32)
    buf.update_priorities(idx, errors)

The sharded replay service (``ShardedReplay``) is not ported (ROADMAP
Queue 1, item 9).  Attribute access is lazy.
"""

_LAZY = {
    "HEALTHY_KEY": ("blendjax_torch.replay.buffer", "HEALTHY_KEY"),
    "SCENARIO_KEY": ("blendjax_torch.replay.buffer", "SCENARIO_KEY"),
    "ReplayBuffer": ("blendjax_torch.replay.buffer", "ReplayBuffer"),
    "ColumnStore": ("blendjax_torch.replay.ring", "ColumnStore"),
    "SumTree": ("blendjax_torch.replay.sumtree", "SumTree"),
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
