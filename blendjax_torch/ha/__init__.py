"""blendjax_torch.ha — learner failover, the port of ``blendjax.ha``:

- :class:`~blendjax_torch.ha.checkpoint.TrainCheckpointer`, a coordinated,
  atomic, versioned cut of the learner-side state (TrainState, update
  counter, seed, the replay buffer's draw state), taken off the update loop
  and committed by a manifest; the files are the reference's, so a cut
  written by either package restores in the other;
- ``python -m blendjax_torch.ha.learner``, the supervised learner process,
  which resumes from the latest complete manifest at startup;
- :class:`~blendjax_torch.ha.supervisor.LearnerProcess` and
  :class:`~blendjax_torch.ha.supervisor.LearnerSupervisor`, the
  launcher-compatible surface ``FleetWatchdog(restart=True)`` respawns, with
  a flight-recorder postmortem naming the dead learner.

Attribute access is lazy, so importing the package imports neither torch
nor the modules behind it.
"""

_LAZY = {
    "MANIFEST_FORMAT": "blendjax_torch.ha.checkpoint",
    "TrainCheckpointer": "blendjax_torch.ha.checkpoint",
    "latest_manifest": "blendjax_torch.ha.checkpoint",
    "restore_replay": "blendjax_torch.ha.checkpoint",
    "LearnerProcess": "blendjax_torch.ha.supervisor",
    "LearnerSupervisor": "blendjax_torch.ha.supervisor",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    import importlib

    if name in _LAZY:
        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'blendjax_torch.ha' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list(_LAZY)))
