"""``.btr`` <-> replay interop: hydrate a :class:`ReplayBuffer` from
recorded transition logs so off-policy training runs with zero Blender
processes.  A copy of ``blendjax.replay.prefill`` over the port's own
``btt/file.py``.

A *transition* message is the transition dict itself plus the quarantine
flag (``healthy``) riding in-band; pickled numpy arrays round-trip
exactly, so a buffer prefilled from a recording is bit-identical to one
fed the same transitions by direct appends.

Workflow::

    # live run, recording (fleet side):
    with FileRecorder("run_00.btr", max_messages=100000) as rec:
        for step in range(n):
            obs2, rew, done, infos = pool.step(actions)
            for i in range(pool.num_envs):
                rec.save(transition_to_message(
                    {"obs": obs[i], "action": actions[i],
                     "reward": rew[i], "next_obs": obs2[i],
                     "done": done[i]},
                    healthy=infos[i].get("healthy", True)))

    # later, no Blender anywhere:
    buf = ReplayBuffer(200000, seed=0)
    n = prefill_from_btr(buf, "run")          # every run_*.btr
    learner.run_offline(num_updates=..., batch_size=...)
"""

from __future__ import annotations

from glob import glob
from pathlib import Path

from blendjax_torch.btt.file import FileReader
from blendjax_torch.replay.buffer import HEALTHY_KEY, SCENARIO_KEY


def transition_to_message(transition, *, healthy=True, scenario=None):
    """Transition dict -> recordable message: the dict itself with the
    quarantine flag in-band under :data:`HEALTHY_KEY` and (when known)
    the scenario id under :data:`SCENARIO_KEY` — both consumed back
    into per-slot bookkeeping by :meth:`ReplayBuffer.append`."""
    msg = dict(transition)
    msg[HEALTHY_KEY] = bool(msg.get(HEALTHY_KEY, True)) and bool(healthy)
    if scenario is not None and SCENARIO_KEY not in msg:
        msg[SCENARIO_KEY] = str(scenario)
    return msg


def message_to_transition(message):
    """Recorded message -> ``(transition, healthy)``; the inverse of
    :func:`transition_to_message` (the health flag stripped from the
    dict; a :data:`SCENARIO_KEY` stamp stays in-band for ``append``)."""
    transition = dict(message)
    healthy = bool(transition.pop(HEALTHY_KEY, True))
    return transition, healthy


def iter_btr_transitions(prefix_or_paths):
    """Yield ``(transition, healthy)`` from ``.btr`` recordings.

    ``prefix_or_paths``: an explicit path / list of paths, or a prefix
    matching ``{prefix}_*.btr`` (the ``FileRecorder.filename`` per-worker
    scheme) — files are visited in sorted order so the append sequence
    is deterministic.
    """
    if isinstance(prefix_or_paths, (str, Path)):
        p = Path(prefix_or_paths)
        if p.exists():
            paths = [p]
        else:
            paths = sorted(glob(f"{prefix_or_paths}_*.btr"))
            if not paths:
                raise FileNotFoundError(
                    f"no .btr file or recordings matching {prefix_or_paths}_*.btr"
                )
    else:
        paths = list(prefix_or_paths)
    for path in paths:
        reader = FileReader(path)
        try:
            for i in range(len(reader)):
                yield message_to_transition(reader[i])
        finally:
            reader.close()


def prefill_from_btr(buffer, prefix_or_paths, *, transform=None, limit=None):
    """Hydrate ``buffer`` from recorded transition logs; returns the
    number of transitions appended.

    ``transform`` (optional) maps each raw message dict to a transition
    dict (or None to skip it) — for recordings whose messages are not
    already transition-shaped.  The quarantine flag is honored either
    way.  ``limit`` caps the appends (the ring evicts oldest-first beyond
    capacity regardless).
    """
    appended = 0
    for transition, healthy in iter_btr_transitions(prefix_or_paths):
        if limit is not None and appended >= limit:
            break
        if transform is not None:
            transition = transform(transition)
            if transition is None:
                continue
        buffer.append(transition, healthy=healthy)
        appended += 1
    return appended
