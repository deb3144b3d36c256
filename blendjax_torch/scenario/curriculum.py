"""Curriculum scheduler: reweights the fleet's scenario mix on an interval
from per-scenario replay evidence, the port of
``blendjax.scenario.curriculum``.

Three policies (docs/scenarios.md):

- ``uniform`` — every scenario carries equal weight forever; the mix
  never changes, and the replay draw stream is byte-identical to a
  scenario-less run;
- ``prioritized`` — weight follows per-scenario TD-priority evidence from
  the replay strata (:meth:`blendjax_torch.replay.ReplayBuffer.scenario_stats`):
  scenarios whose rows carry larger error magnitudes (``priority_mass``
  per eligible row) get more fleets, smoothed by ``temperature`` and
  floored by ``floor`` so no scenario starves;
- ``pinned`` — a hand-set weight dict (:meth:`CurriculumScheduler.pin`).

The scheduler only decides: :meth:`CurriculumScheduler.tick`
(interval-gated) returns the fresh mix, and :func:`apportion` spreads a
mix over N fleets (largest remainder, catalog order).  The
:class:`~blendjax_torch.scenario.randomize.DomainRandomizer` drives an
assignment into the producers, and
:class:`~blendjax_torch.models.actor_learner.ActorLearner` wires the two
together (``scenarios=``/``curriculum=``).  Its :meth:`state_dict` is the
reference's, so a checkpointed curriculum loads in either package.
"""

from __future__ import annotations

import threading
import time

from blendjax_torch.utils.timing import StageTimer, fleet_counters

POLICIES = ("uniform", "prioritized", "pinned")
#: smoothing factor of :meth:`CurriculumScheduler.observe_return`'s
#: per-scenario return record (the reference's default ``ema``)
RETURN_EMA = 0.2


def _normalize(weights, floor=0.0):
    """Floor + renormalize a name->weight dict (floor applied as a
    minimum share AFTER normalization, then renormalized once more)."""
    names = list(weights)
    total = sum(max(0.0, float(weights[n])) for n in names)
    if total <= 0:
        return {n: 1.0 / len(names) for n in names}
    out = {n: max(0.0, float(weights[n])) / total for n in names}
    if floor > 0:
        out = {n: max(floor, w) for n, w in out.items()}
        total = sum(out.values())
        out = {n: w / total for n, w in out.items()}
    return out


def apportion(mix, n):
    """Largest-remainder apportionment of ``n`` fleets over a
    name->weight mix, deterministic: quotas floor first, remainders
    break ties by mix order.  Every returned list has length ``n``."""
    names = list(mix)
    if not names:
        raise ValueError("cannot apportion an empty mix")
    weights = _normalize({k: mix[k] for k in names})
    quotas = [(name, weights[name] * n) for name in names]
    counts = {name: int(q) for name, q in quotas}
    left = n - sum(counts.values())
    # largest remainder first; ties fall back to mix order (index)
    order = sorted(
        range(len(quotas)),
        key=lambda i: (-(quotas[i][1] - int(quotas[i][1])), i),
    )
    for i in order[:left]:
        counts[quotas[i][0]] += 1
    out = []
    for name in names:
        out.extend([name] * counts[name])
    return out


class CurriculumScheduler:
    """Interval-gated scenario-mix policy (module docstring).

    Params
    ------
    scenarios: ScenarioCatalog | sequence[str]
        The scenario names the mix spans (catalog order is canonical).
    policy: "uniform" | "prioritized" | "pinned"
        Starting policy; :meth:`pin` switches to ``pinned`` live.
    interval: int
        Learner updates between reweight passes (:meth:`tick` counts
        its own calls; the ActorLearner calls it once per update).
    temperature: float
        Exponent on the prioritized evidence (1 = proportional;
        higher sharpens toward the hardest scenario).
    floor: float
        Minimum post-normalization share per scenario (prevents
        starvation; must satisfy ``floor * len(scenarios) <= 1``).
    counters / timer:
        ``SCENARIO_EVENTS`` sink / ``SCENARIO_STAGES`` timer.
    """

    def __init__(self, scenarios, *, policy="uniform", interval=8,
                 temperature=1.0, floor=0.05, counters=None, timer=None):
        names = (scenarios.names() if hasattr(scenarios, "names")
                 else list(scenarios))
        if not names:
            raise ValueError("curriculum needs at least one scenario")
        if policy not in POLICIES:
            raise ValueError(
                f"unknown curriculum policy {policy!r}; one of {POLICIES}"
            )
        if floor * len(names) > 1.0 + 1e-9:
            raise ValueError(
                f"floor={floor} over {len(names)} scenarios exceeds "
                "total mass 1.0"
            )
        self.names = names
        self.policy = policy
        self.interval = max(1, int(interval))
        self.temperature = float(temperature)
        self.floor = float(floor)
        self.counters = counters if counters is not None else fleet_counters
        self.timer = timer if timer is not None else StageTimer()
        self._lock = threading.Lock()
        self._mix = {n: 1.0 / len(names) for n in names}
        self._pinned = None
        self._returns = {}   # scenario -> EMA return
        self._ticks = 0
        self._updates = 0
        self._changes = 0

    # -- evidence ------------------------------------------------------------

    def observe_return(self, scenario, value):
        """Fold one per-scenario segment return into the EMA record
        (reporting surface; the prioritized policy reads replay
        priorities, which subsume returns as a difficulty signal)."""
        if scenario is None or scenario not in self.names:
            return
        with self._lock:
            prev = self._returns.get(scenario)
            self._returns[scenario] = (
                float(value) if prev is None
                else (1 - RETURN_EMA) * prev + RETURN_EMA * float(value)
            )

    def pin(self, weights):
        """Hand-pin the mix (operator override): switches the policy to
        ``pinned``; the next reweight pass applies it."""
        unknown = sorted(set(weights) - set(self.names))
        if unknown:
            raise ValueError(
                f"pinned mix names unknown scenario(s) {unknown}; "
                f"known: {self.names}"
            )
        with self._lock:
            self._pinned = _normalize(
                {n: float(weights.get(n, 0.0)) for n in self.names}
            )
            self.policy = "pinned"

    # -- decision ------------------------------------------------------------

    def mix(self):
        """The current name->weight mix (normalized)."""
        with self._lock:
            return dict(self._mix)

    def replay_mix(self):
        """The mix to shape replay draws with, or None when the mix is
        uniform — the scenario-less identity, so a uniform curriculum
        provably cannot perturb the draw stream
        (:meth:`blendjax_torch.replay.ReplayBuffer.sample`'s contract)."""
        mix = self.mix()
        vals = list(mix.values())
        if max(vals) - min(vals) < 1e-12:
            return None
        return mix

    def update(self, scenario_stats=None):
        """One reweight pass (NOT interval-gated — :meth:`tick` is):
        computes the policy's fresh mix from ``scenario_stats`` (the
        :meth:`ReplayBuffer.scenario_stats` shape) and returns it.
        Counts ``scenario_curriculum_updates`` always and
        ``scenario_mix_changes`` when the mix moved."""
        t0 = time.perf_counter()
        with self._lock:
            if self.policy == "pinned" and self._pinned is not None:
                fresh = dict(self._pinned)
            elif self.policy == "prioritized" and scenario_stats:
                evidence = {}
                for n in self.names:
                    rec = scenario_stats.get(n)
                    if rec and rec.get("eligible"):
                        mean_p = (
                            float(rec.get("priority_mass", 0.0))
                            / max(int(rec["eligible"]), 1)
                        )
                        evidence[n] = max(mean_p, 0.0) ** self.temperature
                    else:
                        # no evidence yet: ride the current share so an
                        # unsampled scenario is not zeroed out
                        evidence[n] = self._mix[n]
                fresh = _normalize(evidence, floor=self.floor)
            else:
                # uniform (or prioritized with no evidence at all)
                fresh = {n: 1.0 / len(self.names) for n in self.names}
            changed = any(
                abs(fresh[n] - self._mix[n]) > 1e-9 for n in self.names
            )
            self._mix = fresh
            self._updates += 1
            if changed:
                self._changes += 1
        self.counters.incr("scenario_curriculum_updates")
        if changed:
            self.counters.incr("scenario_mix_changes")
        self.timer.add("scenario_reweight", time.perf_counter() - t0)
        return dict(fresh)

    def tick(self, scenario_stats_fn=None):
        """Interval gate: every ``interval``-th call runs
        :meth:`update` (fetching stats via ``scenario_stats_fn``) and
        returns the fresh mix; other calls return None."""
        with self._lock:
            self._ticks += 1
            due = self._ticks % self.interval == 0
        if not due:
            return None
        stats = scenario_stats_fn() if scenario_stats_fn is not None \
            else None
        return self.update(stats)

    def assign(self, num_fleets):
        """Apportion the current mix over ``num_fleets`` fleets
        (largest remainder, catalog order — deterministic)."""
        return apportion(self.mix(), num_fleets)

    def stats(self):
        with self._lock:
            return {
                "policy": self.policy,
                "interval": self.interval,
                "mix": dict(self._mix),
                "returns_ema": dict(self._returns),
                "updates": self._updates,
                "mix_changes": self._changes,
            }

    # -- checkpoint surface (learner failover; docs/fault_tolerance.md) ------

    def state_dict(self):
        """JSON-able snapshot of everything :meth:`tick` evolves —
        policy, current/pinned mix, per-scenario return EMAs, and the
        tick/update/change counters — so a restored learner's
        curriculum continues from the cut instead of restarting at the
        uniform mix (the interval gate included: a curriculum shift
        due 3 updates after the cut stays due 3 updates after the
        resume)."""
        with self._lock:
            return {
                "names": list(self.names),
                "policy": self.policy,
                "mix": dict(self._mix),
                "pinned": dict(self._pinned) if self._pinned else None,
                "returns_ema": dict(self._returns),
                "ticks": self._ticks,
                "updates": self._updates,
                "changes": self._changes,
            }

    def load_state_dict(self, state):
        """Restore a :meth:`state_dict` snapshot.  The scenario name
        set must match — a checkpoint from a different catalog would
        silently misweight fleets."""
        names = list(state.get("names", []))
        if names != self.names:
            raise ValueError(
                f"curriculum checkpoint spans scenarios {names}, this "
                f"scheduler has {self.names}; restore with the same "
                "catalog"
            )
        if state["policy"] not in POLICIES:
            raise ValueError(
                f"unknown curriculum policy {state['policy']!r} in "
                f"checkpoint; one of {POLICIES}"
            )
        with self._lock:
            self.policy = state["policy"]
            self._mix = {n: float(state["mix"][n]) for n in self.names}
            pinned = state.get("pinned")
            self._pinned = (
                {n: float(pinned[n]) for n in self.names}
                if pinned else None
            )
            self._returns = {
                n: float(v) for n, v in
                (state.get("returns_ema") or {}).items()
                if n in self.names
            }
            self._ticks = int(state.get("ticks", 0))
            self._updates = int(state.get("updates", 0))
            self._changes = int(state.get("changes", 0))
