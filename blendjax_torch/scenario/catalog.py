"""Scenario catalog: named, validated, seeded-samplable scene configs, the
port of ``blendjax.scenario.catalog``.

A :class:`ScenarioSpec` names one scene configuration — fixed scene
params, per-param randomization ranges, a physics rate, a render
resolution — and a :class:`ScenarioCatalog` holds the named set the rest
of the scenario plane works in terms of:

- the :class:`~blendjax_torch.scenario.randomize.DomainRandomizer` samples
  a spec (``spec.sample(rng)`` -> concrete param dict) and pushes the
  draw into running producers over the duplex control plane;
- the :class:`~blendjax_torch.scenario.curriculum.CurriculumScheduler`
  reweights the fleet's mix over the catalog's names;
- replay strata and telemetry records key on the catalog's scenario
  NAMES (strings on the wire, interned to small ints inside the replay
  ring).

Specs round-trip through JSON (:meth:`ScenarioCatalog.to_json` /
:meth:`from_json`) in the reference's ``blendjax.scenario/1`` format, so
either package reads the other's file; validation on the way in makes
unknown fields, inverted ranges, non-numeric bounds and duplicate names
errors at load time, not mid-training.  See docs/scenarios.md.
"""

from __future__ import annotations

import json

#: format tag carried by every serialized catalog (rejecting a foreign
#: JSON document with a useful error instead of a KeyError mid-field)
CATALOG_FORMAT = "blendjax.scenario/1"

#: the spec fields a serialized document may carry — anything else is a
#: schema error (a typo'd ``rangs`` must not silently become a no-op)
_SPEC_FIELDS = ("params", "ranges", "physics_rate_us", "resolution")


def _validate_ranges(name, ranges):
    out = {}
    for key, rng in dict(ranges or {}).items():
        if isinstance(rng, (list, tuple)) and len(rng) == 2 and all(
            isinstance(v, (int, float)) and not isinstance(v, bool)
            for v in rng
        ):
            lo, hi = float(rng[0]), float(rng[1])
            if lo > hi:
                raise ValueError(
                    f"scenario {name!r}: range {key!r} inverted "
                    f"({lo} > {hi})"
                )
            out[key] = (lo, hi)
        elif isinstance(rng, (list, tuple)) and len(rng) > 0 and all(
            isinstance(v, (str, int, float, bool)) for v in rng
        ):
            # any other scalar sequence is a CHOICE list (a 2-tuple of
            # numbers is always an interval — use a 2-element choice of
            # strings/bools, or repeat an element, to force choices)
            out[key] = list(rng)
        else:
            raise ValueError(
                f"scenario {name!r}: range {key!r} must be a numeric "
                f"(lo, hi) pair or a choice list, got {rng!r}"
            )
    return out


class ScenarioSpec:
    """One named scene configuration.

    Params
    ------
    name: str
        Catalog key; also the label stamped on transitions, replay
        rows, telemetry records and serve traffic.
    params: dict | None
        Fixed scene parameters pushed verbatim with every sample
        (e.g. ``{"scene": "warehouse", "clutter": 3}``).
    ranges: dict | None
        Per-parameter randomization: a numeric ``(lo, hi)`` pair draws
        uniformly; a choice list draws one element.  Drawn fresh per
        :meth:`sample`, overlaid on ``params``.
    physics_rate_us: int
        The scenario's per-frame physics cost (the producer's solver
        tick stand-in) — what makes fleets HETEROGENEOUS; rides every
        sample as ``physics_us``.
    resolution: (int, int) | None
        Render resolution ``(h, w)``; rides every sample when set.
    """

    __slots__ = ("name", "params", "ranges", "physics_rate_us",
                 "resolution")

    def __init__(self, name, *, params=None, ranges=None,
                 physics_rate_us=0, resolution=None):
        if not isinstance(name, str) or not name:
            raise ValueError(f"scenario name must be a non-empty "
                             f"string, got {name!r}")
        self.name = name
        self.params = dict(params or {})
        self.ranges = _validate_ranges(name, ranges)
        self.physics_rate_us = int(physics_rate_us)
        if self.physics_rate_us < 0:
            raise ValueError(
                f"scenario {name!r}: physics_rate_us must be >= 0"
            )
        if resolution is not None:
            resolution = tuple(int(v) for v in resolution)
            if len(resolution) != 2 or min(resolution) < 1:
                raise ValueError(
                    f"scenario {name!r}: resolution must be a positive "
                    f"(h, w) pair, got {resolution!r}"
                )
        self.resolution = resolution

    def sample(self, rng):
        """One concrete parameter dict from a seeded
        ``numpy.random.Generator``: fixed ``params``, a fresh uniform /
        choice draw per range, plus the spec's ``physics_us`` /
        ``resolution`` and the ``scenario`` name itself — the dict a
        randomization push carries in full."""
        out = dict(self.params)
        # deterministic draw order: sorted keys, one rng call per key
        for key in sorted(self.ranges):
            rng_spec = self.ranges[key]
            if isinstance(rng_spec, tuple):
                lo, hi = rng_spec
                out[key] = float(lo + (hi - lo) * rng.random())
            else:
                out[key] = rng_spec[int(rng.integers(len(rng_spec)))]
        out["scenario"] = self.name
        # ALWAYS emitted, zero included: a producer reassigned from a
        # slow scenario to a free one must have its rate reset, not
        # keep the old physics while relabelling
        out["physics_us"] = self.physics_rate_us
        if self.resolution is not None:
            out["resolution"] = list(self.resolution)
        return out

    def env_kwargs(self):
        """The LAUNCH-time kwargs for a fleet pinned to this scenario
        (``FleetSet(fleet_env_kwargs=...)``): the knobs the test env
        fixture understands at spawn, before any duplex push lands."""
        return {"scenario": self.name,
                "physics_us": self.physics_rate_us}

    def to_dict(self):
        d = {"params": dict(self.params),
             "ranges": {k: list(v) if isinstance(v, tuple) else list(v)
                        for k, v in self.ranges.items()},
             "physics_rate_us": self.physics_rate_us}
        if self.resolution is not None:
            d["resolution"] = list(self.resolution)
        return d

    @classmethod
    def from_dict(cls, name, d):
        if not isinstance(d, dict):
            raise ValueError(
                f"scenario {name!r}: spec must be an object, got "
                f"{type(d).__name__}"
            )
        unknown = sorted(set(d) - set(_SPEC_FIELDS))
        if unknown:
            raise ValueError(
                f"scenario {name!r}: unknown spec field(s) {unknown}; "
                f"known: {list(_SPEC_FIELDS)}"
            )
        return cls(
            name,
            params=d.get("params"),
            ranges=d.get("ranges"),
            physics_rate_us=d.get("physics_rate_us", 0),
            resolution=d.get("resolution"),
        )

    def __repr__(self):
        return (f"ScenarioSpec({self.name!r}, "
                f"physics_rate_us={self.physics_rate_us}, "
                f"ranges={sorted(self.ranges)})")


class ScenarioCatalog:
    """Ordered named set of :class:`ScenarioSpec`.

    Insertion order is the canonical scenario order (apportionment and
    strata reports iterate it), so a catalog built the same way always
    assigns the same fleets the same scenarios.
    """

    def __init__(self, specs=()):
        self._specs = {}
        for spec in specs:
            self.add(spec)

    def add(self, spec):
        if not isinstance(spec, ScenarioSpec):
            raise TypeError(f"expected ScenarioSpec, got {spec!r}")
        if spec.name in self._specs:
            raise ValueError(f"duplicate scenario name {spec.name!r}")
        self._specs[spec.name] = spec
        return self

    def get(self, name):
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(
                f"unknown scenario {name!r}; catalog has "
                f"{self.names()}"
            ) from None

    def names(self):
        return list(self._specs)

    def sample(self, name, rng):
        return self.get(name).sample(rng)

    def __len__(self):
        return len(self._specs)

    def __iter__(self):
        return iter(self._specs.values())

    def __contains__(self, name):
        return name in self._specs

    # -- JSON round trip -----------------------------------------------------

    def to_json(self, indent=None):
        return json.dumps(
            {"format": CATALOG_FORMAT,
             "scenarios": {s.name: s.to_dict() for s in self}},
            indent=indent,
        )

    @classmethod
    def from_json(cls, text):
        doc = json.loads(text)
        if not isinstance(doc, dict) \
                or doc.get("format") != CATALOG_FORMAT:
            raise ValueError(
                f"not a scenario catalog (format "
                f"{doc.get('format') if isinstance(doc, dict) else None!r}"
                f"; expected {CATALOG_FORMAT!r})"
            )
        cat = cls()
        for name, d in doc.get("scenarios", {}).items():
            cat.add(ScenarioSpec.from_dict(name, d))
        return cat

    def save(self, path):
        with open(path, "w") as f:
            f.write(self.to_json(indent=2))
        return path

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls.from_json(f.read())

    def __repr__(self):
        return f"ScenarioCatalog({self.names()})"
