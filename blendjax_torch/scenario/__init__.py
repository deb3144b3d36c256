"""Scenario plane: catalog, live domain randomization, curriculum — the
port of ``blendjax.scenario``.

Named :class:`ScenarioSpec`/:class:`ScenarioCatalog` scene configs with
seeded sampling and JSON round-trip, a :class:`DomainRandomizer` that
pushes sampled params into RUNNING producers over the duplex control
plane, and a :class:`CurriculumScheduler` that reweights the fleet's
scenario mix from per-scenario replay strata.  Scenario ids ride in-band
on transitions (the ``healthy``-key pattern), so replay rows and
telemetry attribute to scenarios.  See docs/scenarios.md.

Import-light, as the reference's: numpy, plus zmq only when a channel is
dialled; no torch, so producer-side scripts and torch-free processes can
use it.
"""

from blendjax_torch.scenario.catalog import (  # noqa: F401
    CATALOG_FORMAT,
    ScenarioCatalog,
    ScenarioSpec,
)
from blendjax_torch.scenario.curriculum import (  # noqa: F401
    POLICIES,
    CurriculumScheduler,
    apportion,
)
from blendjax_torch.scenario.randomize import (  # noqa: F401
    PUSH_CMD,
    DomainRandomizer,
)

__all__ = [
    "CATALOG_FORMAT",
    "POLICIES",
    "PUSH_CMD",
    "CurriculumScheduler",
    "DomainRandomizer",
    "ScenarioCatalog",
    "ScenarioSpec",
    "apportion",
]
