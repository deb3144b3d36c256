"""The whole of a run but the look for a card, with the timed path broken
underneath: ``correct`` comes out false under each cell's own limits, once
for each fault the cell can have: the step returns its state unchanged
(``frozen``), or steps on half of each batch (``half_batch``).  One card,
so no exchange between cards; the batches are made in set-up, so no
answer is produced where a feed could alter it."""

import pytest
from _tiny import SEED, SPEC, overrides

from portbench.harness import cell

CASES = [(w["name"], f) for w in SPEC.bench["workloads"] for f in ("frozen", "half_batch")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_portbench_a_broken_timed_path_is_not_correct(workload, fault):
    res = cell.run(SPEC, workload, SEED, 0.3, False, device="cpu", fault=fault,
                   overrides=overrides(workload))
    assert res["correct"] is False, res["compared"]
    assert any(c["limit"] is not None and c["value"] > c["limit"]
               for c in res["compared"].values())
