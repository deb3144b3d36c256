"""The control: the reference with float8 products (e4m3 operands, e5m2
gradients) in the program's place, one precision below the
configuration's bfloat16, must come out not correct under each training
cell's limits.  On the CPU at a small size; on the card at the cell's own
size on three seeds (skipped without a card)."""

import pytest
from _tiny import SPEC, overrides

from portbench.harness import correct
from portbench.readings import readings

CELLS = [w["name"] for w in SPEC.bench["workloads"]]


def _fails(rec, workload):
    ok, _ = correct.verdict(rec, SPEC.limits(workload))
    return not ok


@pytest.mark.parametrize("workload", CELLS)
def test_portbench_the_control_is_not_correct_at_a_small_size(workload):
    recs = readings(workload, [], [5, 6, 7], device="cpu", overrides=overrides(workload),
                    emit=lambda line: None)
    controls = [r for r in recs if r["kind"] == "control"]
    assert len(controls) == 3 and all(_fails(r, workload) for r in controls)


@pytest.mark.parametrize("workload", CELLS)
def test_portbench_the_control_is_not_correct_at_the_cell_size_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the card: the cell's own size")
    recs = readings(workload, [], [3000000101, 3000000102, 3000000103], device="cuda",
                    emit=lambda line: None)
    controls = [r for r in recs if r["kind"] == "control"]
    assert len(controls) == 3 and all(_fails(r, workload) for r in controls)
