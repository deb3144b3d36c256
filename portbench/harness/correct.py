"""The numbers that decide ``correct`` for a training cell.

The program's first steps against the reference's, from the same weights
and the same batches:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient (the program's as Adam holds it after one step), over the
  larger of the reference's norm of that leaf and of the median leaf;
- ``grad_diff``: the worst leaf's norm of the difference of the two first
  gradients, over the same: at a large batch half of the rows give a
  gradient of about the same norm but another direction, which only this
  number tells from rounding;
- ``change_gap``: the same of the parameters' change over the steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (a key's bias under softmax: nought to rounding, moved by
  Adam on round-off alone).

Each is compared with its cell's limit in ``limits/<workload>.json``.
"""

from __future__ import annotations

import statistics

import torch

#: a leaf whose reference gradient is under this share of the median
#: leaf's is left out of ``change_gap``
NEGLIGIBLE = 1e-3


def norms(tensors):
    return {k: float(torch.linalg.vector_norm(v)) for k, v in tensors.items()}


def diff_gaps(prog, ref, ref_norms):
    """``{leaf: norm of the difference}`` over the larger of the leaf's
    reference norm and the median leaf's."""
    floor = statistics.median(ref_norms.values())
    return {k: float(torch.linalg.vector_norm(prog[k] - ref[k])) / max(ref_norms[k], floor)
            for k in ref}


def loss_gaps(prog, ref):
    return [abs(p - r) / abs(r) for p, r in zip(prog, ref, strict=True)]


def leaf_gaps(prog, ref, leaves):
    """``{leaf: gap}``: each leaf's gap of norms over the larger of its
    reference norm and the median leaf's."""
    floor = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor) for k in leaves}


def moving_leaves(ref_grads):
    floor = statistics.median(ref_grads.values()) * NEGLIGIBLE
    return sorted(k for k, v in ref_grads.items() if v >= floor)


def numbers(prog, ref):
    """``{name: value}`` from two readings of ``train_readings``' shape."""
    grads = leaf_gaps(prog["grad_norms"], ref["grad_norms"], sorted(ref["grad_norms"]))
    moves = leaf_gaps(prog["change_norms"], ref["change_norms"], moving_leaves(ref["grad_norms"]))
    diffs = diff_gaps(prog["first_grads"], ref["first_grads"], ref["grad_norms"])
    return {
        "loss_gap": max(loss_gaps(prog["losses"], ref["losses"])),
        "grad_gap": max(grads.values()),
        "grad_diff": max(diffs.values()),
        "change_gap": max(moves.values()),
    }


def details(prog, ref):
    """What the readings script records beside :func:`numbers`: each step's
    loss gap and the worst leaves."""
    grads = leaf_gaps(prog["grad_norms"], ref["grad_norms"], sorted(ref["grad_norms"]))
    moves = leaf_gaps(prog["change_norms"], ref["change_norms"], moving_leaves(ref["grad_norms"]))
    diffs = diff_gaps(prog["first_grads"], ref["first_grads"], ref["grad_norms"])
    return {
        "loss_gaps": loss_gaps(prog["losses"], ref["losses"]),
        "grad_worst": sorted(grads, key=grads.get)[-3:],
        "diff_worst": sorted(diffs, key=diffs.get)[-3:],
        "change_worst": sorted(moves, key=moves.get)[-3:],
    }


def verdict(values, limits):
    """``(correct, {name: {'value', 'limit'}})`` over the numbers the cell's
    limits name."""
    compared = {k: {"value": values[k], "limit": lim} for k, lim in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in compared.values())
    return ok, compared
