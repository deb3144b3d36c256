"""The port's completion fences (``blendjax_torch.utils.fence``) against the
reference's ``tests/test_fence.py`` and against ``blendjax.utils.fence`` on
the same inputs, on the CPU (``device="cpu"``).

1. **The reference's cases** on the port: ``value_fence``'s checksum and
   its ignored leaves, a chain's folds and syncs, a chain fencing
   dispatched work, ``fences_valid``'s verdicts.
2. **Across the packages**: ``value_fence`` and a ``fence_chain`` fold
   sequence on numpy-seeded trees (float32, float16, bfloat16, int and bool
   leaves, nested dicts and lists, 0-d leaves) within a relative 1e-6 of
   the reference's; ``fences_valid``'s verdicts for peaks of 1e18 and 1
   FLOP/s equal the reference's.
3. **Placement and refusals**: host leaves (numpy arrays, CPU tensors) enter
   a chain on another device as numbers and a leaf on a third device is
   refused (a chain on the ``meta`` device stands in for the card); the
   card is the default and is refused where there is none.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax.utils import fence as jfence
from blendjax_torch.utils import fence_chain, fences_valid, value_fence

# -- tests/test_fence.py ---------------------------------------------------------


def test_value_fence_returns_checksum_and_blocks():
    tree = {"a": torch.ones((4, 4)), "b": {"c": torch.full((2,), 2.0)}}
    v = value_fence(tree)
    assert v == 3.0  # mean(a)=1 + mean(c)=2
    assert value_fence({"x": []}) == 0.0
    assert value_fence([1.0, None]) == 0.0  # non-array leaves ignored


def test_fence_chain_folds_and_syncs():
    chain = fence_chain(device="cpu")
    total = 0.0
    for i in range(5):
        y = torch.full((3,), float(i)) * 2
        chain.fold(y)
        total += 2.0 * i
    assert chain.sync() == total
    # sync is idempotent and reflects further folds
    chain.fold(torch.full((2,), 1.0))
    assert chain.sync() == total + 1.0


def test_fence_chain_fences_dispatched_work():
    chain = fence_chain(device="cpu")
    big = torch.sin(torch.ones((256, 256))).sum()
    chain.fold(big)
    chain.sync()
    t0 = time.perf_counter()
    big.numpy()  # already done: near-instant
    assert time.perf_counter() - t0 < 0.5


def test_fences_valid_on_cpu():
    ok, details = fences_valid(peak_flops_per_sec=1e18, device="cpu")
    assert ok, details
    ok, details = fences_valid(peak_flops_per_sec=1.0, device="cpu")
    assert not ok  # any real compute beats a 1 FLOP/s "peak"
    assert set(details) == {"min_s", "implied_flops_per_sec", "peak_flops_per_sec"}


# -- across the packages ----------------------------------------------------------


def _tree(seed):
    """A numpy tree of mixed leaves (and two leaves with no dtype)."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((64, 33)).astype(np.float32),
        "layers": [{"b": rng.standard_normal(17).astype(np.float16),
                    "k": rng.integers(-5, 9, (4, 5)).astype(np.int32)},
                   {"mask": rng.random((3, 7)) > 0.5,
                    "s": np.float32(rng.standard_normal())}],
        "scale": np.array(rng.uniform(0.5, 2.0), np.float32),
        "note": "ignored", "none": None,
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    return tree


def _to_jax(tree):
    return jax.tree.map(lambda x: jnp.asarray(x) if hasattr(x, "dtype") else x, tree)


@pytest.mark.parametrize("form", ["numpy", "torch"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_value_fence_equals_the_reference(seed, form):
    tree = _tree(seed)
    ours = value_fence(tree if form == "numpy" else _to_torch(tree))
    ref = jfence.value_fence(_to_jax(tree))
    assert ours == pytest.approx(ref, rel=1e-6)


def test_bfloat16_leaf_equals_the_reference():
    x = np.random.default_rng(3).standard_normal((16, 16)).astype(np.float32)
    ours = value_fence(torch.from_numpy(x).to(torch.bfloat16))
    ref = jfence.value_fence(jnp.asarray(x, jnp.bfloat16))
    assert ours == pytest.approx(ref, rel=1e-6)


def test_fold_sequence_equals_the_reference():
    ours, ref = fence_chain(device="cpu"), jfence.fence_chain()
    for seed in range(6):
        tree = _tree(seed)
        if seed % 2:
            ours.fold(_to_torch(tree))
        else:
            ours.fold(tree)  # host leaves as they are
        ref.fold(_to_jax(tree))
        ours.fold([None, "x"])
        ref.fold([None, "x"])
        assert ours.sync() == pytest.approx(ref.sync(), rel=1e-6)


@pytest.mark.parametrize("peak", [1e18, 1.0])
def test_fences_valid_verdicts_equal_the_reference(peak):
    ok, details = fences_valid(peak, device="cpu")
    ref_ok, ref_details = jfence.fences_valid(peak, n=256)
    assert ok == ref_ok
    assert set(details) == set(ref_details)


# -- placement and refusals -------------------------------------------------------


def test_host_leaves_enter_a_chain_elsewhere_as_numbers_and_other_devices_are_refused():
    """The stated rule, with the ``meta`` device standing in for the card:
    numpy arrays and CPU tensors are reduced on the host and added as a
    number; a leaf on the chain's device is reduced there; a leaf on any
    other device raises rather than being copied."""
    chain = fence_chain(device="meta")
    assert chain.device == torch.device("meta")
    chain.fold({"host": np.ones(3, np.float32), "cpu": torch.ones(2)})
    chain.fold(torch.ones(4, device="meta"))
    cpu_chain = fence_chain(device="cpu")
    with pytest.raises(ValueError, match="meta"):
        cpu_chain.fold([torch.ones(2), torch.ones(2, device="meta")])


def test_value_fence_sums_numpy_and_cpu_leaves_in_one_fetch():
    assert value_fence([np.full(3, 2.0), torch.full((5,), 3.0)]) == 5.0


def test_the_card_is_the_default_and_is_refused_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal is a CPU-only host's")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fence_chain()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fences_valid(1e18)


def test_folds_stay_outside_autograd():
    """A chain folds many steps: a leaf that requires grad must not chain
    the accumulator into an ever-growing autograd graph."""
    w = torch.ones(3, requires_grad=True)
    chain = fence_chain(device="cpu")
    for _ in range(3):
        chain.fold({"w": w * 2})
    assert not chain._acc.requires_grad and chain._acc.grad_fn is None
    assert chain.sync() == 6.0 and value_fence(w) == 1.0
