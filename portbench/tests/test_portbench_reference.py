"""The frozen reference against the program's CPU path at a tiny size, in
float32: the loss, every gradient and one Adam step.  And the pendulum
copy against the producers' simulator."""

import functools

import numpy as np
import pytest
import torch

from portbench.harness import weights
from portbench.harness.correct import moving_leaves
from portbench.reference import pendulum
from portbench.reference import seqformer as ref

DENSE = {"obs_dim": 8, "d_model": 32, "n_heads": 4, "n_layers": 2, "d_ff": 64, "max_len": 16,
         "lr": 1e-3}


def _program_loss():
    from blendjax_torch.models import seqformer

    return functools.partial(seqformer.episode_loss_fn, compute_dtype=torch.float32)


def _episodes(seed, b=3, t=16):
    return torch.from_numpy(pendulum.simulate_batch(np.random.default_rng(seed), b, t, 8))


def test_portbench_reference_matches_the_program_loss_and_gradients():
    cfg = DENSE
    params = weights.make(cfg, 5, torch.device("cpu"))
    ep = _episodes(5)
    mine = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    theirs = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want = ref.episode_loss(mine, ep, cfg)
    got = _program_loss()(theirs, {"episode": ep})
    assert abs(got.item() - want.item()) <= 1e-5 * abs(want.item())
    gw = torch.autograd.grad(want, list(mine.values()))
    gg = torch.autograd.grad(got, list(theirs.values()))
    # a key's bias has no gradient but round-off: judged against the largest
    scale = max(float(g.abs().max()) for g in gw)
    for k, a, b in zip(mine, gw, gg):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6 * scale), k


def test_portbench_reference_adam_step_matches_the_program():
    from blendjax_torch.models.train import TrainState, make_train_step

    cfg = DENSE

    params = weights.make(cfg, 6, torch.device("cpu"))
    ep = _episodes(6)
    state = TrainState.create({k: v.clone() for k, v in params.items()}, lr=cfg["lr"])
    step = make_train_step(_program_loss())
    state, _ = step(state, {"episode": ep})
    mine = {k: v.clone() for k, v in params.items()}
    out = ref.train_readings(mine, [ep], cfg, cfg["lr"])
    # a leaf with no gradient but round-off (a key's bias) moves by Adam's
    # normalised noise: left out as the benchmark's change_gap leaves it
    # an element whose gradient is near Adam's eps (1e-8) moves by a share of
    # lr that rounding in the gradient shifts: elements are held to 5% of lr,
    # each leaf's change as a norm to 1e-4
    for k in moving_leaves(out["grad_norms"]):
        got = state.params[k].detach()
        assert torch.allclose(got, mine[k], rtol=0, atol=0.05 * cfg["lr"]), k
        moved = float(torch.linalg.vector_norm(got - params[k]))
        assert abs(moved - out["change_norms"][k]) <= 1e-4 * out["change_norms"][k], k
    assert out["change_norms"]["embed.w"] > 0


@pytest.mark.parametrize("chunk", [1, 2])
def test_portbench_reference_in_row_blocks_equals_the_whole_batch(chunk):
    params = weights.make(DENSE, 8, torch.device("cpu"))
    ep = _episodes(8)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    whole, gw = ref.loss_and_grads(leaves, ep, DENSE)
    part, gp = ref.loss_and_grads(leaves, ep, DENSE, chunk=chunk)
    assert abs(part - whole) <= 1e-6 * whole
    for k in gw:
        assert torch.allclose(gp[k], gw[k], rtol=1e-5, atol=1e-7 * float(gw[k].abs().max())), k


def test_portbench_pendulum_copy_gives_the_producers_bytes():
    from blendjax_torch.btb.pendulum import simulate_episode

    a = pendulum.simulate_episode(np.random.default_rng(9), 3, 40, 16)
    b = simulate_episode(np.random.default_rng(9), 3, 40, 16)
    assert np.array_equal(a, b)


def test_portbench_pendulum_batch_follows_the_episode_loop():
    a = pendulum.simulate_batch(np.random.default_rng(4), 5, 64, 8)
    b = pendulum.simulate_episode(np.random.default_rng(4), 5, 64, 8)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_portbench_weights_follow_the_seed():
    a = weights.make(DENSE, 2**31 + 7, torch.device("cpu"))
    b = weights.make(DENSE, 2**31 + 7, torch.device("cpu"))
    c = weights.make(DENSE, 2**31 + 8, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.w"], c["embed.w"])


def test_portbench_grad_diff_tells_half_a_batch_from_rounding():
    # rounding in the program's place moves a gradient by a sliver; half of
    # the rows give one of about the same norm in another direction
    from portbench.harness.correct import diff_gaps, norms

    params = weights.make(DENSE, 9, torch.device("cpu"))
    ep = _episodes(9, b=8)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    _, whole = ref.loss_and_grads(leaves, ep, DENSE)
    _, half = ref.loss_and_grads(leaves, ep[:4], DENSE)
    rounded = {k: g.to(torch.bfloat16).to(torch.float32) for k, g in whole.items()}
    ref_norms = norms(whole)
    assert max(diff_gaps(rounded, whole, ref_norms).values()) < 0.01
    assert max(diff_gaps(half, whole, ref_norms).values()) > 0.1
    zero = {k: torch.zeros_like(g) for k, g in whole.items()}
    assert max(diff_gaps(zero, whole, ref_norms).values()) >= 1.0
