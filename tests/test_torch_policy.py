"""The port's policy module against the JAX package's: the same
JAX-initialized parameters (carried across by ``params_from_jax``) and the
same seeded numpy inputs through ``blendjax.models.policy`` and
``blendjax_torch.models.policy``, at the control example's widths (obs 3,
hidden (64, 64), 2 actions; a 4-env rollout of 64 steps).

Tolerances: the logits, log-probs and values agree to atol 1e-6 (as
``tests/test_models.py`` holds the reference's log-probs); the discounted
returns and GAE to rtol 1e-6 (the reference's GAE limit); the losses,
their gradients and the parameters after one Adam step to atol 1e-5 (the
port's float32 rule, ``tests/test_torch_detector.py``), except where
Adam's first step amplifies a gradient's rounding (see "one Adam step"
below: there the limit is not met as written)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from blendjax.models import policy as jpol
from blendjax_torch.control import actor_critic, joint_params, make_ppo_loss
from blendjax_torch.models import policy as tpol
from blendjax_torch.models.convert import params_from_jax, params_to_jax
from blendjax_torch.models.train import TrainState, make_train_step

OBS_DIM, NUM_ACTIONS, T, N = 3, 2, 64, 4
B = T * N


def _jax_actor(continuous=False, seed=1):
    tree = jpol.init(jax.random.PRNGKey(seed), OBS_DIM, NUM_ACTIONS, continuous=continuous)
    tree = jax.tree.map(np.asarray, tree)
    if continuous:  # a log-std that is not all zeros
        tree["log_std"] = np.asarray([-0.3, 0.2], np.float32)
    return tree


def _jax_critic(seed=2):
    return jax.tree.map(np.asarray, jpol.value_init(jax.random.PRNGKey(seed), OBS_DIM))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _rollout(seed=0, continuous=False):
    rng = np.random.default_rng(seed)
    obs = rng.normal(0.0, 0.1, (B, OBS_DIM)).astype(np.float32)
    if continuous:
        actions = rng.normal(0.0, 1.0, (B, NUM_ACTIONS)).astype(np.float32)
    else:
        actions = rng.integers(0, NUM_ACTIONS, B).astype(np.int32)
    rewards = np.ones((T, N), np.float32) * rng.uniform(0.5, 1.0, (T, N)).astype(np.float32)
    dones = rng.random((T, N)) < 0.08
    values = rng.normal(0.0, 1.0, (T, N)).astype(np.float32)
    last_values = rng.normal(0.0, 1.0, N).astype(np.float32)
    logp_old = rng.normal(-0.7, 0.05, B).astype(np.float32)
    mask = (rng.random(B) > 0.1).astype(np.float32)
    return dict(obs=obs, actions=actions, rewards=rewards, dones=dones, values=values,
                last_values=last_values, logp_old=logp_old, mask=mask)


def _grads_close(tgrads, jgrads, atol=1e-5):
    flat = params_to_jax({k: g for k, g in tgrads.items()})
    jflat = jax.tree.map(np.asarray, jgrads)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(flat),
                                 jax.tree_util.tree_leaves_with_path(jflat)):
        np.testing.assert_allclose(a, b, atol=atol, err_msg=str(path))


def _torch_grads(loss_fn, params):
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(params)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


# -- parameters -----------------------------------------------------------------


@pytest.mark.parametrize("continuous", [False, True])
def test_params_cross_and_come_back(continuous):
    """The generic flattening carries the policy pytree (a nested
    ``layers`` list, ``out``, optional ``log_std``) both ways."""
    tree = _jax_actor(continuous)
    params = params_from_jax(tree, device="cpu")
    keys = {"layers.0.w", "layers.0.b", "layers.1.w", "layers.1.b", "out.w", "out.b"}
    assert set(params) == keys | ({"log_std"} if continuous else set())
    assert params["layers.0.w"].shape == (OBS_DIM, 64)
    back = params_to_jax(params)
    assert isinstance(back["layers"], list) and len(back["layers"]) == 2
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(back) == jax.tree.structure(tree)


@pytest.mark.parametrize("continuous", [False, True])
def test_init_layout_matches_reference(continuous):
    g = torch.Generator().manual_seed(0)
    params = tpol.init(g, OBS_DIM, NUM_ACTIONS, continuous=continuous, device="cpu")
    ref = params_from_jax(_jax_actor(continuous), device="cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    critic = tpol.value_init(g, OBS_DIM, device="cpu")
    assert critic["out.w"].shape == (64, 1)
    if continuous:
        assert torch.equal(params["log_std"], torch.zeros(NUM_ACTIONS))


# -- forward --------------------------------------------------------------------


@pytest.mark.parametrize("continuous", [False, True])
def test_logits_and_log_probs(continuous):
    tree = _jax_actor(continuous)
    params = params_from_jax(tree, device="cpu")
    r = _rollout(continuous=continuous)
    np.testing.assert_allclose(_np(tpol.logits(params, _t(r["obs"]))),
                               np.asarray(jpol.logits(tree, r["obs"])), atol=1e-6)
    if continuous:
        got = tpol.gaussian_log_prob(params, _t(r["obs"]), _t(r["actions"]))
        want = jpol.gaussian_log_prob(tree, r["obs"], r["actions"])
    else:
        got = tpol.categorical_log_prob(params, _t(r["obs"]), _t(r["actions"]))
        want = jpol.categorical_log_prob(tree, r["obs"], jnp.asarray(r["actions"]))
    assert got.shape == (B,)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)


def test_value_apply():
    tree = _jax_critic()
    r = _rollout()
    obs3 = r["obs"].reshape(T, N, OBS_DIM)
    got = tpol.value_apply(params_from_jax(tree, device="cpu"), _t(obs3))
    assert got.shape == (T, N)
    np.testing.assert_allclose(_np(got), np.asarray(jpol.value_apply(tree, obs3)),
                               atol=1e-6)


# -- returns and advantages -----------------------------------------------------


@pytest.mark.parametrize("gamma", [0.99, 0.9])
def test_discounted_returns(gamma):
    r = _rollout(seed=3)
    got = tpol.discounted_returns(_t(r["rewards"]), _t(r["dones"]), gamma)
    want = jpol.discounted_returns(jnp.asarray(r["rewards"]), jnp.asarray(r["dones"]), gamma)
    assert got.shape == (T, N) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("gamma,lam", [(0.99, 0.95), (0.9, 1.0)])
def test_gae(gamma, lam):
    r = _rollout(seed=4)
    adv, targets = tpol.gae(_t(r["rewards"]), _t(r["values"]), _t(r["last_values"]),
                            _t(r["dones"]), gamma, lam)
    jadv, jtargets = jpol.gae(jnp.asarray(r["rewards"]), jnp.asarray(r["values"]),
                              jnp.asarray(r["last_values"]), jnp.asarray(r["dones"]),
                              gamma, lam)
    np.testing.assert_allclose(_np(adv), np.asarray(jadv), rtol=1e-6)
    np.testing.assert_allclose(_np(targets), np.asarray(jtargets), rtol=1e-6)


# -- losses and gradients --------------------------------------------------------


@pytest.mark.parametrize("continuous", [False, True])
def test_reinforce_loss_and_grads(continuous):
    tree = _jax_actor(continuous)
    r = _rollout(seed=5, continuous=continuous)
    returns = np.asarray(jpol.discounted_returns(jnp.asarray(r["rewards"]),
                                                 jnp.asarray(r["dones"]))).reshape(-1)

    def jloss(p):
        return jpol.reinforce_loss(p, r["obs"], jnp.asarray(r["actions"]), returns,
                                   continuous=continuous)

    jl, jg = jax.value_and_grad(jloss)(tree)
    tl, tg = _torch_grads(lambda p: tpol.reinforce_loss(
        p, _t(r["obs"]), _t(r["actions"]), _t(returns), continuous=continuous),
        params_from_jax(tree, device="cpu"))
    assert abs(tl - float(jl)) <= 1e-5
    _grads_close(tg, jg)


@pytest.mark.parametrize("case", ["masked", "unmasked", "continuous"])
def test_ppo_loss_and_grads(case):
    continuous = case == "continuous"
    actor, critic = _jax_actor(continuous), _jax_critic()
    r = _rollout(seed=6, continuous=continuous)
    adv = r["values"].reshape(-1) * 0.5 + 0.1
    batch = {"obs": r["obs"], "actions": r["actions"], "logp_old": r["logp_old"],
             "advantages": adv, "targets": r["values"].reshape(-1)}
    if case == "masked":
        batch["mask"] = r["mask"]

    def jloss(ac):
        return jpol.ppo_loss(ac[0], ac[1], {k: jnp.asarray(v) for k, v in batch.items()},
                             continuous=continuous)

    jl, (jga, jgc) = jax.value_and_grad(jloss)((actor, critic))
    tbatch = {k: _t(v) for k, v in batch.items()}
    tl, tg = _torch_grads(
        lambda p: tpol.ppo_loss(*actor_critic(p), tbatch, continuous=continuous),
        joint_params(params_from_jax(actor, device="cpu"),
                     params_from_jax(critic, device="cpu")))
    assert abs(tl - float(jl)) <= 1e-5
    ga, gc = actor_critic(tg)
    _grads_close(ga, jga)
    _grads_close(gc, jgc)


# -- sampling -------------------------------------------------------------------


def test_sample_action_log_prob_is_the_actions():
    params = params_from_jax(_jax_actor(), device="cpu")
    obs = _t(_rollout()["obs"])
    actions, logp = tpol.sample_action(params, torch.Generator().manual_seed(0), obs)
    assert actions.shape == (B,) and set(actions.unique().tolist()) <= {0, 1}
    torch.testing.assert_close(logp, tpol.categorical_log_prob(params, obs, actions),
                               atol=1e-6, rtol=0)
    # the same generator state draws the same actions
    again, _ = tpol.sample_action(params, torch.Generator().manual_seed(0), obs)
    assert torch.equal(actions, again)


def test_sample_action_gaussian_log_prob():
    params = params_from_jax(_jax_actor(continuous=True), device="cpu")
    obs = _t(_rollout()["obs"])
    actions, logp = tpol.sample_action(params, torch.Generator().manual_seed(1), obs)
    assert actions.shape == (B, NUM_ACTIONS)
    torch.testing.assert_close(logp, tpol.gaussian_log_prob(params, obs, actions),
                               atol=1e-6, rtol=0)
    z = (actions - tpol.logits(params, obs)) / torch.exp(params["log_std"])
    assert abs(float(z.mean())) < 0.15 and abs(float(z.std()) - 1.0) < 0.15


def test_sample_action_frequencies_follow_softmax():
    """Over 40,000 draws for each of 3 observations, each action's
    frequency is within 5 standard errors of its softmax probability."""
    g = torch.Generator().manual_seed(7)
    params = tpol.init(g, OBS_DIM, 3, device="cpu")
    params["out.w"] = params["out.w"] * 4  # spread the probabilities
    base = torch.tensor([[0.0, 0.0, 0.0], [0.5, -0.3, 0.2], [-0.4, 0.1, -0.6]])
    draws = 40_000
    obs = base.repeat_interleave(draws, dim=0)
    actions, _ = tpol.sample_action(params, torch.Generator().manual_seed(8), obs)
    probs = torch.softmax(tpol.logits(params, base), dim=-1).detach().numpy()
    counts = np.stack([np.bincount(a, minlength=3) for a in
                       actions.numpy().reshape(3, draws)]) / draws
    se = np.sqrt(probs * (1 - probs) / draws)
    assert (np.abs(counts - probs) <= 5 * se + 1e-9).all(), (counts, probs)


# -- one Adam step ----------------------------------------------------------------
#
# Adam's first step moves each parameter by lr * g / (|g| + eps), eps 1e-8.
# Where |g| is near eps this amplifies a difference in g by up to
# lr / (4 eps) = 7.5e4: two float32 gradients that agree to a few 1e-10
# (summed in different orders by the two frameworks) can then move a
# parameter 1e-5 apart.  So each step is held three ways: against
# optax.adam applied to the port's own gradients, on every element, at
# atol 1e-5; against the reference's whole step (its gradients,
# optax.adam), at atol 1e-5 on every element whose reference gradient is
# at least 1e-6, where Adam's step amplifies a difference in g at most
# 30-fold; and against the reference's whole step on every element, at
# atol 1e-5 plus the measured gradient gap times the slope of
# g -> lr * g / (|g| + eps) between the two gradients, lr * eps /
# (min |g| + eps)^2 (lr / eps where their signs differ).  The last is
# the limit 1e-5 widened on the few elements where it is not met as
# written: one element of 4,096 differed by 1.7e-5.  The gradients
# themselves are held above at atol 1e-5.

LR = 3e-3
EPS = 1e-8  # optax.adam's
SENSITIVE = 1e-6


def _optax_step(tree, grads):
    opt = optax.adam(LR)
    updates, _ = opt.update(grads, opt.init(tree), tree)
    return optax.apply_updates(tree, updates)


def _flat(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


def _hold_step(got, tree, port_grads, ref_grads):
    """``got`` (port params after the step) against optax.adam applied to
    the port's gradients (every element), to the reference's (every
    element whose reference gradient is at least SENSITIVE), and to the
    reference's within 1e-5 plus Adam's amplification of the gradient gap
    (every element)."""
    flat = _flat
    same_grads = flat(_optax_step(tree, params_to_jax(port_grads)))
    reference = flat(_optax_step(tree, ref_grads))
    for g, a, b, pg, rg in zip(flat(params_to_jax(got)), same_grads, reference,
                               flat(params_to_jax(port_grads)), flat(ref_grads)):
        np.testing.assert_allclose(g, a, atol=1e-5)
        well = np.abs(rg) >= SENSITIVE
        assert well.mean() > 0.99
        np.testing.assert_allclose(g[well], b[well], atol=1e-5)
        pg, rg = pg.astype(np.float64), rg.astype(np.float64)
        least = np.where(np.sign(pg) == np.sign(rg), np.minimum(np.abs(pg), np.abs(rg)), 0.0)
        slope = LR * EPS / (least + EPS) ** 2
        gap = np.abs(g.astype(np.float64) - b)
        assert (gap <= 1e-5 + slope * np.abs(pg - rg)).all(), gap.max()


def test_one_adam_step_reinforce():
    tree = _jax_actor()
    r = _rollout(seed=9)
    returns = np.asarray(jpol.discounted_returns(jnp.asarray(r["rewards"]),
                                                 jnp.asarray(r["dones"]))).reshape(-1)
    ref_grads = jax.grad(lambda p: jpol.reinforce_loss(
        p, r["obs"], jnp.asarray(r["actions"]), returns))(tree)
    batch = {"obs": _t(r["obs"]), "actions": _t(r["actions"]).long(), "returns": _t(returns)}

    def loss(p, b):
        return tpol.reinforce_loss(p, b["obs"], b["actions"], b["returns"])

    _, port_grads = _torch_grads(lambda p: loss(p, batch), params_from_jax(tree, device="cpu"))
    state = TrainState.create(params_from_jax(tree, device="cpu"), lr=LR)
    state, _ = make_train_step(loss)(state, batch)
    _hold_step(state.params, tree, port_grads, ref_grads)


def test_one_adam_step_ppo():
    actor, critic = _jax_actor(), _jax_critic()
    r = _rollout(seed=10)
    adv, targets = jpol.gae(jnp.asarray(r["rewards"]), jnp.asarray(r["values"]),
                            jnp.asarray(r["last_values"]), jnp.asarray(r["dones"]))
    batch = {"obs": r["obs"], "actions": r["actions"], "logp_old": r["logp_old"],
             "advantages": np.asarray(adv).reshape(-1),
             "targets": np.asarray(targets).reshape(-1), "mask": r["mask"]}
    ref_grads = jax.grad(lambda ac: jpol.ppo_loss(
        ac[0], ac[1], {k: jnp.asarray(v) for k, v in batch.items()}))((actor, critic))
    tbatch = {k: _t(v) for k, v in batch.items()}

    def joint():
        return joint_params(params_from_jax(actor, device="cpu"),
                            params_from_jax(critic, device="cpu"))

    loss = make_ppo_loss()
    _, port_grads = _torch_grads(lambda p: loss(p, tbatch), joint())
    state = TrainState.create(joint(), lr=LR)
    state, _ = make_train_step(loss)(state, tbatch)
    for got, grads, ref, tree in zip(actor_critic(state.params), actor_critic(port_grads),
                                     ref_grads, (actor, critic)):
        _hold_step(got, tree, grads, ref)
