"""Policies and policy-gradient losses for the control (cartpole) workload:
the port of ``blendjax.models.policy``.

An MLP policy (tanh hidden layers; categorical over discrete actions, or
Gaussian with a state-independent log-std over continuous ones), its
sampling and log-probs, discounted returns, REINFORCE, a critic of the
same trunk, generalized advantage estimation and the clipped-surrogate PPO
objective.  Parameters are a flat ``{path: tensor}`` dict whose keys follow
the reference's pytree paths (``layers.0.w``, ``out.b``, ``log_std``), so
:mod:`blendjax_torch.models.convert` maps one onto the other leaf by leaf.
Randomness comes from an explicit ``torch.Generator`` on the parameters'
device, in place of a JAX key.  The returns and GAE run a reverse loop over
the rollout's T steps on the tensors' device, where the reference runs a
``lax.scan``.  ``logits`` dispatches per layer on its weight dict, so
the int8 params of :func:`blendjax_torch.ops.quant.quantize_policy` run
through the same body.
"""

from __future__ import annotations

import math

import torch

from blendjax_torch.models.layers import dense_apply, dense_init, layer, num_layers, prefixed
from blendjax_torch.utils.device import resolve_device


def _dense(prefix, d_in, d_out, generator, device):
    return prefixed(prefix, dense_init(d_in, d_out, generator=generator, device=device))


def init(generator, obs_dim, num_actions, hidden=(64, 64), continuous=False,
         device="cuda"):
    """MLP policy params drawn from ``generator`` (a ``torch.Generator`` on
    ``device``).  ``continuous=True`` adds a state-independent log-std head
    for a Gaussian policy."""
    device = resolve_device(device)
    dims = (obs_dim, *hidden)
    params = {}
    for i in range(len(dims) - 1):
        params.update(_dense(f"layers.{i}", dims[i], dims[i + 1], generator, device))
    params.update(_dense("out", dims[-1], num_actions, generator, device))
    if continuous:
        params["log_std"] = torch.zeros((num_actions,), device=device)
    return params


def _dense_mq(p, x):
    """``dense_apply`` of a float ``{'w', 'b'}`` or an int8 ``{'w_q',
    'w_scale', 'b'}`` layer."""
    if "w_q" in p:
        from blendjax_torch.ops.quant import dense_apply_int8

        return dense_apply_int8(p, x)
    return dense_apply(p, x)


def logits(params, obs):
    x = obs.to(torch.float32)
    for i in range(num_layers(params, "layers")):
        x = torch.tanh(_dense_mq(layer(params, f"layers.{i}"), x))
    return _dense_mq(layer(params, "out"), x)


def sample_action(params, generator, obs):
    """Sample actions (and their log-probs) for a batch of observations.
    Categorical draws take the Gumbel-max form, as ``jax.random.categorical``
    does; Gaussian ones add ``exp(log_std)`` times a standard normal."""
    out = logits(params, obs)
    if "log_std" in params:
        eps = torch.randn(out.shape, generator=generator, device=out.device)
        action = out + torch.exp(params["log_std"]) * eps
        return action, gaussian_log_prob(params, obs, action)
    u = torch.rand(out.shape, generator=generator, device=out.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    action = torch.argmax(out + gumbel, dim=-1)
    logp = torch.log_softmax(out, dim=-1).gather(-1, action[:, None])[:, 0]
    return action, logp


def categorical_log_prob(params, obs, actions):
    lp = torch.log_softmax(logits(params, obs), dim=-1)
    return lp.gather(-1, actions.long()[..., None])[..., 0]


def gaussian_log_prob(params, obs, actions):
    mean = logits(params, obs)
    log_std = params["log_std"]
    z = (actions - mean) / torch.exp(log_std)
    return (-0.5 * z * z - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)


def discounted_returns(rewards, dones, gamma=0.99):
    """Per-step discounted returns over a (T, N) rollout, resetting at
    episode boundaries."""
    not_done = 1.0 - dones.to(torch.float32)
    out = torch.empty_like(rewards)
    carry = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        carry = rewards[t] + gamma * carry * not_done[t]
        out[t] = carry
    return out


def _local(x):
    return x


_local.n_ranks = 1


def normalized_advantage(x, weight=None, reduce=None):
    """``(advantage, scale)`` of a batch of returns ``x``: the advantage is
    ``x`` less its (``weight``-ed) mean over the batch, over its population
    std, detached; ``scale`` turns a weighted sum over the rows into the
    batch mean.  A loss is ``-(weight * logp * advantage).sum() * scale``.

    ``reduce`` (a data-parallel rank's rows of the global batch:
    :func:`blendjax_torch.parallel.podracer.data_sum`) sums a detached tensor
    over the ranks: the weight, the mean and the variance are the global
    batch's, and ``scale`` carries the rank count, so that the sharded
    step's mean over ranks is the global loss and gradient whatever the
    ranks' shares.  The count is summed on the device, so a captured step
    holds no host copy.
    """
    reduce = _local if reduce is None else reduce
    w = torch.ones_like(x) if weight is None else weight
    wsum = torch.clamp_min(reduce(w.sum()), 1.0)
    mu = reduce((w * x).sum()) / wsum
    var = reduce((w * (x - mu) ** 2).sum()) / wsum
    advantage = (x - mu) / (torch.sqrt(var) + 1e-6)
    return advantage.detach(), reduce.n_ranks / wsum


def reinforce_loss(params, obs, actions, returns, continuous=False, reduce=None):
    """-E[log pi(a|s) * (G - baseline)] with a batch-mean baseline, the
    advantage scaled by the returns' (population) std and detached
    (:func:`normalized_advantage`, over every rank with ``reduce``).

    ``obs`` (T*N, obs_dim), ``actions`` (T*N,), ``returns`` (T*N,).
    """
    if continuous:
        logp = gaussian_log_prob(params, obs, actions)
    else:
        logp = categorical_log_prob(params, obs, actions)
    advantage, scale = normalized_advantage(returns, reduce=reduce)
    return -(logp * advantage).sum() * scale


def value_init(generator, obs_dim, hidden=(64, 64), device="cuda"):
    """MLP state-value params (critic): the policy trunk with a 1-output
    head."""
    return init(generator, obs_dim, 1, hidden=hidden, device=device)


def value_apply(params, obs):
    return logits(params, obs)[..., 0]


def gae(rewards, values, last_values, dones, gamma=0.99, lam=0.95):
    """Generalized advantage estimation over a (T, N) rollout.

    ``values`` (T, N) are V(s_t) along the rollout, ``last_values`` (N,)
    is V(s_T) bootstrapping the tail; episode boundaries cut both the
    bootstrap and the trace.  Returns (advantages, value_targets), each
    (T, N)."""
    nd = 1.0 - dones.to(torch.float32)
    next_values = torch.cat([values[1:], last_values[None]], dim=0)
    deltas = rewards + gamma * next_values * nd - values
    adv = torch.empty_like(deltas)
    carry = torch.zeros_like(deltas[0])
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * lam * nd[t] * carry
        adv[t] = carry
    return adv, adv + values


def ppo_loss(actor, critic, batch, clip_eps=0.2, vf_coef=0.5, ent_coef=0.01,
             continuous=False):
    """Clipped-surrogate PPO objective + value MSE + entropy bonus.

    ``batch``: obs (B, D), actions (B,), logp_old (B,), advantages (B,)
    (normalized here), targets (B,), optional mask (B,): zero weight for
    fabricated transitions (an autoresetting pool's reset step records a
    sampled action that never ran).  Returns the combined scalar.
    """
    obs, actions = batch["obs"], batch["actions"]
    w = batch.get("mask")
    if w is None:
        w = torch.ones(actions.shape[0], dtype=torch.float32, device=actions.device)
    wsum = torch.clamp_min(w.sum(), 1.0)

    def wmean(x):
        return (w * x).sum() / wsum

    if continuous:
        logp = gaussian_log_prob(actor, obs, actions)
    else:
        logp = categorical_log_prob(actor, obs, actions)
    adv = batch["advantages"]
    mu = wmean(adv)
    std = torch.sqrt(wmean((adv - mu) ** 2))
    adv = (adv - mu) / (std + 1e-6)
    ratio = torch.exp(logp - batch["logp_old"])
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
    policy_loss = -wmean(torch.minimum(ratio * adv, clipped * adv))
    v = value_apply(critic, obs)
    value_loss = wmean((v - batch["targets"]) ** 2)
    if continuous:
        ent = torch.sum(actor["log_std"] + 0.5 * math.log(2 * math.pi * math.e))
    else:
        lp = torch.log_softmax(logits(actor, obs), dim=-1)
        ent = -wmean(torch.sum(torch.exp(lp) * lp, dim=-1))
    return policy_loss + vf_coef * value_loss - ent_coef * ent
