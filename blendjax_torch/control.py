"""Learned control over a fleet of Blender cartpoles, on the card: the
counterpart of ``examples/control/`` (``cartpole.py``, ``train_reinforce.py``,
``train_ppo.py``).

    python -m blendjax_torch.control --algo p           # P-controller, one env
    python -m blendjax_torch.control --algo reinforce   # 4 envs, REINFORCE
    python -m blendjax_torch.control --algo ppo         # 4 envs, PPO

N producers run :file:`btb/cartpole.blend.py` (the cart-pole dynamics in
numpy behind a ``RemoteControlledAgent``); an
:class:`~blendjax_torch.btt.envpool.EnvPool` steps them in lockstep.  At
every step the observations go to the card, the policy samples the actions
there, and the forces come back; after each rollout the returns (or the
advantages) are computed on the card and the update runs through
:func:`blendjax_torch.models.train.make_train_step`: one captured CUDA
graph on the card, eager on the CPU.  PPO runs ``epochs`` such steps per
rollout over actor and critic under one Adam, where the reference runs one
jitted ``scan``.  Point ``$BLENDJAX_BLENDER`` at a Blender, or at
``tests/helpers/fake_blender.py`` with ``BLENDJAX_FAKE_BPY=1``.

The training loops (:func:`train_reinforce`, :func:`train_ppo`) take any
pool-like object with ``reset()`` and ``step(actions)``.  ``on_iteration``
gets each iteration's numbers: the loss, the mean return, ``rollout_ms``
and ``update_ms`` (the returns or advantages and the optimizer steps, to
the loss on the host), and per rollout step the ``policy`` round trip
(observations to the card, the sample, the actions back) and the pool's
``env`` step, as sums and medians.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from blendjax_torch.models import policy
from blendjax_torch.models.train import TrainState, make_train_step
from blendjax_torch.utils.device import resolve_device

SCRIPT = Path(__file__).parent / "btb" / "cartpole.blend.py"
FORCE_MAG = 20.0


def p_control(obs):
    """The reference's P-controller: push toward the lean."""
    _, _, angle = obs
    return 35.0 * angle


def run_p_controller(env, steps=1000):
    """Drive one :class:`~blendjax_torch.btt.env.RemoteEnv` with
    :func:`p_control` for ``steps`` steps, resetting after each episode;
    returns the lengths of the episodes that ended."""
    obs, _ = env.reset()
    lengths, length = [], 0
    for _ in range(steps):
        obs, _, done, _ = env.step(float(p_control(obs)))
        length += 1
        if done:
            lengths.append(length)
            length = 0
            obs, _ = env.reset()
    return lengths


def _forces(actions):
    """Sampled {0, 1} actions on the card -> forces {-mag, +mag} on the host."""
    return list(((actions.cpu().numpy() * 2 - 1) * FORCE_MAG).astype(float))


def _mean_episode_return(rewards, dones, mask=None):
    """Reward per finished episode over a (T, N) rollout, or per lane when
    no episode finished (so the log stays comparable)."""
    total = float((rewards if mask is None else rewards * mask).sum())
    finished = float(dones.sum())
    return total / finished if finished else total / rewards.shape[1]


class Rollout:
    """One iteration's rollout buffers (obs, actions and log-probs on the
    device; rewards and dones as the pool returned them) and the times of
    its steps' stages."""

    def __init__(self, device):
        self.device = device
        self.obs, self.actions, self.logp, self.rewards, self.dones = [], [], [], [], []
        self.times = {"policy": [], "env": []}
        self.t0 = time.perf_counter()

    def step(self, pool, params, generator, obs):
        """Sample on the card for ``obs``, step the pool with the forces;
        returns the pool's next obs and its dones."""
        t0 = time.perf_counter()
        obs_t = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        with torch.no_grad():
            actions, logp = policy.sample_action(params, generator, obs_t)
        forces = _forces(actions)
        t1 = time.perf_counter()
        next_obs, rewards, dones, _ = pool.step(forces)
        self.times["policy"].append(t1 - t0)
        self.times["env"].append(time.perf_counter() - t1)
        self.obs.append(obs_t)
        self.actions.append(actions)
        self.logp.append(logp)
        self.rewards.append(rewards)
        self.dones.append(dones)
        return next_obs, dones

    def tensors(self):
        """Rewards and dones as (T, N) tensors on the device."""
        return (torch.as_tensor(np.stack(self.rewards), device=self.device),
                torch.as_tensor(np.stack(self.dones), device=self.device))


def _report(it, rollout, rollout_s, update_s, loss, mean_ep, on_iteration, log_every):
    if on_iteration is not None:
        on_iteration({
            "iteration": it + 1, "loss": loss, "mean_return": mean_ep,
            "rollout_ms": rollout_s * 1e3, "update_ms": update_s * 1e3,
            "policy_ms": sum(rollout.times["policy"]) * 1e3,
            "env_ms": sum(rollout.times["env"]) * 1e3,
            "policy_p50_ms": float(np.median(rollout.times["policy"])) * 1e3,
            "env_p50_ms": float(np.median(rollout.times["env"])) * 1e3})
    if log_every and (it + 1) % log_every == 0:
        print(f"iter {it + 1}: loss {loss:.4f} reward/episode {mean_ep:.1f}")


def train_reinforce(pool, obs_dim=3, num_actions=2, iterations=50, horizon=64, lr=3e-3,
                    gamma=0.99, generator=None, log_every=5, mesh=None, device="cuda",
                    on_iteration=None):
    """Rollout ``horizon`` lockstep steps across the pool per iteration,
    then one REINFORCE update.  Returns (state, per-iteration mean returns).

    ``generator`` (on ``device``) draws the actions, seed 0 by default; the
    parameters come from seed 1, as the reference's keys 0 and 1.
    ``on_iteration``, if given, gets each iteration's numbers as a dict.

    With ``mesh`` (a torch DeviceMesh with a ``'data'`` axis, made by every
    rank) the update is data-parallel over the ranks: each rank steps the
    pool it owns, on the mesh's device, its default generator seeded with
    its data index, and feeds its transitions to
    :func:`~blendjax_torch.parallel.sharding.make_sharded_train_step` with
    the policy replicated.  The advantage's baseline and std and the mean
    are the global batch's (``reinforce_loss(reduce=)``), so the update is
    one process's on every rank's transitions together.  The mean returns
    are this rank's.
    """
    reduce = None
    if mesh is not None:
        from blendjax_torch.parallel.podracer import data_sum
        from blendjax_torch.parallel.sharding import make_sharded_train_step

        device, reduce = mesh.device_type, data_sum(mesh)
    device = resolve_device(device)
    seed = 0 if mesh is None else mesh.get_local_rank("data")
    gen = generator or torch.Generator(device=device).manual_seed(seed)
    params = policy.init(torch.Generator(device=device).manual_seed(1), obs_dim, num_actions,
                         device=device)

    def loss_fn(p, batch):
        return policy.reinforce_loss(p, batch["obs"], batch["actions"], batch["returns"],
                                     reduce=reduce)

    if mesh is None:
        state = TrainState.create(params, lr=lr)
        step = make_train_step(loss_fn)
    else:
        init_sharded, step = make_sharded_train_step(loss_fn, mesh, lr=lr)
        state = init_sharded(params)
    returns_log = []
    obs, _ = pool.reset()
    for it in range(iterations):
        ro = Rollout(device)
        # the actors sample from this rank's replica of the parameters
        local = {k: v.to_local() if isinstance(v, DTensor) else v
                 for k, v in state.params.items()}
        for _ in range(horizon):
            obs, _ = ro.step(pool, local, gen, obs)
        t1 = time.perf_counter()
        rewards, dones = ro.tensors()
        returns = policy.discounted_returns(rewards, dones, gamma)
        batch = {"obs": torch.cat(ro.obs), "actions": torch.cat(ro.actions),
                 "returns": returns.reshape(-1)}
        state, loss = step(state, batch)
        loss = float(loss)
        t2 = time.perf_counter()
        mean_ep = _mean_episode_return(np.stack(ro.rewards), np.stack(ro.dones))
        returns_log.append(mean_ep)
        _report(it, ro, t1 - ro.t0, t2 - t1, loss, mean_ep, on_iteration, log_every)
    return state, returns_log


def actor_critic(params):
    """The joint PPO parameter dict (``actor.*``, ``critic.*``) split into
    the actor's and the critic's."""
    actor = {k[6:]: v for k, v in params.items() if k.startswith("actor.")}
    critic = {k[7:]: v for k, v in params.items() if k.startswith("critic.")}
    return actor, critic


def joint_params(actor, critic):
    """Inverse of :func:`actor_critic`."""
    return {**{f"actor.{k}": v for k, v in actor.items()},
            **{f"critic.{k}": v for k, v in critic.items()}}


def make_ppo_loss(clip_eps=0.2):
    """``loss(params, batch)`` over the joint actor-critic params."""
    def loss_fn(params, batch):
        actor, critic = actor_critic(params)
        return policy.ppo_loss(actor, critic, batch, clip_eps=clip_eps)
    return loss_fn


def ppo_batch(critic, rollout, last_obs, masks, gamma=0.99, lam=0.95):
    """One rollout as PPO's batch: the critic's values along it and at
    ``last_obs``, GAE, and the flattened (T*N) tensors on the device."""
    obs_t = torch.stack(rollout.obs)  # (T, N, D)
    rewards, dones = rollout.tensors()
    with torch.no_grad():
        values = policy.value_apply(critic, obs_t)  # (T, N)
        last = torch.as_tensor(np.asarray(last_obs, np.float32), device=rollout.device)
        adv, targets = policy.gae(rewards, values, policy.value_apply(critic, last), dones,
                                  gamma, lam)
    return {"obs": obs_t.reshape(-1, obs_t.shape[-1]),
            "actions": torch.cat(rollout.actions), "logp_old": torch.cat(rollout.logp),
            "advantages": adv.reshape(-1), "targets": targets.reshape(-1),
            "mask": torch.as_tensor(np.concatenate(masks), device=rollout.device)}


def train_ppo(pool, obs_dim=3, num_actions=2, iterations=40, horizon=128, lr=3e-3,
              gamma=0.99, lam=0.95, clip_eps=0.2, epochs=4, generator=None, log_every=5,
              device="cuda", on_iteration=None):
    """Rollout ``horizon`` lockstep steps per iteration, then ``epochs``
    full-batch PPO updates of actor and critic under one Adam.  Returns
    (state, per-iteration mean returns); :func:`actor_critic` splits
    ``state.params``.

    ``generator`` (on ``device``) draws the actions, seed 0 by default; the
    actor comes from seed 1 and the critic from seed 2.  ``on_iteration``,
    if given, gets each iteration's numbers as a dict.
    """
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    actor = policy.init(torch.Generator(device=device).manual_seed(1), obs_dim, num_actions,
                        device=device)
    critic = policy.value_init(torch.Generator(device=device).manual_seed(2), obs_dim,
                               device=device)
    state = TrainState.create(joint_params(actor, critic), lr=lr)
    # the captured step updates the parameters in place: these views stay
    actor, critic = actor_critic(state.params)
    step = make_train_step(make_ppo_loss(clip_eps))

    returns_log = []
    obs, _ = pool.reset()
    prev_dones = np.zeros(len(obs), bool)
    for it in range(iterations):
        ro, masks = Rollout(device), []
        for _ in range(horizon):
            obs, dones = ro.step(pool, actor, gen, obs)
            # a lane that reported done executes RESET on the next step:
            # that transition's action never ran, so it gets zero weight in
            # the loss (its GAE trace is already cut by the done itself)
            masks.append(1.0 - prev_dones.astype(np.float32))
            prev_dones = np.asarray(dones, bool)
        t1 = time.perf_counter()
        batch = ppo_batch(critic, ro, obs, masks, gamma, lam)
        for _ in range(epochs):
            state, loss = step(state, batch)
        loss = float(loss)
        t2 = time.perf_counter()
        # the reward sum takes the loss's mask: the fabricated reset-step
        # transitions count no more in the log than in the update
        mean_ep = _mean_episode_return(np.stack(ro.rewards), np.stack(ro.dones),
                                       np.stack(masks))
        returns_log.append(mean_ep)
        _report(it, ro, t1 - ro.t0, t2 - t1, loss, mean_ep, on_iteration, log_every)
    return state, returns_log


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--algo", choices=("p", "reinforce", "ppo"), default="reinforce")
    ap.add_argument("--instances", type=int, default=4)
    ap.add_argument("--iterations", type=int, default=None,
                    help="training iterations (default: 50 REINFORCE, 40 PPO)")
    ap.add_argument("--steps", type=int, default=1000, help="P-controller steps")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--start-port", type=int, default=11000)
    args = ap.parse_args(argv)

    from blendjax_torch.btt.env import launch_env
    from blendjax_torch.btt.envpool import launch_env_pool

    launch = dict(scene="", script=str(SCRIPT), background=True, real_time=False,
                  start_port=args.start_port, seed=0)
    if args.algo == "p":
        with launch_env(**launch) as env:
            lengths = run_p_controller(env, steps=args.steps)
        print(f"{len(lengths)} episodes ended, lengths {lengths}")
        return 0
    train = train_reinforce if args.algo == "reinforce" else train_ppo
    kwargs = {"device": args.device}
    if args.iterations is not None:
        kwargs["iterations"] = args.iterations
    with launch_env_pool(num_instances=args.instances, **launch) as pool:
        _, returns = train(pool, **kwargs)
    print(f"reward/episode, first {returns[0]:.1f}, last {returns[-1]:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
