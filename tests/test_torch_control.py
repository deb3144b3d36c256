"""The port's control twins (``blendjax_torch.control``) on the CPU.

The REINFORCE and PPO loops learn the numpy cartpole by the reference's
own criteria (``tests/test_examples.py``: REINFORCE's late returns at
least 0.8 x its early ones, PPO's above 1.3 x), through a pool-shaped
stand-in that is a copy of that file's ``_NumpyCartpolePool``.  Then both
twins, and the P-controller, run over real port cartpole producers
(``btb/cartpole.blend.py`` under the fake Blender with
``BLENDJAX_FAKE_BPY=1``) for a few iterations.
"""

import numpy as np
import pytest
import torch

from blendjax_torch import control
from blendjax_torch.btb import cartpole
from blendjax_torch.btt.env import launch_env
from blendjax_torch.btt.envpool import launch_env_pool
from helpers import FAKE_BLENDER
from helpers.time_limit import time_limit


class _NumpyCartpolePool:
    """Classic cartpole dynamics as an EnvPool stand-in (pure numpy), a
    copy of ``tests/test_examples.py``'s."""

    def __init__(self, n, seed=0):
        self.n = n
        self.rng = np.random.default_rng(seed)
        self.state = np.zeros((n, 4))  # x, x_dot, theta, theta_dot
        self.steps = np.zeros(n, int)

    def _obs(self):
        x, _, th, _ = self.state.T
        return np.stack([x, x + np.sin(th), th], axis=1).astype(np.float32)

    def reset(self):
        self.state = self.rng.uniform(-0.05, 0.05, (self.n, 4))
        self.steps[:] = 0
        return self._obs(), [{}] * self.n

    def step(self, forces):
        g, mc, mp, l, dt = 9.8, 1.0, 0.1, 0.5, 0.02
        f = np.asarray(forces)
        x, x_dot, th, th_dot = self.state.T
        cos, sin = np.cos(th), np.sin(th)
        temp = (f + mp * l * th_dot**2 * sin) / (mc + mp)
        th_acc = (g * sin - cos * temp) / (l * (4 / 3 - mp * cos**2 / (mc + mp)))
        x_acc = temp - mp * l * th_acc * cos / (mc + mp)
        self.state = np.stack(
            [x + dt * x_dot, x_dot + dt * x_acc, th + dt * th_dot, th_dot + dt * th_acc],
            axis=1,
        )
        self.steps += 1
        dones = (np.abs(self.state[:, 2]) > 0.21) | (np.abs(self.state[:, 0]) > 2.4) | (
            self.steps >= 200
        )
        rewards = np.ones(self.n, np.float32)
        if dones.any():  # auto-reset finished lanes
            idx = np.where(dones)[0]
            self.state[idx] = self.rng.uniform(-0.05, 0.05, (len(idx), 4))
            self.steps[idx] = 0
        return self._obs(), rewards, dones, [{}] * self.n


@pytest.fixture
def one_thread():
    """Tiny ops run fastest on one CPU thread (and the suite runs its
    files in parallel workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_reinforce_training_runs_and_improves(one_thread):
    state, returns = control.train_reinforce(_NumpyCartpolePool(8), iterations=12,
                                             horizon=48, lr=5e-3, log_every=0,
                                             device="cpu")
    assert len(returns) == 12
    assert np.isfinite(returns).all()
    # weak improvement check: late episodes last at least as long as early
    assert np.mean(returns[-4:]) >= np.mean(returns[:4]) * 0.8
    assert state.step == 12


def test_ppo_training_runs_and_improves(one_thread):
    """PPO (actor-critic, GAE, clipped surrogate; 4 optimizer steps per
    rollout) learns the numpy cartpole: late returns beat early ones."""
    state, rets = control.train_ppo(_NumpyCartpolePool(8, seed=3), iterations=30,
                                    horizon=64, log_every=0, device="cpu")
    early, late = np.mean(rets[:5]), np.mean(rets[-5:])
    assert late > early * 1.3, (early, late)
    assert state.step == 30 * 4
    actor, critic = control.actor_critic(state.params)
    assert set(actor) == {"layers.0.w", "layers.0.b", "layers.1.w", "layers.1.b",
                          "out.w", "out.b"}
    assert critic["out.w"].shape == (64, 1)


def test_twins_report_each_iteration(one_thread, capsys):
    recs = []
    control.train_reinforce(_NumpyCartpolePool(4), iterations=2, horizon=8, log_every=1,
                            device="cpu", on_iteration=recs.append)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and lines[0].startswith("iter 1: loss ")
    assert [r["iteration"] for r in recs] == [1, 2]
    for r in recs:
        assert r["rollout_ms"] >= r["policy_ms"] + r["env_ms"] > 0
        assert r["update_ms"] > 0 and np.isfinite(r["loss"])


@time_limit(120)
def test_not_ported_options_name_their_roadmap_item():
    """``train_reinforce(mesh=)`` is ported: on 2 gloo ranks, each stepping
    its own numpy cartpole pool, both ranks take the same updates; and one
    sharded update on an uneven 10/6 split of a seeded batch equals one
    process's on the whole batch (SGD(0.1): the loss within 1e-6, every
    parameter within 1e-6)."""
    from blendjax_torch.models import policy
    from blendjax_torch.models.train import TrainState, make_train_step
    from helpers import torch_parallel_ranks
    from helpers.torch_ranks import Ranks

    rng = np.random.default_rng(4)
    params = policy.init(torch.Generator().manual_seed(1), 3, 2, device="cpu")
    batch = {"obs": rng.standard_normal((16, 3)).astype(np.float32),
             "actions": rng.integers(0, 2, 16).astype(np.int64),
             "returns": rng.standard_normal(16).astype(np.float32)}
    ranks = Ranks(torch_parallel_ranks.control_mesh, 2,
                  {"held": {"params": {k: v.numpy() for k, v in params.items()},
                            "batch": batch}})
    try:
        train, held = ranks.result("train", 100), ranks.result("held", 15)
    finally:
        ranks.close()
    assert train[0]["losses"] == train[1]["losses"] and np.isfinite(train[0]["losses"]).all()
    assert len(train[0]["returns"]) == 2
    for k, v in train[0]["params"].items():
        np.testing.assert_array_equal(v, train[1]["params"][k])
    state = TrainState.create(params)
    state.optimizer = torch.optim.SGD(list(state.params.values()), lr=0.1)
    step = make_train_step(lambda p, b: policy.reinforce_loss(p, b["obs"], b["actions"],
                                                              b["returns"]))
    state, loss = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for rec in held.values():
        np.testing.assert_allclose(rec["loss"], float(loss), atol=1e-6)
        for k, v in rec["params"].items():
            np.testing.assert_allclose(v, state.params[k].detach().numpy(), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("source", ["copy", "reference"])
def test_producer_dynamics_equal_the_numpy_pool(source):
    """The producer's dynamics (``btb/cartpole.py``: ``step_state``,
    ``finished``, ``observe``) step the same states under the same forces
    to the same states, observations, rewards and dones as the numpy pool
    the reference's control tests train on (and this file's copy of it),
    bit for bit, over episodes that end by each of the three causes."""
    pool_cls = _NumpyCartpolePool
    if source == "reference":
        from test_examples import _NumpyCartpolePool as pool_cls
    n = 8
    pool = pool_cls(n, seed=5)
    pool.reset()
    # two lanes start near the track's ends, moving outward
    pool.state[3] = [2.35, 2.0, 0.0, 0.0]
    pool.state[4] = [-2.35, -2.0, 0.0, 0.0]
    rng = np.random.default_rng(6)
    lane = np.arange(n)
    causes = set()
    for _ in range(600):
        state, steps = pool.state.copy(), pool.steps.copy()
        balance = np.clip(60 * state[:, 2] + 10 * state[:, 3], -20, 20)
        forces = np.where(lane < 3, rng.choice([-20.0, 20.0], n), balance)
        obs, rewards, dones, _ = pool.step(list(forces))
        want = cartpole.step_state(state, forces)
        want_done = cartpole.finished(want, steps + 1)
        np.testing.assert_array_equal(dones, want_done)
        np.testing.assert_array_equal(rewards, 1.0)
        live = ~want_done  # finished lanes were reset by the pool
        np.testing.assert_array_equal(pool.state[live], want[live])
        np.testing.assert_array_equal(obs[live], cartpole.observe(want)[live])
        for i in np.flatnonzero(want_done):
            causes |= {c for c, hit in (("angle", abs(want[i, 2]) > cartpole.ANGLE_LIMIT),
                                        ("x", abs(want[i, 0]) > cartpole.X_LIMIT),
                                        ("steps", steps[i] + 1 >= cartpole.MAX_STEPS)) if hit}
    assert causes == {"angle", "x", "steps"}


@pytest.fixture
def fake_blender(monkeypatch):
    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)
    monkeypatch.setenv("BLENDJAX_FAKE_BPY", "1")


def _port():
    import socket

    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", port + 1))
            return port
        except OSError:
            continue
    raise RuntimeError("no free port pair")


@pytest.mark.parametrize("algo", ["reinforce", "ppo"])
def test_twins_over_port_cartpole_producers(fake_blender, one_thread, algo):
    train = control.train_reinforce if algo == "reinforce" else control.train_ppo
    with launch_env_pool(scene="", script=str(control.SCRIPT), num_instances=2,
                         background=True, start_port=_port(), seed=0,
                         real_time=False) as pool:
        state, returns = train(pool, iterations=3, horizon=32, log_every=0, device="cpu")
        assert pool.healthy.all()
    assert len(returns) == 3 and np.isfinite(returns).all()
    assert all(torch.isfinite(v).all() for v in state.params.values())


def test_p_controller_over_a_port_cartpole(fake_blender):
    with launch_env(scene="", script=str(control.SCRIPT), background=True,
                    start_port=_port(), seed=0, real_time=False) as env:
        lengths = control.run_p_controller(env, steps=300)
    # pushing toward the lean alone does not hold the pole up, but the
    # episodes end by the dynamics' own limits, within 200 steps each
    assert lengths and all(1 <= n <= 200 for n in lengths)
