"""Cartpole as a Blender env: the classic cart-pole dynamics in numpy,
without the scene.

``examples/control/cartpole.blend.py`` builds a cart and a hinged pole and
lets Blender's rigid-body solver integrate them; the fake Blender simulates
no rigid bodies.  So the port's producer integrates the dynamics the JAX
package's own control tests train on (``_NumpyCartpolePool`` in
``tests/test_examples.py``): gravity 9.8, cart mass 1.0, pole mass 0.1,
half-length 0.5, dt 0.02, Euler steps; an episode ends when
|angle| > 0.21, |x| > 2.4 or after 200 steps.  It keeps the example's env
contract: action = the force on the cart, obs = (cart_x, pole_x,
pole_angle) with pole_x = cart_x + sin(angle), reward 1 per step.

:class:`Cartpole` is the dynamics with its own generator (each reset draws
the 4 state values uniformly in [-0.05, 0.05]); :class:`CartpoleEnv` is the
:class:`~blendjax_torch.btb.env.BaseEnv` that steps it one frame at a time
(``btb/cartpole.blend.py`` runs it).  numpy only, no torch.
"""

from __future__ import annotations

import numpy as np

from blendjax_torch.btb.env import BaseEnv

GRAVITY, CART_MASS, POLE_MASS, HALF_LENGTH, DT = 9.8, 1.0, 0.1, 0.5, 0.02
ANGLE_LIMIT, X_LIMIT, MAX_STEPS = 0.21, 2.4, 200
OBS_DIM = 3


def step_state(state, force):
    """One Euler step of ``state`` (..., 4) = (x, x_dot, theta, theta_dot)
    under ``force`` (broadcast over the leading axes)."""
    f = np.asarray(force)
    x, x_dot, th, th_dot = np.moveaxis(np.asarray(state, np.float64), -1, 0)
    cos, sin = np.cos(th), np.sin(th)
    total = CART_MASS + POLE_MASS
    temp = (f + POLE_MASS * HALF_LENGTH * th_dot**2 * sin) / total
    th_acc = (GRAVITY * sin - cos * temp) / (
        HALF_LENGTH * (4 / 3 - POLE_MASS * cos**2 / total))
    x_acc = temp - POLE_MASS * HALF_LENGTH * th_acc * cos / total
    return np.stack([x + DT * x_dot, x_dot + DT * x_acc, th + DT * th_dot,
                     th_dot + DT * th_acc], axis=-1)


def observe(state):
    """(..., 4) state -> (..., 3) float32 obs (cart_x, pole_x, angle)."""
    x, _, th, _ = np.moveaxis(np.asarray(state), -1, 0)
    return np.stack([x, x + np.sin(th), th], axis=-1).astype(np.float32)


def finished(state, steps):
    """Whether an episode ends at ``state`` after ``steps`` steps."""
    state = np.asarray(state)
    return ((np.abs(state[..., 2]) > ANGLE_LIMIT) | (np.abs(state[..., 0]) > X_LIMIT)
            | (np.asarray(steps) >= MAX_STEPS))


class Cartpole:
    """One cartpole and its generator, seeded ``seed``."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.state = None
        self.steps = 0

    def reset(self):
        """Draw a fresh initial state; returns its obs."""
        self.state = self.rng.uniform(-0.05, 0.05, 4)
        self.steps = 0
        return observe(self.state)

    def step(self, force):
        """Apply ``force`` for one step; returns ``(obs, reward, done)``."""
        self.state = step_state(self.state, float(force))
        self.steps += 1
        return observe(self.state), 1.0, bool(finished(self.state, self.steps))


class CartpoleEnv(BaseEnv):
    """:class:`Cartpole` as a Blender env: the action (the force) applies
    before the frame, the post-step dict carries ``obs`` (a float32 (3,)
    array), ``reward`` and ``done``."""

    def __init__(self, agent, seed):
        super().__init__(agent)
        self.cartpole = Cartpole(seed)
        self.last = None

    def _env_reset(self):
        self.last = (self.cartpole.reset(), 1.0, False)

    def _env_prepare_step(self, action):
        self.last = self.cartpole.step(action)

    def _env_post_step(self):
        obs, reward, done = self.last
        return {"obs": obs, "reward": reward, "done": done}
