"""Damped driven pendulum episodes, the world model's data: the dynamics of
``examples/worldmodel/pendulum.blend.py`` without the scene, as that
example's ``simulate_episode`` writes them.  numpy only, so producers run
it under Blender's interpreter and the trainer uses it for held-out data.
"""

from __future__ import annotations

import numpy as np

#: observation channels the dynamics fill: [cos th, sin th, omega, drive,
#: bob x, bob y, bob z, pad]; channels from here on are zero
OBS_CHANNELS = 8


def simulate_episode(rng, batch, T_steps, obs_dim=OBS_CHANNELS):
    """``batch`` episodes of ``T_steps + 1`` observations each, (batch,
    T_steps + 1, obs_dim) float32.  Each episode draws its initial angle,
    angular velocity, drive amplitude and drive frequency from ``rng`` in
    that order, then integrates with dt = 0.05 and records the state after
    every step."""
    eps = []
    for _ in range(batch):
        th = rng.uniform(-2.0, 2.0)
        om = rng.uniform(-1.0, 1.0)
        amp = rng.uniform(0.2, 1.5)
        freq = rng.uniform(0.5, 2.0)
        t = 0.0
        obs = []
        for _f in range(T_steps + 1):
            drive = amp * np.sin(freq * t)
            om += (-9.81 / 2.0 * np.sin(th) - 0.15 * om + drive) * 0.05
            th += om * 0.05
            t += 0.05
            o = np.zeros(obs_dim, np.float32)
            o[0], o[1], o[2] = np.cos(th), np.sin(th), om
            o[3] = amp * np.sin(freq * t)
            # bob world position: Ry(theta) @ (0, 0, -2)
            o[4] = -2.0 * np.sin(th)
            o[6] = -2.0 * np.cos(th)
            obs.append(o)
        eps.append(np.stack(obs))
    return np.stack(eps)
