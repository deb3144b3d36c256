"""The world model's data: damped driven pendulum episodes.

A frozen copy of the producers' simulator (the dynamics of the world-model
example's ``pendulum.blend.py``), so the benchmark makes its traffic
without the program's code.

:func:`simulate_episode` is the producers' own loop, step by step, and
gives their bytes; :func:`simulate_batch` integrates many episodes at once
(the pool traffic), drawing each episode's four parameters in the same
order.
"""

from __future__ import annotations

import numpy as np

#: observation channels the dynamics fill; channels from here on are zero
OBS_CHANNELS = 8
DT = 0.05


def _draw(rng, n):
    """Each episode's initial angle, angular velocity, drive amplitude and
    drive frequency, drawn episode by episode in that order: (n, 4)."""
    return np.array([(rng.uniform(-2.0, 2.0), rng.uniform(-1.0, 1.0),
                      rng.uniform(0.2, 1.5), rng.uniform(0.5, 2.0)) for _ in range(n)],
                    dtype=np.float64).reshape(n, 4)


def simulate_episode(rng, batch, T_steps, obs_dim=OBS_CHANNELS):
    """(batch, T_steps + 1, obs_dim) float32, scalar by scalar as a producer
    integrates it."""
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
            om += (-9.81 / 2.0 * np.sin(th) - 0.15 * om + drive) * DT
            th += om * DT
            t += DT
            o = np.zeros(obs_dim, np.float32)
            o[0], o[1], o[2] = np.cos(th), np.sin(th), om
            o[3] = amp * np.sin(freq * t)
            o[4] = -2.0 * np.sin(th)
            o[6] = -2.0 * np.cos(th)
            obs.append(o)
        eps.append(np.stack(obs))
    return np.stack(eps)


def simulate_batch(rng, batch, T_steps, obs_dim=OBS_CHANNELS):
    """The same dynamics for ``batch`` episodes integrated together:
    (batch, T_steps + 1, obs_dim) float32."""
    th, om, amp, freq = _draw(rng, batch).T.copy()
    out = np.zeros((batch, T_steps + 1, obs_dim), np.float32)
    t = 0.0
    for f in range(T_steps + 1):
        drive = amp * np.sin(freq * t)
        om = om + (-9.81 / 2.0 * np.sin(th) - 0.15 * om + drive) * DT
        th = th + om * DT
        t += DT
        out[:, f, 0], out[:, f, 1], out[:, f, 2] = np.cos(th), np.sin(th), om
        out[:, f, 3] = amp * np.sin(freq * t)
        out[:, f, 4] = -2.0 * np.sin(th)
        out[:, f, 6] = -2.0 * np.cos(th)
    return out
