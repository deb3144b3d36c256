"""``"source": "pool"``: ``pool_batches`` batches of ``batch`` pendulum
episodes of ``seq_len + 1`` steps made from the seed, cast to the wire's
``float16`` and placed on the device in set-up; the steps cycle through
them in order.  Every row of the pool is a different episode."""

from __future__ import annotations

import numpy as np

from portbench.reference.pendulum import simulate_batch


def pool_episodes(traffic, cfg, seed):
    """The pool as host float16, (pool_batches, batch, seq_len + 1,
    obs_dim): the same seed gives the same episodes."""
    n, b = traffic["pool_batches"], traffic["batch"]
    eps = simulate_batch(np.random.default_rng(seed), n * b, traffic["seq_len"], cfg["obs_dim"])
    return eps.astype(np.float16).reshape(n, b, traffic["seq_len"] + 1, cfg["obs_dim"])


class Feed:
    """Device batches ``{'episode': (B, T+1, D) float16}`` cycled in order."""

    def __init__(self, torch, traffic, cfg, seed, device):
        self.host = pool_episodes(traffic, cfg, seed)
        self.pool = torch.from_numpy(self.host).to(device)
        self.at = 0

    def __next__(self):
        batch = {"episode": self.pool[self.at % len(self.pool)]}
        self.at += 1
        return batch

    def reference_batches(self, n):
        """The first ``n`` batches the program stepped on, as host float16."""
        return [self.host[i % len(self.host)] for i in range(n)]

    def close(self):
        self.pool = None
