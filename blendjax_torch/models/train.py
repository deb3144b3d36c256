"""Training-step builder: ``step(state, batch) -> (state, loss)``.

The port of ``blendjax.models.train``::

    state = TrainState.create(params)            # torch.optim.Adam(lr=1e-3)
    step = make_train_step(loss_fn)
    state, loss = step(state, batch)

``torch.optim.Adam``'s defaults (betas (0.9, 0.999), eps 1e-8, eps inside
the square root 0) are ``optax.adam``'s, and its update ``m_hat /
(sqrt(v_hat) + eps)`` is the same formula.  Where the reference donates
the state so XLA updates it in place, the port updates the parameter
tensors in place: the state passed in is the state returned.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    """Parameters (a ``{path: tensor}`` dict), their optimizer, step count."""

    params: dict
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, params):
        params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        return cls(params=params, optimizer=torch.optim.Adam(params.values(), lr=1e-3))


def make_train_step(loss_fn):
    """Build ``step(state, batch) -> (state, loss)`` for
    ``loss_fn(params, batch) -> scalar``; ``loss`` is detached."""

    def step(state, batch):
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, batch)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step
