"""Log-normal probability model over simulation parameters, and its
score-function (REINFORCE) gradient; the port of
``blendjax.models.probmodel``.

A distribution over supershape parameters (m1, m2) whose samples go
through a renderer that is not differentiable (Blender).  The gradient is
the likelihood-ratio estimator with a baseline, never through the
renderer::

    grad = E[ grad log p(sample) * (loss(sample) - baseline) ]

Parameters are ``{"mu": (K,), "log_sigma": (K,)}`` f32 tensors.  Draws
come from an explicit ``torch.Generator``; :func:`transform` maps standard
normal draws to samples, so a caller can feed its own.
"""

from __future__ import annotations

import math

import torch

from blendjax_torch.utils.device import resolve_device


def init(mu, sigma, device="cuda"):
    """Params of independent log-normals, ``log X ~ N(mu, sigma)``; ``mu``
    and ``sigma`` are length-K sequences.  ``sigma`` is kept as its log,
    for optimization without a constraint."""
    device = resolve_device(device)
    mu = torch.as_tensor(mu, dtype=torch.float32, device=device)
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=device)
    return {"mu": mu.clone(), "log_sigma": torch.log(sigma)}


def transform(params, eps):
    """Standard normal draws ``eps`` (n, K) -> samples
    ``exp(mu + sigma * eps)``."""
    return torch.exp(params["mu"] + torch.exp(params["log_sigma"]) * eps)


def sample(params, generator, n):
    """(n, K) positive samples, their normal draws from ``generator`` (on
    the params' device).  The estimator treats them as fixed, as the
    renderer breaks the chain anyway."""
    mu = params["mu"]
    eps = torch.randn((n, mu.shape[-1]), generator=generator, device=mu.device)
    return transform(params, eps)


def log_prob(params, x):
    """Log density of the log-normal at ``x`` (n, K), summed over K."""
    mu, sigma = params["mu"], torch.exp(params["log_sigma"])
    z = (torch.log(x) - mu) / sigma
    log_pdf = -0.5 * z * z - torch.log(sigma) - 0.5 * math.log(2 * math.pi) - torch.log(x)
    return log_pdf.sum(-1)


def score_loss(params, samples, losses, baseline):
    """Surrogate whose gradient is the score-function estimator.

    ``samples`` (n, K) came from :func:`sample`; ``losses`` (n,) were
    measured through the renderer; ``baseline`` is a variance-reduction
    scalar (e.g. an EMA of recent losses)."""
    advantage = (losses - baseline).detach()
    return torch.mean(log_prob(params, samples.detach()) * advantage)


def ema_update(baseline, losses, decay=0.9):
    """EMA baseline update."""
    return decay * baseline + (1.0 - decay) * losses.mean()


def mean(params):
    """Mean of the log-normal: exp(mu + sigma^2 / 2)."""
    sigma = torch.exp(params["log_sigma"])
    return torch.exp(params["mu"] + 0.5 * sigma * sigma)
