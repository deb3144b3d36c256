"""The SeqFormer's initial weights, made by the benchmark from the seed.

The layout is the program's flat ``{path: tensor}`` dict (head-major
attention projections); the scales are its initialisation's: He-normal
dense weights, normal(1/sqrt(d))
attention projections, normal(0.02) positions, zero biases, unit norm
scales.  Every normal leaf comes from one ``randn`` on the device from a
generator seeded ``seed``, so the same seed gives the same weights on every
call, and the reference can make them again after the program's run.
"""

from __future__ import annotations

import math

import torch


def layout(cfg):
    """``[(path, shape, std)]`` in order; ``std`` None is a zero leaf, and
    ``"ones"`` a unit one."""
    d, obs, h = cfg["d_model"], cfg["obs_dim"], cfg["n_heads"]
    dh, dff = d // h, cfg["d_ff"]
    out = [("embed.w", (obs, d), math.sqrt(2.0 / obs)), ("embed.b", (d,), None),
           ("pos", (cfg["max_len"], d), 0.02)]
    for i in range(cfg["n_layers"]):
        b = f"blocks.{i}"
        out += [(f"{b}.ln1.scale", (d,), "ones"), (f"{b}.ln1.bias", (d,), None)]
        for n in ("wq", "wk", "wv"):
            out += [(f"{b}.{n}.w", (d, h, dh), math.sqrt(1.0 / d)), (f"{b}.{n}.b", (h, dh), None)]
        out += [(f"{b}.wo.w", (h, dh, d), math.sqrt(1.0 / d)), (f"{b}.wo.b", (d,), None),
                (f"{b}.ln2.scale", (d,), "ones"), (f"{b}.ln2.bias", (d,), None)]
        out += [(f"{b}.mlp.fc.w", (d, dff), math.sqrt(2.0 / d)), (f"{b}.mlp.fc.b", (dff,), None),
                (f"{b}.mlp.proj.w", (dff, d), math.sqrt(2.0 / dff)), (f"{b}.mlp.proj.b", (d,), None)]
    out += [("ln_f.scale", (d,), "ones"), ("ln_f.bias", (d,), None),
            ("head.w", (d, obs), math.sqrt(2.0 / d)), ("head.b", (obs,), None)]
    return out


def count(cfg):
    return sum(math.prod(shape) for _, shape, _ in layout(cfg))


def make(cfg, seed, device):
    """float32 weights on ``device`` from ``seed``."""
    leaves = layout(cfg)
    normal = [(p, s, std) for p, s, std in leaves if isinstance(std, float)]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for _, s, _ in normal), generator=gen, device=device)
    out, at = {}, 0
    for path, shape, std in leaves:
        if std is None:
            out[path] = torch.zeros(shape, device=device)
        elif std == "ones":
            out[path] = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            out[path] = flat[at:at + n].view(shape) * std
            at += n
    del flat
    return out
