"""The DeepSeek-V3 blocks' initial weights (Moonlight-16B-A3B's, cut to one
card), made by the benchmark from the seed.

The layout is the program's flat ``{path: tensor}`` dict
(``blendjax_torch.models.seqformer.init_mla``'s paths and shapes, with the
held experts alone in ``moe.w1``/``w3``/``w2``); the scales: every
matrix normal(1/sqrt(fan in)), the
embedding and the head He-normal with zero biases, norm scales 1.  Every
normal leaf comes from one ``randn`` on the device from a generator seeded
``seed``, so the same seed gives the same weights on every call and the
reference can make them again after the program's run.  The routing
biases are no parameters: they start at zero, as DeepSeek-V3's do.
"""

from __future__ import annotations

import math

import torch


def sizes(cfg):
    """The widths and counts the layout reads, from the configuration's
    published keys."""
    return {
        "obs": cfg["obs_dim"], "d": cfg["hidden_size"], "h": cfg["num_attention_heads"],
        "nope": cfg["qk_nope_head_dim"], "rope": cfg["qk_rope_head_dim"],
        "dv": cfg["v_head_dim"], "rank": cfg["kv_lora_rank"], "layers": cfg["num_hidden_layers"],
        "dense": cfg["first_k_dense_replace"], "dense_ff": cfg["intermediate_size"],
        "moe_ff": cfg["moe_intermediate_size"], "held": cfg["n_routed_experts"],
        "router": cfg["router_experts"], "shared": cfg["n_shared_experts"],
    }


def layout(cfg):
    """``[(path, shape, std)]`` in order; ``std`` None is a zero leaf, and
    ``"ones"`` a unit one."""
    s = sizes(cfg)
    d, h, dq = s["d"], s["h"], s["nope"] + s["rope"]

    def mat(path, *shape, fan_in):
        return (path, shape, math.sqrt(1.0 / fan_in))

    def swiglu(prefix, f, *lead):
        return [mat(f"{prefix}.w1", *lead, d, f, fan_in=d),
                mat(f"{prefix}.w3", *lead, d, f, fan_in=d),
                mat(f"{prefix}.w2", *lead, f, d, fan_in=f)]

    out = [("embed.w", (s["obs"], d), math.sqrt(2.0 / s["obs"])), ("embed.b", (d,), None)]
    for i in range(s["layers"]):
        b = f"blocks.{i}"
        out += [(f"{b}.attn_norm.scale", (d,), "ones"),
                mat(f"{b}.wq.w", d, h, dq, fan_in=d),
                mat(f"{b}.wkv_a.w", d, s["rank"] + s["rope"], fan_in=d),
                (f"{b}.kv_norm.scale", (s["rank"],), "ones"),
                mat(f"{b}.wkv_b.w", s["rank"], h, s["nope"] + s["dv"], fan_in=s["rank"]),
                mat(f"{b}.wo.w", h, s["dv"], d, fan_in=h * s["dv"]),
                (f"{b}.mlp_norm.scale", (d,), "ones")]
        if i < s["dense"]:
            out += swiglu(f"{b}.mlp", s["dense_ff"])
        else:
            out.append(mat(f"{b}.moe.gate.w", d, s["router"], fan_in=d))
            out += swiglu(f"{b}.moe", s["moe_ff"], s["held"])
            out += swiglu(f"{b}.moe.shared", s["shared"] * s["moe_ff"])
    out += [("ln_f.scale", (d,), "ones"), ("head.w", (d, s["obs"]), math.sqrt(2.0 / d)),
            ("head.b", (s["obs"],), None)]
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
