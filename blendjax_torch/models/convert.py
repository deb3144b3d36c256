"""Parameters across the frameworks: the JAX package's pytree <-> the port's
flat ``{path: tensor}`` dict.

Leaf names follow the pytree path joined with ``.`` (``{"convs": [{"w":
...}]}`` -> ``convs.0.w``).  Conv kernels (4-D leaves) go HWIO -> OIHW.
Dense weights keep their ``(in, out)`` orientation: the port computes
``x @ w`` as the reference does, not ``nn.Linear``'s ``(out, in)``.
The tree arrives as numpy arrays, so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from blendjax_torch.utils.device import resolve_device


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _flatten(v, f"{prefix}.{k}" if prefix else str(k))


def params_from_jax(tree, device="cuda"):
    """JAX-layout parameter pytree (numpy leaves) -> port params dict of
    float32 tensors on ``device``."""
    device = resolve_device(device)
    out = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf, dtype=np.float32)
        if arr.ndim == 4:  # conv kernel: HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        out[path] = torch.tensor(np.ascontiguousarray(arr), device=device)
    return out


def params_to_jax(params):
    """Inverse of :func:`params_from_jax`: port params -> nested dicts and
    lists of numpy arrays in the JAX layout."""
    tree: dict = {}
    for path, t in params.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        if arr.ndim == 4:  # OIHW -> HWIO
            arr = arr.transpose(2, 3, 1, 0)
        *parents, leaf = path.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(arr)
    return _lists(tree)


def _lists(node):
    """Turn dicts keyed ``"0".."n-1"`` back into lists (pytree sequences)."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node
