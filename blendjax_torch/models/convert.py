"""Parameters across the frameworks: the JAX package's pytree <-> the port's
flat ``{path: tensor}`` dict.

Leaf names follow the pytree path joined with ``.`` (``{"convs": [{"w":
...}]}`` -> ``convs.0.w``).  Conv kernels (4-D leaves) go HWIO -> OIHW.
Dense weights keep their ``(in, out)`` orientation: the port computes
``x @ w`` as the reference does, not ``nn.Linear``'s ``(out, in)``.
Integer leaves (the int8 ``w_q`` of a quantized model) keep their dtype
both ways; every other leaf crosses as float32.
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


def _dtype(arr):
    """A leaf's dtype across the frameworks: integer leaves (int8 weights of
    :mod:`blendjax_torch.ops.quant`) keep theirs, every other one is f32."""
    return arr.dtype if np.issubdtype(arr.dtype, np.integer) else np.float32


def params_from_jax(tree, device="cuda"):
    """JAX-layout parameter pytree (numpy leaves) -> port params dict of
    tensors on ``device``: float32, integer leaves in their own dtype."""
    device = resolve_device(device)
    out = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        arr = arr.astype(_dtype(arr), copy=False)
        if arr.ndim == 4:  # conv kernel: HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        out[path] = torch.tensor(np.ascontiguousarray(arr), device=device)
    return out


def params_to_jax(params):
    """Inverse of :func:`params_from_jax`: port params -> nested dicts and
    lists of numpy arrays in the JAX layout."""
    tree: dict = {}
    for path, t in params.items():
        t = t.detach().cpu()
        arr = (t if not t.dtype.is_floating_point else t.to(torch.float32)).numpy()
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
