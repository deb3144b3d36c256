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
from torch.distributed.tensor import DTensor

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


# -- the TrainState across the frameworks ---------------------------------------
#
# The reference's ``TrainState(params, opt_state, step)`` under ``optax.adam``
# flattens to: the parameter leaves (dict keys sorted at every level, lists in
# order), ``opt_state[0].count`` (int32), the ``mu`` leaves, the ``nu`` leaves
# (each in the parameters' order), ``step``.  In the port ``mu`` and ``nu`` are
# Adam's ``exp_avg`` and ``exp_avg_sq`` and ``count`` is Adam's per-parameter
# ``step`` (a float32 tensor, on the card when Adam is ``capturable``; exact
# up to 2**24), which must agree across the parameters.  Conv kernels and
# their moments cross as HWIO.  A mesh-sharded state (DTensor parameters and
# moments) crosses whole: its tensors are gathered from the mesh on the way
# out (a collective where a tensor is sharded, so every rank of its mesh
# calls it; replicated tensors are read locally), and each rank writes its
# own shard of the whole arrays on the way in.


def jax_order(names):
    """The port's parameter names (``convs.0.w``) in the reference pytree's
    flattening order: dict keys sorted at every level, list indices in
    numerical order."""
    tree: dict = {}
    for name in names:
        node = tree
        *parents, leaf = name.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = None
    out = []

    def walk(node, prefix):
        keys = list(node)
        keys.sort(key=int) if all(k.isdigit() for k in keys) else keys.sort()
        for k in keys:
            path = f"{prefix}.{k}" if prefix else k
            if node[k] is None:
                out.append(path)
            else:
                walk(node[k], path)

    walk(tree, "")
    return out


def _to_jax(arr):
    return arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr  # OIHW -> HWIO


def _jax_shape(shape):
    shape = tuple(shape)
    return (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 else shape


def _from_jax(arr):
    return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr  # HWIO -> OIHW


def _whole(t):
    """``t`` whole: a DTensor gathered from its mesh
    (:func:`blendjax_torch.parallel.sharding.gather_whole`)."""
    if not isinstance(t, DTensor):
        return t
    from blendjax_torch.parallel.sharding import gather_whole

    return gather_whole(t)


def _copy_in(dst, arr):
    """Write the whole array ``arr`` into ``dst``: into its local shard
    when ``dst`` is a DTensor (no communication)."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if isinstance(dst, DTensor):
        mesh = dst.device_mesh
        for mesh_dim, placement in enumerate(dst.placements):
            if placement.is_shard():
                src = src.chunk(mesh.size(mesh_dim), dim=placement.dim)[
                    mesh.get_local_rank(mesh_dim)]
        dst = dst.to_local()
    dst.copy_(src)


def _adam(state):
    opt = state.optimizer
    if not isinstance(opt, torch.optim.Adam) or any(g["amsgrad"] for g in opt.param_groups):
        raise ValueError(f"the reference's layout holds optax.adam's state; the optimizer "
                         f"is {type(opt).__name__} with {opt.defaults}")
    return opt


def train_state_shapes(state):
    """The shapes of the reference's leaves for ``state`` (conv kernels
    HWIO), in its flattening order."""
    shapes = [_jax_shape(state.params[n].shape) for n in jax_order(state.params)]
    return shapes + [()] + shapes + shapes + [()]


def train_state_arrays(state, staging=None):
    """A TrainState's leaves in the reference's order and layout, as numpy
    arrays on the host: parameters, int32 ``count``, ``mu``, ``nu``, int32
    ``step``.  An Adam that has taken no step yet gives ``count`` 0 and
    zero moments, as ``optax.adam``'s init does.

    The copies are issued on the current stream (the one the captured
    update replays on, so they read the finished update) and waited for
    before this returns.  ``staging`` (a dict the caller keeps) holds the
    host buffers, pinned for CUDA tensors, and reuses them across calls:
    each call overwrites the arrays the previous one returned."""
    opt = _adam(state)
    params = [state.params[n] for n in jax_order(state.params)]
    adam = [opt.state.get(p, {}) for p in params]
    if any(adam) and not all(adam):
        raise ValueError("Adam has state for some parameters and not others")
    tensors = list(params)
    if adam and adam[0]:
        tensors += [s["exp_avg"] for s in adam] + [s["exp_avg_sq"] for s in adam]
        tensors += [s["step"] for s in adam]
    tensors = [_whole(t) for t in tensors]
    staging = {} if staging is None else staging
    host = []
    for i, t in enumerate(tensors):
        buf = staging.get(i)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = staging[i] = torch.empty(t.shape, dtype=t.dtype,
                                           pin_memory=t.is_cuda)
        buf.copy_(t.detach(), non_blocking=t.is_cuda)
        host.append(buf)
    if any(t.is_cuda for t in tensors):
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    arrays = [_to_jax(b.numpy()) for b in host]
    p = len(params)
    if len(arrays) == p:
        counts = {0.0}
        mu = nu = [np.zeros(a.shape, a.dtype) for a in arrays]
    else:
        counts = {float(a) for a in arrays[3 * p:]}
        mu, nu = arrays[p:2 * p], arrays[2 * p:3 * p]
    if len(counts) != 1:
        raise ValueError(f"Adam's step differs across parameters: {sorted(counts)}")
    count = counts.pop()
    if count != int(count) or count >= 2 ** 24:
        raise ValueError(f"Adam's step {count} is not an exact count")
    return [*arrays[:p], np.int32(count), *mu, *nu, np.int32(state.step)]


def _adam_state(opt, p):
    """Adam's state for parameter ``p``, made as Adam's first step makes it
    when it has none yet (``step`` on the parameter's device when the group
    is capturable or fused, else on the CPU; zero moments)."""
    st = opt.state[p]
    if not st:
        group = next(g for g in opt.param_groups if any(q is p for q in g["params"]))
        device = p.device if group["capturable"] or group["fused"] else "cpu"
        st["step"] = torch.zeros((), dtype=torch.float32, device=device)
        st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return st


def load_train_state_arrays(state, arrays):
    """Write the reference's leaves (:func:`train_state_arrays`' layout, as
    read from either package's file) into ``state`` in place: parameters and
    Adam's moments with ``copy_``, Adam's steps with ``fill_``, so the
    tensors a captured step replays over are the ones that change.  An Adam
    with no state yet gets its state tensors made first (as its first step
    would make them).  Raises, before anything is written, when the arrays
    do not fit: a leaf count, shape or dtype that differs from the tensor
    it lands in (``count`` and ``step`` must be integers; Adam's float
    ``step`` takes ``count`` as the one conversion)."""
    opt = _adam(state)
    names = jax_order(state.params)
    p = len(names)
    if len(arrays) != 3 * p + 2:
        raise ValueError(f"{len(arrays)} leaves for a TrainState of {p} parameters "
                         f"(expects {3 * p + 2})")
    for have, want in zip(arrays, train_state_shapes(state)):
        if np.shape(have) != want:
            raise ValueError(f"checkpoint leaf of shape {np.shape(have)} where the "
                             f"TrainState has {want}")
    params = [state.params[n] for n in names]
    adam = [opt.state.get(q) or {} for q in params]
    dtypes = ([q.dtype for q in params]
              + [s.get("exp_avg", q).dtype for s, q in zip(adam, params)]
              + [s.get("exp_avg_sq", q).dtype for s, q in zip(adam, params)])
    leaves = list(arrays[:p]) + list(arrays[p + 1:-1])
    for i, (have, want) in enumerate(zip(leaves, dtypes)):
        want = torch.empty(0, dtype=want).numpy().dtype
        if np.asarray(have).dtype != want:
            raise ValueError(f"checkpoint leaf {i if i < p else i + 1} of dtype "
                             f"{np.asarray(have).dtype} where the TrainState has {want}")
    for i in (p, len(arrays) - 1):
        if not np.issubdtype(np.asarray(arrays[i]).dtype, np.integer):
            raise ValueError(f"checkpoint leaf {i} (Adam's count or the step) of dtype "
                             f"{np.asarray(arrays[i]).dtype}; expects an integer")
    count = int(arrays[p])
    with torch.no_grad():
        for i, name in enumerate(names):
            param = state.params[name]
            st = _adam_state(opt, param)
            leaves = (arrays[i], arrays[p + 1 + i], arrays[2 * p + 1 + i])
            for dst, arr in zip((param, st["exp_avg"], st["exp_avg_sq"]), leaves):
                _copy_in(dst, _from_jax(np.asarray(arr)))
            st["step"].fill_(count)
    state.step = int(arrays[-1])
    return state
