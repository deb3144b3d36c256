"""Train-state checkpointing: the port of ``blendjax.utils.checkpoint``.

Save and restore pytrees of arrays (nested dicts, lists and tuples of
numpy arrays or tensors), named arrays with JSON metadata, and the port's
:class:`~blendjax_torch.models.train.TrainState`, each to a single
``.npz``.  The file format is the reference's, so that a file written by
either package restores in the other:

- a pytree's leaves are ``leaf_<i>`` in JAX's flattening order (dict keys
  sorted at every level, sequences in order, ``None`` an empty subtree);
- a TrainState is the reference's ``TrainState(params, opt_state, step)``
  under ``optax.adam``: the parameters, Adam's count, its first and second
  moments, the step, laid out by :mod:`blendjax_torch.models.convert`;
- named arrays carry their metadata as JSON bytes under ``__meta__``;
- a :class:`CheckpointManager` names its files ``step_<N:08d>.npz``.

Every write goes to a ``.tmp`` file that is fsynced before its atomic
rename.  Only the TrainState helpers import torch (through ``convert``),
so the numpy half imports without it.

What differs from the reference, and why:

- ``backend="orbax"`` is refused at construction, naming ``backend='npz'``:
  orbax is a JAX package.
- A TrainState restores **in place**: the template's parameter and Adam
  tensors are overwritten (``copy_``, ``fill_``), so a captured train step
  (:mod:`blendjax_torch.models.train`) keeps its graphs.
- :meth:`CheckpointManager.restore` cannot lose a race with a concurrent
  writer's retention.  It opens each step's file once and loads from the
  open file (an unlinked open file stays readable on POSIX); a step whose
  file vanished before the open means a newer save exists, so it lists the
  directory again, for as long as the listing keeps changing, under a
  time limit rather than a count of attempts.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np

logger = logging.getLogger("blendjax_torch")

#: how long :meth:`CheckpointManager.restore` keeps listing a directory
#: whose steps a concurrent writer keeps replacing
RESTORE_TIMEOUT_S = 30.0
#: the longest pause between two listings of a changing directory, seconds
#: (the first is 1 ms, doubling)
RELIST_PAUSE_MAX_S = 0.05


def _replace_durable(tmp, path):
    """``os.replace`` with the tmp file's bytes fsynced before the rename
    (an unsynced rename can survive a host crash as a complete-looking
    truncated file) and the parent directory fsynced after it (best
    effort: some filesystems refuse a directory fsync)."""
    fd = os.open(tmp, os.O_RDWR)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass  # the rename itself is durable enough on refusal
    finally:
        os.close(dfd)


def _write_npz(path, arrays):
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    _replace_durable(tmp, path)


# -- pytrees, flattened as JAX flattens them -----------------------------------


def _is_tensor(x):
    return type(x).__module__.startswith("torch") and hasattr(x, "detach")


def _tree_leaves(tree):
    """The leaves of a pytree in JAX's flattening order: dict keys sorted,
    lists and tuples (named tuples too) in order, ``None`` an empty
    subtree, anything else a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _tree_leaves(v)]
    return [tree]


def _tree_unflatten(tree, leaves):
    """``tree`` with its leaves replaced, in flattening order, from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _tree_unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        seq = [_tree_unflatten(v, leaves) for v in tree]
        if isinstance(tree, list):
            return seq
        return type(tree)(*seq) if hasattr(tree, "_fields") else tuple(seq)
    return next(leaves)


def _host(leaf):
    """A leaf as a numpy array (a tensor is copied off its device)."""
    if _is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path, tree):
    """Serialize a pytree of arrays to ``path`` (.npz; fsync + atomic
    rename, so a host crash leaves either the old file or the complete new
    one)."""
    _write_npz(path, {f"leaf_{i}": _host(leaf) for i, leaf in enumerate(_tree_leaves(tree))})


def _read_leaves(data, shapes):
    """The ``leaf_<i>`` arrays of an open npz, checked against the target's
    leaf count and ``shapes``."""
    if len(data.files) != len(shapes):
        raise ValueError(f"checkpoint has {len(data.files)} leaves, target expects "
                         f"{len(shapes)}")
    out = []
    for i, shape in enumerate(shapes):
        arr = data[f"leaf_{i}"]
        if arr.shape != tuple(shape):
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != target {shape}")
        out.append(arr)
    return out


def load_pytree(path, target):
    """Restore arrays into the structure of ``target`` (a path or an open
    binary file).  ``target`` supplies the structure; leaf count and shapes
    must match the checkpoint.  Each leaf comes back as its target leaf's
    kind: a tensor of its dtype, device and strides (the int8 weights'
    column-major layout), or a numpy array of its dtype."""
    refs = _tree_leaves(target)
    with np.load(path) as data:
        arrays = _read_leaves(data, [ref.shape if _is_tensor(ref) else np.shape(ref)
                                     for ref in refs])
    loaded = []
    for arr, ref in zip(arrays, refs):
        if _is_tensor(ref):
            import torch

            loaded.append(torch.empty_like(ref).copy_(torch.from_numpy(arr)))
        else:
            loaded.append(arr.astype(np.asarray(ref).dtype))
    return _tree_unflatten(target, iter(loaded))


def save_state(path, arrays, meta=None):
    """Serialize named arrays and a JSON-able metadata dict to ``path``
    (.npz, atomic rename): the sibling of :func:`save_pytree` for states
    whose keys vary (a replay buffer's columns, ring indices and RNG
    state).  Python ints of any size round-trip exactly through JSON, so
    numpy bit-generator states (128-bit ints) are safe."""
    if "__meta__" in arrays:
        raise ValueError("'__meta__' is reserved for the metadata channel")
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    payload["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), np.uint8)
    _write_npz(path, payload)


def load_state(path):
    """Restore ``(arrays, meta)`` written by :func:`save_state`."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
        meta = (json.loads(bytes(data["__meta__"]).decode())
                if "__meta__" in data.files else {})
    return arrays, meta


# -- the port's TrainState ------------------------------------------------------


def _is_train_state(x):
    return hasattr(x, "optimizer") and hasattr(x, "params")


def save_train_state(path, state):
    """Persist a :class:`~blendjax_torch.models.train.TrainState` in the
    reference's layout (:func:`blendjax_torch.models.convert.train_state_arrays`)."""
    from blendjax_torch.models import convert

    save_pytree(path, convert.train_state_arrays(state))


def load_train_state(path, template_state):
    """Restore a TrainState saved by either package into
    ``template_state``, in place (its tensors are overwritten, so captured
    steps stay valid); returns ``template_state``.  ``path`` may be an open
    binary file."""
    from blendjax_torch.models import convert

    with np.load(path) as data:
        arrays = _read_leaves(data, convert.train_state_shapes(template_state))
    convert.load_train_state_arrays(template_state, arrays)
    return template_state


class CheckpointManager:
    """Step-numbered checkpoints with retention and latest-step resume::

        mgr = CheckpointManager(dir, max_to_keep=3)
        mgr.save(step, state)
        state = mgr.restore(template_state)        # latest, in place
        start = (mgr.latest_step() or -1) + 1      # resume loop

    ``state`` is a :class:`~blendjax_torch.models.train.TrainState` or a
    pytree (a TrainState already gathered to the host by
    :func:`~blendjax_torch.models.convert.train_state_arrays` is the list
    of its leaves).  Only ``backend="npz"`` is supported.
    """

    def __init__(self, directory, max_to_keep=3, backend="npz", counters=None):
        if backend == "orbax":
            raise ValueError(
                "CheckpointManager(backend='orbax') is not supported by the PyTorch "
                "port: orbax checkpoints JAX arrays; use backend='npz' (the default, "
                "the reference's own file format)")
        if backend != "npz":
            raise ValueError(f"unknown backend {backend!r}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.backend = backend
        #: optional EventCounters sink (``ha_restore_fallbacks``)
        self.counters = counters
        #: restores that fell back past an unloadable checkpoint
        self.restore_fallbacks = 0
        os.makedirs(self.directory, exist_ok=True)

    # -- step bookkeeping ---------------------------------------------------

    def _path(self, step):
        return os.path.join(self.directory, f"step_{step:08d}.npz")

    def all_steps(self):
        """The complete steps, ascending.  An interrupted save's
        ``step_N.npz.tmp`` is not a step.  One ``scandir`` pass: its
        entries' types come with the listing, so a file removed while the
        list is read cannot drop a step that was listed."""
        steps = []
        with os.scandir(self.directory) as it:
            for entry in it:
                name = entry.name
                if not (name.startswith("step_") and name.endswith(".npz")):
                    continue
                if not entry.is_file():
                    continue
                try:
                    steps.append(int(name[len("step_"):-len(".npz")]))
                except ValueError:
                    continue
        return sorted(set(steps))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save / restore -----------------------------------------------------

    def save(self, step, state):
        path = self._path(step)
        if _is_train_state(state):
            save_train_state(path, state)
        else:
            save_pytree(path, state)
        self._retain()
        return path

    def _load(self, f, template):
        if _is_train_state(template):
            return load_train_state(f, template)
        return load_pytree(f, template)

    def _restore_step(self, template, step):
        with open(self._path(step), "rb") as f:
            return self._load(f, template)

    def restore(self, template, step=None):
        """Restore ``step`` (default: the latest loadable one) into
        ``template`` (a TrainState in place; a pytree's structure).  Raises
        FileNotFoundError when no checkpoint exists.

        With ``step=None`` an unloadable checkpoint (torn or truncated) falls
        back to the previous step, counted in :attr:`restore_fallbacks`
        (and ``ha_restore_fallbacks``) and warned; RuntimeError with the
        first error when every step fails.  A step whose file vanished
        before it was opened is not a fallback: a concurrent save replaced
        it, and the directory is listed again after a short pause.  An
        explicit ``step`` keeps
        the strict contract: its failure raises."""
        if step is not None:
            return self._restore_step(template, step)
        deadline = time.monotonic() + RESTORE_TIMEOUT_S
        failed, first_exc, listing, pause = set(), None, None, 1e-3
        while True:
            steps = self.all_steps()
            for s in reversed(steps):
                if s in failed:
                    continue
                try:
                    f = open(self._path(s), "rb")
                except FileNotFoundError:
                    break  # retention removed it after the listing: list again
                with f:
                    try:
                        restored = self._load(f, template)
                    except Exception as exc:  # noqa: BLE001 - fall back, counted
                        failed.add(s)
                        first_exc = first_exc or exc
                        self.restore_fallbacks += 1
                        if self.counters is not None:
                            self.counters.incr("ha_restore_fallbacks")
                        logger.warning("checkpoint step %d under %s failed to load "
                                       "(%s: %s); falling back to the previous step",
                                       s, self.directory, type(exc).__name__, exc)
                        continue
                if failed:
                    logger.warning("restored checkpoint step %d after newer step(s) "
                                   "failed to load", s)
                return restored
            else:
                # every listed step failed (or none is listed): final once two
                # listings in a row agree
                if steps == listing:
                    if first_exc is None:
                        raise FileNotFoundError(f"no checkpoints under {self.directory}")
                    raise RuntimeError(
                        f"every checkpoint under {self.directory} failed to load; first "
                        f"error: {type(first_exc).__name__}: {first_exc}") from first_exc
            listing = steps
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"checkpoints under {self.directory} kept changing for "
                    f"{RESTORE_TIMEOUT_S:.0f} s; no step could be opened")
            # give the writer the interpreter before listing again
            time.sleep(pause)
            pause = min(2 * pause, RELIST_PAUSE_MAX_S)

    def _retain(self):
        if self.max_to_keep is None:
            return
        steps = self.all_steps()
        for step in steps[: max(0, len(steps) - self.max_to_keep)]:
            try:
                os.unlink(self._path(step))
            except OSError:
                pass
