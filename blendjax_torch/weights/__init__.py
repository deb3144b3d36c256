"""blendjax_torch.weights — versioned, checksummed parameter snapshots, a
numpy-only copy of ``blendjax.weights.snapshot``: a snapshot that either
package publishes assembles in the other, and a served model adopts it
through ``apply_weights``; and the WeightBus (:mod:`blendjax_torch.weights.bus`)
that streams them from a learner to the serve tier, with the canary
controller (:mod:`blendjax_torch.weights.controller`) that promotes or
rolls back a new version behind a gateway.  The publisher, subscriber and
controller are imported lazily (they need zmq)."""

from blendjax_torch.weights.snapshot import (
    Snapshot,
    SnapshotAssembler,
    flatten_tree,
    leaf_digest,
    snapshot_messages,
    unflatten_tree,
)

_LAZY = {"WeightPublisher": "bus", "WeightSubscriber": "bus", "linear_tree": "bus",
         "WeightBusController": "controller"}

__all__ = ["Snapshot", "SnapshotAssembler", "WeightBusController", "WeightPublisher",
           "WeightSubscriber", "flatten_tree", "leaf_digest", "linear_tree",
           "snapshot_messages", "unflatten_tree"]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module = importlib.import_module(f"blendjax_torch.weights.{_LAZY[name]}")
        value = getattr(module, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'blendjax_torch.weights' has no attribute {name!r}")
