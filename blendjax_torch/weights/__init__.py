"""blendjax_torch.weights — versioned, checksummed parameter snapshots, a
numpy-only copy of ``blendjax.weights.snapshot``: a snapshot that either
package publishes assembles in the other, and a served model adopts it
through ``apply_weights``.  The WeightBus publisher and subscriber are not
ported (ROADMAP Queue 1, item 9)."""

from blendjax_torch.weights.snapshot import (
    Snapshot,
    SnapshotAssembler,
    flatten_tree,
    leaf_digest,
    snapshot_messages,
    unflatten_tree,
)

__all__ = ["Snapshot", "SnapshotAssembler", "flatten_tree", "leaf_digest",
           "snapshot_messages", "unflatten_tree"]
