"""Live replay resharding: grow the shard fleet under traffic, the port
of ``blendjax.autoscale.reshard``.

Adding storage moves slot ownership crash-exactly:

1. the source shard checkpoints its full state (``save`` RPC; appends go
   on after the cut);
2. :meth:`~blendjax_torch.replay.service.ShardFleet.grow` copies that
   checkpoint under the new shard's name and spawns it, so the newcomer
   boots holding every source row up to the cut;
3. :meth:`~blendjax_torch.replay.shard_client.ShardedReplay.adopt_shard`
   verifies the restore, copies only the rows appended past the cut into
   the moving range (``written_since``), and flips ownership of the range
   (the upper half of the source's slots,
   :data:`~blendjax_torch.replay.shard_client.RESHARD_FRACTION`) under the
   buffer lock.

Total capacity, the SumTree and the RNG never change, so the draw stream
continues bit-identically.  Failure is atomic: any abort
(:class:`~blendjax_torch.replay.shard_client.ReshardAborted`) leaves the
ownership map untouched and the source serving its full range, and the
half-born shard process is retired.
"""

from __future__ import annotations

import logging
import time

from blendjax_torch.replay.shard_client import ReshardAborted, ShardRPCError
from blendjax_torch.utils.timing import fleet_counters

logger = logging.getLogger("blendjax_torch")


def reshard_replay(replay, fleet, *, source=None, counters=None, timer=None):
    """Add one shard to a live deployment and hand it a slot range.

    Params
    ------
    replay: ShardedReplay
        The draw authority; gains a shard on success.
    fleet: ShardFleet
        The shard processes; ``grow``/``retire`` side of the resize.
    source: int | None
        Live shard surrendering the range; defaults to the shard
        owning the most slots (the one a previous reshard split
        least).

    Returns ``(shard_index, address)`` of the adopted shard.  Raises
    :class:`~blendjax_torch.replay.shard_client.ReshardAborted` (map
    untouched, source untouched, newcomer retired) on any failure.
    """
    counters = counters if counters is not None else fleet_counters
    timer = timer if timer is not None else replay.timer
    t0 = time.perf_counter()
    if source is None:
        with replay._cond:
            owned = [
                int((replay._owner == s).sum())
                for s in range(replay.num_shards)
            ]
            dead = replay._dead.copy()
        live = [s for s in range(len(owned)) if not dead[s]]
        if not live:
            raise ReshardAborted(
                f"{replay.name}: no live shard to reshard from"
            )
        source = max(live, key=lambda s: owned[s])
    try:
        cut = replay.clients[source].rpc("save")
    except ShardRPCError as exc:
        counters.incr("autoscale_reshard_aborts")
        raise ReshardAborted(
            f"{replay.name}: source shard {source} save failed: {exc}"
        ) from exc
    idx, addr = fleet.grow(restore_ckpt=cut["path"])
    try:
        shard = replay.adopt_shard(
            addr, source=int(source), cut_seq=int(cut["seq"]),
        )
    except BaseException:
        # abort WHOLE: the newcomer process (and its disk/shm state)
        # goes away; the map and the source were never touched
        fleet.retire(idx)
        raise
    dt = time.perf_counter() - t0
    timer.add("autoscale_resize", dt)
    logger.warning(
        "reshard: shard %d live at %s, %d shards serving (%.2fs "
        "decision-to-settle)", shard, addr, replay.num_shards, dt,
    )
    return shard, addr
