"""Segment fan-in for the multi-fleet actor-learner (Podracer,
arXiv:2104.06272): the port of ``blendjax.parallel.podracer`` without the
mesh.

- :class:`SegmentFanIn` — per-fleet rollout segments (time-major
  ``(T, n_f, ...)``, stacked straight into recycled per-fleet arena
  buffers) are assembled into ONE env-major global batch ``(N, T, ...)``
  in a pooled global arena, the rows of absent fleets zero-filled and
  masked, and placed on the device through the feed's pinned staging;
- :func:`make_segment_loss` — the masked env-major REINFORCE loss the
  multi-fleet learner runs (on an all-ones mask, exactly
  :func:`blendjax_torch.models.policy.reinforce_loss` on the transposed
  batch).

Layout: the single-fleet path keeps time-major ``(T, N)`` batches; the
fan-in path is env-major ``(N, T)``, as the reference's.  The reference
also shards the global batch over a mesh (``mesh=``, ``P('data')``) and
launches fleets as a ``FleetSet``; neither is ported (ROADMAP Queue 1,
items 7 and 9): ``mesh=`` raises, and the caller passes a list of pools.
"""

from __future__ import annotations

import queue
import time

import numpy as np
import torch

from blendjax_torch.btt.arena import ArenaBatch, ArenaPool
from blendjax_torch.models import policy
from blendjax_torch.utils.device import resolve_device

#: keys of one rollout segment, in assembly order
SEGMENT_KEYS = ("obs", "actions", "rewards", "dones")


def padded_size(n, shard_count):
    """Smallest multiple of ``shard_count`` >= ``n`` (the global batch's
    padded env count; padding rows ride at mask weight 0)."""
    if shard_count <= 1:
        return n
    return -(-n // shard_count) * shard_count


def make_segment_loss(gamma=0.99, continuous=False):
    """Masked REINFORCE over ENV-MAJOR ``(N, T)`` segment batches.

    ``batch``: obs ``(N, T, D)``, actions ``(N, T[, A])``, rewards /
    dones ``(N, T)``, mask ``(N,)`` — weight 0 rows are padding or
    dead-fleet slices and contribute nothing to the loss, the baseline,
    or the advantage normalization (the population std, as
    ``reinforce_loss``'s).
    """

    def loss_fn(p, batch):
        returns = policy.discounted_returns(
            batch["rewards"].T, batch["dones"].T, gamma
        ).T  # (N, T)
        if continuous:
            logp = policy.gaussian_log_prob(p, batch["obs"], batch["actions"])
        else:
            logp = policy.categorical_log_prob(p, batch["obs"], batch["actions"])
        w = batch["mask"].to(torch.float32)[:, None].expand(returns.shape)
        wsum = torch.clamp_min(w.sum(), 1.0)
        mu = (w * returns).sum() / wsum
        var = (w * (returns - mu) ** 2).sum() / wsum
        adv = (returns - mu) / (torch.sqrt(var) + 1e-6)
        return -((w * logp * adv.detach()).sum() / wsum)

    return loss_fn


class SegmentFanIn:
    """Fan-in of per-fleet rollout segments into global batches.

    One bounded queue per fleet on the actor side; on the learner side
    :meth:`collect` pulls one segment from every *live* fleet (a fleet
    whose actor died is skipped once its queue drains — the learner never
    stalls on a dead fleet), :meth:`assemble` scatters them env-major into
    a recycled global arena with absent rows zeroed and masked, and
    :meth:`to_device` stages the batch onto ``device``.

    Params
    ------
    fleet_sizes: sequence[int]
        Envs per fleet, in fleet order; fleet ``f`` owns global rows
        ``[offset_f, offset_f + n_f)``.
    mesh:
        Not ported (ROADMAP Queue 1, item 7): must be None.
    queue_size: int
        Segments buffered per fleet (bounds actor-policy staleness
        exactly like the single-fleet queue).
    arena_pool / fleet_arena_pools:
        Global-batch pool and per-fleet segment pools; sized from
        ``queue_size`` when omitted.
    device: str | torch.device
        Where :meth:`to_device` places the batch; CUDA unless the caller
        asks for the CPU.
    """

    def __init__(self, fleet_sizes, mesh=None, queue_size=4, arena_pool=None,
                 fleet_arena_pools=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "SegmentFanIn(mesh=...): the sharded learner waits for the "
                "parallel layer (ROADMAP Queue 1, item 7)"
            )
        self.fleet_sizes = [int(n) for n in fleet_sizes]
        if not self.fleet_sizes or min(self.fleet_sizes) < 1:
            raise ValueError(f"bad fleet sizes {fleet_sizes}")
        self.num_fleets = len(self.fleet_sizes)
        self.offsets = np.concatenate([[0], np.cumsum(self.fleet_sizes)])
        self.n_real = int(self.offsets[-1])
        self.n_padded = self.n_real
        self.device = resolve_device(device)
        self.queues = [
            queue.Queue(maxsize=queue_size) for _ in range(self.num_fleets)
        ]
        self.arena_pool = arena_pool or ArenaPool(pool_size=3)
        self.fleet_arena_pools = fleet_arena_pools or [
            ArenaPool(pool_size=queue_size + 2)
            for _ in range(self.num_fleets)
        ]
        # shape signatures interned first-seen-first; group 0 (the only
        # one in a homogeneous run) keeps the unsuffixed buffer names
        self._shape_groups = {}
        self._stager = None  # the pinned staging ring, made at first use

    # -- actor side ----------------------------------------------------------

    def put_segment(self, fleet_id, seg_lists, stop_event):
        """Stack a finished segment straight into a recycled per-fleet
        arena buffer and enqueue it (bounded put, re-checked against
        ``stop_event``).  ``seg_lists`` is the actor's per-key list of
        per-step ``(n_f,...)`` arrays, ordered :data:`SEGMENT_KEYS`.
        Returns False once stop is set (the segment is dropped and its
        arena recycled)."""
        arena = self.fleet_arena_pools[fleet_id].acquire(stop_event=stop_event)
        if arena is None:
            return False
        data = {}
        for key, col in zip(SEGMENT_KEYS, seg_lists):
            first = np.asarray(col[0])
            buf = arena.get_buffer(key, (len(col),) + first.shape, first.dtype)
            np.stack(col, out=buf)
            data[key] = buf
        batch = ArenaBatch(data, arena)
        while not stop_event.is_set():
            try:
                self.queues[fleet_id].put(batch, timeout=0.2)
                return True
            except queue.Full:
                continue
        batch.recycle()
        return False

    # -- learner side --------------------------------------------------------

    def collect(self, alive_fn, stop_event, deadline=None, poll=0.2):
        """One segment per live fleet: ``{fleet_id: ArenaBatch}``.

        A fleet with ``alive_fn(f)`` False AND an empty queue contributes
        nothing (its rows will be zero-masked); a live-but-slow fleet is
        waited on.  Returns the partial dict immediately when
        ``stop_event`` sets or ``deadline`` (``time.monotonic`` seconds)
        passes — the caller must :meth:`recycle_segments` anything it
        does not assemble."""
        out = {}
        pending = set(range(self.num_fleets))
        while pending:
            if stop_event.is_set():
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            progressed = False
            for f in sorted(pending):
                try:
                    out[f] = self.queues[f].get_nowait()
                    pending.discard(f)
                    progressed = True
                except queue.Empty:
                    if not alive_fn(f):
                        # drain-then-drop: a dead actor may still owe a
                        # final enqueued segment
                        try:
                            out[f] = self.queues[f].get_nowait()
                            progressed = True
                        except queue.Empty:
                            pass
                        pending.discard(f)
            if pending and not progressed:
                # park on one pending queue instead of spinning
                f = min(pending)
                try:
                    out[f] = self.queues[f].get(timeout=poll)
                    pending.discard(f)
                except queue.Empty:
                    pass
        return out

    @staticmethod
    def recycle_segments(segs):
        for s in segs.values():
            s.recycle()

    @staticmethod
    def _shape_sig(seg):
        """Per-segment schema signature: key -> (sample shape, dtype)."""
        return tuple(
            (key, seg.data[key].shape[1:], str(seg.data[key].dtype))
            for key in SEGMENT_KEYS
        )

    def split_groups(self, segs):
        """Partition per-fleet segments by shape signature, interned
        first-seen-first: ``[(group_index, {fid: seg}), ...]`` in group
        order.  One group (every homogeneous run) is the common case."""
        groups = {}
        for f in sorted(segs):
            sig = self._shape_sig(segs[f])
            gid = self._shape_groups.setdefault(sig, len(self._shape_groups))
            groups.setdefault(gid, {})[f] = segs[f]
        return sorted(groups.items())

    def assemble(self, segs, stop_event=None, timeout=30.0, _group=0):
        """Scatter per-fleet segments into one env-major global batch.

        Returns an :class:`ArenaBatch` whose data is ``{obs, actions,
        rewards, dones, mask}`` with leading axis ``n_padded`` — rows of
        absent fleets zero-filled and carried at ``mask`` 0.  Fleet
        arenas recycle as soon as their rows are copied; the global arena
        recycles after the device copy (:meth:`to_device`).  Segments
        must share one shape signature (:meth:`split_groups`)."""
        if not segs:
            raise ValueError("assemble needs at least one fleet segment")
        arena = self.arena_pool.acquire(timeout=timeout, stop_event=stop_event)
        if arena is None:
            if stop_event is not None and stop_event.is_set():
                self.recycle_segments(segs)
                return None
            raise TimeoutError(
                f"no global batch arena freed within {timeout:.1f}s "
                f"(pool size {self.arena_pool.pool_size}); the learner "
                "has stalled or the pool is undersized"
            )
        first = next(iter(segs.values())).data
        t_len = first["rewards"].shape[0]
        # group > 0 buffers get their own arena paths so shape groups never
        # thrash each other's preallocations
        suffix = "" if _group == 0 else f"@g{_group}"
        data = {}
        for key in SEGMENT_KEYS:
            tail = first[key].shape[2:]
            data[key] = arena.get_buffer(
                key + suffix, (self.n_padded, t_len) + tail, first[key].dtype
            )
        mask = arena.get_buffer("mask" + suffix, (self.n_padded,), np.float32)
        mask[:] = 0.0
        for f, seg in segs.items():
            o, n = int(self.offsets[f]), self.fleet_sizes[f]
            for key in SEGMENT_KEYS:
                # (T, n, ...) -> (n, T, ...) at the fleet's global offset
                np.copyto(data[key][o:o + n], seg.data[key].swapaxes(0, 1))
            mask[o:o + n] = 1.0
            seg.recycle()
        # zero the rows nobody wrote: arenas recycle, so stale bytes from a
        # previous batch would otherwise leak into the (masked, but still
        # computed-on) rows
        dead = mask == 0.0
        if dead.any():
            for key in SEGMENT_KEYS:
                data[key][dead] = 0
        data["mask"] = mask
        return ArenaBatch(data, arena)

    def to_device(self, batch):
        """Place an assembled global batch on the device and recycle its
        arena once the copy has completed.  On the card every leaf goes
        through the feed's pinned staging ring and the arena returns only
        after the copy's event; on the CPU each leaf is first copied into
        memory it owns (``torch.from_numpy`` would alias the arena, and the
        next assembly would rewrite this batch in place)."""
        from blendjax_torch.btt.prefetch import _hand_over, _owned_cpu_batch, _PinnedStager

        if self.device.type != "cuda":
            dev = _owned_cpu_batch(batch.data)
            batch.recycle()
            return dev
        if self._stager is None:
            self._stager = _PinnedStager(self.device)
        dev, event = self._stager.put(batch.data)
        event.synchronize()
        batch.recycle()
        return _hand_over(dev, event, self.device)
