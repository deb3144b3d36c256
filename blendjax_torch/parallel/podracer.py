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
  batch);
- :class:`FleetSet` — ``num_fleets`` independent env fleets, each with its
  own :class:`~blendjax_torch.btt.launcher.BlenderLauncher`,
  :class:`~blendjax_torch.btt.envpool.EnvPool`,
  :class:`~blendjax_torch.btt.supervise.FleetSupervisor`, counters and
  port range, with one aggregate health snapshot; ``ctrl=True`` and
  ``fleet_env_kwargs=`` make the heterogeneous fleets of the scenario
  plane (docs/scenarios.md).

Layout: the single-fleet path keeps time-major ``(T, N)`` batches; the
fan-in path is env-major ``(N, T)``, as the reference's.

Over a mesh (``mesh=``, the data-parallel learner) ranks are processes:
where the reference drives every shard from one process, here each rank
owns its fleets and fills its own ``Shard(0)`` rows of the global batch,
padded to the rows of the rank with the most envs, and every batch
statistic of the loss is taken over all ranks (``make_segment_loss(
reduce=)``).
"""

from __future__ import annotations

import logging
import queue
import time

import numpy as np
import torch
import torch.distributed as dist

from blendjax_torch.btt.arena import ArenaBatch, ArenaPool
from blendjax_torch.models import policy
from blendjax_torch.utils.device import resolve_device

log = logging.getLogger("blendjax_torch")

#: keys of one rollout segment, in assembly order
SEGMENT_KEYS = ("obs", "actions", "rewards", "dones")


def padded_size(n, shard_count):
    """Smallest multiple of ``shard_count`` >= ``n`` (the global batch's
    padded env count; padding rows ride at mask weight 0)."""
    if shard_count <= 1:
        return n
    return -(-n // shard_count) * shard_count


def make_segment_loss(gamma=0.99, continuous=False, reduce=None):
    """Masked REINFORCE over ENV-MAJOR ``(N, T)`` segment batches.

    ``batch``: obs ``(N, T, D)``, actions ``(N, T[, A])``, rewards /
    dones ``(N, T)``, mask ``(N,)`` — weight 0 rows are padding or
    dead-fleet slices and contribute nothing to the loss, the baseline,
    or the advantage normalization (the population std, as
    ``reinforce_loss``'s).

    ``reduce`` (a data-parallel rank's rows of the global batch;
    :func:`data_sum`) takes the weight, the baseline and the variance over
    every rank (:func:`policy.normalized_advantage`), however the real rows
    fall over the ranks.
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
        adv, scale = policy.normalized_advantage(returns, w, reduce)
        return -(w * logp * adv).sum() * scale

    return loss_fn


def data_sum(mesh, axis="data"):
    """``sum(x)``: a detached tensor summed over ``mesh``'s ``axis`` (one
    all-reduce); ``sum.n_ranks`` is the axis's size.  The batch statistics
    of a data-parallel rank's loss go through it."""
    group = mesh.get_group(axis)

    def total(x):
        x = x.detach().clone()
        dist.all_reduce(x, group=group)
        return x

    total.n_ranks = mesh.size(mesh.mesh_dim_names.index(axis))
    return total


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
        Envs per fleet, in fleet order; fleet ``f`` owns rows
        ``[offset_f, offset_f + n_f)`` of this process's batch.
    mesh: torch DeviceMesh | None
        The data-parallel learner's mesh.  Every rank of ``axis`` makes its
        own fan-in over the fleets it owns (collectively: the ranks agree on
        the row count here).  Each rank's batch has ``n_local`` rows, the
        most envs any rank owns, its own real rows first and the rest
        zero-filled at mask 0, and lands as that rank's ``Shard(0)`` rows of
        an ``n_padded = n_local x ranks`` global batch (:meth:`to_device`).
        None: one process's batch on ``device``.
    axis: str
        The mesh axis the batch shards over.
    queue_size: int
        Segments buffered per fleet (bounds actor-policy staleness
        exactly like the single-fleet queue).
    arena_pool / fleet_arena_pools:
        Global-batch pool and per-fleet segment pools; sized from
        ``queue_size`` when omitted.
    device: str | torch.device
        Where :meth:`to_device` places the batch without a mesh; CUDA unless
        the caller asks for the CPU.  With a mesh, the mesh's device.
    """

    def __init__(self, fleet_sizes, mesh=None, axis="data", queue_size=4, arena_pool=None,
                 fleet_arena_pools=None, device="cuda"):
        self.fleet_sizes = [int(n) for n in fleet_sizes]
        if not self.fleet_sizes or min(self.fleet_sizes) < 1:
            raise ValueError(f"bad fleet sizes {fleet_sizes}")
        self.num_fleets = len(self.fleet_sizes)
        self.offsets = np.concatenate([[0], np.cumsum(self.fleet_sizes)])
        #: this process's real rows
        self.n_real = int(self.offsets[-1])
        self.mesh, self.axis, self.sharding = mesh, axis, None
        if mesh is None:
            self.shard_count, self.n_local, self.n_real_global = 1, self.n_real, self.n_real
            self.device = resolve_device(device)
        else:
            from blendjax_torch.parallel.mesh import data_sharding

            self.shard_count = mesh.size(mesh.mesh_dim_names.index(axis))
            self.sharding = data_sharding(mesh, axis)
            group = mesh.get_group(axis)
            most, total = (torch.tensor([self.n_real]) for _ in range(2))
            dist.all_reduce(most, op=dist.ReduceOp.MAX, group=group)
            dist.all_reduce(total, group=group)
            self.n_local, self.n_real_global = int(most), int(total)
            self.device = resolve_device(mesh.device_type)
        #: rows of the global batch, padding included
        self.n_padded = self.n_local * self.shard_count
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

    def collect(self, alive_fn, stop_event, deadline=None, poll=0.2, min_ready=None):
        """One segment per live fleet: ``{fleet_id: ArenaBatch}``.

        A fleet with ``alive_fn(f)`` False AND an empty queue contributes
        nothing (its rows will be zero-masked); a live-but-slow fleet is
        waited on.  Returns the partial dict immediately when
        ``stop_event`` sets or ``deadline`` (``time.monotonic`` seconds)
        passes — the caller must :meth:`recycle_segments` anything it
        does not assemble.

        ``min_ready`` (docs/scenarios.md, heterogeneous fleets): return as
        soon as at least that many live fleets have contributed — the
        fan-in analog of ``step_wait(min_ready=k)``, so a slow scenario's
        fleet rides into whichever update its segment lands in instead of
        stalling every update to its frame rate.  None keeps the all-live
        barrier."""
        out = {}
        pending = set(range(self.num_fleets))
        while pending:
            if stop_event.is_set():
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            if min_ready is not None and len(out) >= min(
                    min_ready,
                    max(1, sum(1 for f in range(self.num_fleets) if alive_fn(f)))):
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

    def assemble_groups(self, segs, stop_event=None, timeout=30.0):
        """:meth:`assemble` tolerant of per-scenario obs shapes: the
        segments are partitioned by shape signature and each group is
        assembled into its OWN full-width global batch (the other groups'
        fleet rows zero-masked), so a mixed-resolution fleet set never
        forces one global shape.  Returns a list of ``ArenaBatch``
        (singleton, and byte-equal to :meth:`assemble`, whenever shapes
        agree)."""
        out = []
        try:
            for gid, group in self.split_groups(segs):
                out.append(self.assemble(group, stop_event=stop_event, timeout=timeout,
                                         _group=gid))
                if out[-1] is None:
                    out.pop()
        except BaseException:
            for b in out:
                b.recycle()
            raise
        return out

    def assemble(self, segs, stop_event=None, timeout=30.0, _group=0):
        """Scatter per-fleet segments into one env-major global batch.

        Returns an :class:`ArenaBatch` whose data is ``{obs, actions,
        rewards, dones, mask}`` with leading axis ``n_local`` — rows of
        absent fleets and padding zero-filled and carried at ``mask`` 0.  Fleet
        arenas recycle as soon as their rows are copied; the global arena
        recycles after the device copy (:meth:`to_device`).  Segments
        must share one shape signature: route mixed-scenario sets through
        :meth:`assemble_groups`."""
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
                key + suffix, (self.n_local, t_len) + tail, first[key].dtype
            )
        mask = arena.get_buffer("mask" + suffix, (self.n_local,), np.float32)
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
        """Place an assembled batch on the device and recycle its arena once
        the copy has completed.  On the card every leaf goes through the
        feed's pinned staging ring and the arena returns only after the
        copy's event; on the CPU each leaf is first copied into memory it
        owns (``torch.from_numpy`` would alias the arena, and the next
        assembly would rewrite this batch in place).  With a mesh the leaves
        are this rank's ``Shard(0)`` rows of the global batch (DTensors)."""
        from blendjax_torch.btt.prefetch import (
            _hand_over,
            _owned_cpu_batch,
            _PinnedStager,
            _shard_leaves,
        )

        if self.device.type != "cuda":
            dev = _owned_cpu_batch(batch.data)
            batch.recycle()
        else:
            if self._stager is None:
                self._stager = _PinnedStager(self.device)
            dev, event = self._stager.put(batch.data)
            event.synchronize()
            batch.recycle()
            dev = _hand_over(dev, event, self.device)
        return dev if self.sharding is None else _shard_leaves(dev, self.sharding)


class FleetSet:
    """N independent env fleets with one aggregate health surface.

    Launches ``num_fleets`` fleets of ``envs_per_fleet`` producers each:
    fleet ``f`` binds ports from ``start_port + f * port_stride`` (so
    fleets never collide), steps through its own
    :class:`~blendjax_torch.btt.envpool.EnvPool` (quarantining, per-fleet
    ``EventCounters``) and is watched by its own
    :class:`~blendjax_torch.btt.supervise.FleetSupervisor` carrying
    ``fleet_id=f``, which respawns a dead producer (every fleet is
    supervised, and its producers run under ``--background``).  :meth:`health`
    aggregates every fleet's snapshot — counters summed, quarantine masks
    concatenated — via :func:`blendjax_torch.btt.supervise.aggregate_health`.

    Use as a context manager; pass the set (or ``fleet_set.pools``) to
    :class:`~blendjax_torch.models.actor_learner.ActorLearner`.

    Scenario plane (docs/scenarios.md): ``ctrl=True`` allocates a second
    named socket (``CTRL``) per instance — the duplex control endpoints,
    per fleet on :attr:`ctrl_addresses` in the shape
    :class:`~blendjax_torch.scenario.DomainRandomizer` takes — and
    ``fleet_env_kwargs`` (one dict per fleet, layered over the shared
    ``**env_kwargs``) launches heterogeneous fleets, e.g.
    ``fleet_env_kwargs=[spec.env_kwargs() for spec in ...]``.
    """

    def __init__(self, scene, script, num_fleets, envs_per_fleet, *, start_port=21000,
                 port_stride=100, timeoutms=None, fault_policy=None, interval=0.5,
                 ctrl=False, fleet_env_kwargs=None, **env_kwargs):
        if num_fleets < 1 or envs_per_fleet < 1:
            raise ValueError("num_fleets and envs_per_fleet must be >= 1")
        sockets_per_env = 2 if ctrl else 1
        if envs_per_fleet * 2 * sockets_per_env > port_stride:
            # each instance binds one port per named socket (launchers may
            # probe past collisions, hence the 2x margin): a fleet spilling
            # into the next fleet's range would crosstalk with no useful error
            raise ValueError(
                f"envs_per_fleet={envs_per_fleet} does not fit in "
                f"port_stride={port_stride}; raise port_stride to at least "
                f"{2 * sockets_per_env}x the fleet size")
        if fleet_env_kwargs is not None and len(fleet_env_kwargs) != num_fleets:
            raise ValueError(f"fleet_env_kwargs names {len(fleet_env_kwargs)} fleets, "
                             f"num_fleets={num_fleets}")
        self.num_fleets = num_fleets
        self.envs_per_fleet = envs_per_fleet
        self._cfg = dict(scene=scene, script=script,
                         start_port=start_port, port_stride=port_stride, timeoutms=timeoutms,
                         fault_policy=fault_policy, interval=interval,
                         ctrl=bool(ctrl), fleet_env_kwargs=fleet_env_kwargs,
                         env_kwargs=env_kwargs)
        self.launchers = []
        self.pools = []
        self.supervisors = []
        #: per-fleet CTRL endpoint lists (``ctrl=True`` only)
        self.ctrl_addresses = []
        self._stack = []

    def __enter__(self):
        from blendjax_torch.btt.constants import DEFAULT_TIMEOUTMS
        from blendjax_torch.btt.env import kwargs_to_cli
        from blendjax_torch.btt.envpool import EnvPool
        from blendjax_torch.btt.launcher import BlenderLauncher
        from blendjax_torch.btt.supervise import FleetSupervisor
        from blendjax_torch.utils.timing import EventCounters

        cfg = self._cfg
        sockets = ["GYM"] + (["CTRL"] if cfg["ctrl"] else [])
        try:
            for f in range(self.num_fleets):
                # per-fleet overrides layered over the shared kwargs:
                # heterogeneous fleets differ only here
                fkw = dict(cfg["env_kwargs"])
                if cfg["fleet_env_kwargs"] is not None:
                    fkw.update(cfg["fleet_env_kwargs"][f] or {})
                bl = BlenderLauncher(
                    scene=cfg["scene"], script=cfg["script"],
                    num_instances=self.envs_per_fleet, named_sockets=sockets,
                    start_port=cfg["start_port"] + f * cfg["port_stride"],
                    background=True,
                    instance_args=[kwargs_to_cli(fkw) for _ in range(self.envs_per_fleet)])
                bl.__enter__()
                self._stack.append(bl)
                self.launchers.append(bl)
                if cfg["ctrl"]:
                    self.ctrl_addresses.append(list(bl.launch_info.addresses["CTRL"]))
            for f, bl in enumerate(self.launchers):
                counters = EventCounters()
                pool = EnvPool(bl.launch_info.addresses["GYM"],
                               timeoutms=cfg["timeoutms"] or DEFAULT_TIMEOUTMS,
                               fault_policy=cfg["fault_policy"], counters=counters)
                self.pools.append(pool)
                sup = FleetSupervisor(bl, pool=pool, interval=cfg["interval"],
                                      counters=counters, fleet_id=f)
                sup.start()
                self.supervisors.append(sup)
        except BaseException:
            self.close()
            raise
        return self

    def health(self):
        """Aggregate multi-fleet health snapshot (see
        :func:`blendjax_torch.btt.supervise.aggregate_health`)."""
        from blendjax_torch.btt.supervise import aggregate_health

        return aggregate_health(self.supervisors)

    def close(self):
        """Stop every fleet's supervisor, close its pool and shut its
        producers down; each step is attempted for every fleet."""
        for sup in self.supervisors:
            try:
                sup.stop()
            except Exception:
                log.exception("fleet supervisor stop failed")
        self.supervisors = []
        for pool in self.pools:
            try:
                pool.close()
            except Exception:
                log.exception("fleet pool close failed")
        self.pools = []
        while self._stack:
            bl = self._stack.pop()
            try:
                bl.__exit__(None, None, None)
            except Exception:
                log.exception("fleet launcher shutdown failed")
        self.launchers = []

    def __exit__(self, *exc):
        self.close()
        return False
