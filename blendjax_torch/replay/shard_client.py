"""Sharded replay client: the draw authority over N storage shards, the
port of ``blendjax.replay.shard_client``.

:class:`ShardedReplay` subclasses :class:`~blendjax_torch.replay.ReplayBuffer`
and keeps every sampling decision local — the global
:class:`~blendjax_torch.replay.sumtree.SumTree`, the seeded RNG, the
eligibility and generation masks — while the transition rows live on
remote :class:`~blendjax_torch.replay.service.ReplayShard` storage (shard
``s`` owns global slots ``[s*C, (s+1)*C)``).  The draw is the same code
over the same tree whatever the layout, so the global draw stream is
bit-identical for any shard count, to an in-process ``ReplayBuffer`` of
the same capacity and seed, and to the reference's ``ShardedReplay``
(``tests/test_torch_replay_service.py``); ``save``/``restore`` checkpoint
the client mid-stream in the reference's format.

Failure model:

- every shard RPC runs under a :class:`~blendjax_torch.btt.faults.FaultPolicy`
  (a retry re-sends the same correlation id, which the shard's reply cache
  makes exactly-once; backoff; circuit breaker);
- a shard that exhausts its policy (or whose process the supervisor saw
  die) is quarantined: its slot range leaves the draw domain, strata
  renormalize over the live shards' priority mass, and sampling continues
  degraded (``replay_shard_quarantined``); appends it owns are journaled
  client-side;
- a restarted shard (checkpoint and ``.btr`` spill tail restored) is
  re-admitted by a health probe: the client checks the shard's durability
  cursor against what it acked, flushes the journal, and the range rejoins
  the draw domain (``replay_shard_readmissions``).

:class:`~blendjax_torch.btt.supervise.FleetSupervisor` drives both halves
when given a :class:`~blendjax_torch.replay.service.ShardFleet` and
``replay=sharded``.  A scenario-strata draw (``sample(scenario_mix=)``)
leaves out the rows of quarantined shards and the journalled rows, as the
base draw does (:meth:`ShardedReplay._drawable_mask_locked`).
:meth:`ShardedReplay.adopt_shard` admits a new shard live, handing it a
slot range of a source shard (``ReshardAborted`` when it aborts whole);
total capacity, the SumTree and the RNG never change, so the draw stream
continues bit-identically.
"""

from __future__ import annotations

import logging
import os
import socket as _socket
import threading
import time

import numpy as np

from blendjax_torch.btt.faults import FaultPolicy
from blendjax_torch.obs.flight import flight_recorder
from blendjax_torch.obs.spans import SpanRecorder
from blendjax_torch.replay.buffer import ReplayBuffer, load_client_state
from blendjax_torch.utils.timing import fleet_counters

logger = logging.getLogger("blendjax_torch")

#: Client checkpoint format tag (the shard side uses
#: ``blendjax_torch.replay.shard/1``).
SHARDED_FORMAT = "blendjax.replay.sharded/1"

#: Share of a source shard's owned slots that a live handoff
#: (:meth:`ShardedReplay.adopt_shard`) moves: the upper half, an even split.
RESHARD_FRACTION = 0.5


def free_port():
    """An OS-assigned free TCP port (the usual bind-then-close probe)."""
    s = _socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class ReshardAborted(RuntimeError):
    """A live shard handoff (:meth:`ShardedReplay.adopt_shard`) aborted
    whole: the client's ownership map is untouched and the source shard
    keeps serving its full range.  The caller retires the would-be shard
    process."""


class ShardRPCError(TimeoutError):
    """A shard RPC failed at the transport level (no reply within the
    policy, connection refused, circuit open).  Subclasses
    :class:`TimeoutError` so consumers that treat replay starvation as
    skippable (the learner's off-policy tail) handle shard outages the
    same way; carries ``shard_id`` so the failure pins to a shard."""

    def __init__(self, message, shard_id=None):
        super().__init__(message)
        self.shard_id = shard_id


class ShardClient:
    """RPC channel to one replay shard with exactly-once retries.

    Every request is stamped with a fresh ``wire.BTMID_KEY``; a
    fault-policy retry re-sends the SAME id, and replies whose id does
    not match the outstanding request are dropped as stale (a late
    first-attempt reply after a retry, or a dead incarnation's
    leftovers after :meth:`reset_channel`).

    The wire itself is a :class:`~blendjax_torch.btt.transport.RpcChannel`:
    ZMQ DEALER always (control plane + remote fallback), transparently
    upgraded to the ShmRPC ring pair for a same-host shard
    (docs/transport.md).  ``shm=False`` pins the client to ZMQ.
    """

    def __init__(self, address, shard_id=0, *, fault_policy=None,
                 counters=None, timeoutms=5000,
                 span_recorder=None, shm="auto"):
        self.address = address
        self.shard_id = int(shard_id)
        self.policy = fault_policy or FaultPolicy()
        self.state = self.policy.new_state(key=self.shard_id)
        self.counters = counters if counters is not None else fleet_counters
        self.timeoutms = int(timeoutms)
        #: cross-process span sink (None = tracing off): client-side RPC
        #: spans plus the shard's piggybacked server-side spans
        self.spans = span_recorder
        self._shm_mode = shm
        self._chan = None
        #: one request at a time on the channel: a ZMQ socket or a ring
        #: pair read by two threads at once hands one thread the other's
        #: reply (the buffer's appends and a reshard's checkpoint cut
        #: share a shard's client)
        self._lock = threading.Lock()

    def _channel(self):
        if self._chan is None:
            from blendjax_torch.btt.transport import RpcChannel

            self._chan = RpcChannel(
                self.address, shm=self._shm_mode,
                name=f"replay-shard-{self.shard_id}",
            )
        return self._chan

    @property
    def transport(self):
        """The wire the next RPC rides: ``"shm"`` or ``"tcp"``."""
        return self._chan.transport if self._chan is not None else "tcp"

    def reset_channel(self):
        """Drop the channel (DEALER socket AND any shm ring pair) so
        the next RPC dials fresh — replies a dead shard incarnation
        still manages to emit die with the old channel instead of
        confusing the re-admitted one."""
        if self._chan is not None:
            self._chan.reset()

    close = reset_channel

    def rpc(self, cmd, payload=None, *, timeout_ms=None, raw_buffers=False):
        """One exactly-once RPC under the fault policy; returns the
        decoded reply dict, raises :class:`ShardRPCError` (transport)
        or ``RuntimeError`` (the shard executed and reported failure).
        The retry/stale-reply discipline itself is the shared
        :func:`blendjax_torch.btt.rpc.exactly_once_rpc`."""
        from blendjax_torch.btt.rpc import exactly_once_rpc

        msg = dict(payload or {})
        msg["cmd"] = cmd
        with self._lock:
            return exactly_once_rpc(
                self._channel(), msg,
                policy=self.policy, state=self.state,
                counters=self.counters,
                wait_ms=(self.timeoutms if timeout_ms is None
                         else int(timeout_ms)),
                raw_buffers=raw_buffers, spans=self.spans,
                remote_name=f"replay shard {self.shard_id}",
                span_label=f"shard{self.shard_id}_rpc",
                span_cat="replay_client",
                span_args={"shard": self.shard_id},
                rpc_name=f"replay-shard-{self.shard_id}:{cmd}",
                exc_factory=lambda text: ShardRPCError(
                    f"replay shard {self.shard_id} ({self.address}): "
                    f"{text}", self.shard_id,
                ),
                retryable=(ShardRPCError,),
            )


class _ShardedStore:
    """The storage half of :class:`ShardedReplay`: the same surface the
    base class uses on its local :class:`~blendjax_torch.replay.ring.
    ColumnStore` (``write_row``/``read_row``/``gather``/checkpoint
    hooks), fanned across shard RPCs.  Schema discipline is identical —
    fixed by the first row, drift raises — enforced client-side so a
    bad append never reaches the wire."""

    def __init__(self, owner):
        self.owner = owner
        self._schema = None  # key -> (shape, dtype)

    @property
    def keys(self):
        return tuple(self._schema) if self._schema else ()

    @property
    def nbytes(self):
        return 0  # rows live on the shards

    def _check_row(self, row):
        if self._schema is None:
            schema = {}
            for key, value in row.items():
                arr = np.asarray(value)
                if arr.dtype.hasobject or arr.dtype.kind in "USV":
                    raise TypeError(
                        f"transition key {key!r} has dtype {arr.dtype} "
                        f"({type(value).__name__}); replay columns hold "
                        "fixed-shape numeric/bool arrays only"
                    )
                schema[key] = (arr.shape, arr.dtype)
            self._schema = schema
            return
        schema = self._schema
        if row.keys() != schema.keys():
            extra = sorted(set(map(str, row)) ^ set(map(str, schema)))
            raise KeyError(
                f"transition keys changed mid-stream (difference: "
                f"{extra}); the replay schema is fixed by the first "
                "append"
            )
        for key, (shape, dtype) in schema.items():
            arr = np.asarray(row[key])
            if arr.shape != shape or arr.dtype != dtype:
                raise ValueError(
                    f"transition key {key!r} drifted to "
                    f"{arr.shape}/{arr.dtype} (schema: {shape}/{dtype})"
                )

    # -- rows ----------------------------------------------------------------

    def write_row(self, slot, row):
        o = self.owner
        self._check_row(row)
        s = int(o._owner[slot])
        if o._dead[s]:
            o._journal_row_locked(slot, row)
            return
        t0 = time.perf_counter()
        try:
            o.clients[s].rpc(
                "append",
                {"rows": [row], "slots": [int(o._local[slot])]},
                raw_buffers=True,
            )
        except ShardRPCError as exc:
            o._quarantine_locked(s, reason=str(exc))
            o._journal_row_locked(slot, row)
            return
        finally:
            o.timer.add("shard_append", time.perf_counter() - t0)
        o._acked[s] += 1

    def read_row(self, slot):
        o = self.owner
        if o._pending[slot]:
            return {k: np.array(v) for k, v in o._journal[slot].items()}
        out = self.gather(np.array([slot], np.int64))
        return {k: np.array(v[0]) for k, v in out.items()}

    def gather(self, indices, out=None, keys=None):
        o = self.owner
        idx = np.asarray(indices, np.int64)
        n = idx.size
        if self._schema is None:
            raise RuntimeError(
                f"{o.name}: gather before any append fixed the schema"
            )
        if keys is None:
            selected = dict(self._schema)
        else:
            missing = [k for k in keys if k not in self._schema]
            if missing:
                raise KeyError(
                    f"no such replay column(s) {missing}; stored keys: "
                    f"{sorted(self._schema)}"
                )
            selected = {k: self._schema[k] for k in keys}
        batch = {}
        for key, (shape, dtype) in selected.items():
            if out is None:
                dst = np.empty((n,) + shape, dtype)
            elif callable(out):
                dst = out(key, (n,) + shape, dtype)
            else:
                dst = out.get(key)
                if dst is None:
                    dst = np.empty((n,) + shape, dtype)
            if dst.shape != (n,) + shape or dst.dtype != dtype:
                raise ValueError(
                    f"out[{key!r}] is {dst.shape}/{dst.dtype}, need "
                    f"{(n,) + shape}/{dtype}"
                )
            batch[key] = dst
        t0 = time.perf_counter()
        try:
            shard_of = o._owner[idx]
            shards = np.unique(shard_of)
            jobs = []
            for s in shards:
                pos = np.flatnonzero(shard_of == s)
                jobs.append((int(s), pos, o._local[idx[pos]]))
            if len(jobs) > 1 and o._gather_pool is not None:
                # one RPC per shard, in flight CONCURRENTLY: the
                # shards' gathers/ring writes overlap each other (and
                # this thread's scatters) instead of serializing one
                # round trip at a time — most of the wire tax a
                # multi-shard batch still pays after ShmRPC is latency,
                # not bytes
                results = list(o._gather_pool.map(
                    lambda job: self._fetch_shard(job, selected, batch),
                    jobs,
                ))
            else:
                results = [self._fetch_shard(job, selected, batch)
                           for job in jobs]
            for s, exc in results:
                if exc is not None:
                    o._quarantine_locked(s, reason=str(exc))
            for s, exc in results:
                if exc is not None:
                    raise exc
        finally:
            o.timer.add("shard_gather", time.perf_counter() - t0)
        return batch

    def _fetch_shard(self, job, selected, batch):
        """One shard's slice of a gather: RPC + scatter into the batch
        destinations (disjoint row sets, so concurrent workers never
        overlap).  Returns ``(shard, ShardRPCError | None)`` — the
        quarantine decision stays with the calling thread, which holds
        the buffer lock."""
        s, pos, local = job
        o = self.owner
        try:
            reply = o.clients[s].rpc(
                "gather",
                {"indices": local.tolist(), "keys": list(selected)},
                raw_buffers=True,
            )
        except ShardRPCError as exc:
            return s, exc
        data = reply["data"]
        for key in selected:
            batch[key][pos] = data[key]
        return s, None

    # -- checkpoint surface (storage rides on the shards) --------------------

    def state_arrays(self):
        return {}

    def load_state_arrays(self, arrays):
        pass


class ShardedReplay(ReplayBuffer):
    """Prioritized replay over remote storage shards (see module doc).

    Params (beyond :class:`~blendjax_torch.replay.ReplayBuffer`'s)
    ------
    shards: sequence[str | ShardClient]
        One endpoint (or prepared client) per shard, in slot-range
        order.  Total capacity = ``num_shards * shard_capacity``.
    fault_policy: FaultPolicy | None
        Retry/backoff/circuit policy every shard RPC runs under.  The
        default retries twice with a 5-failure circuit breaker — the
        breaker is what keeps quarantined-shard probes from dialing a
        corpse on every heal tick.
    timeoutms: int
        Per-attempt reply wait.
    shard_capacity: int | None
        Expected per-shard capacity; required (with ``allow_dead``)
        when construction must tolerate an unreachable shard, otherwise
        discovered from the shards' ``hello`` replies (which must
        agree).
    allow_dead: bool
        Quarantine unreachable shards at construction instead of
        raising (the restore-into-a-degraded-deployment path).
    """

    def __init__(self, shards, *, seed=0, prioritized=True, alpha=0.6,
                 beta=0.4, eps=1e-3, counters=None, timer=None,
                 fault_policy=None, timeoutms=5000, name=None,
                 shard_capacity=None, allow_dead=False,
                 trace=False, shm="auto"):
        if not shards:
            raise ValueError("ShardedReplay needs at least one shard")
        counters = counters if counters is not None else fleet_counters
        policy = fault_policy or FaultPolicy(
            max_retries=2, backoff_base=0.05, backoff_max=0.5,
            circuit_threshold=5, circuit_cooldown_s=2.0, seed=seed,
        )
        self.fault_policy = policy
        #: cross-process span sink shared by every shard channel (None =
        #: tracing off); shard-side spans piggybacked on replies land
        #: here next to the client RPC spans
        self.spans = SpanRecorder() if trace else None
        clients = []
        for i, s in enumerate(shards):
            if isinstance(s, ShardClient):
                if s.spans is None:
                    s.spans = self.spans
                clients.append(s)
            else:
                clients.append(ShardClient(
                    s, i, fault_policy=policy, counters=counters,
                    timeoutms=timeoutms,
                    span_recorder=self.spans, shm=shm,
                ))
        dead_at_init = []
        hellos = []
        for i, c in enumerate(clients):
            try:
                hellos.append(c.rpc("hello"))
            except ShardRPCError:
                if not allow_dead:
                    raise
                hellos.append(None)
                dead_at_init.append(i)
        caps = {int(h["capacity"]) for h in hellos if h is not None}
        if shard_capacity is None:
            if not caps:
                raise ShardRPCError(
                    "every shard unreachable at construction and no "
                    "shard_capacity given"
                )
            if len(caps) != 1:
                raise ValueError(
                    f"shards disagree on capacity: {sorted(caps)}; all "
                    "shards of one ShardedReplay must be equal-sized"
                )
            shard_capacity = caps.pop()
        elif caps and caps != {int(shard_capacity)}:
            raise ValueError(
                f"shards report capacity {sorted(caps)}, expected "
                f"{shard_capacity}"
            )
        self.num_shards = len(clients)
        self.shard_capacity = int(shard_capacity)
        super().__init__(
            self.num_shards * self.shard_capacity, seed=seed,
            prioritized=prioritized, alpha=alpha, beta=beta, eps=eps,
            counters=counters, timer=timer,
            name=name or (
                f"sharded-replay[{len(clients)}x{shard_capacity}]"
            ),
        )
        self.clients = clients
        self.store = _ShardedStore(self)
        #: worker pool for concurrent per-shard gather RPCs (None:
        #: sequential) on multi-core hosts with several shards: the shards'
        #: server-side gathers and ring writes overlap instead of
        #: serializing one round trip at a time
        self._gather_pool = None
        if self.num_shards > 1 and (os.cpu_count() or 1) > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._gather_pool = ThreadPoolExecutor(
                max_workers=min(self.num_shards, 8),
                thread_name_prefix="bjx-shard-gather",
            )
        #: per-shard rows durably acked (the client half of the
        #: crash-exact contract: re-admission verifies the shard's seq
        #: cursor against this)
        self._acked = [
            int(h["seq"]) if h is not None else 0 for h in hellos
        ]
        self._dead = np.zeros(self.num_shards, bool)
        self._pending = np.zeros(self.capacity, bool)
        self._journal = {}  # global slot -> owned row dict
        self._probe_lock = threading.Lock()
        #: slot-range ownership map (the live-resharding seam): global
        #: slot -> owning shard index, and -> its LOCAL slot on that
        #: shard.  The identity layout (shard s owns the contiguous
        #: range [s*C, (s+1)*C) with local = global % C) until a
        #: handoff (:meth:`adopt_shard`) remaps a range onto a new
        #: shard.  Total capacity — and with it the SumTree, the RNG
        #: and every draw — NEVER changes under a reshard: only which
        #: shard serves a slot's storage RPCs does, which is what makes
        #: the draw stream bit-identical across a resize by
        #: construction.
        self._owner = np.repeat(
            np.arange(self.num_shards, dtype=np.int64),
            self.shard_capacity,
        )
        self._local = (np.arange(self.capacity, dtype=np.int64)
                       % self.shard_capacity)
        for h in hellos:
            if h is not None and h.get("keys"):
                # a shard with pre-existing rows: adopt nothing — the
                # client's eligibility state is authoritative and empty,
                # so those rows are plain overwrite targets
                logger.info(
                    "replay shard %s reports %d pre-existing rows",
                    h["shard_id"], h["seq"],
                )
        with self._cond:
            for i in dead_at_init:
                self._quarantine_locked(
                    i, reason="unreachable at construction"
                )

    # -- shard-range helpers -------------------------------------------------

    def _owned_slots(self, s):
        """Global slots shard ``s`` currently owns (contiguous
        ``[s*C, (s+1)*C)`` until a reshard remaps a range)."""
        return np.flatnonzero(self._owner == s)

    def _local_to_global(self, s):
        """Inverse of the ownership map for shard ``s``: its LOCAL slot
        -> the global slot it backs.  Locals are unique per shard (a
        handoff moves a range whose locals were already distinct), so
        the dict is total over owned slots."""
        owned = self._owned_slots(s)
        return {int(self._local[g]): int(g) for g in owned}

    def _eligible_live_locked(self):
        """Mask of rows drawable right now: eligible AND owned by a live
        shard AND not waiting in the journal."""
        live = ~self._dead[self._owner]
        return self._valid & live & ~self._pending

    # -- quarantine / journal / re-admission ---------------------------------

    @property
    def quarantined(self):
        with self._cond:
            return self._dead.copy()

    @property
    def healthy(self):
        with self._cond:
            return ~self._dead

    def _journal_row_locked(self, slot, row):
        # own array leaves (the caller's may view recycled arena/wire
        # memory); immutable scalar leaves ride as-is so their wire
        # encoding matches a direct append's
        self._journal[slot] = {
            k: (np.array(v) if isinstance(v, np.ndarray) else v)
            for k, v in row.items()
        }
        self._pending[slot] = True
        self.counters.incr("replay_shard_journal")

    def _quarantine_locked(self, s, reason="unresponsive"):
        if self._dead[s]:
            return
        self._dead[s] = True
        self.counters.incr("replay_shard_quarantined")
        flight_recorder.note(
            "replay_shard_quarantined", target=f"shard{s}",
            reason=reason, buffer=self.name,
        )
        self.clients[s].reset_channel()
        live = int((~self._dead).sum())
        logger.warning(
            "%s: shard %d quarantined (%s); sampling continues degraded "
            "over %d/%d shards", self.name, s, reason, live,
            self.num_shards,
        )
        self._cond.notify_all()

    def quarantine_shard(self, s, reason="unresponsive"):
        """Isolate shard ``s``: its slot range leaves the draw domain
        (strata renormalize over live shards) and its appends journal
        client-side until re-admission.  Idempotent.  Called by the
        supervisor on shard-process death, and internally when an RPC
        exhausts its fault policy."""
        with self._cond:
            self._quarantine_locked(int(s), reason=reason)

    def notify_respawn(self, s):
        """Clear shard ``s``'s backoff/circuit state so the next
        :meth:`probe` dials it immediately (the supervisor calls this
        right after a successful respawn, mirroring
        ``EnvPool.notify_respawn``)."""
        self.clients[int(s)].state.record_success()

    def probe(self, block_ms=50):
        """Try to re-admit quarantined shards (supervisor heal path; also
        safe to call inline).  Returns True when at least one shard
        rejoined."""
        with self._cond:
            dead = list(np.flatnonzero(self._dead))
        if not dead:
            return False
        readmitted = False
        with self._probe_lock:
            for s in dead:
                client = self.clients[s]
                if client.state.circuit_open():
                    continue
                try:
                    hello = client.rpc("hello", timeout_ms=block_ms)
                except (ShardRPCError, RuntimeError):
                    continue
                with self._cond:
                    if self._readmit_locked(s, hello):
                        readmitted = True
        return readmitted

    def _readmit_locked(self, s, hello):
        if not self._dead[s]:
            return False
        if int(hello["capacity"]) != self.shard_capacity:
            raise RuntimeError(
                f"{self.name}: restarted shard {s} reports capacity "
                f"{hello['capacity']} != {self.shard_capacity}; refusing "
                "re-admission (it would serve wrong rows)"
            )
        shard_seq = int(hello["seq"])
        owned = self._owned_slots(s)
        if shard_seq < self._acked[s]:
            # the shard came back OLDER than what it acked (restored a
            # stale checkpoint with no spill tail): rows in its range
            # may be arbitrarily wrong — invalidate everything except
            # the journal (whose rows we still hold) instead of serving
            # ghost data
            lost = owned[
                self._valid[owned] & ~self._pending[owned]
            ]
            for slot in lost:
                self._valid[slot] = False
                self._num_valid -= 1
                if self.tree is not None:
                    self.tree.set(int(slot), 0.0)
            self.counters.incr("replay_shard_lost", len(lost))
            flight_recorder.note(
                "replay_shard_lost", target=f"shard{s}",
                rows=len(lost), shard_seq=shard_seq, acked=self._acked[s],
                buffer=self.name,
            )
            logger.error(
                "%s: shard %d restored seq %d < acked %d; invalidated "
                "%d rows in its range", self.name, s, shard_seq,
                self._acked[s], len(lost),
            )
        self._acked[s] = max(self._acked[s], shard_seq)
        # flush the journal: rows appended while the shard was down, in
        # slot order (idempotent by content — a lost flush ack re-sends
        # the same rows to the same slots)
        slots = sorted(
            slot for slot in self._journal if self._owner[slot] == s
        )
        if slots:
            try:
                reply = self.clients[s].rpc(
                    "append",
                    {
                        "rows": [self._journal[slot] for slot in slots],
                        "slots": [
                            int(self._local[slot]) for slot in slots
                        ],
                    },
                    raw_buffers=True,
                )
            except ShardRPCError as exc:
                self._quarantine_locked(
                    s, reason=f"journal flush failed: {exc}"
                )
                return False
            self._acked[s] = int(reply["seq"])
            for slot in slots:
                del self._journal[slot]
                self._pending[slot] = False
        self._dead[s] = False
        self.counters.incr("replay_shard_readmissions")
        flight_recorder.note(
            "replay_shard_readmission", target=f"shard{s}",
            seq=self._acked[s], journal_flushed=len(slots),
            buffer=self.name,
        )
        logger.warning(
            "%s: shard %d re-admitted at seq %d (%d journaled rows "
            "flushed); full draw domain restored", self.name, s,
            self._acked[s], len(slots),
        )
        self._cond.notify_all()
        return True

    # -- sampling ------------------------------------------------------------

    def _draw_locked(self, batch_size, beta):
        if not self._dead.any():
            return super()._draw_locked(batch_size, beta)
        return self._draw_degraded_locked(batch_size, beta)

    def _drawable_mask_locked(self):
        """Scenario-strata draws honor the same degraded-mode eligibility
        as the base draw: rows on quarantined shards or waiting in the
        journal cannot be gathered, so a stratum must not select them."""
        if not self._dead.any() and not self._pending.any():
            return self._valid
        return self._eligible_live_locked()

    def _draw_degraded_locked(self, batch_size, beta):
        """The degraded draw: strata renormalized over the LIVE,
        drawable priority mass.  The master tree is never mutated by
        quarantine (the dead shards' leaves keep their values for
        re-admission); instead the drawable rows' leaf masses are
        cumulated in slot order and each stratified mass resolved with
        one ``searchsorted`` — exact for ANY capacity.  (The master
        tree's prefix domain cannot be reused here: for non-power-of-2
        capacities the tree's prefix order is a rotation of slot order,
        so shard slot ranges are not contiguous in it.)  O(capacity)
        per draw — the exceptional-outage path trades a vectorized
        cumsum (~0.1 ms at 100k rows) for zero bookkeeping on the hot
        healthy path."""
        eligible = self._eligible_live_locked()
        dead_ids = np.flatnonzero(self._dead)
        if self.tree is not None and self.tree.total > 0.0:
            leaves = self.tree._tree[self.tree.capacity:
                                     self.tree.capacity + self.capacity]
            # journaled rows' mass is masked out too: they cannot be
            # gathered, so it must not distort the strata
            live_mass = np.where(eligible, leaves, 0.0)
            cum = np.cumsum(live_mass)
            live_total = float(cum[-1])
            if live_total > 0.0:
                seg = live_total / batch_size
                masses = (
                    np.arange(batch_size) + self._rng.random(batch_size)
                ) * seg
                masses = np.minimum(
                    masses, np.nextafter(live_total, 0)
                )
                idx = np.minimum(
                    np.searchsorted(cum, masses, side="right"),
                    self.capacity - 1,
                ).astype(np.int64)
                probs = live_mass[idx] / live_total
                # float ties at stratum boundaries can land on a
                # zero-mass leaf: re-route those draws to deterministic
                # uniform picks over the drawable rows
                bad = (probs <= 0.0) | ~eligible[idx]
                if bad.any():
                    pool = np.flatnonzero(eligible)
                    if pool.size == 0:
                        raise TimeoutError(
                            f"{self.name}: no drawable rows outside "
                            f"quarantined shards {list(dead_ids)} "
                            f"({self._diag_locked()})"
                        )
                    idx[bad] = pool[self._rng.integers(
                        0, pool.size, int(bad.sum())
                    )]
                    probs[bad] = 1.0 / pool.size
                n_live = int(eligible.sum())
                weights = (n_live * probs) ** -beta
                weights = (weights / weights.max()).astype(np.float32)
                return idx, weights
        pool = np.flatnonzero(eligible)
        if pool.size == 0:
            raise TimeoutError(
                f"{self.name}: no drawable rows outside quarantined "
                f"shards {list(dead_ids)} ({self._diag_locked()})"
            )
        idx = pool[
            self._rng.integers(0, pool.size, batch_size)
        ].astype(np.int64)
        return idx, np.ones(batch_size, np.float32)

    def sample(self, batch_size, **kwargs):
        """Base-class :meth:`~blendjax_torch.replay.ReplayBuffer.sample`, plus
        the storage failure path: a shard dying mid-gather is
        quarantined and the draw retried over the survivors — one
        degraded redraw per newly-dead shard, then the error surfaces
        naming the shard and embedding :meth:`stats`."""
        last = None
        for _ in range(self.num_shards + 1):
            try:
                return super().sample(batch_size, **kwargs)
            except ShardRPCError as exc:
                if exc.shard_id is None:
                    raise
                last = exc
        raise ShardRPCError(
            f"{self.name}: sampling failed even after quarantining "
            f"shard {last.shard_id} ({last}; {self._diag()})",
            last.shard_id,
        )

    # -- checkpoint ----------------------------------------------------------

    def _state_arrays_meta_locked(self):
        arrays, meta = super()._state_arrays_meta_locked()
        arrays["pending"] = self._pending
        arrays["owner"] = self._owner
        arrays["local"] = self._local
        for slot, row in self._journal.items():
            for key, value in row.items():
                arrays[f"jrn.{slot}.{key}"] = value
        meta["format"] = SHARDED_FORMAT
        meta["num_shards"] = self.num_shards
        meta["shard_capacity"] = self.shard_capacity
        meta["acked"] = [int(a) for a in self._acked]
        meta["dead"] = [int(s) for s in np.flatnonzero(self._dead)]
        meta["schema"] = {
            k: [list(shape), np.dtype(dtype).str]
            for k, (shape, dtype) in (self.store._schema or {}).items()
        }
        return arrays, meta

    def save(self, path):
        """Checkpoint the sampling authority AND snapshot every live
        shard, under one lock so client state and shard contents agree
        (appends block for the duration).  Restoring the pair continues
        the exact draw stream — the base-class contract, now spanning
        the service."""
        from blendjax_torch.utils.checkpoint import save_state

        with self._cond:
            arrays, meta = self._state_arrays_meta_locked()
            snapshots = {}
            for s, client in enumerate(self.clients):
                if self._dead[s]:
                    snapshots[str(s)] = None
                    continue
                reply = client.rpc("save")
                snapshots[str(s)] = {
                    "path": reply.get("path"), "seq": int(reply["seq"]),
                }
            meta["shard_snapshots"] = snapshots
            save_state(path, arrays, meta)
        return path

    @classmethod
    def restore(cls, path, shards, *, counters=None, timer=None,
                fault_policy=None, timeoutms=5000, allow_dead=True,
                reconcile=False):
        """Rebuild the sampling authority from :meth:`save` output over
        ``shards`` (typically the same deployment, restarted).  Each
        reachable shard's durability cursor must match what the
        checkpoint acked — a shard that restored different contents
        than this client state describes would serve wrong rows, so the
        mismatch raises instead.  Unreachable shards start quarantined
        (``allow_dead``) and re-admit through the normal probe path.

        ``reconcile=True`` is the **learner-failover** mode
        (docs/fault_tolerance.md "Learner failover"): the shards
        SURVIVED while their client died, so a shard legitimately sits
        AHEAD of the checkpoint — the dead client appended rows after
        the cut.  Each such shard is asked ``written_since(acked)`` and
        exactly the slots written past the cut are invalidated
        client-side (counted ``replay_shard_lost``): they hold rows the
        rewound draw state does not describe, and the resumed actors
        rewrite them in the same ring order — the *replayed* rung of
        the recovery-semantics table.  A shard that cannot answer
        exactly (tail rotated/overflowed past the cut) has its whole
        range rolled back instead of trusting a partial list.  A shard
        BEHIND the checkpoint still raises — that is real data loss,
        not a rewound client."""
        from blendjax_torch.utils.checkpoint import load_state

        arrays, meta = load_state(path)
        fmt = meta.get("format")
        if fmt != SHARDED_FORMAT:
            raise ValueError(
                f"not a sharded replay checkpoint (format {fmt!r})"
            )
        buf = cls(
            shards, seed=meta["seed"], prioritized=meta["prioritized"],
            alpha=meta["alpha"], beta=meta["beta"], eps=meta["eps"],
            counters=counters, timer=timer, fault_policy=fault_policy,
            timeoutms=timeoutms,
            shard_capacity=int(meta["shard_capacity"]),
            allow_dead=allow_dead,
        )
        if buf.num_shards != int(meta["num_shards"]):
            raise ValueError(
                f"checkpoint spans {meta['num_shards']} shards, "
                f"{buf.num_shards} endpoints given"
            )
        load_client_state(buf, arrays, meta)
        buf.store._schema = {
            k: (tuple(shape), np.dtype(dt))
            for k, (shape, dt) in (meta.get("schema") or {}).items()
        }
        buf._pending = np.array(arrays["pending"], bool)
        if "owner" in arrays:
            # resharded deployments carry an explicit slot-ownership map;
            # older checkpoints predate it and keep the identity layout
            # __init__ already built
            buf._owner = np.array(arrays["owner"], np.int64)
            buf._local = np.array(arrays["local"], np.int64)
        for arr_name, value in arrays.items():
            if not arr_name.startswith("jrn."):
                continue
            _, slot, key = arr_name.split(".", 2)
            buf._journal.setdefault(int(slot), {})[key] = np.array(value)
        acked = [int(a) for a in meta["acked"]]
        meta_dead = {int(s) for s in meta.get("dead", [])}
        for s in range(buf.num_shards):
            if buf._dead[s]:
                buf._acked[s] = acked[s]
                continue
            if s in meta_dead:
                # quarantined at checkpoint time: no snapshot exists for
                # it and its cursor may legitimately run ahead of the
                # stale ack (a durably-applied append whose ack was
                # lost triggered the quarantine) — it goes back through
                # the re-admission handshake below, which reconciles
                # the cursors and invalidates anything unaccounted
                buf._acked[s] = max(buf._acked[s], acked[s])
                continue
            shard_seq = buf._acked[s]  # hello's cursor from __init__
            if shard_seq > acked[s] and reconcile:
                buf._reconcile_ahead_shard(s, acked[s])
                continue
            if shard_seq != acked[s]:
                raise RuntimeError(
                    f"{buf.name}: shard {s} is at seq {shard_seq} but "
                    f"the checkpoint acked {acked[s]} — restore the "
                    "shard from its matching snapshot before restoring "
                    "the client (or pass reconcile=True for the "
                    "learner-failover case of a live shard ahead of a "
                    "rewound client), or it would serve rows the draw "
                    "state does not describe"
                )
        for s in meta_dead:
            with buf._cond:
                buf._quarantine_locked(
                    int(s), reason="quarantined at checkpoint time"
                )
        return buf

    def _reconcile_ahead_shard(self, s, acked_at_cut):
        """Restore-time reconcile of a live shard AHEAD of the client
        checkpoint (see :meth:`restore` ``reconcile=``): invalidate the
        slots written past the cut so the rewound draw state never
        gathers rows it does not describe."""
        inv = self._local_to_global(s)
        reply = self.clients[s].rpc(
            "written_since", {"seq": int(acked_at_cut)}
        )
        if reply["complete"]:
            targets = [
                inv[int(slot)] for slot in reply["slots"]
                if int(slot) in inv
            ]
            reason = f"{len(targets)} slots written past the cut"
        else:
            targets = [int(g) for g in self._owned_slots(s)]
            reason = (
                "tail rotated/overflowed past the cut; whole range "
                "rolled back"
            )
        with self._cond:
            rolled = 0
            for slot in targets:
                if not self._valid[slot] or self._pending[slot]:
                    continue
                self._valid[slot] = False
                self._num_valid -= 1
                if self.tree is not None:
                    self.tree.set(int(slot), 0.0)
                rolled += 1
            # the shard's post-cut rows ARE durable — the acked cursor
            # tracks the shard's real seq so resumed appends stay in
            # sync; only the DRAW domain rolled back to the cut
            self._acked[s] = int(reply["seq"])
        if rolled:
            self.counters.incr("replay_shard_lost", rolled)
        flight_recorder.note(
            "replay_shard_reconciled", target=f"shard{s}",
            rolled_back=rolled, acked_at_cut=int(acked_at_cut),
            shard_seq=int(reply["seq"]), buffer=self.name,
        )
        logger.warning(
            "%s: shard %d reconciled ahead of the checkpoint cut "
            "(seq %d > acked %d): %s; %d rows left the draw domain "
            "until the resumed actors rewrite them", self.name, s,
            int(reply["seq"]), int(acked_at_cut), reason, rolled,
        )

    # -- live resharding -----------------------------------------------------

    def adopt_shard(self, new_shard, *, source, cut_seq, timeoutms=5000):
        """Admit a NEW storage shard by handing it a slot range from a
        live ``source`` shard — the replay half of live autoscaling
        (:func:`blendjax_torch.autoscale.reshard_replay`).

        The caller has already (1) checkpointed the source at
        ``cut_seq`` (its ``save`` RPC) and (2) spawned ``new_shard``
        restored FROM that checkpoint (:meth:`~blendjax_torch.replay.service.
        ShardFleet.grow` with ``restore_ckpt=``), so the new shard
        holds every source row up to the cut.  This method verifies
        that, copies only the rows the source appended PAST the cut
        into the moving range (reconciled via ``written_since`` — the
        same machinery re-admission trusts), and flips ownership of the
        upper :data:`RESHARD_FRACTION` of the source's slots under the
        buffer lock (appends block for the cutover, draws never stop).

        Total capacity, the SumTree and the RNG are untouched: draws
        over unmoved ranges are bit-identical, draws over moved ranges
        gather the same rows from a different process.

        ABORTS WHOLE on any verification or copy failure
        (:class:`ReshardAborted`, ``autoscale_reshard_aborts``): the
        ownership map is untouched, the source keeps serving its full
        range, and the caller retires the would-be shard.  The source
        is never quarantined by a handoff failure — direct RPCs here
        bypass the write-path quarantine machinery on purpose.

        Params
        ------
        new_shard: str | ShardClient
            Endpoint (or prepared client) of the restored new shard.
        source: int
            Live shard index surrendering a slot range.
        cut_seq: int
            The source's durability cursor at the checkpoint the new
            shard restored (``save`` RPC's ``seq``).
        Returns the new shard's index.
        """
        s = int(source)
        cut_seq = int(cut_seq)
        t0 = time.perf_counter()
        if isinstance(new_shard, ShardClient):
            client = new_shard
            if client.spans is None:
                client.spans = self.spans
        else:
            client = ShardClient(
                new_shard, self.num_shards,
                fault_policy=self.fault_policy, counters=self.counters,
                timeoutms=timeoutms, span_recorder=self.spans,
            )

        def _abort(why, exc=None):
            self.counters.incr("autoscale_reshard_aborts")
            flight_recorder.note(
                "autoscale_reshard_aborted", target=f"shard{s}",
                reason=why, buffer=self.name,
            )
            client.reset_channel()
            logger.error(
                "%s: shard handoff from %d aborted (%s); ownership map "
                "untouched, source keeps serving", self.name, s, why,
            )
            err = ReshardAborted(f"{self.name}: shard handoff aborted: {why}")
            if exc is not None:
                raise err from exc
            raise err

        # phase 1 (unlocked): verify the new shard restored the cut
        try:
            hello = client.rpc("hello")
        except ShardRPCError as exc:
            _abort(f"new shard unreachable: {exc}", exc)
        if int(hello["capacity"]) != self.shard_capacity:
            _abort(
                f"new shard capacity {hello['capacity']} != "
                f"{self.shard_capacity}"
            )
        if int(hello["seq"]) != cut_seq:
            _abort(
                f"new shard restored seq {hello['seq']}, expected the "
                f"cut at {cut_seq} (wrong/stale checkpoint)"
            )

        # phase 2 (locked): appends block while ownership flips; draws
        # keep flowing the moment the lock drops
        with self._cond:
            if s < 0 or s >= self.num_shards:
                _abort(f"no such source shard {s}")
            if self._dead[s]:
                _abort(f"source shard {s} is quarantined")
            owned = self._owned_slots(s)
            k = int(len(owned) * RESHARD_FRACTION)
            if k < 1 or k >= len(owned):
                _abort(
                    f"fraction {RESHARD_FRACTION} of {len(owned)} owned slots "
                    "leaves nothing to move (or nothing behind)"
                )
            moved = owned[len(owned) - k:]
            if self._pending[moved].any():
                _abort("journaled rows in the moving range")
            # rows the source appended past the cut: exactly these are
            # missing from the checkpoint the new shard restored
            try:
                since = self.clients[s].rpc(
                    "written_since", {"seq": cut_seq}
                )
            except ShardRPCError as exc:
                _abort(f"source written_since failed: {exc}", exc)
            if not since["complete"]:
                _abort(
                    "source cannot enumerate rows past the cut (tail "
                    "rotated); re-checkpoint and retry"
                )
            inv = self._local_to_global(s)
            moving = set(int(g) for g in moved)
            delta = sorted({
                int(slot) for slot in since["slots"]
                if int(slot) in inv and inv[int(slot)] in moving
            })
            new_seq = cut_seq
            if delta:
                keys = list(self.store._schema or {})
                if not keys:
                    _abort(
                        f"{len(delta)} rows past the cut but no schema "
                        "fixed client-side (state mismatch)"
                    )
                try:
                    got = self.clients[s].rpc(
                        "gather", {"indices": delta, "keys": keys},
                        raw_buffers=True,
                    )
                    rows = [
                        {key: got["data"][key][i] for key in keys}
                        for i in range(len(delta))
                    ]
                    reply = client.rpc(
                        "append", {"rows": rows, "slots": delta},
                        raw_buffers=True,
                    )
                except ShardRPCError as exc:
                    _abort(f"delta copy failed: {exc}", exc)
                new_seq = int(reply["seq"])
            # commit: the new shard joins the draw domain owning the
            # moved range; everything before this line was reversible
            t = self.num_shards
            client.shard_id = t
            self.clients.append(client)
            self.num_shards = t + 1
            self._dead = np.append(self._dead, False)
            self._acked.append(int(new_seq))
            self._owner[moved] = t
            self._cond.notify_all()
        dt = time.perf_counter() - t0
        self.timer.add("autoscale_handoff", dt)
        self.counters.incr("autoscale_reshard_handoffs")
        self.counters.incr("autoscale_reshard_rows_copied", len(delta))
        flight_recorder.note(
            "autoscale_reshard_handoff", target=f"shard{t}",
            source=s, moved=len(moved), copied=len(delta),
            cut_seq=cut_seq, buffer=self.name,
        )
        logger.warning(
            "%s: shard %d adopted %d slots from shard %d (%d rows "
            "copied past the cut, %.3fs); draw stream continuous",
            self.name, t, len(moved), s, len(delta), dt,
        )
        return t

    # -- observability -------------------------------------------------------

    def shard_telemetry(self, s, timeout_ms=500):
        """One shard process's telemetry snapshot (the jax-free shard's
        ``telemetry`` RPC: counters + per-stage latency histograms in
        the TelemetryHub merge shape).  Raises :class:`ShardRPCError`
        for a dead/quarantined shard — the hub reports that as a
        ``remote_errors`` entry instead of failing the scrape."""
        with self._cond:
            if self._dead[s]:
                raise ShardRPCError(
                    f"shard {s} is quarantined", int(s)
                )
        return self.clients[int(s)].rpc("telemetry", timeout_ms=timeout_ms)

    def register_with_hub(self, hub, name=None):
        """Wire this buffer into a :class:`~blendjax_torch.obs.TelemetryHub`:
        the client's counters + stage timer locally, and every shard
        process as a remote telemetry source (pulled per scrape over
        the existing RPC channel)."""
        name = name or self.name
        hub.register(
            name, counters=self.counters, timer=self.timer,
            probe=self.stats,
        )
        for s in range(self.num_shards):
            hub.register_remote(
                f"{name}/shard{s}",
                lambda s=s: self.shard_telemetry(s),
            )
        return hub

    def _diag_locked(self):
        dead = list(np.flatnonzero(self._dead))
        return (
            super()._diag_locked()
            + f" shards={self.num_shards} quarantined={dead} "
            f"journal={int(self._pending.sum())}"
        )

    def stats(self):
        st = super().stats()
        with self._cond:
            st["shards"] = {
                "count": self.num_shards,
                "capacity_per_shard": self.shard_capacity,
                "quarantined": [
                    int(s) for s in np.flatnonzero(self._dead)
                ],
                "acked": [int(a) for a in self._acked],
                "journal_pending": int(self._pending.sum()),
                "addresses": [c.address for c in self.clients],
                "owned_slots": [
                    int((self._owner == s).sum())
                    for s in range(self.num_shards)
                ],
            }
        return st

    def close(self):
        if self._gather_pool is not None:
            self._gather_pool.shutdown(wait=False)
            self._gather_pool = None
        for c in self.clients:
            c.close()
