"""ServeGateway: a routed, supervised fleet of policy servers, the port of
``blendjax.serve.gateway``.

N replicas (:class:`~blendjax_torch.serve.server.PolicyServer`, usually the
processes of a :class:`~blendjax_torch.serve.server.ServerFleet`) behind
one routing front.  The gateway is one process or thread with a
client-facing ROUTER socket and one DEALER backend per replica:

- **episode-lease affinity**: the ``{slot, episode}`` lease every reset
  reply carries becomes the session token.  The gateway rewrites the
  replica's episode id to a gateway-unique lease id, remembers
  ``lease -> (replica, slot, real episode)``, and pins every later
  ``step``/``close`` of that episode to the replica that owns its
  KV-cache row (``gateway_affinity_hits``).  Lease ids are never reused
  across replica incarnations;
- **load-spread fresh episodes**: each replica's ``telemetry`` RPC is
  scraped on an interval for queue depth, live episodes and the
  ``queue_wait`` p99; a ``reset`` goes to the lowest-scoring healthy,
  non-draining replica (rotation breaks ties; ``gateway_rebalances``
  counts the routes where load overrode rotation);
- **supervision**: a replica whose death the watchdog reports
  (:meth:`ServeGateway.notify_replica_death`), or that stops answering
  scrapes, is **quarantined**: its leases are invalidated, steps against
  them get the actionable stale-lease error and resume after ``reset()``
  on a healthy replica; the respawned replica rejoins on its first
  answered scrape.  :meth:`ServeGateway.drain` stops fresh episodes to a
  replica while its live ones finish, and ``add_replica`` /
  ``remove_replica`` resize the route set live (the autoscaler's calls);
- **exactly-once through the extra hop**: ``wire.BTMID_KEY`` is forwarded
  verbatim, a retry of an in-flight request is re-forwarded to the same
  replica (whose dedupe keeps it exactly-once), and a bounded reply cache
  of mutating replies answers a retry whose reply was lost between
  gateway and client without touching the fleet again;
- **multi-model routing**: requests carrying ``model`` route only to
  replicas hosting that id (learned from the scrape);
- **canary routing** (``canary``/``promote``/``rollback``, steered by
  :class:`blendjax_torch.weights.controller.WeightBusController`) and
  per-version and per-scenario reply records (``version_stats``,
  ``scenario_stats``);
- **ShmRPC**: same-host clients upgrade onto the gateway's shm front as
  against a bare server, and each replica backend is upgraded to its own
  shm channel on the scrape cycle.

Every forwarded reply carries the serving replica's id (``replica``).
Telemetry: ``GATEWAY_EVENTS`` counters and ``GATEWAY_STAGES``
(``gw_route``/``gw_forward``/``gw_reply``); the gateway answers the
``telemetry`` RPC itself, so ``ServeClient.register_with_hub`` makes it a
hub remote.

:class:`ShardedGateway` splits the data plane over N worker processes
(:mod:`blendjax_torch.serve.gateway_worker`) behind one front address.

The silence horizon after which a replica (or a sharded gateway's worker)
is quarantined is :func:`quarantine_after` of the scrape interval,
``max(5, 8 * scrape_interval_s)``: a death the watchdog reports is acted on
at once, and silence alone is a slow fallback, so a loaded host that
delays a scrape does not quarantine a live replica or worker.

Imports no torch: the gateway and its workers are routers, and a worker
spawn must not pay the torch import.  Run a gateway as a process::

    python -m blendjax_torch.serve.gateway --address tcp://127.0.0.1:24100 \
        --replica tcp://127.0.0.1:24000 --replica tcp://127.0.0.1:24001

or in-process via :func:`start_gateway_thread`.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import subprocess
import sys
import threading
import time
import zlib
from collections import OrderedDict, deque

from blendjax_torch import wire
from blendjax_torch.btt import shm_rpc
from blendjax_torch.obs.histogram import LatencyHistogram
from blendjax_torch.obs.spans import make_span, now_us
from blendjax_torch.serve.protocol import MUTATING_CMDS, REPLY_CACHE_DEPTH, drain_socket
from blendjax_torch.utils.timing import StageTimer, fleet_counters

logger = logging.getLogger("blendjax_torch")

#: Bound on the in-flight route table (mid -> client ident + replica).
#: Routes pop when their reply forwards; entries past the bound are the
#: leftovers of clients that gave up — evicted oldest-first.
ROUTE_CACHE_DEPTH = 8192

#: Commands the gateway answers itself (never forwarded): aggregate
#: capability/stats/telemetry, the drain lifecycle, the weight-bus
#: canary lifecycle (docs/weight_bus.md), and the sharded control
#: plane's versioned routing-state publication (``gw_snapshot``,
#: worker mode only — see :class:`ShardedGateway`).
GATEWAY_CMDS = ("hello", "stats", "telemetry", "drain", "undrain",
                "canary", "promote", "rollback", "gw_snapshot")

#: Per-weight-version reply metrics kept (newest versions win): enough
#: for a canary + stable + a few predecessors, bounded regardless of
#: publish rate.
VERSION_STATS_DEPTH = 8

#: Seconds a sharded gateway waits for each worker process's first answer.
WORKER_READY_TIMEOUT_S = 60.0

#: Idle horizon after which a lease is forgotten (a standalone gateway's
#: and every sharded gateway worker's).
LEASE_TTL_S = 600.0

#: Period of the watchdog over a sharded gateway's worker processes.
WORKER_WATCHDOG_INTERVAL_S = 0.2


def quarantine_after(scrape_interval_s):
    """The silence horizon after which a replica or a worker is
    quarantined: eight scrape intervals, and never under 5 s (a watchdog's
    death notice acts at once; silence is the slow fallback, long enough
    that a loaded host's stall does not quarantine a live process)."""
    return max(5.0, 8 * float(scrape_interval_s))


#: Per-scenario reply metrics kept (oldest label evicted first):
#: bounded regardless of how many scenario labels clients invent —
#: a catalog is typically a handful, this is headroom
#: (docs/scenarios.md).
SCENARIO_STATS_DEPTH = 32


class _Replica:
    """One backend replica: its DEALER channel plus the cached scrape
    state the router decides with."""

    __slots__ = (
        "id", "address", "sock", "healthy", "draining", "models",
        "queued", "live", "p99_ms", "pending_live", "last_ok",
        "incarnation", "scrape_mid", "scrape_sent", "next_scrape", "pid",
        "caps", "shm", "shm_state", "shm_next_try", "weight_version",
    )

    def __init__(self, rid, address, sock, now):
        self.id = rid
        self.address = address
        self.sock = sock
        self.healthy = True
        self.draining = False
        self.models = None     # None until the first scrape: matches any
        self.queued = 0
        self.live = 0
        self.p99_ms = 0.0
        #: fresh episodes routed here since the last scrape — the
        #: optimistic estimate that keeps a reset burst spreading
        self.pending_live = 0
        self.last_ok = now     # construction grace: one quarantine window
        self.incarnation = 0
        self.scrape_mid = None
        self.scrape_sent = 0.0
        self.next_scrape = 0.0  # scrape immediately on loop start
        self.pid = None
        self.caps = None  # the replica's hello capability fields, from the scrape
        #: backend ShmRPC channel (None = ZMQ): negotiated through the
        #: scrape cycle once the replica proves alive, torn down on
        #: quarantine, re-negotiated after respawn
        self.shm = None
        self.shm_state = "idle"  # idle | pending | active | off
        self.shm_next_try = 0.0
        #: scraped WeightBus version (None = no snapshot adopted yet,
        #: or a pre-bus replica) — what canary routing keys on
        self.weight_version = None

    def hosts(self, model):
        return model is None or self.models is None or model in self.models

    def load_score(self):
        """Routing score, lower = preferred: live episodes (capacity),
        queue depth (overload, weighted — queued work is latency NOW)
        and the scraped ``queue_wait`` p99 as a slow-replica penalty."""
        return (self.live + self.pending_live + 4 * self.queued
                + self.p99_ms / 100.0)

    def snapshot(self):
        return {
            "address": self.address,
            "healthy": self.healthy,
            "draining": self.draining,
            "models": sorted(self.models) if self.models else None,
            "queued": self.queued,
            "live_episodes": self.live,
            "p99_ms": round(self.p99_ms, 3),
            "incarnation": self.incarnation,
            "pid": self.pid,
            "weight_version": self.weight_version,
        }


class _Lease:
    __slots__ = ("rid", "slot", "episode", "model", "incarnation",
                 "dead", "t_use", "scenario")

    def __init__(self, rid, slot, episode, model, incarnation,
                 scenario=None):
        self.rid = rid
        self.slot = slot
        self.episode = episode  # the replica's REAL lease id
        self.model = model
        self.incarnation = incarnation
        self.dead = False
        self.t_use = time.monotonic()
        #: scenario label the episode was admitted under (None =
        #: unlabelled traffic) — every step/close inherits it for the
        #: per-scenario reply records (docs/scenarios.md)
        self.scenario = scenario


class _Route:
    __slots__ = ("ident", "rid", "inc", "cmd", "model", "gw_ep", "t0",
                 "span_trace", "t0_us", "scenario")

    def __init__(self, ident, rid, inc, cmd, model, gw_ep, span_trace,
                 t0_us, scenario=None):
        self.ident = ident
        self.rid = rid
        self.inc = inc  # replica incarnation at forward time
        self.cmd = cmd
        self.model = model
        self.gw_ep = gw_ep  # the client-visible lease id (step/close)
        self.t0 = time.perf_counter()
        self.span_trace = span_trace
        self.t0_us = t0_us
        self.scenario = scenario


class ServeGateway:
    """The routing front of a policy-server fleet (module docstring).

    Params
    ------
    address: str
        Client-facing endpoint to bind (``tcp://host:*`` binds an
        ephemeral port; resolved endpoint on :attr:`address`).
    replicas: sequence[str]
        Backend replica addresses; replica ids are ``r0..rN-1`` in
        order.
    scrape_interval_s: float
        Cached load/liveness scrape period per replica (the routing
        table refresh — never per-request).
    lease_ttl_s: float | None
        Idle horizon after which a lease is forgotten
        (:data:`LEASE_TTL_S`; None disables, as the sharded gateway's
        control plane does).  A client that crashes without ``close()``
        leaves its lease behind — the replica reclaims the slot via its
        own ``slot_ttl_s``, but the gateway only learns through this
        sweep (the scrape carries counts, not slot identities).  A
        pruned lease's late step gets the same actionable
        reset-and-resume error as a stale one.
    """

    def __init__(self, address, replicas, *, scrape_interval_s=0.25,
                 lease_ttl_s=LEASE_TTL_S, counters=None, timer=None,
                 shm_base=None, worker_index=None, n_workers=1,
                 enable_shm=True):
        import zmq

        if not replicas:
            raise ValueError("a gateway needs >= 1 replica address")
        #: sharded-data-plane worker identity (None = a standalone
        #: gateway).  A worker gateway does NOT scrape or quarantine
        #: replicas itself — replica health / drain / load / canary
        #: state arrives as versioned ``gw_snapshot`` publications from
        #: the control plane (the WeightBus publish pattern pointed at
        #: routing state), so nothing on the request path ever RPCs the
        #: control plane.  Its lease ids are congruent to
        #: ``worker_index`` mod ``n_workers``, so any party can compute
        #: a lease's owning worker with zero shared state.
        self.worker_index = None if worker_index is None \
            else int(worker_index)
        self.n_workers = int(n_workers)
        self.worker_tag = (None if self.worker_index is None
                           else f"gw{self.worker_index}")
        #: last applied control-snapshot version (worker mode; stale
        #: versions are ignored so re-ordered publishes cannot roll
        #: routing state backwards)
        self._snap_version = -1
        #: per-replica incarnation as published by the control plane —
        #: a bump means the control saw a death/restart this worker may
        #: have missed, so local leases on it must die
        self._snap_inc = {}
        self.scrape_interval_s = float(scrape_interval_s)
        self.quarantine_after_s = quarantine_after(self.scrape_interval_s)
        self.lease_ttl_s = (
            None if lease_ttl_s is None else float(lease_ttl_s)
        )
        self._next_lease_sweep = 0.0
        self.counters = counters if counters is not None else fleet_counters
        self.timer = timer if timer is not None else StageTimer()
        self._ctx = zmq.Context.instance()
        self._front = self._ctx.socket(zmq.ROUTER)
        self._front.setsockopt(zmq.LINGER, 0)
        if address.endswith(":*") or address.endswith(":0"):
            base = address.rsplit(":", 1)[0]
            port = self._front.bind_to_random_port(base)
            self.address = f"{base}:{port}"
        else:
            self._front.bind(address)
            self.address = address
        now = time.monotonic()
        self._replicas = {}
        for i, addr in enumerate(replicas):
            sock = self._ctx.socket(zmq.DEALER)
            sock.setsockopt(zmq.LINGER, 0)
            sock.connect(addr)
            self._replicas[f"r{i}"] = _Replica(f"r{i}", addr, sock, now)
        self._order = list(self._replicas)
        self._rr = 0
        self._routes = OrderedDict()   # mid -> _Route (in flight)
        self._scrapes = {}             # mid -> replica id
        self._leases = {}              # gw episode id -> _Lease
        self._lease_rev = {}           # (rid, incarnation, real ep) -> gw ep
        #: lease-id sequence.  Standalone: 0, 1, 2, ...  Worker k of N:
        #: k+N, k+2N, ... — every id ≡ k (mod N), never below N (0 is
        #: not a valid lease and ids < N would alias worker indices)
        self._ep_seq = (0 if self.worker_index is None
                        else self.worker_index)
        self._reply_cache = OrderedDict()
        #: watchdog + autoscale notices (thread-safe appends), applied
        #: on the loop.  ``("add", rid, address)`` / ``("remove", rid,
        #: None)`` are the live-resize ops: the DEALER socket is created
        #: and registered ON the loop thread (zmq sockets are not
        #: thread-safe), so ``add_replica``/``remove_replica`` stay
        #: callable from any controller thread
        self._notices = deque()
        #: next replica id the live-resize path allocates ("r<N>") —
        #: monotonic so a retired id is never reused (stale leases and
        #: in-flight routes on the old id can never alias a newcomer)
        self._rid_seq = len(replicas)
        self._rid_lock = threading.Lock()
        #: the serve_forever poller, stored so _apply_notices can
        #: register/unregister replica sockets added after loop start
        self._poller = None
        #: front-side ShmRPC transport (clients upgrade onto it exactly
        #: as against a bare server) — its bell doubles as the shared
        #: reply-wake fd for the BACKEND shm channels, so one poller
        #: entry covers every ring this process reads
        self._shm_front = None
        if enable_shm and shm_rpc.enabled():
            self._shm_front = shm_rpc.ShmRpcServer(
                shm_base or shm_rpc.new_base("gw"), self.counters,
                who="gateway",
            )
        #: in-flight backend upgrade handshakes: mid -> (phase, rid)
        self._shm_connects = {}
        #: weight-bus canary state (docs/weight_bus.md): while a canary
        #: window is open, fresh episodes split between replicas at the
        #: canary version (``_canary_fraction`` of them, paced by the
        #: deterministic accumulator) and replicas at any OTHER known
        #: version; a rolled-back version is avoided for fresh traffic
        #: until its replicas move off it (rollback republish)
        self._canary_version = None
        self._canary_fraction = 0.0
        self._canary_acc = 0.0
        self._stable_version = None
        self._rejected_version = None
        #: per-weight-version reply metrics (requests / errors / client
        #: round-trip histogram through this gateway) — what the
        #: WeightBusController's promote/rollback verdicts read.  The
        #: lock matters: the gateway IO thread inserts/evicts while a
        #: controller thread iterates via version_stats()
        self._version_stats = OrderedDict()
        self._version_stats_lock = threading.Lock()
        #: per-scenario reply metrics (docs/scenarios.md): requests /
        #: errors / client round-trip histogram per scenario LABEL,
        #: next to the per-version records — the serve tier's view of
        #: a labelled traffic mix.  Same lock discipline as the
        #: version stats (IO thread writes, scrapers iterate).
        self._scenario_stats = OrderedDict()

    # -- admin (callable from any thread; applied under the GIL) -------------

    def drain(self, rid):
        """Stop routing FRESH episodes to ``rid``; its live episodes
        keep stepping until they close — the rolling-restart primitive.

        Idempotent: re-draining an already-draining replica is a no-op
        (returns ``False``, no second ``gateway_drains`` count), so a
        restarted autoscale controller can re-issue its decision
        against observed fleet state without double-acting.  Legal on a
        QUARANTINED replica: the flag survives quarantine and
        re-admission (``_ingest_scrape`` never touches ``draining``),
        so a victim that dies mid-drain comes back still draining.
        An unknown ``rid`` raises ``KeyError`` naming the known ids —
        never a silent no-op."""
        rep = self._replicas.get(rid)
        if rep is None:
            raise KeyError(
                f"unknown replica {rid!r}; known: {self._order}"
            )
        if rep.draining:
            return False
        rep.draining = True
        self.counters.incr("gateway_drains")
        return True

    def undrain(self, rid):
        """Re-admit a drained replica to fresh-episode routing.  Same
        contract as :meth:`drain`: idempotent (``False`` when it was
        not draining), legal while quarantined, ``KeyError`` with the
        known ids on an unknown ``rid``."""
        rep = self._replicas.get(rid)
        if rep is None:
            raise KeyError(
                f"unknown replica {rid!r}; known: {self._order}"
            )
        if not rep.draining:
            return False
        rep.draining = False
        return True

    def canary(self, version, fraction=0.25):
        """Open a canary window: route ``fraction`` of FRESH episodes
        to replicas whose scraped ``weight_version`` equals
        ``version``; the rest go to replicas at other known versions.
        Replicas at NO known version (a respawned process that has not
        caught up to the bus yet) get no fresh episodes while a window
        is open — re-admission for canary traffic is version-gated."""
        self._canary_version = int(version)
        self._canary_fraction = float(fraction)
        self._canary_acc = 0.0
        if self._rejected_version == self._canary_version:
            self._rejected_version = None  # an explicit second chance
        self.counters.incr("weight_canary_starts")
        return self._canary_version

    def promote(self):
        """The open canary version becomes stable; the window closes
        (fresh episodes stop being version-split)."""
        if self._canary_version is None:
            return False
        self._stable_version = self._canary_version
        self._canary_version = None
        self._canary_fraction = 0.0
        self.counters.incr("weight_canary_promotions")
        return True

    def rollback(self):
        """Close the canary window and REJECT its version: fresh
        episodes avoid replicas still at it (until a rollback republish
        moves them forward to the old weights)."""
        if self._canary_version is None:
            return False
        self._rejected_version = self._canary_version
        self._canary_version = None
        self._canary_fraction = 0.0
        self.counters.incr("weight_canary_rollbacks")
        return True

    def set_stable(self, version):
        """Record the stable (baseline) weight version — the
        controller's bootstrap for the first version a fleet reports."""
        self._stable_version = None if version is None else int(version)

    @property
    def canary_version(self):
        return self._canary_version

    @property
    def stable_version(self):
        return self._stable_version

    @property
    def rejected_version(self):
        return self._rejected_version

    def fleet_versions(self):
        """``{rid: scraped weight_version}`` over HEALTHY replicas."""
        return {r.id: r.weight_version
                for r in self._replicas.values() if r.healthy}

    def version_stats(self):
        """Per-weight-version reply metrics: ``{version: {"requests",
        "errors", "p50_ms", "p99_ms"}}`` (client round-trip through
        this gateway, errors included in the counts)."""
        with self._version_stats_lock:
            items = [(v, rec["requests"], rec["errors"],
                      rec["hist"].copy())
                     for v, rec in self._version_stats.items()]
        out = {}
        for v, requests, errors, hist in items:
            pct = hist.percentiles()
            out[v] = {
                "requests": requests,
                "errors": errors,
                "p50_ms": pct["p50_ms"],
                "p99_ms": pct["p99_ms"],
            }
        return out

    def _note_version_reply(self, version, is_error, latency_s):
        with self._version_stats_lock:
            rec = self._version_stats.get(version)
            if rec is None:
                rec = self._version_stats[version] = {
                    "requests": 0, "errors": 0,
                    "hist": LatencyHistogram(),
                }
                # evict oldest-first, but NEVER the stable or canary
                # record: those are exactly what the controller's
                # promote/rollback verdicts diff against, and a
                # fast-publishing learner would otherwise age the
                # stable baseline out and silently disable the p99
                # regression check
                keep = {self._stable_version, self._canary_version,
                        version}
                while len(self._version_stats) > VERSION_STATS_DEPTH:
                    victim = next(
                        (v for v in self._version_stats
                         if v not in keep),
                        None,
                    )
                    if victim is None:
                        break  # everything is load-bearing: grow
                    del self._version_stats[victim]
            rec["requests"] += 1
            if is_error:
                rec["errors"] += 1
            rec["hist"].add(latency_s)

    def scenario_stats(self):
        """Per-scenario reply metrics: ``{scenario: {"requests",
        "errors", "p50_ms", "p99_ms"}}`` — client round-trip through
        this gateway per traffic label, the serve tier's per-scenario
        QPS/latency record (docs/scenarios.md)."""
        with self._version_stats_lock:
            items = [(s, rec["requests"], rec["errors"],
                      rec["hist"].copy())
                     for s, rec in self._scenario_stats.items()]
        out = {}
        for s, requests, errors, hist in items:
            pct = hist.percentiles()
            out[s] = {
                "requests": requests,
                "errors": errors,
                "p50_ms": pct["p50_ms"],
                "p99_ms": pct["p99_ms"],
            }
        return out

    def _note_scenario_reply(self, scenario, is_error, latency_s):
        with self._version_stats_lock:
            rec = self._scenario_stats.get(scenario)
            if rec is None:
                rec = self._scenario_stats[scenario] = {
                    "requests": 0, "errors": 0,
                    "hist": LatencyHistogram(),
                }
                while len(self._scenario_stats) > SCENARIO_STATS_DEPTH:
                    self._scenario_stats.popitem(last=False)
            rec["requests"] += 1
            if is_error:
                rec["errors"] += 1
            rec["hist"].add(latency_s)
        self.counters.incr("scenario_serve_requests")

    def notify_replica_death(self, idx_or_rid, exit_code=None):
        """Watchdog ``on_death`` hook: quarantine the replica NOW
        instead of waiting out the scrape silence horizon."""
        self._notices.append(("death", self._rid(idx_or_rid)))

    def notify_replica_respawn(self, idx_or_rid, proc=None):
        """Watchdog ``on_respawn`` hook: probe the replica immediately
        so re-admission does not wait for the next scheduled scrape."""
        self._notices.append(("respawn", self._rid(idx_or_rid)))

    def _rid(self, idx_or_rid):
        return (idx_or_rid if isinstance(idx_or_rid, str)
                else f"r{int(idx_or_rid)}")

    def add_replica(self, address, rid=None):
        """Admit a NEW replica to the route set (autoscale scale-up).
        Callable from any thread: allocates a never-reused id and
        enqueues the admission; the loop thread creates and registers
        the DEALER socket.  The newcomer is scraped immediately and
        joins fresh-episode routing once it answers.  Returns the id."""
        with self._rid_lock:
            if rid is None:
                rid = f"r{self._rid_seq}"
                self._rid_seq += 1
            else:
                # an explicit id (fleet-index alignment) advances the
                # sequence past it so later automatic ids cannot alias
                num = rid[1:]
                if rid.startswith("r") and num.isdigit():
                    self._rid_seq = max(self._rid_seq, int(num) + 1)
        self._notices.append(("add", rid, address))
        return rid

    def remove_replica(self, rid):
        """Retire ``rid`` from the gateway entirely (autoscale
        scale-down, after its drain reached zero live leases).  Any
        lease still on it is marked dead — the owning client gets the
        actionable stale-lease error, exactly the quarantine path —
        so removal is safe even when the drain was cut short."""
        self._notices.append(("remove", rid, None))

    def replica_ids(self):
        """The CURRENT route-set ids (admissions/removals applied on
        the loop thread may lag an ``add_replica`` by one loop tick)."""
        return list(self._order)

    def lease_count(self, rid):
        """Live (non-dead) leases owned by ``rid`` — what an autoscale
        drain polls toward zero before retiring the process."""
        return sum(1 for lease in list(self._leases.values())
                   if lease.rid == rid and not lease.dead)

    def replica_snapshots(self):
        """Per-replica routing-state snapshots (healthy / draining /
        load), the scrape surface controller decisions read."""
        return {r.id: r.snapshot() for r in list(self._replicas.values())}

    def _apply_notices(self):
        while self._notices:
            kind, rid, payload = (self._notices.popleft() + (None,))[:3]
            if kind == "add":
                self._admit_replica(rid, payload)
                continue
            rep = self._replicas.get(rid)
            if rep is None:
                continue
            if kind == "remove":
                self._retire_replica(rep)
            elif kind == "death":
                self._quarantine(rep)
            else:  # respawn: probe now
                rep.next_scrape = 0.0

    def _admit_replica(self, rid, address):
        import zmq

        if rid in self._replicas:
            return  # idempotent against a re-enqueued admission
        sock = self._ctx.socket(zmq.DEALER)
        sock.setsockopt(zmq.LINGER, 0)
        sock.connect(address)
        rep = _Replica(rid, address, sock, time.monotonic())
        self._replicas[rid] = rep
        self._order.append(rid)
        if self._poller is not None:
            self._poller.register(sock, zmq.POLLIN)
        logger.info("gateway: replica %s (%s) admitted", rid, address)

    def _retire_replica(self, rep):
        self._demote_backend(rep, "replica retired")
        for lease in self._leases.values():
            if lease.rid == rep.id:
                lease.dead = True
        for mid in [m for m, r in self._scrapes.items() if r == rep.id]:
            self._scrapes.pop(mid, None)
        if self._poller is not None:
            try:
                self._poller.unregister(rep.sock)
            except KeyError:
                pass
        try:
            rep.sock.close(0)
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass
        self._replicas.pop(rep.id, None)
        if rep.id in self._order:
            self._order.remove(rep.id)
        self._rr = self._rr % max(1, len(self._order))
        logger.info("gateway: replica %s (%s) retired", rep.id,
                    rep.address)

    # -- lease + quarantine bookkeeping --------------------------------------

    def _drop_lease(self, gw_ep):
        lease = self._leases.pop(gw_ep, None)
        if lease is not None:
            self._lease_rev.pop(
                (lease.rid, lease.incarnation, lease.episode), None
            )

    def _demote_backend(self, rep, reason, backoff_s=2.0):
        """Drop a replica's shm channel and fall back to its DEALER
        socket (re-negotiated through the scrape cycle)."""
        if rep.shm is not None:
            try:
                rep.shm.close(unlink=True)
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass
            rep.shm = None
            logger.warning("gateway: replica %s shm channel demoted "
                           "(%s)", rep.id, reason)
        if rep.shm_state != "off":
            rep.shm_state = "idle"
            rep.shm_next_try = time.monotonic() + backoff_s
        for mid in [m for m, entry in self._shm_connects.items()
                    if entry[1] == rep.id]:
            entry = self._shm_connects.pop(mid)
            if len(entry) > 2 and entry[2] is not None:
                try:
                    entry[2].close(unlink=True)
                except Exception:  # noqa: BLE001
                    pass

    def _quarantine(self, rep):
        if not rep.healthy:
            return
        self._demote_backend(rep, "replica quarantined", backoff_s=0.5)
        rep.healthy = False
        rep.incarnation += 1
        rep.pending_live = 0
        rep.queued = 0
        rep.live = 0
        # the respawned process starts with NO adopted snapshot: until
        # a scrape reports its (re-synced) version, canary routing must
        # not treat it as caught up
        rep.weight_version = None
        for lease in self._leases.values():
            if lease.rid == rep.id:
                # kept (marked) rather than dropped so the episode's
                # next step gets the SPECIFIC stale-lease error naming
                # the dead replica, not a generic unknown-lease one
                lease.dead = True
        self.counters.incr("gateway_replica_quarantined")
        logger.warning("gateway: replica %s (%s) quarantined",
                       rep.id, rep.address)

    # -- scrape loop ---------------------------------------------------------

    def _scrape_tick(self):
        import zmq

        now = time.monotonic()
        if self.worker_index is not None:
            # worker mode: the control plane owns scrapes, quarantine
            # verdicts and re-admission (published via gw_snapshot) —
            # only the local lease-TTL sweep below runs here
            self._lease_sweep(now)
            return
        for rep in self._replicas.values():
            if rep.scrape_mid is not None and \
                    now - rep.scrape_sent > self.scrape_interval_s * 2:
                # scrape lost (dead replica or drop): give up on the
                # mid so the next interval re-probes
                self._scrapes.pop(rep.scrape_mid, None)
                rep.scrape_mid = None
            if rep.scrape_mid is None and now >= rep.next_scrape:
                msg = {"cmd": "telemetry"}
                mid = wire.stamp_message_id(msg)
                try:
                    # DONTWAIT: a dead replica's pipe must not fill up
                    # with scrapes and block the gateway loop — the
                    # silence horizon quarantines it instead
                    wire.send_message_dealer(rep.sock, msg,
                                             flags=zmq.DONTWAIT)
                except zmq.ZMQError:  # Again included: skip this round
                    continue
                rep.scrape_mid = mid
                rep.scrape_sent = now
                rep.next_scrape = now + self.scrape_interval_s
                self._scrapes[mid] = rep.id
            if rep.healthy and now - rep.last_ok > self.quarantine_after_s:
                self._quarantine(rep)
        self._lease_sweep(now)

    def _lease_sweep(self, now):
        """Abandoned-episode sweep: a client that crashed without
        ``close()`` must not leak a lease forever (the replica reclaims
        the slot via ``slot_ttl_s``; this is the gateway's analogue).
        Swept on the scrape cadence, amortized."""
        if self.lease_ttl_s is not None and now >= self._next_lease_sweep:
            self._next_lease_sweep = now + max(1.0, self.lease_ttl_s / 4)
            cutoff = now - self.lease_ttl_s
            for gw_ep in [ep for ep, lease in self._leases.items()
                          if lease.t_use < cutoff]:
                self._drop_lease(gw_ep)

    def _ingest_scrape(self, rep, reply):
        rep.last_ok = time.monotonic()
        rep.scrape_mid = None
        pid = reply.get("pid")
        if rep.healthy and rep.pid is not None and pid is not None \
                and pid != rep.pid:
            # SILENT restart: the replica answered a new pid without
            # ever missing a scrape (external restart, or a respawn
            # faster than the quarantine horizon).  Its slot pool is
            # fresh — old leases must die NOW, and the incarnation must
            # bump so the new process's recycled (slot, episode) pairs
            # cannot alias old gateway leases through _lease_rev
            self._quarantine(rep)
        if not rep.healthy:
            rep.healthy = True
            self.counters.incr("gateway_replica_respawns")
            logger.warning("gateway: replica %s answered again — "
                           "re-admitted", rep.id)
        models = reply.get("models")
        if models:
            rep.models = set(models)
        rep.queued = int(reply.get("queued", 0))
        rep.live = int(reply.get("live_episodes", 0))
        rep.pending_live = 0  # the scrape's live count subsumes it
        rep.pid = pid
        rep.weight_version = reply.get("weight_version")
        caps = reply.get("hello")
        if isinstance(caps, dict):
            rep.caps = caps
        stages = reply.get("stages") or {}
        rec = stages.get("queue_wait") or {}
        hist = rec.get("hist")
        try:
            if hist:
                rep.p99_ms = LatencyHistogram.from_dict(
                    hist
                ).percentiles()["p99_ms"]
            elif "p99_ms" in rec:
                # a summary-shaped stage record (no histogram)
                rep.p99_ms = float(rec["p99_ms"])
        except Exception:  # noqa: BLE001 - scrape must not kill routing
            pass
        # the replica just proved alive: (re-)negotiate its shm channel
        self._maybe_upgrade_backend(rep)

    # -- backend shm upgrade (rides the scrape cycle, fully async) -----------

    def _maybe_upgrade_backend(self, rep):
        import zmq

        if (self._shm_front is None or rep.shm is not None
                or rep.shm_state in ("pending", "off")
                or time.monotonic() < rep.shm_next_try):
            return
        msg = {"cmd": "shm_connect", "host": shm_rpc.host_token()}
        mid = wire.stamp_message_id(msg)
        try:
            wire.send_message_dealer(rep.sock, msg, flags=zmq.DONTWAIT)
        except zmq.ZMQError:
            return
        rep.shm_state = "pending"
        self._shm_connects[mid] = ("connect", rep.id, None)

    def _handle_backend_upgrade(self, rep, phase, chan, reply):
        """One step of the async backend handshake (connect -> attach
        -> open), driven entirely by replies arriving on the replica's
        DEALER socket — the gateway loop never blocks on it."""
        import zmq

        def fail(permanent=False, close_chan=None):
            if close_chan is not None:
                try:
                    close_chan.close(unlink=True)
                except Exception:  # noqa: BLE001
                    pass
            rep.shm_state = "off" if permanent else "idle"
            rep.shm_next_try = time.monotonic() + 5.0

        if not rep.healthy:
            return fail(close_chan=chan)
        if phase == "connect":
            if "error" in reply or "shm_channel" not in reply:
                # a considered refusal (kill-switch, host mismatch,
                # pre-ShmRPC replica): permanent for this incarnation
                logger.info("gateway: replica %s refused shm (%s)",
                            rep.id, reply.get("error", "no channel"))
                return fail(permanent=True)
            try:
                new_chan = shm_rpc.ShmClientChannel(
                    reply["shm_channel"], reply["shm_bell"],
                    bell=self._shm_front.bell,
                )
            except Exception:  # noqa: BLE001 - degrade, never fail
                return fail()
            msg = {"cmd": "shm_attach", "channel": new_chan.name,
                   "bell": new_chan.bell_path}
            mid = wire.stamp_message_id(msg)
            try:
                wire.send_message_dealer(rep.sock, msg,
                                         flags=zmq.DONTWAIT)
            except zmq.ZMQError:
                return fail(close_chan=new_chan)
            self._shm_connects[mid] = ("attach", rep.id, new_chan)
            return
        # phase == "attach"
        if "error" in reply:
            return fail(close_chan=chan)
        try:
            chan.finish(open_timeout_ms=1000)
        except Exception:  # noqa: BLE001
            return fail(close_chan=chan)
        rep.shm = chan
        rep.shm_state = "active"
        logger.info("gateway: replica %s upgraded to shm channel %s",
                    rep.id, chan.name)

    # -- control-snapshot subscription (worker mode) -------------------------

    def _cmd_gw_snapshot(self, msg):
        """Adopt one versioned control-plane snapshot: replica health /
        drain / load / caps and the canary window, as scraped and
        decided by the :class:`ShardedGateway` control thread.  Workers
        only ever READ this consistent view — the request path never
        RPCs the control plane.  Stale versions are ignored (re-ordered
        publishes must not roll routing state backwards)."""
        if self.worker_index is None:
            return {"error": "gw_snapshot against a non-worker gateway"}
        version = int(msg.get("version", -1))
        if version <= self._snap_version:
            return {"applied": False, "version": self._snap_version}
        self._snap_version = version
        for rid, snap in (msg.get("replicas") or {}).items():
            rep = self._replicas.get(rid)
            if not isinstance(snap, dict) or rep is None:
                continue
            inc = int(snap.get("incarnation", 0))
            known = self._snap_inc.get(rid)
            if known is not None and inc > known:
                # the control plane saw a death/restart (possibly a
                # silent one) this worker may have missed: local leases
                # on the replica must die before the new incarnation's
                # recycled (slot, episode) pairs can alias them
                self._quarantine(rep)
            self._snap_inc[rid] = inc
            if not snap.get("healthy", False):
                self._quarantine(rep)
            elif not rep.healthy:
                rep.healthy = True
                self.counters.incr("gateway_replica_respawns")
            rep.draining = bool(snap.get("draining", False))
            models = snap.get("models")
            if models:
                rep.models = set(models)
            rep.queued = int(snap.get("queued", 0))
            rep.live = int(snap.get("live", 0))
            rep.pending_live = 0  # the snapshot's live count subsumes it
            rep.p99_ms = float(snap.get("p99_ms") or 0.0)
            rep.pid = snap.get("pid")
            rep.weight_version = snap.get("weight_version")
            caps = snap.get("caps")
            if isinstance(caps, dict):
                rep.caps = caps
            if rep.healthy:
                # the control plane vouches for the replica (its scrape
                # answered): probe the shm upgrade off the snapshot
                # cadence, exactly where the standalone gateway probes
                # off its own scrape ingest
                rep.last_ok = time.monotonic()
                self._maybe_upgrade_backend(rep)
        weights = msg.get("weights") or {}
        self._canary_version = weights.get("canary_version")
        self._canary_fraction = float(
            weights.get("canary_fraction") or 0.0
        )
        self._stable_version = weights.get("stable_version")
        self._rejected_version = weights.get("rejected_version")
        self.counters.incr("gateway_snapshot_applies")
        return {"applied": True, "version": version}

    # -- gateway-level commands ----------------------------------------------

    def _cmd_hello(self, msg):
        models = set()
        caps = None
        for rep in self._replicas.values():
            models |= rep.models or set()
            if caps is None and rep.healthy and rep.caps is not None:
                caps = rep.caps
        out = {}
        if caps is not None:
            # a representative replica's capability fields
            # (obs_dim, slots, max_batch, buckets, int8, serial, model)
            # so hello consumers written against a bare server work
            # unchanged pointed at a gateway
            out.update(caps)
        out.update({
            "gateway": True,
            "replicas": {r.id: r.snapshot()
                         for r in self._replicas.values()},
            "models": sorted(models),
            "shm": (self._shm_front.info()
                    if self._shm_front is not None else None),
            "pid": os.getpid(),
        })
        if self.worker_tag is not None:
            out["gw_worker"] = self.worker_tag
            out["n_workers"] = self.n_workers
        return out

    def _cmd_stats(self, msg):
        return {
            "gateway": True,
            "replicas": {r.id: r.snapshot()
                         for r in self._replicas.values()},
            "leases": len(self._leases),
            "routes_inflight": len(self._routes),
            "counters": self.counters.snapshot(),
            "weights": self._weights_snapshot(),
            "scenarios": self.scenario_stats(),
            "pid": os.getpid(),
        }

    def _weights_snapshot(self):
        """The rollout state one dict deep: canary window, stable /
        rejected versions, per-replica versions, per-version metrics."""
        return {
            "canary_version": self._canary_version,
            "canary_fraction": self._canary_fraction,
            "stable_version": self._stable_version,
            "rejected_version": self._rejected_version,
            "fleet_versions": self.fleet_versions(),
            "version_stats": {
                str(v): rec for v, rec in self.version_stats().items()
            },
        }

    def _cmd_telemetry(self, msg):
        """The gateway's OWN telemetry in the TelemetryHub merge shape
        (``ServeClient.register_with_hub`` against a gateway address
        scrapes the routing tier, not a replica)."""
        return {
            "gateway": True,
            "pid": os.getpid(),
            "counters": self.counters.snapshot(),
            "stages": self.timer.snapshot_serialized(),
            "replicas": {r.id: r.snapshot()
                         for r in self._replicas.values()},
            "weights": self._weights_snapshot(),
            "scenarios": self.scenario_stats(),
        }

    def _cmd_canary(self, msg):
        version = msg.get("version")
        if version is None:
            return {"error": "canary needs a version"}
        v = self.canary(version, float(msg.get("fraction", 0.25)))
        return {"canary_version": v,
                "fraction": self._canary_fraction}

    def _cmd_promote(self, msg):
        promoted = self.promote()
        return {"promoted": promoted,
                "stable_version": self._stable_version}

    def _cmd_rollback(self, msg):
        rolled = self.rollback()
        return {"rolled_back": rolled,
                "rejected_version": self._rejected_version}

    def _cmd_drain(self, msg):
        return self._drain_cmd(msg, True)

    def _cmd_undrain(self, msg):
        return self._drain_cmd(msg, False)

    def _drain_cmd(self, msg, draining):
        rid = msg.get("replica")
        if rid not in self._replicas:
            return {"error": (
                f"unknown replica {rid!r}; known: {self._order}"
            )}
        (self.drain if draining else self.undrain)(rid)
        return {"draining": [r.id for r in self._replicas.values()
                             if r.draining]}

    # -- routing -------------------------------------------------------------

    def _route_fresh(self, model):
        """Pick the replica a fresh episode goes to: healthy, not
        draining, hosting ``model``; lowest load score, with ties going
        to the ROTATION candidate (eligible replicas are ranked in
        rotation order and ``min`` keeps the first on equal scores), so
        equal-load fleets round-robin instead of pinning to the
        lowest-sorting replica id.

        Weight-bus overlays (docs/weight_bus.md): a ROLLED-BACK
        version's replicas are avoided while any alternative exists,
        and an open canary window splits fresh episodes between the
        canary version's replicas (``_canary_fraction`` of them, paced
        deterministically) and other KNOWN-version replicas — a replica
        at no known version (respawned, not yet caught up to the bus)
        gets nothing until a scrape shows it synced."""
        n = len(self._order)
        eligible = []  # in rotation order starting at the pointer
        for k in range(n):
            r = self._replicas[self._order[(self._rr + k) % n]]
            if r.healthy and not r.draining and r.hosts(model):
                eligible.append(r)
        if not eligible:
            return None
        self._rr = (self._rr + 1) % n
        if self._rejected_version is not None:
            safe = [r for r in eligible
                    if r.weight_version != self._rejected_version]
            if safe:
                # availability first: with NOWHERE else to go, the
                # rejected version still serves rather than refusing
                eligible = safe
        if self._canary_version is not None:
            can = [r for r in eligible
                   if r.weight_version == self._canary_version]
            rest = [r for r in eligible
                    if r.weight_version is not None
                    and r.weight_version != self._canary_version]
            if can and rest:
                self._canary_acc += self._canary_fraction
                if self._canary_acc >= 1.0:
                    self._canary_acc -= 1.0
                    eligible = can
                    self.counters.incr("weight_canary_routes")
                else:
                    eligible = rest
            elif can or rest:
                # only one side exists (the whole fleet converged, or
                # nothing has): no split to pace — but unknown-version
                # replicas stay excluded until they catch up
                if can:
                    self.counters.incr("weight_canary_routes")
                eligible = can or rest
            # neither side known: fall through ungated (a pre-bus
            # fleet must keep serving under an accidental canary)
        cand = eligible[0]
        chosen = min(eligible, key=lambda r: r.load_score())
        if chosen is not cand:
            self.counters.incr("gateway_rebalances")
        return chosen

    def _forward(self, rep, ident, msg, cmd, model, gw_ep,
                 scenario=None):
        """Record the route and relay the request (BTMID verbatim).
        The send is NON-blocking: a replica whose pipe is full (stalled
        process, dead peer past the HWM) must cost its own clients an
        actionable error, never freeze the whole gateway loop."""
        import zmq

        mid = msg.get(wire.BTMID_KEY)
        span_ctx = msg.get(wire.SPAN_KEY)
        trace = (span_ctx or {}).get("trace") \
            if isinstance(span_ctx, dict) else None
        prior = self._routes.get(mid) if mid is not None else None
        if mid is not None:
            self._routes[mid] = _Route(ident, rep.id, rep.incarnation,
                                       cmd, model, gw_ep, trace,
                                       now_us(), scenario)
            while len(self._routes) > ROUTE_CACHE_DEPTH:
                self._routes.popitem(last=False)
        t0 = time.perf_counter()
        if rep.shm is not None:
            # the upgraded wire first; a full ring falls through to the
            # DEALER socket (same replica, same mid — the wires differ,
            # the discipline does not), a dead ring demotes
            try:
                frames = wire.encode(msg, raw_buffers=True)
                if rep.shm.send(frames, timeout_ms=0):
                    self.timer.add("gw_forward",
                                   time.perf_counter() - t0)
                    self.counters.incr("gateway_routed")
                    return
            except ValueError:
                pass  # oversized for the ring: this one rides ZMQ
            except (OSError, EOFError) as exc:
                self._demote_backend(
                    rep, f"{type(exc).__name__}: {exc}"
                )
        try:
            wire.send_message_dealer(rep.sock, msg, raw_buffers=True,
                                     flags=zmq.DONTWAIT)
        except zmq.Again:
            # pipe to the replica is full: it is stalled or gone.  If
            # this was a RE-forward of an in-flight retry, the original
            # send was already delivered and still owes a reply —
            # restore that route and stay silent (an error here would
            # be cached against a request the replica may yet apply).
            # A FIRST forward is answered now, actionably (retriable),
            # instead of parking in a queue that may never drain.
            if prior is not None:
                self._routes[mid] = prior
                prior.ident = ident
                return
            if mid is not None:
                self._routes.pop(mid, None)
            self._local_reply(ident, msg, {"error": (
                f"replica {rep.id} send queue full (stalled or "
                "unreachable): retry, or reset() after its respawn"
            )}, span_name=f"gateway:{cmd}", cache=False)
            return
        except zmq.ZMQError:
            if mid is not None:
                if prior is not None:
                    self._routes[mid] = prior
                    prior.ident = ident
                else:
                    self._routes.pop(mid, None)
            return
        self.timer.add("gw_forward", time.perf_counter() - t0)
        self.counters.incr("gateway_routed")

    def _local_reply(self, ident, msg, reply, *, span_name, cache=True):
        """Answer a request from the gateway itself (control commands,
        stale-lease errors, cache hits): stamp mid + span, cache
        mutating replies so retries stay local, send.

        ``cache=False`` for TRANSIENT transport/routing errors ("no
        healthy replica", "send queue full"): those are not processing
        outcomes, and caching them would answer a same-mid retry with
        the stale error after the fleet has already healed — the
        advertised remediation would be unreachable for that RPC."""
        mid = msg.get(wire.BTMID_KEY)
        if "error" in reply:
            self.counters.incr("gateway_errors")
        if self.worker_tag is not None and "gw_worker" not in reply:
            # every worker-answered reply names its worker, so a wedged
            # worker is diagnosable from a client traceback alone
            reply["gw_worker"] = self.worker_tag
        span_ctx = msg.get(wire.SPAN_KEY)
        if isinstance(span_ctx, dict) and span_ctx.get("trace") is not None:
            reply = dict(reply)
            reply[wire.SPANS_KEY] = [make_span(
                span_name, now_us(), trace=span_ctx["trace"],
                cat="gateway",
            )]
        if mid is not None:
            reply[wire.BTMID_KEY] = mid
            if cache and msg.get("cmd") in MUTATING_CMDS:
                self._cache_reply(mid, reply)
        self._send_client(ident, reply)

    def _cache_reply(self, mid, reply):
        self._reply_cache[mid] = reply
        while len(self._reply_cache) > REPLY_CACHE_DEPTH:
            self._reply_cache.popitem(last=False)

    def _send_client(self, ident, reply):
        import zmq

        if ident is not None and getattr(ident, "shm_channel", False):
            # the request arrived on the shm front: the reply rides the
            # same channel (a dead one is dropped; the client demotes
            # and its same-mid retry re-fetches from the reply cache)
            if self._shm_front is not None and self._shm_front.send(
                ident, reply
            ):
                self.counters.incr("gateway_replies")
            return
        try:
            wire.send_message_router(self._front, ident, reply,
                                     raw_buffers=True)
            self.counters.incr("gateway_replies")
        except zmq.ZMQError:
            pass  # client gone; its retry will re-dial

    def _handle_client(self, ident, msg):
        t_route = time.perf_counter()
        self.counters.incr("gateway_requests")
        mid = msg.get(wire.BTMID_KEY)
        cmd = msg.get("cmd")
        if mid is not None and cmd in MUTATING_CMDS \
                and mid in self._reply_cache:
            # retry of a request whose reply the client lost: answered
            # from the gateway cache — the fleet never sees it again
            self.counters.incr("gateway_cache_hits")
            self._send_client(ident, self._reply_cache[mid])
            return
        if mid is not None and mid in self._routes:
            # retry of an IN-FLIGHT forward: re-point the client route
            # and re-send to the SAME replica, whose own dedupe/reply
            # cache keeps the retry exactly-once end-to-end.  A retried
            # step/close carries the GATEWAY lease id again, so it is
            # rewritten through the lease exactly like a first send.
            route = self._routes[mid]
            route.ident = ident
            rep = self._replicas.get(route.rid)
            lease = (self._leases.get(route.gw_ep)
                     if route.gw_ep is not None else None)
            rewritable = route.cmd == "reset" or (
                lease is not None and not lease.dead
            )
            if rep is not None and rep.healthy and rewritable:
                if lease is not None:
                    msg["slot"] = lease.slot
                    msg["episode"] = lease.episode
                self.counters.incr("gateway_dup_inflight")
                self._forward(rep, ident, msg, route.cmd, route.model,
                              route.gw_ep, scenario=route.scenario)
                return
            # the replica died holding the request (or the lease did):
            # drop the route and fall through to fresh handling (a
            # reset re-routes; a step's dead lease errors actionably)
            del self._routes[mid]
        if cmd in GATEWAY_CMDS:
            handler = getattr(self, f"_cmd_{cmd}")
            try:
                reply = handler(msg)
            except Exception as exc:  # noqa: BLE001 - surfaced to client
                logger.exception("gateway: %r failed", cmd)
                reply = {"error": f"{type(exc).__name__}: {exc}"}
            if cmd == "hello" and mid is not None \
                    and "obs_dim" not in reply:
                # startup window: no scrape has delivered capability
                # fields yet — forward THIS hello to a healthy replica
                # (the reply path stashes its caps and overlays the
                # gateway fields), so hello consumers never see a
                # capability-less reply while the fleet is up
                rep = next((r for r in self._replicas.values()
                            if r.healthy), None)
                if rep is not None:
                    self.timer.add("gw_route",
                                   time.perf_counter() - t_route)
                    self._forward(rep, ident, msg, "hello", None, None)
                    return
            self.timer.add("gw_route", time.perf_counter() - t_route)
            self._local_reply(ident, msg, reply,
                              span_name=f"gateway:{cmd}")
            return
        if mid is None:
            # forwarded replies route back to clients BY correlation id
            # (the replica's reply carries no client identity): a
            # mid-less request would execute on the replica with its
            # reply unroutable — reject it here, actionably, instead
            self.timer.add("gw_route", time.perf_counter() - t_route)
            self._local_reply(ident, msg, {"error": (
                f"{cmd!r} through a gateway needs a correlation id "
                "(wire.stamp_message_id); its reply could not be "
                "routed back otherwise"
            )}, span_name=f"gateway:{cmd}")
            return
        if cmd == "reset":
            model = msg.get("model")
            # the traffic label rides the admission request and is
            # inherited by the episode's lease (docs/scenarios.md);
            # replicas ignore the extra key
            scenario = msg.get("scenario")
            rep = self._route_fresh(model)
            self.timer.add("gw_route", time.perf_counter() - t_route)
            if rep is None:
                self._local_reply(ident, msg, {"error": (
                    "no healthy replica"
                    + (f" hosting model {model!r}" if model else "")
                    + f" (fleet: {self._order}); retry after respawn"
                )}, span_name="gateway:reset", cache=False)
                return
            rep.pending_live += 1
            self._forward(rep, ident, msg, "reset", model, None,
                          scenario=scenario)
            return
        if cmd in ("step", "close"):
            gw_ep = msg.get("episode")
            lease = self._leases.get(gw_ep)
            if lease is None or lease.dead:
                self.timer.add("gw_route",
                               time.perf_counter() - t_route)
                if lease is not None:
                    self._drop_lease(gw_ep)
                self.counters.incr("gateway_stale_lease_redirects")
                if cmd == "close":
                    # mirror the server's stale-close semantics: a
                    # no-op close is answered, never an error
                    self._local_reply(ident, msg, {"closed": False},
                                      span_name="gateway:close")
                    return
                dead_on = (f" (replica {lease.rid} died)"
                           if lease is not None else "")
                self._local_reply(ident, msg, {
                    "error": (
                        f"stale episode lease {gw_ep!r}{dead_on}: "
                        "reset() and resume on a healthy replica"
                    ),
                    "lease": "stale" if lease is not None else "unknown",
                }, span_name=f"gateway:{cmd}")
                return
            rep = self._replicas[lease.rid]
            # rewrite to the replica's REAL lease; everything else —
            # mid, span context, obs buffers — rides verbatim
            msg["slot"] = lease.slot
            msg["episode"] = lease.episode
            lease.t_use = time.monotonic()
            self.counters.incr("gateway_affinity_hits")
            self.timer.add("gw_route", time.perf_counter() - t_route)
            self._forward(rep, ident, msg, cmd, lease.model, gw_ep,
                          scenario=lease.scenario)
            return
        self.timer.add("gw_route", time.perf_counter() - t_route)
        self._local_reply(ident, msg, {
            "error": f"unknown serve command {cmd!r}"
        }, span_name="gateway:unknown")

    # -- reply path ----------------------------------------------------------

    def _handle_replica_reply(self, rep, reply):
        t0 = time.perf_counter()
        # ANY reply on this socket proves the process is alive: a
        # replica busy in a long compile must not get quarantined for
        # missing a scrape while it is actively answering traffic
        # (re-admission itself stays scrape-driven)
        rep.last_ok = time.monotonic()
        mid = reply.get(wire.BTMID_KEY)
        if mid is not None and mid in self._shm_connects:
            phase, rid, chan = self._shm_connects.pop(mid)
            self._handle_backend_upgrade(self._replicas[rid], phase,
                                         chan, reply)
            return
        if mid is not None and mid in self._scrapes:
            rid = self._scrapes.pop(mid)
            self._ingest_scrape(self._replicas[rid], reply)
            return
        route = self._routes.get(mid) if mid is not None else None
        if route is None:
            # a dup (cache hit + original), or a client that gave up
            self.counters.incr("stale_replies")
            return
        if route.rid != rep.id:
            # late reply from a replica this request was re-routed
            # AWAY from (quarantine mid-retry): the live route belongs
            # to the new replica — leave it for the genuine reply
            self.counters.incr("stale_replies")
            return
        del self._routes[mid]
        reply["replica"] = rep.id
        if self.worker_tag is not None:
            reply["gw_worker"] = self.worker_tag
        wv = reply.get("weight_version")
        if wv is not None:
            # per-version rollout metrics: every stamped reply lands in
            # its version's request/error/latency record — what the
            # canary controller's promote/rollback verdicts read
            self._note_version_reply(wv, "error" in reply,
                                     time.perf_counter() - route.t0)
        if route.scenario is not None:
            # per-scenario traffic metrics next to the per-version
            # ones: a labelled mix's QPS/p99 is attributable per
            # scenario from the gateway alone (docs/scenarios.md)
            self._note_scenario_reply(route.scenario, "error" in reply,
                                      time.perf_counter() - route.t0)
        if "error" in reply:
            # name the replica in the traceback the client will raise
            reply["error"] = f"replica {rep.id}: {reply['error']}"
            if reply.get("lease") in ("unknown", "stale") \
                    and route.gw_ep is not None:
                # the replica disowned the lease (evicted/restarted):
                # forget it so the next step short-circuits here.  This
                # is the SAME client-visible event as the gateway's own
                # dead-lease redirect (which side answers first is a
                # race between watchdog respawn and client retry), so
                # it counts under the same name
                self._drop_lease(route.gw_ep)
                self.counters.incr("gateway_stale_lease_redirects")
        elif route.cmd == "reset":
            if not rep.healthy or route.inc != rep.incarnation:
                # a reset reply drained AFTER the replica was
                # quarantined — or from an incarnation older than the
                # current one (a silent restart was detected between
                # forward and reply): registering a live lease here
                # would point the client's steps at a dead slot — and
                # poison _lease_rev for the new incarnation's recycled
                # episode ids.  Drop it; the client's retry re-routes
                # the reset to a healthy replica.
                self.counters.incr("stale_replies")
                return
            real_ep = reply.get("episode")
            key = (rep.id, rep.incarnation, real_ep)
            gw_ep = self._lease_rev.get(key)
            if gw_ep is None:
                # worker mode strides by the worker count, keeping
                # every lease id ≡ worker_index (mod n_workers) — the
                # consistent-hash ownership rule the sharded front and
                # every client can evaluate statelessly
                self._ep_seq += (1 if self.worker_index is None
                                 else self.n_workers)
                gw_ep = self._ep_seq
                self._leases[gw_ep] = _Lease(
                    rep.id, reply.get("slot"), real_ep, route.model,
                    rep.incarnation, scenario=route.scenario,
                )
                self._lease_rev[key] = gw_ep
            reply["episode"] = gw_ep
        elif route.cmd == "close":
            self._drop_lease(route.gw_ep)
        elif route.cmd == "hello":
            # a forwarded startup hello: stash the replica's capability
            # fields for every later gateway-local hello, and overlay
            # the gateway's own fields on THIS reply
            rep.caps = {
                k: reply[k]
                for k in ("model", "obs_dim", "slots", "serial", "int8",
                          "max_batch", "buckets")
                if k in reply
            }
            reply.update(self._cmd_hello({}))
        if route.span_trace is not None:
            spans = reply.setdefault(wire.SPANS_KEY, [])
            spans.append(make_span(
                f"gateway:{route.cmd}", route.t0_us,
                trace=route.span_trace, cat="gateway",
            ))
        if mid is not None and route.cmd in MUTATING_CMDS:
            self._cache_reply(mid, reply)
        self._send_client(route.ident, reply)
        self.timer.add("gw_reply", time.perf_counter() - t0)

    # -- serving -------------------------------------------------------------

    def _drain_front(self):
        import zmq

        def handle(out):
            ident, msg = out
            reply = shm_rpc.control_reply(self._shm_front, msg)
            if reply is not None:
                # transport negotiation with THIS gateway — answered
                # here (uncounted), never forwarded to the fleet
                try:
                    wire.send_message_router(self._front, ident, reply)
                except zmq.ZMQError:
                    pass
                return
            self._handle_client(ident, msg)

        drain_socket(
            lambda: wire.recv_message_router_sized(
                self._front, flags=zmq.NOBLOCK)[:2],
            handle,
            self.counters, "gateway", "client request",
        )

    def _drain_front_shm(self):
        if self._shm_front is None:
            return

        def handle(chan, msg):
            reply = shm_rpc.control_reply(self._shm_front, msg)
            if reply is not None:
                self._shm_front.send(chan, reply)
                return
            self._handle_client(chan, msg)

        self._shm_front.pump(handle)

    def _drain_replica_shm(self, rep):
        while rep.shm is not None:
            try:
                reply = rep.shm.try_recv()
            except (OSError, EOFError) as exc:
                self._demote_backend(rep, f"{type(exc).__name__}: {exc}")
                return
            if reply is None:
                return
            self._handle_replica_reply(rep, reply)

    def _drain_replica(self, rep):
        import zmq

        drain_socket(
            lambda: wire.recv_message_dealer(rep.sock,
                                             flags=zmq.NOBLOCK),
            lambda reply: self._handle_replica_reply(rep, reply),
            self.counters, "gateway", "replica reply",
        )

    def serve_forever(self, stop_event=None, poll_ms=50):
        import zmq

        poller = zmq.Poller()
        poller.register(self._front, zmq.POLLIN)
        if self._shm_front is not None and self._shm_front.fd is not None:
            # ONE fd wakes the loop for the whole shm side: front
            # channels ding it directly, and the backend channels were
            # attached with it as their reply bell
            poller.register(self._shm_front.fd, zmq.POLLIN)
        for rep in self._replicas.values():
            poller.register(rep.sock, zmq.POLLIN)
        # stored so live resize (_admit_replica/_retire_replica, loop
        # thread only) can register/unregister replica sockets
        self._poller = poller
        while stop_event is None or not stop_event.is_set():
            self._apply_notices()
            self._scrape_tick()
            try:
                events = dict(poller.poll(poll_ms))
                if self._front in events:
                    self._drain_front()
                self._drain_front_shm()
                for rep in list(self._replicas.values()):
                    if rep.sock in events:
                        self._drain_replica(rep)
                    self._drain_replica_shm(rep)
            except zmq.ZMQError:
                return  # a socket closed under us: clean shutdown

    def close(self):
        try:
            self._front.close(0)
        except Exception:  # noqa: BLE001 - shutdown best-effort
            pass
        for rep in self._replicas.values():
            self._demote_backend(rep, "gateway shutdown")
            try:
                rep.sock.close(0)
            except Exception:  # noqa: BLE001
                pass
        if self._shm_front is not None:
            try:
                self._shm_front.close(unlink=True)
            except Exception:  # noqa: BLE001
                pass
            self._shm_front = None


class _LocalGatewayHandle:
    """An in-process gateway (thread) for tests and benchmarks."""

    def __init__(self, gateway, thread, stop):
        self.gateway = gateway
        self.address = gateway.address
        self._thread = thread
        self._stop = stop

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.gateway.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_gateway_thread(replicas, *, address="tcp://127.0.0.1:*",
                         counters=None, timer=None, **kwargs):
    """Serve a :class:`ServeGateway` from a daemon thread; returns a
    handle with ``.address``, ``.gateway`` and ``.close()``."""
    gateway = ServeGateway(address, replicas, counters=counters,
                           timer=timer, **kwargs)
    stop = threading.Event()
    thread = threading.Thread(
        target=gateway.serve_forever, kwargs={"stop_event": stop},
        daemon=True, name="bjx-serve-gateway",
    )
    thread.start()
    return _LocalGatewayHandle(gateway, thread, stop)


# ---------------------------------------------------------------------------
# Sharded data plane: N worker processes behind one front address
# ---------------------------------------------------------------------------


#: How many recent control-snapshot mids the front remembers: worker
#: acks for those mids are swallowed instead of treated as client
#: replies.  A handful of versions can be in flight across N workers;
#: 64 is headroom.
SNAPSHOT_MID_DEPTH = 64


class _FrontRoute:
    """One relayed, in-flight request at the sharded front: which
    client to answer and which worker owes the reply."""

    __slots__ = ("ident", "widx", "cmd")

    def __init__(self, ident, widx, cmd):
        self.ident = ident
        self.widx = widx
        self.cmd = cmd


class _Worker:
    """The front's view of one gateway worker process."""

    __slots__ = ("idx", "tag", "address", "sock", "alive", "last_ok",
                 "scrape_mid", "scrape_sent", "next_scrape", "counters")

    def __init__(self, idx, address, sock, now):
        self.idx = idx
        self.tag = f"gw{idx}"
        self.address = address
        self.sock = sock
        self.alive = True
        self.last_ok = now
        self.scrape_mid = None
        self.scrape_sent = 0.0
        self.next_scrape = 0.0
        self.counters = {}


class _GatewayLaunchInfo:
    """The :class:`~blendjax_torch.btt.watchdog.FleetWatchdog` launcher
    contract (``.processes`` + owner's ``respawn``) for the worker
    fleet."""

    def __init__(self, processes, addresses):
        self.processes = processes
        self.addresses = {"GATEWAY_WORKER": addresses}


class ShardedGateway:
    """One client-facing front address over N ``GatewayWorker``
    processes plus the control plane, in one supervising process.

    The split (docs/serving.md, "The sharded gateway"):

    - **data plane**: N worker processes (``python -m
      blendjax_torch.serve.gateway_worker``), each a full :class:`ServeGateway`
      in worker mode with its own client-facing address, its own shm
      front, its own leases and reply cache.  Lease ownership is
      partitioned by the lease id itself — worker k allocates ids
      ≡ k (mod N), so ``owner(ep) = ep % N`` is computable statelessly
      by the front, a client, or a debugger;
    - **front** (this class): binds the ONE address clients dial first.
      It relays a client's first traffic to the owning worker, and every
      successful ``reset`` reply gains a ``gw_workers`` map so the
      client re-dials its owning worker DIRECTLY — steady-state request
      bytes never cross the front again.  Fresh traffic (``reset``,
      unroutable mids) is assigned by ``crc32(mid) % active_workers``
      with a linear probe past dead workers, so a same-mid retry lands
      on the worker whose dedupe/reply cache keeps it exactly-once;
    - **control plane**: an inner :class:`ServeGateway` pointed at the
      replica fleet, pumped from the front's loop.  It alone scrapes
      telemetry, quarantines/re-admits replicas, owns drain flags and
      canary/promote/rollback verdicts and the load-score table.  That
      state reaches workers as a versioned ``gw_snapshot`` publication
      (the WeightBus publish pattern pointed at routing state): workers
      only ever READ a consistent snapshot and never RPC the control
      plane on the request path.

    Workers are supervised by a
    :class:`~blendjax_torch.btt.watchdog.FleetWatchdog` (``restart=True``).
    A SIGKILLed worker takes its leases with it: the front answers
    steps against its partition with the actionable stale-lease error
    (``gateway_lease_rehash``) until the respawn's first answered
    scrape re-admits it (``gateway_worker_respawns``), and clients
    resume after ``reset()`` exactly as for a replica death.  Each
    worker's ``/dev/shm`` segments live under a parent-pinned base
    prefix that is glob-swept before its respawn and at close
    as the policy server's are.
    """

    def __init__(self, address, replicas, *, workers=2,
                 scrape_interval_s=0.25, counters=None, timer=None):
        import zmq

        from blendjax_torch.replay.shard_client import free_port

        if int(workers) < 1:
            raise ValueError("a sharded gateway needs >= 1 worker")
        self.n_workers = int(workers)
        #: fresh-traffic hash window (bench arms shrink it; lease-owned
        #: traffic still reaches workers outside the window)
        self.active_workers = self.n_workers
        self.scrape_interval_s = float(scrape_interval_s)
        self.quarantine_after_s = quarantine_after(self.scrape_interval_s)
        self.counters = counters if counters is not None else fleet_counters
        self.timer = timer if timer is not None else StageTimer()
        self._ctx = zmq.Context.instance()
        self._front = self._ctx.socket(zmq.ROUTER)
        self._front.setsockopt(zmq.LINGER, 0)
        if address.endswith(":*") or address.endswith(":0"):
            base = address.rsplit(":", 1)[0]
            port = self._front.bind_to_random_port(base)
            self.address = f"{base}:{port}"
        else:
            self._front.bind(address)
            self.address = address
        #: the control plane: a standalone ServeGateway over the replica
        #: fleet, pumped from THIS loop.  Its client front is an unused
        #: ephemeral port; what we want is its scrape/quarantine/canary
        #: machinery and its replica table — the gw_snapshot source.
        self._ctl = ServeGateway(
            "tcp://127.0.0.1:*", replicas,
            scrape_interval_s=self.scrape_interval_s,
            lease_ttl_s=None, counters=self.counters, timer=self.timer,
            enable_shm=False,
        )
        now = time.monotonic()
        self._workers = []
        self._wcmds = []
        #: parent-pinned shm base prefix per worker: respawns reuse the
        #: name, and the parent glob-sweeps it before each respawn and
        #: at close, so a SIGKILLed worker cannot leak /dev/shm
        self._wbases = []
        for k in range(self.n_workers):
            waddr = f"tcp://127.0.0.1:{free_port()}"
            base = (shm_rpc.new_base(f"gww{k}")
                    if shm_rpc.enabled() else None)
            cmd = [sys.executable, "-m", "blendjax_torch.serve.gateway_worker",
                   "--address", waddr,
                   "--worker-index", str(k),
                   "--workers", str(self.n_workers),
                   "--scrape-interval", str(self.scrape_interval_s)]
            for addr in replicas:
                cmd += ["--replica", addr]
            if base is not None:
                cmd += ["--shm-base", base]
            sock = self._ctx.socket(zmq.DEALER)
            sock.setsockopt(zmq.LINGER, 0)
            sock.connect(waddr)
            self._workers.append(_Worker(k, waddr, sock, now))
            self._wcmds.append(cmd)
            self._wbases.append(base)
        self._routes = OrderedDict()   # mid -> _FrontRoute
        self._wscrapes = {}            # mid -> worker idx
        self._snap_mids = deque(maxlen=SNAPSHOT_MID_DEPTH)
        self._snap_version = -1
        self._next_publish = 0.0
        self._notices = deque()
        self.launch_info = None

    # -- worker process management -------------------------------------------

    def _spawn(self, idx):
        from blendjax_torch.btt.launcher import child_env

        return subprocess.Popen(self._wcmds[idx], env=child_env(),
                                start_new_session=True)

    def start(self):
        procs = []
        try:
            for k in range(self.n_workers):
                procs.append(self._spawn(k))
            self.launch_info = _GatewayLaunchInfo(
                procs, [w.address for w in self._workers])
            self._wait_ready()
        except BaseException:
            if self.launch_info is None:
                self.launch_info = _GatewayLaunchInfo(procs, [])
            self.close()
            raise
        return self

    def _wait_ready(self):
        from blendjax_torch.serve.client import ServeClient

        deadline = time.monotonic() + WORKER_READY_TIMEOUT_S
        for w in self._workers:
            while True:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"gateway worker {w.tag} at {w.address} not "
                        f"ready within {WORKER_READY_TIMEOUT_S:.1f}s"
                    )
                probe = ServeClient(w.address, timeoutms=500, shm=False,
                                    follow_redirects=False)
                try:
                    probe.hello()
                    break
                except TimeoutError:
                    continue
                finally:
                    probe.close()

    def respawn(self, idx):
        """FleetWatchdog's restart hook: sweep the dead worker's shm
        base first, then relaunch the SAME command —
        address, index and base prefix are parent-pinned, so the
        respawn rejoins under its old identity."""
        if self._wbases[idx] is not None:
            shm_rpc.unlink_base(self._wbases[idx])
        proc = self._spawn(idx)
        self.launch_info.processes[idx] = proc
        return proc

    # -- admin (thread-safe flag sets on the control plane; workers
    # -- learn of them from the next published snapshot) ---------------------

    def drain(self, rid):
        return self._ctl.drain(rid)

    def undrain(self, rid):
        return self._ctl.undrain(rid)

    def canary(self, version, fraction=0.25):
        return self._ctl.canary(version, fraction)

    def promote(self):
        return self._ctl.promote()

    def rollback(self):
        return self._ctl.rollback()

    # -- watchdog notices (thread-safe; applied on the loop) -----------------

    def notify_worker_death(self, idx, exit_code=None):
        self._notices.append(("death", int(idx)))

    def notify_worker_respawn(self, idx, proc=None):
        self._notices.append(("respawn", int(idx)))

    def notify_replica_death(self, idx_or_rid, exit_code=None):
        self._ctl.notify_replica_death(idx_or_rid, exit_code)

    def notify_replica_respawn(self, idx_or_rid, proc=None):
        self._ctl.notify_replica_respawn(idx_or_rid, proc)

    def _apply_notices(self):
        while self._notices:
            kind, idx = self._notices.popleft()
            w = self._workers[idx]
            if kind == "death":
                self._mark_worker_dead(w)
            else:
                # probe the respawn immediately: its first answered
                # scrape re-admits it
                w.next_scrape = 0.0

    def _mark_worker_dead(self, w):
        if not w.alive:
            return
        w.alive = False
        if w.scrape_mid is not None:
            self._wscrapes.pop(w.scrape_mid, None)
            w.scrape_mid = None
        self.counters.incr("gateway_worker_deaths")
        logger.warning(
            "gateway front: worker %s at %s is gone — its lease "
            "partition (ep %% %d == %d) is stale until respawn",
            w.tag, w.address, self.n_workers, w.idx,
        )

    def set_active_workers(self, n):
        """Restrict FRESH-traffic hash assignment (and the
        ``gw_workers`` redirect map) to the first ``n`` workers.  A
        bench knob: the 1-worker and N-worker arms run over the same
        fleet and the same worker processes.  Lease-owned traffic
        still reaches its owning worker.

        ``n == 1`` collapses the data plane to the UNSHARDED shape:
        the front withholds the direct-dial map, so every message —
        fresh and lease-owned alike — rides this one front address
        through one event loop, exactly what a monolithic gateway
        deployment looks like to clients.  That is the baseline arm
        of ``gateway_shard_x``; ``n > 1`` restores partitioned
        direct dial."""
        self.active_workers = max(1, min(int(n), self.n_workers))
        return self.active_workers

    # -- worker health + control snapshots -----------------------------------

    def _worker_tick(self):
        import zmq

        now = time.monotonic()
        for w in self._workers:
            if (w.scrape_mid is not None
                    and now - w.scrape_sent > 2 * self.scrape_interval_s):
                self._wscrapes.pop(w.scrape_mid, None)
                w.scrape_mid = None
            if w.scrape_mid is None and now >= w.next_scrape:
                msg = {"cmd": "telemetry"}
                mid = wire.stamp_message_id(msg)
                try:
                    wire.send_message_dealer(w.sock, msg,
                                             flags=zmq.DONTWAIT)
                except zmq.ZMQError:
                    continue
                w.scrape_mid = mid
                w.scrape_sent = now
                w.next_scrape = now + self.scrape_interval_s
                self._wscrapes[mid] = w.idx
            if w.alive and now - w.last_ok > self.quarantine_after_s:
                self._mark_worker_dead(w)

    def _ingest_worker_scrape(self, w, reply):
        w.scrape_mid = None
        if not w.alive:
            w.alive = True
            self.counters.incr("gateway_worker_respawns")
            logger.warning(
                "gateway front: worker %s answered again — re-admitted",
                w.tag,
            )
            # a fresh worker starts with an empty routing view: publish
            # the current control state before client traffic reaches it
            self._publish_snapshot(force=True)
        counters = reply.get("counters")
        if isinstance(counters, dict):
            w.counters = counters

    def _publish_snapshot(self, force=False):
        """Version and fan the control plane's routing state out to the
        workers (replica health/drain/load + canary verdicts).  Workers
        apply it atomically under their GIL; stale versions are
        ignored, so a re-ordered publish can never roll a worker's view
        backwards."""
        import zmq

        now = time.monotonic()
        if not force and now < self._next_publish:
            return
        self._next_publish = now + self.scrape_interval_s
        ctl = self._ctl
        self._snap_version += 1
        msg = {
            "cmd": "gw_snapshot",
            "version": self._snap_version,
            "replicas": {
                rep.id: {
                    "healthy": rep.healthy,
                    "draining": rep.draining,
                    "models": sorted(rep.models or ()),
                    "queued": rep.queued,
                    "live": rep.live,
                    "p99_ms": rep.p99_ms,
                    "pid": rep.pid,
                    "incarnation": rep.incarnation,
                    "weight_version": rep.weight_version,
                    "caps": rep.caps,
                }
                for rep in ctl._replicas.values()
            },
            "weights": {
                "canary_version": ctl._canary_version,
                "canary_fraction": ctl._canary_fraction,
                "stable_version": ctl._stable_version,
                "rejected_version": ctl._rejected_version,
            },
        }
        mid = wire.stamp_message_id(msg)
        self._snap_mids.append(mid)
        sent = 0
        for w in self._workers:
            if not w.alive:
                continue
            try:
                wire.send_message_dealer(w.sock, msg, flags=zmq.DONTWAIT)
                sent += 1
            except zmq.ZMQError:
                continue
        if sent:
            self.counters.incr("gateway_snapshot_publishes")

    # -- front request handling ----------------------------------------------

    def _worker_map(self):
        """tag -> direct-dial address for the live workers in the
        active window — what a successful ``reset`` reply carries so
        the client's steady-state traffic skips this front."""
        return {w.tag: w.address
                for w in self._workers[:self.active_workers] if w.alive}

    def _sharded_fields(self):
        return {
            "gateway": True,
            "sharded": True,
            "workers": self.n_workers,
            "active_workers": self.active_workers,
            "workers_alive": sum(1 for w in self._workers if w.alive),
            "gw_workers": self._worker_map(),
            "gw_n_workers": self.n_workers,
            "pid": os.getpid(),
        }

    def gateway_counters(self):
        """``gateway_*`` counters merged across the front process and
        every worker's latest scrape — the fleet-wide view ``stats``
        and ``telemetry`` answer with."""
        out = dict(self.counters.snapshot())
        for w in self._workers:
            for key, val in (w.counters or {}).items():
                if key.startswith("gateway_") or key == "stale_replies":
                    out[key] = out.get(key, 0) + val
        return out

    def _pick_worker_for_mid(self, mid):
        """Deterministic fresh-traffic assignment: crc32 of the
        correlation id over the active window (NOT ``hash()`` — that is
        salted per process), linear-probed past dead workers so a
        same-mid retry lands on the same worker whenever that worker is
        up (its dedupe/reply cache keeps the retry exactly-once)."""
        n = max(1, min(self.active_workers, len(self._workers)))
        start = zlib.crc32(str(mid).encode()) % n
        for k in range(n):
            w = self._workers[(start + k) % n]
            if w.alive:
                return w
        return None

    def _front_reply(self, ident, msg, reply, *, span_name):
        """Answer a request from the front itself.  No reply cache:
        every front-local answer is a pure function of (request,
        current worker liveness), so a same-mid retry recomputes the
        same answer."""
        import zmq

        mid = msg.get(wire.BTMID_KEY)
        if "error" in reply:
            self.counters.incr("gateway_errors")
        span_ctx = msg.get(wire.SPAN_KEY)
        if isinstance(span_ctx, dict) and span_ctx.get("trace") is not None:
            reply = dict(reply)
            reply[wire.SPANS_KEY] = [make_span(
                span_name, now_us(), trace=span_ctx["trace"],
                cat="gateway",
            )]
        if mid is not None:
            reply[wire.BTMID_KEY] = mid
        try:
            wire.send_message_router(self._front, ident, reply,
                                     raw_buffers=True)
            self.counters.incr("gateway_replies")
        except zmq.ZMQError:
            pass  # client gone; its retry will re-dial

    def _resolve(self, msg):
        """``gw_resolve``: map an episode lease to its owning worker.
        The recovery path for a client that direct-dialed a worker that
        died — it asks the front where to go next."""
        ep = msg.get("episode")
        try:
            widx = int(ep) % self.n_workers
        except (TypeError, ValueError):
            return {"error": (
                f"gw_resolve needs an integer episode lease, got {ep!r}"
            ), "gw_workers": self._worker_map()}
        w = self._workers[widx]
        return {"gw_worker": w.tag, "address": w.address,
                "alive": w.alive, "gw_workers": self._worker_map()}

    def _handle_front_client(self, ident, msg):
        import zmq

        mid = msg.get(wire.BTMID_KEY)
        cmd = msg.get("cmd")
        # the front is pure ZMQ: shm negotiation gets the standard
        # refusal (clients mark the channel off and, after redirecting
        # to their worker's address, re-arm and negotiate THERE)
        reply = shm_rpc.control_reply(None, msg)
        if reply is not None:
            try:
                wire.send_message_router(self._front, ident, reply)
            except zmq.ZMQError:
                pass
            return
        if cmd == "gw_resolve":
            self.counters.incr("gateway_requests")
            self._front_reply(ident, msg, self._resolve(msg),
                              span_name="gateway:gw_resolve")
            return
        if cmd == "hello":
            self.counters.incr("gateway_requests")
            out = self._ctl._cmd_hello(msg)
            if "obs_dim" not in out and mid is not None:
                # the control plane has not scraped capabilities yet
                # (startup): relay through a worker, which forwards to
                # a replica; the reply path overlays the sharded fields
                w = self._pick_worker_for_mid(mid)
                if w is not None:
                    self._relay_to(w, ident, msg, cmd)
                    return
            out.update(self._sharded_fields())
            self._front_reply(ident, msg, out, span_name="gateway:hello")
            return
        if cmd in ("drain", "undrain", "canary", "promote", "rollback"):
            self.counters.incr("gateway_requests")
            handler = getattr(self._ctl, f"_cmd_{cmd}")
            try:
                out = handler(msg)
            except Exception as exc:  # noqa: BLE001 - report, don't die
                logger.exception("gateway front: %s failed", cmd)
                out = {"error": f"{type(exc).__name__}: {exc}"}
            # admin verdicts must not wait a scrape interval to reach
            # the data plane
            self._publish_snapshot(force=True)
            self._front_reply(ident, msg, out,
                              span_name=f"gateway:{cmd}")
            return
        if cmd == "stats":
            self.counters.incr("gateway_requests")
            self._front_reply(ident, msg, self._cmd_stats(msg),
                              span_name="gateway:stats")
            return
        if cmd == "telemetry":
            self.counters.incr("gateway_requests")
            self._front_reply(ident, msg, self._cmd_telemetry(msg),
                              span_name="gateway:telemetry")
            return
        self._relay(ident, msg, cmd, mid)

    def _cmd_stats(self, msg):
        out = self._ctl._cmd_stats(msg)
        out.update(self._sharded_fields())
        out["counters"] = self.gateway_counters()
        return out

    def _cmd_telemetry(self, msg):
        out = self._ctl._cmd_telemetry(msg)
        out.update(self._sharded_fields())
        out["counters"] = self.gateway_counters()
        return out

    def _relay(self, ident, msg, cmd, mid):
        if mid is None:
            self.counters.incr("gateway_requests")
            self._front_reply(ident, msg, {"error": (
                f"{cmd!r} through a gateway needs a correlation id "
                "(wire.stamp_message_id); its reply could not be "
                "routed back otherwise"
            )}, span_name=f"gateway:{cmd}")
            return
        route = self._routes.get(mid)
        if route is not None:
            # a retry of an in-flight relay: same worker (its dedupe /
            # reply cache keeps it exactly-once) as long as it lives
            w = self._workers[route.widx]
            if w.alive:
                route.ident = ident
                self._relay_to(w, ident, msg, cmd, record=False)
                return
            del self._routes[mid]
        if cmd in ("step", "close"):
            ep = msg.get("episode")
            widx = None
            try:
                widx = int(ep) % self.n_workers
            except (TypeError, ValueError):
                pass  # unintelligible lease: any live worker rejects it
            if widx is not None:
                w = self._workers[widx]
                if not w.alive:
                    # the owning worker died and took the lease's
                    # reply cache / replica route with it — the lease
                    # is unrecoverable, exactly like a replica death
                    self.counters.incr("gateway_requests")
                    self.counters.incr("gateway_lease_rehash")
                    self.counters.incr("gateway_stale_lease_redirects")
                    if cmd == "close":
                        self._front_reply(ident, msg, {"closed": False},
                                          span_name="gateway:close")
                    else:
                        self._front_reply(ident, msg, {"error": (
                            f"stale episode lease {ep!r} (gateway "
                            f"worker {w.tag} died): reset() and resume "
                            "on a healthy replica"
                        ), "lease": "stale"}, span_name="gateway:step")
                    return
                self._relay_to(w, ident, msg, cmd)
                return
        w = self._pick_worker_for_mid(mid)
        if w is None:
            self.counters.incr("gateway_requests")
            self._front_reply(ident, msg, {"error": (
                "no live gateway worker (of "
                f"{[x.tag for x in self._workers]}): retry after the "
                "watchdog respawns one"
            )}, span_name=f"gateway:{cmd}")
            return
        self._relay_to(w, ident, msg, cmd)

    def _relay_to(self, w, ident, msg, cmd, record=True):
        import zmq

        mid = msg.get(wire.BTMID_KEY)
        if record and mid is not None:
            self._routes[mid] = _FrontRoute(ident, w.idx, cmd)
            while len(self._routes) > ROUTE_CACHE_DEPTH:
                self._routes.popitem(last=False)
        try:
            wire.send_message_dealer(w.sock, msg, raw_buffers=True,
                                     flags=zmq.DONTWAIT)
        except zmq.Again:
            if mid is not None:
                self._routes.pop(mid, None)
            self.counters.incr("gateway_requests")
            self._front_reply(ident, msg, {"error": (
                f"gateway worker {w.tag} send queue full (stalled or "
                "unreachable): retry, or reset() after its respawn"
            )}, span_name=f"gateway:{cmd}")
            return
        except zmq.ZMQError:
            if mid is not None:
                self._routes.pop(mid, None)
            return
        self.counters.incr("gateway_front_relays")

    def _handle_worker_reply(self, w, reply):
        w.last_ok = time.monotonic()
        mid = reply.get(wire.BTMID_KEY)
        if mid is not None and mid in self._wscrapes:
            del self._wscrapes[mid]
            self._ingest_worker_scrape(w, reply)
            return
        if mid is not None and mid in self._snap_mids:
            return  # snapshot ack
        route = self._routes.pop(mid, None) if mid is not None else None
        if route is None:
            self.counters.incr("stale_replies")
            return
        if (route.cmd == "reset" and "error" not in reply
                and self.active_workers > 1):
            # the redirect payload: the client moves its channel to its
            # owning worker's own address and never relays here again.
            # With the data plane collapsed to one worker the map is
            # withheld — every message keeps riding this front, which
            # IS the unsharded single-address shape the shard bench
            # arm measures against.
            reply["gw_workers"] = self._worker_map()
            reply["gw_n_workers"] = self.n_workers
        elif route.cmd == "hello":
            fields = self._sharded_fields()
            if self.active_workers == 1:
                fields.pop("gw_workers", None)
            reply.update(fields)
        import zmq

        try:
            wire.send_message_router(self._front, route.ident, reply,
                                     raw_buffers=True)
            self.counters.incr("gateway_replies")
        except zmq.ZMQError:
            pass

    # -- loop ----------------------------------------------------------------

    def _drain_front(self):
        import zmq

        drain_socket(
            lambda: wire.recv_message_router_sized(
                self._front, flags=zmq.NOBLOCK)[:2],
            lambda out: self._handle_front_client(out[0], out[1]),
            self.counters, "gateway front", "client request",
        )

    def _drain_worker(self, w):
        import zmq

        drain_socket(
            lambda: wire.recv_message_dealer(w.sock, flags=zmq.NOBLOCK),
            lambda reply: self._handle_worker_reply(w, reply),
            self.counters, "gateway front", "worker reply",
        )

    def serve_forever(self, stop_event=None, poll_ms=50):
        import zmq

        poller = zmq.Poller()
        poller.register(self._front, zmq.POLLIN)
        for w in self._workers:
            poller.register(w.sock, zmq.POLLIN)
        for rep in self._ctl._replicas.values():
            poller.register(rep.sock, zmq.POLLIN)
        while stop_event is None or not stop_event.is_set():
            self._apply_notices()
            self._ctl._apply_notices()
            self._ctl._scrape_tick()
            self._worker_tick()
            self._publish_snapshot()
            try:
                events = dict(poller.poll(poll_ms))
                if self._front in events:
                    self._drain_front()
                for w in self._workers:
                    if w.sock in events:
                        self._drain_worker(w)
                for rep in self._ctl._replicas.values():
                    if rep.sock in events:
                        self._ctl._drain_replica(rep)
            except zmq.ZMQError:
                return  # a socket closed under us: clean shutdown

    def close(self):
        try:
            self._front.close(0)
        except Exception:  # noqa: BLE001 - shutdown best-effort
            pass
        for w in self._workers:
            try:
                w.sock.close(0)
            except Exception:  # noqa: BLE001
                pass
        info = self.launch_info
        if info is not None:
            for proc in info.processes:
                try:
                    proc.terminate()
                except Exception:  # noqa: BLE001
                    pass
            for proc in info.processes:
                try:
                    proc.wait(timeout=5)
                except Exception:  # noqa: BLE001
                    try:
                        proc.kill()
                        proc.wait(timeout=5)
                    except Exception:  # noqa: BLE001
                        pass
        for base in self._wbases:
            if base is not None:
                shm_rpc.unlink_base(base)
        self._ctl.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False


class _LocalShardedHandle:
    """An in-process sharded-gateway front (thread) plus its worker
    processes and watchdog, for tests and benchmarks."""

    def __init__(self, gateway, thread, stop, watchdog):
        self.gateway = gateway
        self.address = gateway.address
        self._thread = thread
        self._stop = stop
        self._watchdog = watchdog

    def set_active_workers(self, n):
        return self.gateway.set_active_workers(n)

    def close(self):
        if self._watchdog is not None:
            self._watchdog.stop()
        self._stop.set()
        self._thread.join(timeout=5)
        self.gateway.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_sharded_gateway_thread(replicas, *, address="tcp://127.0.0.1:*",
                                 workers=2, counters=None, timer=None,
                                 supervise=True, **kwargs):
    """Spawn N gateway worker processes + the front/control loop in a
    daemon thread, supervised by a FleetWatchdog (``restart=True``, every
    :data:`WORKER_WATCHDOG_INTERVAL_S`);
    returns a handle with ``.address``, ``.gateway``,
    ``.set_active_workers()`` and ``.close()``."""
    gateway = ShardedGateway(address, replicas, workers=workers,
                             counters=counters, timer=timer,
                             **kwargs).start()
    stop = threading.Event()
    thread = threading.Thread(
        target=gateway.serve_forever, kwargs={"stop_event": stop},
        daemon=True, name="bjx-sharded-gateway",
    )
    thread.start()
    watchdog = None
    if supervise:
        from blendjax_torch.btt.watchdog import FleetWatchdog

        watchdog = FleetWatchdog(
            gateway, interval=WORKER_WATCHDOG_INTERVAL_S, restart=True,
            on_death=gateway.notify_worker_death,
            on_respawn=gateway.notify_worker_respawn,
        )
        watchdog.start()
    return _LocalShardedHandle(gateway, thread, stop, watchdog)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Route a fleet of blendjax_torch policy servers."
    )
    ap.add_argument("--address", required=True)
    ap.add_argument("--replica", action="append", required=True,
                    help="backend replica address (repeatable)")
    ap.add_argument("--scrape-interval", type=float, default=0.25)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    gateway = ServeGateway(args.address, args.replica,
                           scrape_interval_s=args.scrape_interval)
    stop = threading.Event()

    def _term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    logger.info("serve gateway at %s over %d replicas",
                gateway.address, len(args.replica))
    try:
        gateway.serve_forever(stop_event=stop)
    finally:
        gateway.close()


if __name__ == "__main__":
    main()
