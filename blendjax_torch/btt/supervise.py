"""Supervised restart-and-resync: the fleet's self-healing control loop,
the port of ``blendjax.btt.supervise``.

:class:`blendjax_torch.btt.watchdog.FleetWatchdog` respawns dead producers,
and :class:`blendjax_torch.btt.envpool.EnvPool` quarantines and re-admits
unresponsive envs; alone, a respawned producer sits idle until the consumer
happens to time out into it.  ``FleetSupervisor`` closes the loop:

- on producer **death** it immediately quarantines the matching pool env
  (no waiting for an RPC timeout into a dead peer) and counts the event;
- on **respawn** it clears that env's backoff/circuit state and drives
  the re-admission handshake from its own heal thread, so envs rejoin
  within the fault policy's deadline even when the training loop is busy;
- **dataset streams** need no RPC resync (tcp consumers keep their
  connect-mode sockets; shm readers remap the new ring generation via the
  reopen path in :mod:`blendjax_torch.native.ring`), but the supervisor
  verifies the remap through registered health checks and reports it;
- :meth:`health` snapshots the whole story — deaths, restarts, retries,
  quarantines, timeouts, re-admissions, circuit trips, stream timeouts,
  TransferGate backstop fires — from the shared
  :class:`blendjax_torch.utils.timing.EventCounters`.

Usage::

    counters = EventCounters()
    pool = EnvPool(addresses, fault_policy=policy, counters=counters)
    with FleetSupervisor(launcher, pool=pool, interval=0.5) as sup:
        for step in range(n):
            obs, rew, done, infos = pool.step(actions)   # N-1 under faults
        assert sup.health()["quarantines"] == 0          # clean run
"""

from __future__ import annotations

import logging
import threading
import time

from blendjax_torch.btt.watchdog import FleetWatchdog
from blendjax_torch.obs.flight import default_postmortem_dir, flight_recorder
from blendjax_torch.obs.histogram import fold_stage_snapshot, stage_records
from blendjax_torch.utils.timing import FLEET_EVENTS, REPLAY_EVENTS, fleet_counters

logger = logging.getLogger("blendjax_torch")


class FleetSupervisor:
    """Ties fleet restarts to consumer healing, with one health surface.

    Params
    ------
    launcher: BlenderLauncher
        A launcher inside its context (``launch_info`` populated).
    pool: EnvPool | None
        Pool to quarantine/re-admit in lockstep with producer deaths.
        Instance ``i`` of the launcher must serve env ``i`` of the pool
        (the natural outcome of building the pool from
        ``launch_info.addresses``).
    interval: float
        Watchdog poll period, seconds.
    counters: EventCounters | None
        Event sink; defaults to the pool's counters (so pool-side retry/
        quarantine events and supervisor-side death/restart events land
        in one snapshot), else the process-wide ``fleet_counters``.
    heal_interval: float
        Heal-thread cadence, seconds (each tick drives pending
        re-admission probes).
    replay: blendjax_torch.replay.ReplayBuffer | ShardedReplay | None
        When the training loop runs off-policy, attach its buffer so
        :meth:`health` reports the replay fill/exclusion state and stage
        timings alongside the fleet counters — one snapshot for the whole
        acting+learning story.  A
        :class:`~blendjax_torch.replay.ShardedReplay` is supervised like a
        fleet: when this supervisor's launcher IS the shard
        fleet (:class:`~blendjax_torch.replay.service.ShardFleet`, pool
        None), a shard-process death quarantines the matching shard
        proactively and a respawn clears its backoff state; either way
        the heal thread drives :meth:`ShardedReplay.probe` so restored
        shards re-admit within the policy deadline.
    fleet_id: int | None
        This fleet's index in a multi-fleet (Sebulba) deployment — the
        breakdown key :func:`aggregate_health` reports per-fleet
        counters under.  Give each fleet's supervisor its OWN
        ``EventCounters`` so the per-fleet slices stay disjoint (as
        :class:`~blendjax_torch.parallel.podracer.FleetSet` does).
    timer: StageTimer | None
        Attach the fleet's stage timer (the one its feed/replay path
        records into) so :meth:`health` reports per-stage latency
        percentiles (``stages``) next to the counters, and
        :func:`aggregate_health` can merge the histograms across
        fleets.
    hub: blendjax_torch.obs.TelemetryHub | None
        Register this supervisor's counters/timer/health with a
        telemetry hub at construction (name ``fleet<id>``), so one
        ``hub.scrape()`` covers the fleet without extra plumbing.
    postmortem_dir: str | None
        Where to dump a flight-recorder postmortem JSON when a producer
        (or supervised shard process) dies — the crash artifact naming
        the quarantined target.  Defaults to ``$BJX_POSTMORTEM_DIR``;
        with neither set, deaths are still recorded in the process-wide
        flight ring but no file is written.
    """

    def __init__(
        self,
        launcher,
        pool=None,
        interval=1.0,
        counters=None,
        heal_interval=0.05,
        replay=None,
        fleet_id=None,
        timer=None,
        hub=None,
        postmortem_dir=None,
    ):
        self.launcher = launcher
        self.pool = pool
        self.fleet_id = fleet_id
        self.timer = timer
        self.postmortem_dir = (
            postmortem_dir if postmortem_dir is not None
            else default_postmortem_dir()
        )
        #: path of the most recent postmortem dump (None until a death)
        self.last_postmortem = None
        if counters is None:
            counters = pool.counters if pool is not None else fleet_counters
        self.counters = counters
        if hub is not None:
            hub.register_supervisor(
                f"fleet{fleet_id if fleet_id is not None else 0}", self
            )
        self.watchdog = FleetWatchdog(
            launcher, interval=interval, on_death=self._on_death,
            restart=True,
        )
        self.replay = replay
        self.heal_interval = heal_interval
        self._stop = threading.Event()
        self._event = threading.Event()  # pulses on any state change
        self._heal_thread = None
        self._checks = {}
        self._down = set()  # instances reported dead, respawn still owed

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        if self._heal_thread is not None:
            raise RuntimeError("supervisor already started")
        self.watchdog.start()
        self._heal_thread = threading.Thread(
            target=self._heal_loop, daemon=True, name="bjx-supervisor"
        )
        self._heal_thread.start()
        return self

    def stop(self):
        self._stop.set()
        self.watchdog.stop()
        if self._heal_thread is not None:
            self._heal_thread.join(timeout=self.heal_interval + 5)
            self._heal_thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- death -> quarantine -> resync --------------------------------------

    def _on_death(self, idx, code):
        # the watchdog reports a death with a FAILED respawn once, then
        # re-fires when a later respawn succeeds; distinguish via its own
        # death log (the callback runs synchronously after the append) so
        # deaths count physical deaths and restarts count real respawns
        rec = next(
            (d for d in reversed(self.watchdog.deaths) if d[0] == idx), None
        )
        target = (
            f"fleet{self.fleet_id}/instance{idx}"
            if self.fleet_id is not None else f"instance{idx}"
        )
        respawned = bool(rec and rec[2])
        new_death = not (respawned and idx in self._down)
        if not new_death:
            self._down.discard(idx)  # same death, respawn finally landed
        else:
            self.counters.incr("deaths")
            flight_recorder.note(
                "producer_death", target=target,
                exit_code=code, respawned=respawned,
            )
        if self.pool is not None and idx < self.pool.num_envs:
            # proactive: stop RPCing a peer known to be dead instead of
            # discovering it one timeout at a time
            self.pool.quarantine_env(
                idx, reason=f"producer died (exit {code})"
            )
        # a supervisor whose launcher is the replay shard fleet (pool
        # None) maps instance deaths onto shard quarantine the same way
        # an env supervisor maps them onto pool quarantine
        rep = self.replay
        rep_is_sharded = (
            rep is not None and self.pool is None
            and hasattr(rep, "quarantine_shard")
            and idx < getattr(rep, "num_shards", 0)
        )
        if rep_is_sharded:
            rep.quarantine_shard(
                idx, reason=f"shard process died (exit {code})"
            )
        if respawned:
            self.counters.incr("restarts")
            if self.pool is not None and idx < self.pool.num_envs:
                # the endpoint is coming back: drop backoff/circuit state
                # so the heal loop re-dials it immediately
                self.pool.notify_respawn(idx)
            if rep_is_sharded:
                rep.notify_respawn(idx)
        else:
            self._down.add(idx)  # respawn failed; watchdog retries it
        if new_death and self.postmortem_dir is not None:
            # AFTER the quarantines above, so the dump's event ring ends
            # with what was done about the death, and its health snapshot
            # reflects the degraded state being entered
            try:
                extra = {"target": target, "exit_code": code,
                         "health": self.health()}
            except Exception:  # noqa: BLE001 - dump must not cascade
                extra = {"target": target, "exit_code": code}
            self.last_postmortem = flight_recorder.dump(
                directory=self.postmortem_dir,
                reason=f"death-{target}",
                extra=extra,
            )
        self._event.set()

    def _heal_loop(self):
        while not self._stop.wait(self.heal_interval):
            pool = self.pool
            try:
                if pool is not None and pool.quarantined.any() \
                        and pool.probe(block_ms=20):
                    self._event.set()
            except Exception:
                # the heal loop shares the watchdog's prime directive:
                # it must outlive whatever it is healing
                logger.exception("supervisor heal tick failed")
            rep = self.replay
            if rep is None or not hasattr(rep, "probe"):
                continue
            try:
                quarantined = getattr(rep, "quarantined", None)
                if quarantined is not None and quarantined.any() \
                        and rep.probe(block_ms=20):
                    self._event.set()
            except Exception:
                logger.exception("supervisor replay heal tick failed")

    # -- stream verification --------------------------------------------------

    def attach_replay(self, buffer):
        """Report ``buffer`` (a :class:`blendjax_torch.replay.ReplayBuffer`
        or :class:`~blendjax_torch.replay.ShardedReplay`) in :meth:`health`
        and heal it: the constructor's ``replay=``, for a buffer made after
        the supervisor."""
        self.replay = buffer

    def add_health_check(self, name, fn):
        """Register ``fn() -> bool`` evaluated by :meth:`health` and
        required by :meth:`await_healthy` — e.g. a dataset-stream remap
        probe (``lambda: reader.reconnects >= 1`` for the shm rc -4 path,
        or a freshness check on the consuming iterator)."""
        self._checks[name] = fn

    # -- observability ------------------------------------------------------

    def health(self):
        """One snapshot of fleet health: every canonical fault counter
        (zero-filled, see ``FLEET_EVENTS``/``REPLAY_EVENTS``), watchdog
        liveness, the pool's quarantine state, the attached replay
        buffer's fill/exclusion stats, and registered stream checks."""
        h = dict.fromkeys(FLEET_EVENTS + REPLAY_EVENTS, 0)
        h.update(self.counters.snapshot())
        h["alive"] = self.watchdog.alive
        if self.fleet_id is not None:
            h["fleet_id"] = self.fleet_id
        if self.timer is not None:
            # per-stage means AND latency percentiles (p50/p90/p99/max)
            # from the attached StageTimer's histograms
            h["stages"] = self.timer.summary()
        if self.pool is not None:
            mask = self.pool.healthy
            h["num_envs"] = int(mask.size)
            h["healthy_envs"] = int(mask.sum())
            # async pipeline observability: how deep each env's in-flight
            # queue currently is vs. the configured ceiling
            depths = getattr(self.pool, "inflight", None)
            if depths is not None:
                h["inflight_per_env"] = list(depths)
                h["inflight_total"] = int(sum(depths))
                h["pipeline_depth"] = int(
                    getattr(self.pool, "pipeline_depth", 1)
                )
        if self.replay is not None:
            h["replay"] = self.replay.stats()
        h["checks"] = {name: bool(fn()) for name, fn in self._checks.items()}
        return h

    def _await(self, cond, timeout):
        """Bounded wait for ``cond()`` — event-pulsed, no bare sleeps."""
        deadline = time.monotonic() + timeout
        while True:
            if cond():
                return True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            self._event.clear()
            self._event.wait(min(0.05, remaining))

    def await_deaths(self, n=1, timeout=30.0):
        """Block until ``n`` producer deaths have been processed (their
        envs quarantined, respawns issued).  True on success."""
        return self._await(lambda: self.counters.get("deaths") >= n, timeout)

    def await_healthy(self, timeout=30.0):
        """Block until every pool env is healthy, every replay shard is
        re-admitted (when the attached replay is sharded), and every
        registered check passes.  True on success, False on timeout."""

        def cond():
            if self.pool is not None and not self.pool.healthy.all():
                return False
            rep_q = getattr(self.replay, "quarantined", None)
            if rep_q is not None and rep_q.any():
                return False
            return all(bool(fn()) for fn in self._checks.values())

        return self._await(cond, timeout)


def aggregate_health(supervisors):
    """One health snapshot over a multi-fleet (Sebulba) deployment.

    Every canonical counter (``FLEET_EVENTS`` + ``REPLAY_EVENTS``) is
    summed across the fleets' supervisors — the quarantine/death/retry
    totals the sharded bench surfaces — and each fleet's full
    :meth:`FleetSupervisor.health` snapshot rides underneath, keyed by
    its ``fleet_id`` (the per-fleet breakdown: the ``fleet_id``
    dimension on the shared event vocabulary).  ``num_envs`` /
    ``healthy_envs`` sum across fleets; ``alive`` is True only while
    EVERY fleet's watchdog is alive; ``dead_fleets`` lists fleets whose
    pool has no healthy env left (the mask a sharded learner zeroes —
    see :class:`blendjax_torch.parallel.podracer.SegmentFanIn`).
    """
    agg = dict.fromkeys(FLEET_EVENTS + REPLAY_EVENTS, 0)
    fleets = {}
    num_envs = healthy_envs = 0
    alive = True
    dead_fleets = []
    stage_merge = {}  # the obs.histogram.fold_stage_snapshot accumulator
    for idx, sup in enumerate(supervisors):
        h = sup.health()
        fid = h.get("fleet_id", idx)
        fleets[fid] = h
        for name in FLEET_EVENTS + REPLAY_EVENTS:
            agg[name] += int(h.get(name, 0))
        num_envs += int(h.get("num_envs", 0))
        healthy_envs += int(h.get("healthy_envs", 0))
        alive = alive and bool(h.get("alive", False))
        if h.get("num_envs", 0) and h.get("healthy_envs", 0) == 0:
            dead_fleets.append(fid)
        timer = getattr(sup, "timer", None)
        if timer is not None:
            fold_stage_snapshot(stage_merge, timer.snapshot())
    agg.update(
        num_fleets=len(fleets),
        num_envs=num_envs,
        healthy_envs=healthy_envs,
        alive=alive,
        dead_fleets=dead_fleets,
        fleets=fleets,
    )
    if stage_merge:
        # cross-fleet stage latencies: histograms merged so the
        # aggregate p99 is a quantile of the UNION of intervals, not a
        # mean of per-fleet percentiles
        agg["stages"] = stage_records(stage_merge)
    return agg
