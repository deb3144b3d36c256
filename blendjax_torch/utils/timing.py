"""Lightweight per-stage timing and named event counters.

Usage::

    timer = StageTimer()
    with timer.stage("recv"):
        msg = sock.recv()
    ...
    timer.summary()   # {'recv': {'count': n, 'total_s': t, 'mean_ms': m,
                      #           'p50_ms': ..., 'p90_ms': ..., 'p99_ms': ...,
                      #           'max_ms': ...}, ...}

Every ``add`` also lands in a fixed-memory log-bucketed latency histogram
(:class:`blendjax_torch.obs.histogram.LatencyHistogram`), so the summary
carries per-stage percentiles.  The feed records ``recv`` (loader queue
wait), ``collate`` (batch assembly in a worker, collate path),
``arena_wait`` (a worker blocked on an exhausted arena pool), ``scatter``
(wire frames copied into an arena batch), ``device_put`` (staging +
host->device copy issue) and ``recycle`` (the wait for an arena's copy to
complete, and its return to the pool), under the reference's names; the
policy server records :data:`SERVE_STAGES`, the HA checkpointer
:data:`HA_STAGES`, the replay service :data:`REPLAY_STAGES`, the
weight bus :data:`WEIGHT_STAGES`, the scenario plane
:data:`SCENARIO_STAGES`, the serve gateway :data:`GATEWAY_STAGES`, the
autoscaler :data:`AUTOSCALE_STAGES` and the MPMD pipeline
:data:`PIPE_STAGES`.  :meth:`StageTimer.snapshot` is the
mergeable form the :class:`~blendjax_torch.obs.hub.TelemetryHub` folds.
With ``StageTimer(trace=True)`` each interval is also kept, with its
start and thread, in a bounded ring (:data:`DEFAULT_TRACE_CAP`; evictions
counted in ``trace_dropped``), and :meth:`StageTimer.export_chrome_trace` writes the
ring as Chrome trace-event JSON: the loader workers, the prefetch thread
and the train loop on rows of their own, so feed stalls show as gaps.
Pure stdlib, so producers and the torch-free services import it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager

from blendjax_torch.obs.histogram import LatencyHistogram


class EventCounters:
    """Thread-safe named event counters (stream timeouts, recorder drops,
    transfer-gate backstops; the env layer's retries, timeouts,
    quarantines and re-admissions).  :data:`fleet_counters` is the process-wide
    default; pass a fresh instance for isolated accounting."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = defaultdict(int)

    def incr(self, name, n=1):
        with self._lock:
            self._counts[name] += n

    def get(self, name):
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self):
        """Copy of all counters as a plain dict."""
        with self._lock:
            return dict(self._counts)

    def reset(self):
        with self._lock:
            self._counts.clear()


#: Canonical feed-pipeline stage names (the loader, the arena assembly and
#: the device feed record under them).
FEED_STAGES = (
    "recv", "collate", "arena_wait", "scatter", "recycle", "device_put",
)

#: Canonical fault and health event names, the reference's: what the env
#: layer, the watchdog and the stream count, and what
#: ``FleetSupervisor.health()`` zero-fills.  ``ready_waits`` /
#: ``stale_replies`` / ``inflight_discards`` are the async env pipeline's;
#: ``record_drops`` the recorder's refusals at capacity;
#: ``watchdog_backoff_jitter_ms`` the watchdog's randomized respawn delay.
FLEET_EVENTS = (
    "deaths", "restarts", "retries", "timeouts", "failures", "quarantines",
    "readmissions", "circuit_opens", "circuit_rejections",
    "stream_timeouts", "stream_ring_vanished", "transfer_gate_backstops",
    "ready_waits", "stale_replies", "inflight_discards",
    "record_drops",
    "watchdog_backoff_jitter_ms",
)

#: Canonical experience-replay event names, the reference's:
#: ``replay_appends`` / ``replay_overwrites`` / ``replay_excluded`` —
#: rows accepted, rows that evicted a live one, rows flagged unhealthy;
#: ``replay_samples`` / ``replay_sample_waits`` / ``replay_sample_skips``
#: — batches drawn, draws that waited on an underfilled buffer, learner
#: tail draws skipped; ``replay_priority_updates`` — priority refreshes;
#: the sharded service's ``replay_shard_quarantined`` (a shard isolated,
#: the draw renormalized over the live ones), ``replay_shard_readmissions``
#: (a shard back after the handshake), ``replay_shard_journal`` (appends
#: held client-side for a quarantined shard), ``replay_shard_lost`` (rows
#: a restarted shard could not account for, their slots invalidated);
#: ``replay_wire_bytes`` / ``replay_shm_bytes`` — a shard's RPC payload
#: bytes over the socket and through the ShmRPC rings.
REPLAY_EVENTS = (
    "replay_appends", "replay_overwrites", "replay_excluded",
    "replay_samples", "replay_sample_waits", "replay_priority_updates",
    "replay_sample_skips",
    "replay_shard_quarantined", "replay_shard_readmissions",
    "replay_shard_journal", "replay_shard_lost",
    "replay_wire_bytes", "replay_shm_bytes",
)

#: Canonical weight-bus event names, the reference's (the canary names
#: are counted by :class:`blendjax_torch.weights.controller.WeightBusController`
#: and the gateway it steers):
#: ``weight_published`` / ``weight_publish_bytes`` — snapshots streamed
#: and their payload bytes; ``weight_syncs`` — full catch-ups for late
#: joiners; ``weight_adopted`` — verified snapshots hot-swapped into a
#: serving model between ticks; ``weight_torn_discarded`` — partial
#: streams dropped; ``weight_digest_rejected`` — completed streams that
#: failed their checksums; ``weight_apply_failed`` — verified snapshots
#: the model refused (the last good version keeps serving);
#: ``weight_rollback_publishes`` — a prior version republished under a
#: fresh id.
WEIGHT_EVENTS = (
    "weight_published", "weight_publish_bytes", "weight_syncs",
    "weight_adopted", "weight_torn_discarded", "weight_digest_rejected",
    "weight_apply_failed",
    "weight_canary_starts", "weight_canary_routes",
    "weight_canary_promotions", "weight_canary_rollbacks",
    "weight_rollback_publishes",
)

#: Canonical weight-bus stage names: ``weight_publish`` (the actor-learner's
#: host read-back of its params and the publish: snapshot, digest, chunk and
#: stream), ``weight_assemble`` (chunk ingest and digest check per completed
#: snapshot), ``weight_swap`` (the between-ticks hot-swap into the served
#: tensors).
WEIGHT_STAGES = (
    "weight_publish", "weight_assemble", "weight_swap",
)

#: Canonical replay stage names: ``replay_append``, ``sample_wait``,
#: ``sample_gather``, ``priority_update``, and the sharded service's
#: ``shard_append`` (one append RPC: wire, remote write, spill flush) and
#: ``shard_gather`` (one gather RPC and the client-side scatter).
REPLAY_STAGES = (
    "replay_append", "sample_wait", "sample_gather", "priority_update",
    "shard_append", "shard_gather",
)

#: Canonical policy-serving event names
#: (:class:`blendjax_torch.serve.server.PolicyServer`), the reference's:
#: ``serve_requests`` / ``serve_replies`` — requests admitted, replies
#: sent; ``serve_batches`` — batched model calls (ticks);
#: ``serve_batch_pad`` — padding rows added to reach a bucket;
#: ``serve_cache_hits`` — retried requests answered from the reply cache;
#: ``serve_dup_inflight`` — duplicates of a still-queued request dropped at
#: admission; ``serve_resets`` / ``serve_closes`` — episodes admitted and
#: closed; ``serve_evictions`` — idle slots reclaimed; ``serve_slot_denied``
#: — resets refused for want of a slot; ``serve_errors`` — requests
#: answered with an error (or dropped as undecodable); ``serve_prefills``
#: — episodes admitted with an observation prefix; ``serve_wire_bytes`` —
#: request and reply payload bytes over the socket; ``serve_shm_bytes`` —
#: the same through the ShmRPC rings.
SERVE_EVENTS = (
    "serve_requests", "serve_replies", "serve_batches",
    "serve_batch_pad", "serve_cache_hits", "serve_dup_inflight",
    "serve_resets", "serve_closes", "serve_evictions",
    "serve_slot_denied", "serve_errors", "serve_prefills",
    "serve_wire_bytes", "serve_shm_bytes",
)

#: Canonical policy-serving stage names (:class:`StageTimer`):
#: ``queue_wait`` (admission to batch dequeue), ``batch_assemble`` (drain,
#: pad to the bucket, host arrays), ``compute`` (the batched model call, to
#: its result on the host), ``reply`` (the batch's replies sent).
SERVE_STAGES = (
    "queue_wait", "batch_assemble", "compute", "reply",
)

#: Canonical learner-failover (HA) event names, the reference's:
#: ``ha_ckpt_saves`` — coordinated checkpoints committed (the manifest
#: written); ``ha_ckpt_bytes`` — bytes serialized into committed
#: checkpoints; ``ha_ckpt_skipped`` — due checkpoints skipped because the
#: previous background serialization was still in flight;
#: ``ha_ckpt_failures`` — checkpoint attempts that failed (counted and
#: logged, never raised into the update loop); ``ha_ckpt_evicted`` — old
#: cuts removed by retention; ``ha_restores`` — restores from a manifest;
#: ``ha_restore_fallbacks`` — restores that fell back to an older step or
#: manifest because the latest failed to load; ``ha_learner_deaths`` /
#: ``ha_learner_respawns`` — supervised learner-process deaths and
#: respawns; ``ha_resume_publishes`` — restored parameters republished on
#: a weight bus under a fresh version.
HA_EVENTS = (
    "ha_ckpt_saves", "ha_ckpt_bytes", "ha_ckpt_skipped",
    "ha_ckpt_failures", "ha_ckpt_evicted",
    "ha_restores", "ha_restore_fallbacks",
    "ha_learner_deaths", "ha_learner_respawns", "ha_resume_publishes",
)

#: Canonical learner-failover stage names: ``ha_snapshot`` (the
#: synchronous barrier on the update loop: the TrainState copied to host
#: buffers, ordered after the update, plus the replay cut), ``ha_serialize``
#: (the background thread: npz writes, fsync, manifest commit, retention),
#: ``ha_restore`` (the train state restored in place from a manifest).
HA_STAGES = (
    "ha_snapshot", "ha_serialize", "ha_restore",
)

#: Canonical scenario-plane event names, the reference's
#: (``docs/scenarios.md``): ``scenario_samples`` — seeded param dicts drawn
#: from a spec; ``scenario_pushes`` / ``scenario_push_failures`` — duplex
#: pushes sent, and those that timed out or failed into a dead or stalled
#: producer; ``scenario_applies`` — pushes confirmed by the first
#: transition echoing the pushed scenario; ``scenario_reassignments`` —
#: scenarios re-pushed to a respawned or re-admitted env over the env's
#: existing channel (ZMQ reconnects it to the respawned producer);
#: ``scenario_curriculum_updates`` / ``scenario_mix_changes`` —
#: curriculum reweight passes, and those that changed the mix;
#: ``scenario_rows_stamped`` — replay rows appended with a scenario id;
#: ``scenario_strata_draws`` — batches drawn under a non-uniform mix;
#: ``scenario_serve_requests`` — labelled serve replies a gateway recorded.
SCENARIO_EVENTS = (
    "scenario_samples", "scenario_pushes", "scenario_push_failures",
    "scenario_applies", "scenario_reassignments",
    "scenario_curriculum_updates", "scenario_mix_changes",
    "scenario_rows_stamped", "scenario_strata_draws",
    "scenario_serve_requests",
)

#: Canonical scenario-plane stage names: ``scenario_sample`` (one seeded
#: spec sample), ``scenario_push`` (one bounded duplex send of a sample),
#: ``scenario_reweight`` (one curriculum reweight pass).
SCENARIO_STAGES = (
    "scenario_sample", "scenario_push", "scenario_reweight",
)

#: Canonical serve-gateway event names, the reference's
#: (:class:`blendjax_torch.serve.gateway.ServeGateway`):
#: ``gateway_requests`` / ``gateway_replies`` / ``gateway_errors`` —
#: client requests in, replies out, and requests errored or dropped;
#: ``gateway_cache_hits`` — retries answered from the gateway's own reply
#: cache; ``gateway_dup_inflight`` — retries of a forward still in flight,
#: re-sent to the same replica; ``gateway_routed`` — requests forwarded to
#: a replica; ``gateway_affinity_hits`` — step/close requests routed by a
#: live episode lease; ``gateway_rebalances`` — fresh-episode routes where
#: the scraped load overrode plain rotation; ``gateway_replica_quarantined``
#: / ``gateway_replica_respawns`` — a replica isolated (scrape timeout or
#: reported death) and re-admitted; ``gateway_stale_lease_redirects`` —
#: requests answered with the actionable stale-lease error;
#: ``gateway_drains`` — replicas put into drain.  The sharded data plane
#: adds ``gateway_worker_deaths`` / ``gateway_worker_respawns`` (worker
#: processes), ``gateway_lease_rehash`` (lease-owned requests the front
#: answered for a dead worker), ``gateway_snapshot_applies`` /
#: ``gateway_snapshot_publishes`` (versioned control-state snapshots) and
#: ``gateway_front_relays`` (requests the front relayed to a worker).
GATEWAY_EVENTS = (
    "gateway_requests", "gateway_replies", "gateway_errors",
    "gateway_cache_hits", "gateway_dup_inflight",
    "gateway_routed", "gateway_affinity_hits", "gateway_rebalances",
    "gateway_replica_quarantined", "gateway_replica_respawns",
    "gateway_stale_lease_redirects", "gateway_drains",
    "gateway_worker_deaths", "gateway_worker_respawns",
    "gateway_lease_rehash", "gateway_snapshot_applies",
    "gateway_snapshot_publishes", "gateway_front_relays",
)

#: Canonical serve-gateway stage names: ``gw_route`` (request decode and
#: routing decision), ``gw_forward`` (re-encode and send to the replica),
#: ``gw_reply`` (replica reply received and sent back to the client).
GATEWAY_STAGES = (
    "gw_route", "gw_forward", "gw_reply",
)

#: Canonical autoscale event names, the reference's
#: (:class:`blendjax_torch.autoscale.AutoscaleController` and the live
#: replay reshard): ticks, holds (a decision against a bound or a
#: cooldown), committed scale-ups and -downs, rollbacks, drain timeouts,
#: replicas spawned and retired, in-flight transitions adopted by a
#: restarted controller, and shard handoffs committed, aborted whole, and
#: the rows their reconcile copied.
AUTOSCALE_EVENTS = (
    "autoscale_ticks", "autoscale_holds",
    "autoscale_scale_ups", "autoscale_scale_downs",
    "autoscale_rollbacks", "autoscale_drain_timeouts",
    "autoscale_replica_spawns", "autoscale_replicas_retired",
    "autoscale_adoptions",
    "autoscale_reshard_handoffs", "autoscale_reshard_aborts",
    "autoscale_reshard_rows_copied",
)

#: Canonical autoscale stage names: ``autoscale_tick`` (one decision
#: pass), ``autoscale_resize`` (decision to the fleet healthy at its new
#: size, the ``resize_settle_s`` metric), ``autoscale_drain`` (drain issued
#: to the victim's leases at zero), ``autoscale_handoff`` (a shard
#: handoff, source checkpoint to client map cutover).
AUTOSCALE_STAGES = (
    "autoscale_tick", "autoscale_resize", "autoscale_drain",
    "autoscale_handoff",
)

#: Canonical MPMD-pipeline event names (see docs/pipeline.md).  Same
#: contract as ``FLEET_EVENTS``: any ``EventCounters`` accepts them and
#: the TelemetryHub zero-fills every name in every scrape.  The driver
#: and each stage process count into their own sinks; the hub merge is
#: the fleet view.
#: ``pipe_updates`` — pipeline updates committed (stage side: SGD
#: applied at the update boundary; driver side: full
#: begin→feed→finish→commit rounds completed);
#: ``pipe_microbatches`` — microbatch records processed (stage side:
#: backward passes completed; driver side: microbatches fed);
#: ``pipe_feed_parks`` — feed stalls: the bounded in-flight window was
#: full, so the driver parked instead of allocating — the bubble
#: schedule acting as backpressure on the arena feed;
#: ``pipe_resends`` — in-flight activation/grad/target records re-sent
#: under the SAME correlation id after a missed ack (peer death or shm
#: demotion; the receiver's reply cache + ``(update, mb)`` dedup make
#: the resend exactly-once);
#: ``pipe_dup_records`` — duplicate records absorbed by that dedup (a
#: resent record whose original did land);
#: ``pipe_restarts`` — update attempts the driver abandoned and
#: replayed after reconciling a changed fleet (a stage died
#: mid-update);
#: ``pipe_rollbacks`` — stage-side param rollbacks to an earlier
#: committed boundary (checkpoint restore or rebuild-from-seed);
#: ``pipe_driver_rollbacks`` — rollback commands the driver issued
#: while reconciling stages to the lowest common applied update;
#: ``pipe_stage_respawns`` — stage incarnation changes the driver
#: observed at hello (the watchdog respawned a killed stage);
#: ``pipe_ckpt_restores`` — stage param restores from the per-stage
#: checkpoint cut (at process start or rollback);
#: ``pipe_wire_bytes`` — payload bytes through a stage server's wire
#: paths (both transports, both directions it counts).
PIPE_EVENTS = (
    "pipe_updates", "pipe_microbatches", "pipe_feed_parks",
    "pipe_resends", "pipe_dup_records",
    "pipe_restarts", "pipe_rollbacks", "pipe_driver_rollbacks",
    "pipe_stage_respawns", "pipe_ckpt_restores", "pipe_wire_bytes",
)

#: Canonical MPMD-pipeline stage names (see docs/pipeline.md), the
#: :class:`StageTimer` vocabulary the stage processes and the pipeline
#: driver report under: ``pipe_fwd`` (one microbatch forward through a
#: stage's owned layers), ``pipe_bwd`` (one microbatch backward — on
#: the last stage this is the fused forward+loss+backward unit),
#: ``pipe_apply`` (the SGD apply at an update commit), ``pipe_feed``
#: (driver: pushing one microbatch pair into the pipeline, parks
#: included), ``pipe_finish`` (driver: the grads-ready poll barrier
#: after the last microbatch — the visible tail of the 1F1B bubble).
PIPE_STAGES = (
    "pipe_fwd", "pipe_bwd", "pipe_apply", "pipe_feed", "pipe_finish",
)


#: Process-wide default counter registry.  Component constructors take a
#: ``counters=`` override for isolated accounting.
fleet_counters = EventCounters()


#: Bound on the ``trace=True`` event ring: 65,536 intervals hold
#: hours of feed-stage tracing at typical batch rates in a few MB.  Beyond
#: it the oldest events are dropped and counted in
#: :attr:`StageTimer.trace_dropped` (the recent window is what a stall
#: investigation wants).
DEFAULT_TRACE_CAP = 65536


class StageTimer:
    """Accumulates wall-clock time per named stage (thread-safe: stages are
    recorded from loader workers and the prefetch thread concurrently).

    Every :meth:`add` also lands in a
    :class:`~blendjax_torch.obs.histogram.LatencyHistogram`, so
    :meth:`summary` reports p50/p90/p99/max per stage beside the means.
    With ``trace=True`` every interval is also kept, with its start and its
    thread, in a ring of :data:`DEFAULT_TRACE_CAP` events for
    :meth:`export_chrome_trace`.
    """

    def __init__(self, trace=False):
        self._lock = threading.Lock()
        self._trace = bool(trace)
        self._trace_cap = DEFAULT_TRACE_CAP
        self.reset()

    def reset(self):
        """Forget every stage and event; wall time and trace timestamps
        count from now."""
        with self._lock:
            self._total = defaultdict(float)
            self._count = defaultdict(int)
            self._hist = defaultdict(LatencyHistogram)
            self._events = deque(maxlen=self._trace_cap)
            self._trace_dropped = 0
            self._start = time.perf_counter()

    @contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, _t0=t0)

    def add(self, name, seconds, _t0=None):
        with self._lock:
            self._total[name] += seconds
            self._count[name] += 1
            self._hist[name].add(seconds)
            if self._trace:
                start = _t0 if _t0 is not None else time.perf_counter() - seconds
                if len(self._events) == self._trace_cap:
                    self._trace_dropped += 1
                self._events.append((name, start, seconds, threading.get_ident()))

    def add_bulk(self, name, total_seconds, count):
        """Accumulate ``count`` pre-aggregated intervals in one locked
        update.  Not traced (an aggregate has no start), and the histogram
        entries land at the aggregate's mean."""
        if count <= 0:
            return
        with self._lock:
            self._total[name] += total_seconds
            self._count[name] += count
            self._hist[name].add_many(total_seconds / count, count)

    @property
    def wall_s(self):
        """Seconds since the last :meth:`reset`."""
        return time.perf_counter() - self._start

    def total_s(self, name):
        with self._lock:
            return self._total.get(name, 0.0)

    def count(self, name):
        with self._lock:
            return self._count.get(name, 0)

    def mean_ms(self, name):
        with self._lock:
            c = self._count.get(name, 0)
            return (self._total[name] / c) * 1e3 if c else 0.0

    def duty_cycle(self, name):
        """Fraction of wall time since the last reset spent inside ``name``."""
        wall = self.wall_s
        with self._lock:
            return self._total.get(name, 0.0) / wall if wall > 0 else 0.0

    @property
    def trace_dropped(self):
        """Trace events evicted from the bounded ring (oldest first)."""
        with self._lock:
            return self._trace_dropped

    def percentiles(self, name):
        """``{"p50_ms","p90_ms","p99_ms","max_ms"}`` for a stage (zeros
        when unrecorded)."""
        with self._lock:
            h = self._hist.get(name)
            if h is None:
                return {"p50_ms": 0.0, "p90_ms": 0.0, "p99_ms": 0.0,
                        "max_ms": 0.0}
            return h.percentiles()

    def summary(self):
        with self._lock:
            out = {}
            for name, total in self._total.items():
                count = self._count[name]
                out[name] = {
                    "count": count,
                    "total_s": round(total, 6),
                    "mean_ms": round((total / count) * 1e3, 3),
                    **self._hist[name].percentiles(),
                }
            return out

    def snapshot(self):
        """Mergeable per-stage state for the
        :class:`~blendjax_torch.obs.hub.TelemetryHub`: ``{stage: {"count",
        "total_s", "hist"}}`` with the histograms copied (the hub merges
        destructively)."""
        with self._lock:
            return {
                name: {"count": self._count[name], "total_s": total,
                       "hist": self._hist[name].copy()}
                for name, total in self._total.items()
            }

    def snapshot_serialized(self):
        """:meth:`snapshot` with the histograms in their sparse
        ``to_dict`` form: the ``stages`` of a remote ``telemetry`` reply."""
        return {
            name: {"count": rec["count"], "total_s": rec["total_s"],
                   "hist": rec["hist"].to_dict()}
            for name, rec in self.snapshot().items()
        }

    def export_chrome_trace(self, path):
        """Write the traced intervals as Chrome trace-event JSON
        (``chrome://tracing``, Perfetto): one ``ph: "X"`` event each, ``ts``
        and ``dur`` in microseconds from the last :meth:`reset`, one row
        (``tid``) per thread.  Returns the event count; raises RuntimeError
        unless the timer was built with ``trace=True``."""
        if not self._trace:
            raise RuntimeError("tracing is off; construct StageTimer(trace=True)")
        with self._lock:
            events = list(self._events)
            origin = self._start
        pid = os.getpid()
        out = [{"name": name, "ph": "X", "pid": pid, "tid": tid,
                "ts": (start - origin) * 1e6, "dur": dur * 1e6}
               for name, start, dur, tid in events]
        with open(path, "w") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)
        return len(out)
