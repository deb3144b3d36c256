"""AutoscaleController: metric-driven serve-fleet resize with rollback,
the port of ``blendjax.autoscale.controller``.

The gateway scrapes every replica's queue depth, live episodes and p99;
this controller turns those scrapes into ``grow`` / ``drain`` / ``retire``
decisions, with the verify-then-commit shape of
:class:`~blendjax_torch.weights.controller.WeightBusController`:

- **scale up** when load (mean queue depth or fleet p99) crosses the upper
  band: spawn one replica
  (:meth:`~blendjax_torch.serve.server.ServerFleet.grow`), admit it to the
  gateway, then hold a **healthy window**; an error-rate or latency
  regression inside it rolls the newcomer back out (drain and retire,
  ``autoscale_rollbacks``);
- **scale down** when load sits below the lower band: **drain** the
  least-loaded replica, verify the shrunk route set through the same
  window, and only then retire the process; a drain that cannot empty
  within ``drain_grace_s``, or a regression, re-admits it untouched;
- **hysteresis and cooldowns**: the band between the thresholds,
  per-direction cooldowns and ``min_replicas``/``max_replicas`` keep the
  loop from flapping (``autoscale_holds`` counts suppressed firings);
- **crash-safe by statelessness**: a restarted controller that finds a
  replica already draining adopts that transition
  (``autoscale_adoptions``) and carries it to its verdict.

One transition is in flight at a time; :meth:`AutoscaleController.tick`
advances it one step per call.  Replica ids follow the fleet-index
convention ``r<idx>``, so a gateway id maps back to its
:class:`~blendjax_torch.serve.server.ServerFleet` slot.  Imports no torch.
"""

from __future__ import annotations

import logging
import threading
import time

from blendjax_torch.utils.timing import StageTimer, fleet_counters

logger = logging.getLogger("blendjax_torch")


class AutoscaleController:
    """Closed-loop serve-fleet resizing over one
    :class:`~blendjax_torch.serve.gateway.ServeGateway` and the
    :class:`~blendjax_torch.serve.server.ServerFleet` whose processes it
    routes to.

    Params
    ------
    gateway: ServeGateway
        The in-process gateway whose scrape state drives decisions and
        whose ``add_replica``/``drain``/``remove_replica`` this
        controller calls.
    fleet: ServerFleet
        The replica processes; ``grow``/``retire`` side of a resize.
    min_replicas / max_replicas: int
        Hard bounds on ACTIVE (non-draining) replicas.
    up_queue_depth / up_p99_ms: float
        Upper hysteresis band: mean queued-per-replica OR fleet p99
        above either triggers a scale-up.
    down_queue_depth / down_p99_ms: float
        Lower band: BOTH below triggers a scale-down.  Load between
        the bands is the stable region — no action, no hold counted.
    cooldown_up_s / cooldown_down_s: float
        Minimum spacing between committed transitions per direction
        (rollbacks also arm the cooldown — a resize that just failed
        should not retry next tick).
    healthy_window_s: float
        Post-action verification window before a transition commits.
    min_requests: int
        Fleet replies observed inside the window before an error-rate
        verdict (one slow request must not roll a resize back).
    max_error_rate: float
        Fleet error fraction inside the window above which the
        transition rolls back.
    max_p99_x: float
        Newcomer p99 over the incumbent median above which a scale-up
        rolls back (skipped while incumbents have no latency history).
    drain_grace_s: float
        Bound on a scale-down drain: leases still live past it
        re-admit the replica (``autoscale_drain_timeouts``).
    """

    def __init__(self, gateway, fleet, *, min_replicas=1, max_replicas=8,
                 up_queue_depth=8.0, up_p99_ms=200.0,
                 down_queue_depth=1.0, down_p99_ms=50.0,
                 cooldown_up_s=5.0, cooldown_down_s=10.0,
                 healthy_window_s=3.0, min_requests=20,
                 max_error_rate=0.02, max_p99_x=2.0,
                 drain_grace_s=10.0, counters=None, timer=None):
        self.gateway = gateway
        self.fleet = fleet
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_queue_depth = float(up_queue_depth)
        self.up_p99_ms = float(up_p99_ms)
        self.down_queue_depth = float(down_queue_depth)
        self.down_p99_ms = float(down_p99_ms)
        self.cooldown_up_s = float(cooldown_up_s)
        self.cooldown_down_s = float(cooldown_down_s)
        self.healthy_window_s = float(healthy_window_s)
        self.min_requests = int(min_requests)
        self.max_error_rate = float(max_error_rate)
        self.max_p99_x = float(max_p99_x)
        self.drain_grace_s = float(drain_grace_s)
        self.counters = counters if counters is not None else fleet_counters
        self.timer = timer if timer is not None else StageTimer()
        #: the ONE in-flight transition (None = idle): kind "up"/"down",
        #: rid, stage "drain"/"verify", t0, deadlines, counter baseline.
        #: Deliberately reconstructible: a fresh controller re-derives
        #: an equivalent record from gateway state (see _adopt).
        self._transition = None
        self._cooldown_until = {"up": 0.0, "down": 0.0}
        self._thread = None
        self._stop = None

    # -- scraped state views -------------------------------------------------

    def _active(self, snaps):
        """Healthy, non-draining replica snapshots (the route set a
        decision sizes against)."""
        return {
            rid: rec for rid, rec in snaps.items()
            if rec["healthy"] and not rec["draining"]
        }

    def _load(self, active):
        """(mean queued per replica, max p99_ms) over the active set."""
        if not active:
            return 0.0, 0.0
        queued = sum(r["queued"] for r in active.values()) / len(active)
        p99 = max(r["p99_ms"] for r in active.values())
        return float(queued), float(p99)

    def _req_err(self):
        g = self.gateway.counters
        return g.get("gateway_requests"), g.get("gateway_errors")

    def _window_regression(self, base):
        """Fleet-wide error-rate verdict over the window so far; None
        while healthy (or too little traffic to judge)."""
        req0, err0 = base
        req, err = self._req_err()
        d_req, d_err = req - req0, err - err0
        if d_req >= self.min_requests \
                and (d_err / d_req) > self.max_error_rate:
            return (f"error rate {d_err / d_req:.3f} > "
                    f"{self.max_error_rate} over {d_req} requests")
        return None

    @staticmethod
    def _fleet_idx(rid):
        """Gateway id -> fleet slot under the ``r<idx>`` convention
        (None for ids outside it — nothing to retire then)."""
        if rid.startswith("r") and rid[1:].isdigit():
            return int(rid[1:])
        return None

    # -- the decision tick ---------------------------------------------------

    def tick(self):
        """One control step; returns the action taken (``"grow" |
        "drain" | "scale_up" | "scale_down" | "rollback" | "adopt" |
        "hold" | None``).  Advances an in-flight transition by one
        stage, else evaluates the scaling rules."""
        t0 = time.perf_counter()
        self.counters.incr("autoscale_ticks")
        try:
            if self._transition is None:
                adopted = self._adopt()
                if adopted is not None:
                    return adopted
            if self._transition is not None:
                return self._advance()
            return self._decide()
        finally:
            self.timer.add("autoscale_tick",
                           time.perf_counter() - t0)

    def _adopt(self):
        """Idempotence against a controller death mid-transition: a
        replica observed already draining becomes OUR scale-down at its
        drain stage — the decision is finished, never re-issued."""
        snaps = self.gateway.replica_snapshots()
        for rid, rec in snaps.items():
            if rec["draining"] and rec["healthy"]:
                now = time.monotonic()
                self._transition = {
                    "kind": "down", "rid": rid, "stage": "drain",
                    "t0": now, "deadline": now + self.drain_grace_s,
                    "base": self._req_err(),
                }
                self.counters.incr("autoscale_adoptions")
                logger.warning(
                    "autoscale: adopted in-flight drain of %s (a prior "
                    "controller's decision); carrying it to a verdict",
                    rid,
                )
                return "adopt"
        return None

    def _decide(self):
        snaps = self.gateway.replica_snapshots()
        active = self._active(snaps)
        queued, p99 = self._load(active)
        n = len(active)
        now = time.monotonic()
        wants_up = queued > self.up_queue_depth or p99 > self.up_p99_ms
        wants_down = (queued < self.down_queue_depth
                      and p99 < self.down_p99_ms)
        if wants_up:
            if n >= self.max_replicas or now < self._cooldown_until["up"]:
                self.counters.incr("autoscale_holds")
                return "hold"
            return self._begin_up(n, queued, p99)
        if wants_down:
            if n <= self.min_replicas \
                    or now < self._cooldown_until["down"]:
                self.counters.incr("autoscale_holds")
                return "hold"
            return self._begin_down(active, queued, p99)
        return None  # inside the hysteresis band: stable

    def _begin_up(self, n, queued, p99):
        t0 = time.monotonic()
        base = self._req_err()
        [(idx, address)] = self.fleet.grow(1)
        self.counters.incr("autoscale_replica_spawns")
        rid = self.gateway.add_replica(address, rid=f"r{idx}")
        self._transition = {
            "kind": "up", "rid": rid, "idx": idx, "stage": "verify",
            "t0": t0, "deadline": t0 + self.healthy_window_s,
            "base": base,
        }
        logger.warning(
            "autoscale: scaling UP %d -> %d (queued %.1f, p99 %.0fms); "
            "replica %s spawned at %s, verifying for %.1fs",
            n, n + 1, queued, p99, rid, address, self.healthy_window_s,
        )
        return "grow"

    def _begin_down(self, active, queued, p99):
        # victim: the least-loaded active replica — fewest live leases
        # to wait out, least traffic disturbed
        rid = min(active, key=lambda r: (
            active[r]["live_episodes"] + 4 * active[r]["queued"]
            + active[r]["p99_ms"] / 100.0
        ))
        t0 = time.monotonic()
        base = self._req_err()
        self.gateway.drain(rid)
        self._transition = {
            "kind": "down", "rid": rid, "stage": "drain",
            "t0": t0, "deadline": t0 + self.drain_grace_s,
            "base": base,
        }
        logger.warning(
            "autoscale: scaling DOWN %d -> %d (queued %.1f, p99 "
            "%.0fms); draining %s (grace %.1fs)",
            len(active), len(active) - 1, queued, p99, rid,
            self.drain_grace_s,
        )
        return "drain"

    # -- advancing the in-flight transition ----------------------------------

    def _advance(self):
        tr = self._transition
        if tr["kind"] == "up":
            return self._advance_up(tr)
        return self._advance_down(tr)

    def _advance_up(self, tr):
        rid = tr["rid"]
        now = time.monotonic()
        snaps = self.gateway.replica_snapshots()
        rec = snaps.get(rid)
        regression = self._window_regression(tr["base"])
        if regression is None and rec is not None and rec["healthy"] \
                and rec["p99_ms"] > 0:
            others = [r["p99_ms"] for i, r in snaps.items()
                      if i != rid and r["healthy"] and r["p99_ms"] > 0]
            if others:
                others.sort()
                med = others[len(others) // 2]
                if rec["p99_ms"] > self.max_p99_x * med:
                    regression = (
                        f"newcomer p99 {rec['p99_ms']:.0f}ms > "
                        f"{self.max_p99_x}x incumbent {med:.0f}ms"
                    )
        if regression is not None:
            return self._rollback_up(tr, regression)
        if now < tr["deadline"]:
            return None  # window still open, healthy so far
        if rec is None or not rec["healthy"]:
            return self._rollback_up(
                tr, "newcomer never turned healthy in the window"
            )
        self._transition = None
        self._cooldown_until["up"] = now + self.cooldown_up_s
        dt = now - tr["t0"]
        self.timer.add("autoscale_resize", dt)
        self.counters.incr("autoscale_scale_ups")
        logger.warning(
            "autoscale: scale-up committed — %s healthy through the "
            "window (%.2fs decision-to-settle)", rid, dt,
        )
        return "scale_up"

    def _rollback_up(self, tr, why):
        rid, idx = tr["rid"], tr["idx"]
        # the newcomer never owned committed traffic: drain (stops
        # fresh routes; any lease it did pick up dies with the removal
        # and the owning client fails over via the stale-lease error)
        # and retire on the spot
        try:
            self.gateway.drain(rid)
        except KeyError:
            pass  # never admitted — nothing routed to it
        self.gateway.remove_replica(rid)
        self.fleet.retire(idx)
        self._transition = None
        self._cooldown_until["up"] = (
            time.monotonic() + self.cooldown_up_s
        )
        self.counters.incr("autoscale_rollbacks")
        logger.error(
            "autoscale: scale-up of %s ROLLED BACK (%s); fleet back at "
            "its prior size", rid, why,
        )
        return "rollback"

    def _advance_down(self, tr):
        rid = tr["rid"]
        now = time.monotonic()
        if tr["stage"] == "drain":
            if self.gateway.lease_count(rid) == 0:
                dt = now - tr["t0"]
                self.timer.add("autoscale_drain", dt)
                tr["stage"] = "verify"
                tr["deadline"] = now + self.healthy_window_s
                logger.info(
                    "autoscale: %s drained (%.2fs); verifying the "
                    "shrunk route set for %.1fs", rid, dt,
                    self.healthy_window_s,
                )
                return None
            if now >= tr["deadline"]:
                self.gateway.undrain(rid)
                self._transition = None
                self._cooldown_until["down"] = (
                    now + self.cooldown_down_s
                )
                self.counters.incr("autoscale_drain_timeouts")
                self.counters.incr("autoscale_rollbacks")
                logger.error(
                    "autoscale: drain of %s timed out with %d live "
                    "leases after %.1fs; re-admitted (rollback)",
                    rid, self.gateway.lease_count(rid),
                    self.drain_grace_s,
                )
                return "rollback"
            return None  # leases still finishing
        # verify stage: the fleet minus the drained replica must stay
        # healthy before the process is actually retired
        regression = self._window_regression(tr["base"])
        if regression is not None:
            self.gateway.undrain(rid)
            self._transition = None
            self._cooldown_until["down"] = now + self.cooldown_down_s
            self.counters.incr("autoscale_rollbacks")
            logger.error(
                "autoscale: scale-down of %s ROLLED BACK (%s); replica "
                "re-admitted untouched", rid, regression,
            )
            return "rollback"
        if now < tr["deadline"]:
            return None
        self.gateway.remove_replica(rid)
        idx = self._fleet_idx(rid)
        if idx is not None:
            self.fleet.retire(idx)
        self._transition = None
        self._cooldown_until["down"] = now + self.cooldown_down_s
        dt = now - tr["t0"]
        self.timer.add("autoscale_resize", dt)
        self.counters.incr("autoscale_replicas_retired")
        self.counters.incr("autoscale_scale_downs")
        logger.warning(
            "autoscale: scale-down committed — %s retired (%.2fs "
            "decision-to-settle)", rid, dt,
        )
        return "scale_down"

    # -- background driving --------------------------------------------------

    def start(self, interval_s=0.25):
        if self._thread is not None:
            return self
        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 - controller survives
                    logger.exception("autoscale controller tick failed")
                self._stop.wait(interval_s)

        self._thread = threading.Thread(
            target=loop, daemon=True, name="bjx-autoscale-controller"
        )
        self._thread.start()
        return self

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None
            self._stop = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
