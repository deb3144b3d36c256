"""WeightBusController: metric-driven canary promote and rollback, the
port of ``blendjax.weights.controller``.

The gateway routes a fraction of fresh episodes to replicas at a new
weight version and measures each version's requests, errors and latency
(:meth:`~blendjax_torch.serve.gateway.ServeGateway.version_stats`); this
controller closes the loop:

- a **new version** appearing in the fleet (the scraped per-replica
  ``weight_version``) opens a canary window at ``fraction``;
- a canary that stays **healthy** through ``healthy_window_s`` with at
  least ``min_requests`` observed is **promoted**
  (``weight_canary_promotions``);
- a canary whose error rate exceeds ``max_error_rate``, whose p99 exceeds
  ``max_p99_x`` times the stable version's, or that stays unanswered past
  ``verdict_timeout_s`` while the fleet served enough traffic is **rolled
  back** (``weight_canary_rollbacks``): the version is rejected for fresh
  traffic and, with a :class:`~blendjax_torch.weights.bus.WeightPublisher`
  attached, the stable weights are republished under a fresh higher
  version id (``weight_rollback_publishes``), rolling the subscribed fleet
  forward to the old weights;
- the **first** version ever seen is adopted as stable directly.

Drive it by calling :meth:`WeightBusController.tick` from your own loop
(deterministic) or :meth:`~WeightBusController.start` a daemon thread.
Imports no torch.
"""

from __future__ import annotations

import logging
import threading
import time

logger = logging.getLogger("blendjax_torch")


class WeightBusController:
    """Automated canary lifecycle over one
    :class:`~blendjax_torch.serve.gateway.ServeGateway` (and optionally the
    :class:`~blendjax_torch.weights.bus.WeightPublisher` to drive rollback
    republishes through).

    Params
    ------
    gateway: ServeGateway
        The in-process gateway whose canary routing and per-version
        metrics this controller drives.
    publisher: WeightPublisher | None
        When given, a rollback also re-publishes the stable version's
        weights (fresh higher version id) so subscribed replicas roll
        forward to the old weights instead of serving the rejected ones
        forever.
    fraction: float
        Share of fresh episodes routed to the canary version while a
        window is open.
    healthy_window_s: float
        How long a canary must stay healthy before promotion.
    min_requests: int
        Canary replies observed before any verdict (promote OR
        rollback) — one slow request must not roll a version back.
    max_error_rate: float
        Canary error-reply fraction above which it rolls back.
    max_p99_x: float
        Canary p99 over stable p99 above which it rolls back (skipped
        while the stable version has no latency history).
    verdict_timeout_s: float
        Liveness bound on the window itself: a canary that has NOT
        accumulated ``min_requests`` replies by this deadline — while
        the fleet served enough traffic that its ``fraction`` share
        should have — is rolled back as wedged/unreachable (a
        crash-looping canary replica never replies, so no error-rate
        or p99 verdict would ever fire, and an open window holds
        unknown-version replicas out of fresh traffic forever).  When
        the whole fleet was idle there is nothing to judge by and the
        window stays open.
    """

    def __init__(self, gateway, publisher=None, *, fraction=0.25,
                 healthy_window_s=2.0, min_requests=20,
                 max_error_rate=0.05, max_p99_x=1.5,
                 verdict_timeout_s=30.0):
        self.gateway = gateway
        self.publisher = publisher
        self.fraction = float(fraction)
        self.healthy_window_s = float(healthy_window_s)
        self.min_requests = int(min_requests)
        self.max_error_rate = float(max_error_rate)
        self.max_p99_x = float(max_p99_x)
        self.verdict_timeout_s = float(verdict_timeout_s)
        self._canary_t0 = None
        self._base = {}           # version -> (requests, errors) at t0
        self._thread = None
        self._stop = None

    # -- state views ---------------------------------------------------------

    def _fleet_versions(self):
        """Healthy replicas' scraped weight versions (None filtered)."""
        return [
            v for v in self.gateway.fleet_versions().values()
            if v is not None
        ]

    def _delta(self, stats, version):
        """(requests, errors) for ``version`` since the canary window
        opened."""
        rec = stats.get(version)
        if rec is None:
            return 0, 0
        b_req, b_err = self._base.get(version, (0, 0))
        return rec["requests"] - b_req, rec["errors"] - b_err

    # -- the decision tick ---------------------------------------------------

    def _open_window(self, version):
        """Start a canary window at ``version``: snapshot every
        version's (requests, errors) as the diff baseline, stamp the
        clock, flip the gateway's routing split."""
        self._base = {
            v: (rec["requests"], rec["errors"])
            for v, rec in self.gateway.version_stats().items()
        }
        self._canary_t0 = time.monotonic()
        self.gateway.canary(version, self.fraction)
        logger.info("weight controller: canary v%d at %.0f%%",
                    version, 100 * self.fraction)
        return "canary"

    def tick(self):
        """One control decision; returns the action taken
        (``"canary" | "promote" | "rollback" | None``)."""
        gw = self.gateway
        versions = self._fleet_versions()
        newest = max(versions) if versions else None
        stable = gw.stable_version
        if gw.canary_version is None:
            if newest is None:
                return None
            if stable is None:
                # first version the fleet ever reports: no baseline to
                # canary against — adopt it as the stable reference
                gw.set_stable(newest)
                return None
            if newest <= stable or newest == gw.rejected_version:
                return None
            return self._open_window(newest)
        # a window is open
        canary_v = gw.canary_version
        if newest is not None and newest > canary_v:
            # superseded mid-window: restart the window at the newest
            # version (the old canary never gets a verdict)
            return self._open_window(newest)
        stats = gw.version_stats()
        c_req, c_err = self._delta(stats, canary_v)
        regression = None
        if c_req < self.min_requests:
            if time.monotonic() - self._canary_t0 \
                    < self.verdict_timeout_s:
                return None
            fleet_req = sum(
                self._delta(stats, v)[0] for v in stats
            )
            if fleet_req * self.fraction < self.min_requests:
                # the whole fleet was (near) idle: nothing to judge a
                # healthy canary against either — keep the window open
                return None
            regression = (
                f"{c_req} canary replies in {self.verdict_timeout_s:g}s"
                f" while the fleet served {fleet_req} — canary wedged "
                "or unreachable"
            )
        elif (c_err / c_req) > self.max_error_rate:
            regression = (f"error rate {c_err / c_req:.3f} > "
                          f"{self.max_error_rate}")
        else:
            c_p99 = (stats.get(canary_v) or {}).get("p99_ms", 0.0)
            s_p99 = (stats.get(stable) or {}).get("p99_ms", 0.0)
            if s_p99 > 0 and c_p99 > self.max_p99_x * s_p99:
                regression = (f"p99 {c_p99:.1f}ms > {self.max_p99_x}x "
                              f"stable {s_p99:.1f}ms")
        if regression is not None:
            gw.rollback()
            logger.warning("weight controller: canary v%d rolled back "
                           "(%s)", canary_v, regression)
            if self.publisher is not None and stable is not None:
                try:
                    # the republished (old-weights, new-id) version IS
                    # the fleet's new stable reference — without this,
                    # the next tick would canary the republication
                    # against the version it just rolled back
                    gw.set_stable(self.publisher.republish(stable))
                except KeyError:
                    logger.warning(
                        "weight controller: stable v%d aged out of "
                        "publisher history; fleet keeps serving its "
                        "adopted weights", stable,
                    )
            return "rollback"
        if time.monotonic() - self._canary_t0 >= self.healthy_window_s:
            gw.promote()
            logger.info("weight controller: canary v%d promoted",
                        canary_v)
            return "promote"
        return None

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
                    logger.exception("weight controller tick failed")
                self._stop.wait(interval_s)

        self._thread = threading.Thread(
            target=loop, daemon=True, name="bjx-weight-controller"
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
