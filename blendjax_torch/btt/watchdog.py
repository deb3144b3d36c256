"""Fleet failure detection: the port of ``blendjax.btt.watchdog``.

``FleetWatchdog`` watches a launched fleet from a background thread and
reports deaths promptly; with ``restart=True`` it respawns dead instances
with their original command line (``launcher.respawn(idx)``).  Streams heal
on tcp because producers bind and consumers keep their connect-mode
sockets.  Anything with a ``launch_info.processes`` list and a
``respawn(idx)`` is watched the same way: the learner supervisor
(:mod:`blendjax_torch.ha.supervisor`) and the replay shard fleet
(:class:`~blendjax_torch.replay.service.ShardFleet`, under
:class:`~blendjax_torch.btt.supervise.FleetSupervisor`) are two; each
sweeps its ``/dev/shm`` objects in its own ``respawn``.
"""

from __future__ import annotations

import logging
import random
import threading

from blendjax_torch.utils.timing import fleet_counters

logger = logging.getLogger("blendjax_torch")


class FleetWatchdog:
    """Monitors a launched fleet.

    Params
    ------
    launcher: BlenderLauncher
        A launcher inside its context (``launch_info`` populated).
    interval: float
        Poll period, seconds.
    on_death: callable | None
        ``on_death(index, exit_code)`` invoked per death (from the watchdog
        thread).
    restart: bool
        Respawn dead instances with their original command.
    on_respawn: callable | None
        ``on_respawn(index, process)`` invoked after a SUCCESSFUL respawn
        (from the watchdog thread; only fires with ``restart=True``).
        ``on_death`` reports the loss; this reports the replacement — a
        consumer that probes/re-admits (the serve gateway, a supervisor
        heal loop) re-arms immediately instead of waiting out its next
        poll.
    respawn_backoff_s / respawn_jitter_s: float
        Pause inserted before each respawn: ``respawn_backoff_s`` fixed
        plus ``uniform(0, respawn_jitter_s)`` randomized per member.
        With N members SIGKILLed in the same poll window (or a box
        stall), the jitter de-correlates their relaunches so they do
        not come back in lockstep and stampede the gateway's
        re-admission scrape.  Applied milliseconds are counted under
        ``watchdog_backoff_jitter_ms`` so postmortems show the pacing.
    counters: EventCounters | None
        Counter sink for ``watchdog_backoff_jitter_ms`` (defaults to
        the process-wide ``fleet_counters``).
    """

    def __init__(self, launcher, interval=1.0, on_death=None, restart=False,
                 on_respawn=None, respawn_backoff_s=0.0,
                 respawn_jitter_s=0.05, counters=None):
        self.launcher = launcher
        self.interval = interval
        self.on_death = on_death
        self.restart = restart
        self.on_respawn = on_respawn
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.respawn_jitter_s = float(respawn_jitter_s)
        self.counters = counters if counters is not None else fleet_counters
        self.deaths = []  # (index, exit_code, restarted)
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        if self._thread is not None:
            raise RuntimeError("watchdog already started")
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    @property
    def alive(self):
        """Number of currently-running instances."""
        info = self.launcher.launch_info
        if info is None or info.processes is None:
            return 0
        return sum(1 for p in info.processes
                   if p is not None and p.poll() is None)

    def _run(self):
        while not self._stop.wait(self.interval):
            info = self.launcher.launch_info
            if info is None or info.processes is None:
                return
            for idx, proc in enumerate(info.processes):
                if proc is None:
                    # retired member (autoscale scale-down): its slot is
                    # kept so fleet indices stay stable, but there is
                    # nothing to watch or respawn
                    continue
                code = proc.poll()
                if code is None:
                    continue
                already = any(d[0] == idx and not d[2] for d in self.deaths)
                restarted = False
                if self.restart:
                    delay = self.respawn_backoff_s + random.uniform(
                        0.0, self.respawn_jitter_s)
                    if delay > 0:
                        self.counters.incr(
                            "watchdog_backoff_jitter_ms",
                            max(1, int(delay * 1000.0)),
                        )
                        if self._stop.wait(delay):
                            return
                    try:
                        new = self.launcher.respawn(idx)
                    except Exception:
                        # a failed respawn (transient ENOMEM, unavailable
                        # executable) must not kill the watchdog thread:
                        # the instance is still dead next poll, so the
                        # respawn retries every interval — but the death
                        # itself is still reported (once, below) so
                        # supervisors can quarantine/alert while the
                        # producer stays down.  A later successful respawn
                        # appends a second, restarted=True record (and
                        # re-fires on_death, which re-arms the consumer
                        # resync).
                        logger.exception(
                            "respawn of instance %d failed; retrying on "
                            "the next poll", idx,
                        )
                        if already:
                            continue
                    else:
                        restarted = True
                        # resolve any earlier respawn-failed record so a
                        # future death of this instance reports again
                        self.deaths = [
                            d for d in self.deaths
                            if not (d[0] == idx and not d[2])
                        ]
                        logger.warning(
                            "instance %d died (exit %s); restarted as "
                            "pid %d", idx, code, new.pid,
                        )
                elif not already:
                    logger.warning("instance %d died (exit %s)", idx, code)
                else:
                    continue
                self.deaths.append((idx, code, restarted))
                if self.on_death is not None:
                    # an exception in user callback code must not kill the
                    # watchdog thread — it is exactly the component that
                    # must survive everything else failing
                    try:
                        self.on_death(idx, code)
                    except Exception:
                        logger.exception(
                            "watchdog on_death callback failed for "
                            "instance %d (watchdog keeps running)", idx,
                        )
                if restarted and self.on_respawn is not None:
                    # after on_death: the loss is reported before the
                    # replacement (same survival contract)
                    try:
                        self.on_respawn(idx, new)
                    except Exception:
                        logger.exception(
                            "watchdog on_respawn callback failed for "
                            "instance %d (watchdog keeps running)", idx,
                        )
