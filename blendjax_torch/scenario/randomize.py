"""Live domain randomization over the duplex control plane, the port of
``blendjax.scenario.randomize``.

The :class:`DomainRandomizer` pushes sampled scene parameters into RUNNING
producers over the PAIR duplex channel mid-training (the densityopt
pattern, generalized):

- each producer binds a ``CTRL`` PAIR socket next to its ``GYM`` one
  (``FleetSet(ctrl=True)`` allocates the addresses; the env script
  attaches it via :meth:`blendjax_torch.btb.env.BaseEnv.attach_param_channel`
  and applies pushes through its ``_env_apply_params`` hook);
- the randomizer holds one consumer-side
  :class:`~blendjax_torch.btt.duplex.DuplexChannel` per producer, samples
  a :class:`~blendjax_torch.scenario.catalog.ScenarioSpec` (seeded) and
  sends the concrete param dict, per assignment change or per K steps;
- pushes are bounded, never blocking: a SIGKILLed producer makes ``send``
  time out (counted ``scenario_push_failures``); it cannot wedge the
  pushing thread;
- producers echo the applied scenario name in every transition
  (``info["scenario"]``), which confirms a push (:meth:`note_info` ->
  ``scenario_applies``) and attributes replay rows and telemetry;
- a re-admitted env (``info["readmitted"]``) gets its fleet's scenario
  re-pushed (:meth:`reassign` -> ``scenario_reassignments``).

The push is the reference's message on the reference's wire, so either
package's randomizer drives the other's producers.  See docs/scenarios.md.

One difference from the reference: :meth:`reassign` re-pushes over the
env's existing channel, where the reference's re-dials a fresh one.  ZMQ
reconnects a channel to the respawned producer within its reconnect
interval, and the producer's PAIR socket keeps one peer: a re-dialled
channel that arrives while the old one is attached is dropped with its
message, so the respawned producer would keep its launch scene.  Over the
existing channel the frames that queued while the producer was down
arrive first and the re-push last, so the fleet's current scenario wins.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np

from blendjax_torch.utils.timing import StageTimer, fleet_counters

logger = logging.getLogger("blendjax_torch")

#: wire command tag of a randomization push (the producer-side hook
#: dispatches on it; unknown commands are ignored by the default hook)
PUSH_CMD = "scenario"

#: default bound on one duplex push send, milliseconds.  PAIR queues up
#: to HWM (10) frames to a dead peer before Again — small enough that a
#: fleet-wide reassignment over one dead producer costs tens of ms, not
#: the socket default's tens of seconds.
DEFAULT_PUSH_TIMEOUT_MS = 200


def _as_fleet_lists(addresses):
    """Normalize ``ctrl_addresses``: a flat list of endpoints is ONE
    fleet; a list of lists is one entry per fleet."""
    addresses = list(addresses)
    if addresses and isinstance(addresses[0], str):
        return [addresses]
    return [list(f) for f in addresses]


class DomainRandomizer:
    """Samples scenarios and pushes the draws into running producers.

    Params
    ------
    catalog: ScenarioCatalog
        The named scenario set assignments come from.
    ctrl_addresses: list[str] | list[list[str]]
        Producer CTRL endpoints — flat (one fleet) or per-fleet
        (``FleetSet.ctrl_addresses``).
    seed: int
        Seeds the sampling RNG: same catalog + same push sequence ->
        identical parameter draws.
    push_timeout_ms: int
        Bound on each duplex send (see module docstring).
    resample_every: int | None
        When set, :meth:`maybe_resample` re-pushes a fresh draw of the
        CURRENT scenario to a fleet every N calls (per-K-steps
        randomization); None leaves pacing entirely to the caller.
    counters / timer:
        ``SCENARIO_EVENTS`` sink and ``SCENARIO_STAGES`` timer;
        defaults to the process-wide ``fleet_counters`` / a private
        timer.
    """

    def __init__(self, catalog, ctrl_addresses, *, seed=0,
                 push_timeout_ms=DEFAULT_PUSH_TIMEOUT_MS,
                 resample_every=None, counters=None, timer=None):
        self.catalog = catalog
        self._fleets = _as_fleet_lists(ctrl_addresses)
        self.num_fleets = len(self._fleets)
        self.counters = counters if counters is not None else fleet_counters
        self.timer = timer if timer is not None else StageTimer()
        self.push_timeout_ms = int(push_timeout_ms)
        self.resample_every = (
            None if resample_every is None else max(1, int(resample_every))
        )
        self._rng = np.random.default_rng(seed)
        # two-lock discipline: ``_lock`` guards the assignment /
        # confirmation state and the channel dict with SHORT holds, so
        # the actor hot path (``note_info``/``scenario_of``, once per
        # transition) never waits behind a network send; ``_push_lock``
        # serializes the push pipeline itself — RNG draws (numpy
        # Generators are not thread-safe; the documented deterministic
        # draw sequence needs one serialized consumer) and the zmq
        # PAIR sends (one socket per env, not thread-safe) — across
        # the learner's reassignments, an actor's respawn re-push and
        # per-K resampling.  Order: ``_push_lock`` outer, ``_lock``
        # inner, never the reverse.
        self._lock = threading.RLock()
        self._push_lock = threading.RLock()
        self._chans = {}          # (fleet, env) -> DuplexChannel
        self._assigned = [None] * self.num_fleets
        self._confirmed = [False] * self.num_fleets
        self._step_ticks = [0] * self.num_fleets
        self._closed = False

    # -- channels ------------------------------------------------------------

    def _channel(self, f, i):
        """The consumer-side PAIR channel to producer ``(f, i)``, dialled
        at first use; ZMQ reconnects it to a respawned producer."""
        from blendjax_torch.btt.duplex import DuplexChannel

        key = (f, i)
        with self._lock:
            chan = self._chans.get(key)
            if chan is None:
                chan = DuplexChannel(
                    self._fleets[f][i], btid=i,
                    timeoutms=self.push_timeout_ms,
                )
                self._chans[key] = chan
            return chan

    # -- assignment & pushes -------------------------------------------------

    @property
    def assignments(self):
        """Current scenario name per fleet (None = never assigned)."""
        with self._lock:
            return list(self._assigned)

    def scenario_of(self, fleet_id):
        with self._lock:
            return self._assigned[fleet_id]

    def _sample_spec(self, spec):
        """One seeded draw (``_push_lock`` held: the RNG has exactly
        one serialized consumer, keeping the documented deterministic
        draw sequence)."""
        t0 = time.perf_counter()
        params = spec.sample(self._rng)
        self.counters.incr("scenario_samples")
        self.timer.add("scenario_sample", time.perf_counter() - t0)
        return params

    def assign(self, fleet_id, scenario):
        """Assign ``scenario`` to every env of ``fleet_id`` and push a
        fresh sampled param dict to each.  Returns the number of envs
        the push reached (a dead producer is counted and skipped, never
        blocked on).  The sends run outside the state lock: an actor
        thread reading ``scenario_of``/``note_info`` never waits
        behind a reassignment's network round."""
        spec = self.catalog.get(scenario)  # raises on unknown names
        with self._push_lock:
            with self._lock:
                if self._closed:
                    return 0
                self._assigned[fleet_id] = spec.name
                self._confirmed[fleet_id] = False
                n_envs = len(self._fleets[fleet_id])
            delivered = 0
            for i in range(n_envs):
                params = self._sample_spec(spec)
                if self._push(fleet_id, i, params):
                    delivered += 1
            return delivered

    def _push(self, f, i, params):
        """One bounded duplex send; True when the frame was queued to a
        live peer.  zmq.Again (dead/stalled producer past the HWM) is a
        counted failure — the caller's thread NEVER wedges here."""
        import zmq

        t0 = time.perf_counter()
        try:
            chan = self._channel(f, i)
            chan.send(cmd=PUSH_CMD, scenario=params.get("scenario"),
                      params=params)
        except zmq.Again:
            self.counters.incr("scenario_push_failures")
            self.timer.add("scenario_push", time.perf_counter() - t0)
            logger.warning(
                "scenario push to fleet %d env %d timed out "
                "(producer dead or stalled); continuing", f, i,
            )
            return False
        except zmq.ZMQError as exc:
            self.counters.incr("scenario_push_failures")
            self.timer.add("scenario_push", time.perf_counter() - t0)
            logger.warning(
                "scenario push to fleet %d env %d failed (%s)", f, i, exc,
            )
            return False
        self.counters.incr("scenario_pushes")
        self.timer.add("scenario_push", time.perf_counter() - t0)
        return True

    def apply_assignment(self, assignment):
        """Drive a full per-fleet assignment (the curriculum's output):
        only fleets whose scenario CHANGED are pushed.  Returns the list
        of fleet ids that changed."""
        if len(assignment) != self.num_fleets:
            raise ValueError(
                f"assignment names {len(assignment)} fleets, randomizer "
                f"has {self.num_fleets}"
            )
        changed = []
        for f, name in enumerate(assignment):
            if name is None or name == self.scenario_of(f):
                continue
            self.assign(f, name)
            changed.append(f)
        return changed

    def reassign(self, fleet_id, env_index):
        """Re-push the fleet's current scenario to ONE env — the
        respawn/re-admission path (the new producer incarnation starts
        with its launch scene; its scenario must follow it).  Over the
        env's existing channel, which ZMQ has reconnected to the new
        incarnation (module docstring).  No-op for a never-assigned
        fleet."""
        with self._lock:
            name = self._assigned[fleet_id]
        if name is None:
            return False
        spec = self.catalog.get(name)
        with self._push_lock:
            params = self._sample_spec(spec)
            ok = self._push(fleet_id, env_index, params)
        self.counters.incr("scenario_reassignments")
        with self._lock:
            self._confirmed[fleet_id] = False
        return ok

    def maybe_resample(self, fleet_id):
        """Per-K-steps randomization: called once per fleet step, pushes
        a fresh draw of the CURRENT scenario every ``resample_every``
        calls.  Inert when ``resample_every`` is None."""
        if self.resample_every is None:
            return False
        with self._lock:
            self._step_ticks[fleet_id] += 1
            due = self._step_ticks[fleet_id] % self.resample_every == 0
            name = self._assigned[fleet_id]
        if not due or name is None:
            return False
        spec = self.catalog.get(name)
        with self._push_lock:
            for i in range(len(self._fleets[fleet_id])):
                self._push(fleet_id, i, self._sample_spec(spec))
        return True

    def note_info(self, fleet_id, info):
        """Confirmation hook: the first data-plane transition stamped
        with the fleet's newly-pushed scenario closes the push loop
        (``scenario_applies``).  Cheap enough to call per transition."""
        sid = info.get("scenario")
        if sid is None:
            return
        with self._lock:
            if not self._confirmed[fleet_id] \
                    and sid == self._assigned[fleet_id]:
                self._confirmed[fleet_id] = True
                self.counters.incr("scenario_applies")

    def stats(self):
        """One scenario-plane snapshot: assignments, confirmations,
        and the push/sample stage timings."""
        with self._lock:
            return {
                "num_fleets": self.num_fleets,
                "assignments": list(self._assigned),
                "confirmed": list(self._confirmed),
                "scenarios": self.catalog.names(),
                "stages": self.timer.summary(),
            }

    def close(self):
        # the push lock first: an in-flight push finishes (bounded by
        # its timeout) before its channel is closed under it
        with self._push_lock:
            with self._lock:
                self._closed = True
                chans, self._chans = self._chans, {}
            for chan in chans.values():
                try:
                    chan.close()
                except Exception:  # noqa: BLE001 - teardown best-effort
                    pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
