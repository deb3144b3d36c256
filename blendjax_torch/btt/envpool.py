"""Vectorized remote environments, a copy of ``blendjax.btt.envpool``.

``EnvPool`` drives N Blender env instances in lockstep and exposes batched,
numpy-collated ``reset()``/``step(actions)`` whose outputs feed a policy on
the card: stack of obs in, vector of actions out.  RPCs are pipelined
(send to all, then receive from all) so the wall-clock cost per pool step
is one frame of the slowest instance, not the sum.

``step`` auto-resets finished instances by default: an instance reporting
``done`` is sent ``reset`` on the *next* step and contributes its fresh
initial observation (its reward is 0 and done False for that transition),
the standard vectorized-env contract, so rollouts keep static shapes.

Fault tolerance: exchanges run under a
:class:`blendjax_torch.btt.faults.FaultPolicy` (retries with backoff,
per-call deadline, per-env circuit breaker).  With ``quarantine=True``
(default) an env that exhausts its retries is *quarantined* instead of
failing the whole batched step: it stops receiving RPCs, contributes a
synthetic transition (last known observation, zero reward, ``done=True``
exactly once so trainers close the episode), and is flagged in the
``healthy`` mask and per-env infos.  Training continues on the N-1 live
envs.  Quarantined envs are probed at each ``step`` (or by a caller's
thread through :meth:`EnvPool.probe`) with a fresh socket and a ``reset``
resync handshake; on success the env re-enters the pool through the
autoreset contract (fresh initial obs, zero reward).  Only when *every*
env is quarantined does ``step`` raise.

Async pipelined stepping: ``step()`` is lock-step, every call pays a full
fan-out round trip plus the slowest env's physics before any learner
compute runs.  The ``step_async(actions)`` / ``step_wait(min_ready=k)``
pair overlaps the two instead: requests ride DEALER sockets
(empty-delimiter framing, so the producers' REP sockets serve them
unmodified) with per-request correlation ids (``wire.BTMID_KEY``), up to
``pipeline_depth`` requests in flight per env, and ``step_wait`` returns
the first ``k`` completed transitions *with their env indices* instead of
blocking on stragglers.  The fault machinery covers the pipeline:
in-flight requests age against the policy deadline (retry -> re-send under
the same correlation id, which the producer agent dedupes -> quarantine),
a quarantine mid-flight turns that env's outstanding requests into
synthetic transitions (the first carrying the episode-closing
``done=True``) without touching survivors, and re-admission resyncs the
pipeline depth from zero.

:class:`~blendjax_torch.btt.supervise.FleetSupervisor` ties the pool to
a :class:`~blendjax_torch.btt.watchdog.FleetWatchdog`: on a producer's
death it calls :meth:`EnvPool.quarantine_env`, on its respawn
:meth:`EnvPool.notify_respawn`, and its heal thread drives
:meth:`EnvPool.probe` until the env is re-admitted.  Without a
supervisor, a relaunched producer on the same address is re-admitted by
the step's probes alone.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from contextlib import contextmanager

import numpy as np
import zmq

from blendjax_torch import wire
from blendjax_torch.btt.collate import collate
from blendjax_torch.btt.constants import DEFAULT_TIMEOUTMS
from blendjax_torch.btt.env import kwargs_to_cli
from blendjax_torch.btt.faults import FaultPolicy
from blendjax_torch.obs.flight import flight_recorder
from blendjax_torch.obs.spans import SpanRecorder, make_span, now_us
from blendjax_torch.utils.timing import fleet_counters

logger = logging.getLogger("blendjax_torch")


def _zero_like(obs):
    """Type/shape-preserving zero observation for a quarantined env that
    never delivered one (keeps batch collation static-shaped)."""
    if isinstance(obs, np.ndarray):
        return np.zeros_like(obs)
    if isinstance(obs, dict):
        return {k: _zero_like(v) for k, v in obs.items()}
    if isinstance(obs, (list, tuple)):
        seq = [_zero_like(v) for v in obs]
        return seq if isinstance(obs, list) else tuple(seq)
    if isinstance(obs, bool):
        return False
    if isinstance(obs, (int, float, complex, np.number)):
        return type(obs)(0)
    return obs


def _empty_batch_like(obs):
    """Zero-row batch matching ``collate``'s layout for samples shaped
    like ``obs``, so a timeout-expiry ``step_wait`` return concatenates
    cleanly with non-empty batches."""
    if isinstance(obs, np.ndarray):
        return np.empty((0,) + obs.shape, obs.dtype)
    if isinstance(obs, dict):
        return {k: _empty_batch_like(v) for k, v in obs.items()}
    if isinstance(obs, (list, tuple)):
        seq = [_empty_batch_like(v) for v in obs]
        return seq if isinstance(obs, list) else tuple(seq)
    if isinstance(obs, bool):
        return np.empty((0,), bool)
    if isinstance(obs, (int, float, complex, np.number)):
        return np.empty((0,), np.asarray(obs).dtype)
    return []


class EnvPool:
    """Batched client for N remote Blender environments.

    Params
    ------
    addresses: list[str]
        GYM endpoints, one per instance (e.g.
        ``launch_info.addresses['GYM']``).
    timeoutms: int
        Per-socket receive timeout (per-attempt wait when the fault
        policy sets no ``deadline_s``).
    autoreset: bool
        Auto-reset finished instances during ``step``.
    fault_policy: FaultPolicy | None
        Retry/backoff/circuit policy for exchanges and re-admission
        probes; None installs the default :class:`FaultPolicy`.  Pass
        ``FaultPolicy(max_retries=0)`` for strict single-attempt
        semantics (retrying ``step`` against a slow-but-alive env can
        advance it an extra frame; see :mod:`blendjax_torch.btt.faults`).
    quarantine: bool
        Degraded mode: isolate failing envs and keep stepping the rest
        (see module docstring).  False restores fail-whole-batch:
        any env exhausting its retries raises ``TimeoutError`` naming it
        (successful siblings' ``env_times`` are committed first, so a
        partial exchange never desyncs the survivors).
    counters: EventCounters | None
        Fault-event sink; defaults to the process-wide
        ``blendjax_torch.utils.timing.fleet_counters``.
    pipeline_depth: int
        Maximum requests in flight per env on the async
        ``step_async``/``step_wait`` path (>= 1).  Lock-step ``step()``
        ignores it.
    trace: bool
        Record cross-process trace spans: every RPC gets a client-side
        span in :attr:`spans` tagged with its ``wire.BTMID_KEY``
        correlation id, requests carry a span context, and
        producer-side spans piggybacked on replies are ingested into
        the same recorder.  Off by default (zero per-RPC cost).
    span_recorder: SpanRecorder | None
        Share a recorder across components (implies ``trace=True``).
    """

    def __init__(
        self,
        addresses,
        timeoutms=DEFAULT_TIMEOUTMS,
        autoreset=True,
        fault_policy=None,
        quarantine=True,
        counters=None,
        pipeline_depth=1,
        trace=False,
        span_recorder=None,
    ):
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if pipeline_depth > wire.REPLY_CACHE_DEPTH:
            # beyond the producer's dedupe window, a retried oldest
            # in-flight request can no longer be answered from its reply
            # cache — the frame would silently be simulated twice
            raise ValueError(
                f"pipeline_depth {pipeline_depth} exceeds the producer "
                f"reply-cache window ({wire.REPLY_CACHE_DEPTH}): retries "
                "could double-apply a non-idempotent step"
            )
        self._ctx = zmq.Context.instance()
        self._addresses = list(addresses)
        self._timeoutms = timeoutms
        self.sockets = [self._connect(a) for a in self._addresses]
        self.num_envs = len(self._addresses)
        self.env_times = [None] * self.num_envs
        self._needs_reset = np.ones(self.num_envs, dtype=bool)
        self.autoreset = autoreset
        self.quarantine = quarantine
        self.policy = fault_policy if fault_policy is not None else FaultPolicy()
        self.counters = counters if counters is not None else fleet_counters
        #: cross-process span sink (None = tracing off); producers'
        #: piggybacked spans land here next to the client-side ones
        self.spans = (
            span_recorder if span_recorder is not None
            else (SpanRecorder() if trace else None)
        )
        # quarantine state; _lock guards every transition (step runs on the
        # training thread, probes may run from a supervisor thread)
        self._lock = threading.RLock()
        self._exchanging = set()  # envs whose sockets a step/reset is using
        self._quarantined = np.zeros(self.num_envs, dtype=bool)
        self._states = [self.policy.new_state(i) for i in range(self.num_envs)]
        self._probe = [None] * self.num_envs  # per-env re-admission attempt
        self._fresh = [None] * self.num_envs  # unconsumed resync reset reply
        self._pending_done = set()  # envs owing their one quarantine done=True
        self._last_obs = [None] * self.num_envs
        # async pipeline state (step_async/step_wait).  DEALER channels are
        # dialed lazily — a pool that only ever uses lock-step step() never
        # opens them.  _dealer_stale marks channels that must be re-dialed
        # before reuse (set by quarantine from any thread; acted on only by
        # the async caller's thread, which owns the sockets).
        self.pipeline_depth = int(pipeline_depth)
        self._dealers = [None] * self.num_envs
        self._dealer_stale = [False] * self.num_envs
        # None until the env's first async reply; then whether the
        # producer echoes wire.BTMID_KEY.  Non-echoing (legacy) producers
        # fall back to FIFO reply matching, which a retry re-send would
        # corrupt (two mid-less replies for one record) — the aging pass
        # escalates their timeouts to failure instead of retrying
        self._mid_echo = [None] * self.num_envs
        self._inflight = [deque() for _ in range(self.num_envs)]
        self._ready = deque()  # completed transitions, completion order

    def _connect(self, addr):
        s = self._ctx.socket(zmq.REQ)
        s.setsockopt(zmq.LINGER, 0)
        s.setsockopt(zmq.SNDTIMEO, self._timeoutms * 10)
        s.setsockopt(zmq.RCVTIMEO, self._timeoutms)
        s.setsockopt(zmq.REQ_RELAXED, 1)
        s.setsockopt(zmq.REQ_CORRELATE, 1)
        s.connect(addr)
        return s

    def _dealer_socket(self, i):
        """The async channel for env ``i`` (lock held).  Re-dialed when
        stale — a quarantine marks the channel dirty so replies belonging
        to the pre-quarantine pipeline can never poison the re-admitted
        env; only the async caller's thread (which owns the sockets)
        actually closes/re-dials, keeping zmq single-threaded."""
        s = self._dealers[i]
        if s is None or self._dealer_stale[i]:
            if s is not None:
                s.close(0)
            s = self._ctx.socket(zmq.DEALER)
            # no SNDTIMEO/RCVTIMEO: every dealer send/recv is non-blocking
            # (DONTWAIT + Poller), so socket timeouts would be inert
            s.setsockopt(zmq.LINGER, 0)
            s.connect(self._addresses[i])
            self._dealers[i] = s
            self._dealer_stale[i] = False
        return s

    # -- health surface -----------------------------------------------------

    @property
    def healthy(self):
        """Boolean mask, True for envs currently serving real transitions."""
        with self._lock:
            return ~self._quarantined.copy()

    @property
    def quarantined(self):
        with self._lock:
            return self._quarantined.copy()

    @property
    def inflight(self):
        """Per-env count of async requests currently in flight."""
        with self._lock:
            return [len(dq) for dq in self._inflight]

    # -- pipelined RPC ------------------------------------------------------

    def _recv_wait_ms(self):
        """Per-attempt recv wait: the policy deadline when set (so one
        slow env cannot eat the whole socket timeout per attempt), else
        the socket timeout."""
        if self.policy.deadline_s is not None:
            return max(1, int(self.policy.deadline_s * 1000))
        return self._timeoutms

    def _exchange(self, requests, indices=None):
        """Pipelined exchange over env ``indices`` (default: all).

        Sends every request, then collects replies; an env that fails its
        send or exhausts its recv retries lands in ``failed`` instead of
        aborting the exchange, and every *successful* reply commits its
        ``env_times`` entry regardless of sibling failures (a partial
        exchange must never desync the survivors).

        Returns ``(replies, failed)``: ``replies`` maps env index to its
        reply dict, ``failed`` maps env index to the error string.
        """
        if indices is None:
            indices = list(range(self.num_envs))
        # socket mutual exclusion with the probe machinery, both ways: an
        # env quarantined between the caller's snapshot and this point may
        # have a probe mid-flight on its (re-dialed) socket, and a probe
        # must never touch a socket this exchange is using.  Quarantined /
        # busy-probed envs are failed up front without an RPC.
        with self._lock:
            blocked = {
                i for i in indices
                if self._quarantined[i]
                or (self._probe[i] is not None and self._probe[i].get("busy"))
            }
            self._exchanging = set(indices) - blocked
        try:
            return self._exchange_locked_out(requests, indices, blocked)
        finally:
            with self._lock:
                self._exchanging = set()

    def _exchange_locked_out(self, requests, indices, blocked=()):
        reqs = dict(zip(indices, requests))
        # stamp once per logical call: a policy-driven re-send below
        # carries the SAME id, so a producer that already
        # simulated the frame re-serves its cached reply instead of
        # stepping twice (the id is echoed in the reply and popped on
        # receive, so lock-step results stay bit-identical)
        for req in reqs.values():
            mid = wire.stamp_message_id(req)
            if self.spans is not None:
                wire.stamp_span_context(req, mid)
        t0_us = {}  # per-env client-span start (tracing only)
        replies, failed = {}, {}
        awaiting = []
        for i in indices:
            if i in blocked:
                failed[i] = f"environment {i} is quarantined"
                continue
            if self._states[i].circuit_open():
                # the breaker protects strict-mode pools too: a dead env
                # stops costing (max_retries+1) recv waits per step
                self.counters.incr("circuit_rejections")
                failed[i] = (
                    f"environment {i} circuit open after "
                    f"{self._states[i].consecutive_failures} consecutive "
                    "failures"
                )
                continue
            if self.spans is not None:
                # BEFORE the send: the producer stamps its span at
                # request receipt, which can precede this thread's next
                # instruction once the zmq enqueue is out — a t0 taken
                # after the send would let the producer span escape its
                # enclosing client span
                t0_us[i] = now_us()
            try:
                wire.send_message(self.sockets[i], reqs[i])
                awaiting.append(i)
            except zmq.Again:
                self.counters.incr("timeouts")
                self._states[i].record_failure(self.counters)
                failed[i] = f"send to environment {i} timed out"
        # recv phase: one poller over every awaiting socket, in rounds —
        # attempt r waits at most one recv budget for ALL still-pending
        # envs together, so K simultaneously dead envs stall a step for
        # ~(max_retries+1) recv waits total, not K times that
        wait_ms = self._recv_wait_ms()
        pending = set(awaiting)
        poller = zmq.Poller()
        for i in pending:
            poller.register(self.sockets[i], zmq.POLLIN)
        for attempt in range(self.policy.max_retries + 1):
            deadline = time.monotonic() + wait_ms / 1e3
            while pending:
                remaining_ms = int((deadline - time.monotonic()) * 1000)
                if remaining_ms <= 0:
                    break
                events = dict(poller.poll(remaining_ms))
                if not events:
                    break
                for i in list(pending):
                    sock = self.sockets[i]
                    if not (events.get(sock, 0) & zmq.POLLIN):
                        continue
                    try:
                        ddict = wire.recv_message(sock)
                    except Exception:
                        # a garbled/unpicklable reply is an env fault,
                        # not a pool crash: discard it and let the retry
                        # / quarantine machinery handle the env
                        logger.warning(
                            "env %d: malformed reply discarded", i,
                            exc_info=True,
                        )
                        continue
                    piggyback = wire.pop_spans(ddict)
                    ddict.pop(wire.BTMID_KEY, None)
                    if self.spans is not None:
                        self.spans.ingest(piggyback)
                        self.spans.record(make_span(
                            "env_rpc", t0_us.get(i, now_us()),
                            trace=reqs[i].get(wire.BTMID_KEY),
                            cat="envpool", args={"env": i},
                        ))
                    self.env_times[i] = ddict.get("time")
                    self._states[i].record_success()
                    replies[i] = ddict
                    poller.unregister(sock)
                    pending.discard(i)
            if not pending:
                break
            for i in pending:
                self.counters.incr("timeouts")
                self._states[i].record_failure(self.counters)
            if attempt >= self.policy.max_retries:
                for i in pending:
                    self.counters.incr("failures")
                    failed[i] = (
                        f"no response from environment {i} within timeout"
                    )
                break
            # one shared backoff per round (the slowest of the pending
            # envs' jittered delays), then re-send to all of them —
            # REQ_RELAXED allows it, REQ_CORRELATE drops the stale reply
            self.counters.incr("retries", len(pending))
            delay = max(
                self._states[i].backoff(attempt + 1) for i in pending
            )
            if delay > 0:
                time.sleep(delay)
            for i in list(pending):
                try:
                    wire.send_message(self.sockets[i], reqs[i])
                except zmq.Again:
                    self.counters.incr("failures")
                    failed[i] = f"send to environment {i} timed out"
                    poller.unregister(self.sockets[i])
                    pending.discard(i)
        return replies, failed

    def _fail_or_quarantine(self, failed):
        """Route exchange failures: quarantine mode isolates each failed
        env; strict mode raises (after the successes were committed)."""
        if not failed:
            return
        if not self.quarantine:
            raise TimeoutError("; ".join(failed.values()))
        for i, reason in failed.items():
            self.quarantine_env(i, reason=reason)

    # -- quarantine & re-admission ------------------------------------------

    def quarantine_env(self, i, reason="unresponsive"):
        """Isolate env ``i``: no more RPCs until a probe re-admits it.
        Idempotent; safe from any thread (the supervisor calls this
        proactively on producer death, ahead of any timeout).

        A quarantine mid-flight drains the env's async pipeline: every
        outstanding request it owed a transition for becomes a synthetic
        ready transition (the first carrying the episode's one
        ``done=True``), and the DEALER channel is marked stale so its
        possible late replies are orphaned rather than delivered to the
        re-admitted incarnation."""
        with self._lock:
            if self._quarantined[i]:
                return
            self._quarantined[i] = True
            self._pending_done.add(i)
            self._fresh[i] = None
            self._probe[i] = {"active": False, "sent": False, "started": 0.0,
                              "attempts": 0, "next_at": 0.0}
            self.counters.incr("quarantines")
            owed = sum(1 for r in self._inflight[i] if not r["discard"])
            if self._inflight[i]:
                self.counters.incr("inflight_discards", len(self._inflight[i]))
                self._inflight[i].clear()
                self._dealer_stale[i] = True
            for _ in range(owed):
                self._ready.append(self._synthetic_ready_locked(i))
        flight_recorder.note("quarantine", target=f"env{i}", reason=reason)
        logger.warning("env %d quarantined: %s", i, reason)

    def notify_respawn(self, i):
        """The producer behind env ``i`` was restarted: drop the backoff
        and circuit state so the next probe runs immediately on a fresh
        socket (a supervisor calls it after it respawned the producer)."""
        with self._lock:
            if not self._quarantined[i]:
                return
            self._states[i] = self.policy.new_state(i)
            p = self._probe[i]
            if p is not None and p.get("busy"):
                # a probe is mid-flight on this env's socket from another
                # thread: don't replace its attempt record (a fresh one
                # would let a second probe redial — and close — the
                # socket in use); just clear the backoff so the next
                # attempt after it resolves runs immediately
                p.update(next_at=0.0, attempts=0)
            else:
                self._probe[i] = {"active": False, "sent": False,
                                  "started": 0.0, "attempts": 0,
                                  "next_at": 0.0}

    def probe(self, block_ms=0):
        """Attempt re-admission of quarantined envs (backoff/circuit
        gated).  Each attempt is a three-phase async handshake spread over
        successive calls — dial a fresh socket, send a ``reset`` resync
        once the connection is writable, collect the fresh initial
        observation — so ``block_ms=0`` (the in-``step`` mode) never
        blocks the training loop; positive ``block_ms`` bounds each wait
        (supervisor heal loop).  An attempt that exceeds the policy
        deadline fails, feeds the circuit breaker, and backs off.
        Returns the list of env indices re-admitted by this call."""
        readmitted = []
        deadline_s = (
            self.policy.deadline_s
            if self.policy.deadline_s is not None
            else self._timeoutms / 1e3
        )
        # phase 1 (locked, non-blocking): pick due probes, dial fresh
        # sockets, and mark each one busy so concurrent probe callers
        # (training step vs supervisor heal thread) never share a socket
        work = []
        with self._lock:
            if not self.sockets:
                return readmitted  # pool closed (a heal tick may race it)
            now = time.monotonic()
            for i in np.flatnonzero(self._quarantined):
                i = int(i)
                st, p = self._states[i], self._probe[i]
                if p is None or p.get("busy") or i in self._exchanging:
                    continue
                if st.circuit_open(now) or now < p["next_at"]:
                    continue
                if not p.get("active"):
                    # reconnect: a fresh REQ drops any half-done request
                    # cycle and re-dials the (possibly re-bound) endpoint
                    self.sockets[i].close(0)
                    self.sockets[i] = self._connect(self._addresses[i])
                    p.update(active=True, sent=False, started=now)
                p["busy"] = True
                work.append((i, self.sockets[i], p))
        # phase 2 (unlocked): the blocking polls — a dead endpoint must
        # not starve step()/reset() of the pool lock while we wait on it
        for i, sock, p in work:
            reply, malformed = None, False
            try:
                if not p["sent"] and sock.poll(block_ms, zmq.POLLOUT):
                    try:
                        wire.send_message(
                            sock, {"cmd": "reset", "time": None},
                            flags=zmq.NOBLOCK,
                        )
                        p["sent"] = True
                    except zmq.Again:
                        pass  # connection raced away; retry within deadline
                if p["sent"] and sock.poll(block_ms, zmq.POLLIN):
                    try:
                        reply = wire.recv_message(sock)
                    except Exception:
                        malformed = True
                        logger.warning(
                            "env %d: malformed resync reply discarded", i,
                            exc_info=True,
                        )
            finally:
                # phase 3 (locked): apply the outcome
                with self._lock:
                    p["busy"] = False
                    if reply is not None and self._quarantined[i]:
                        self.env_times[i] = reply.get("time")
                        self._fresh[i] = reply
                        self._quarantined[i] = False
                        self._needs_reset[i] = False
                        self._probe[i] = None
                        # an unsurfaced quarantine done stays pending:
                        # step() emits the interrupted episode's terminal
                        # transition before consuming the resync obs
                        self._states[i].record_success()
                        self.counters.incr("readmissions")
                        readmitted.append(i)
                        flight_recorder.note(
                            "readmission", target=f"env{i}"
                        )
                        logger.warning("env %d re-admitted after resync", i)
                    elif malformed or (
                        time.monotonic() - p["started"] >= deadline_s
                    ):
                        self.counters.incr("timeouts")
                        self._probe_failed(i, time.monotonic())
        return readmitted

    def _probe_failed(self, i, now):
        """One re-admission attempt failed: back off (policy jitter) and
        schedule a fresh-socket retry; consecutive failures feed the
        circuit breaker so a permanently-dead endpoint stops being dialed
        every step."""
        p = self._probe[i]
        p["attempts"] += 1
        p["active"] = False
        self._states[i].record_failure(self.counters)
        p["next_at"] = now + self._states[i].backoff(p["attempts"])

    # -- batched API --------------------------------------------------------

    def reset(self):
        """Reset all live instances; returns ``(batched_obs, infos)``.

        Quarantined envs contribute their last known (or zero) observation
        with ``info['healthy'] = False``; they rejoin via the re-admission
        handshake, which itself performs a ``reset``.  Raises when every
        env is quarantined.

        An explicit reset supersedes any async pipeline in progress: all
        in-flight requests and uncollected ready transitions are
        discarded and the DEALER channels marked for re-dial.
        """
        self.probe(block_ms=0)
        with self._lock:
            self._fresh = [None] * self.num_envs  # superseded by this reset
            for i in range(self.num_envs):
                if self._inflight[i]:
                    self.counters.incr(
                        "inflight_discards", len(self._inflight[i])
                    )
                    self._inflight[i].clear()
                    self._dealer_stale[i] = True
            self._ready.clear()
            live = [i for i in range(self.num_envs) if not self._quarantined[i]]
        if not live:
            raise TimeoutError("all environments are quarantined")
        if not self.quarantine and len(live) < self.num_envs:
            # strict mode: a supervisor-quarantined env fails the call
            # instead of contributing a synthetic slot
            raise TimeoutError(
                "environment(s) "
                f"{[i for i in range(self.num_envs) if i not in live]} are "
                "quarantined (strict mode: no degraded batches)"
            )
        replies, failed = self._exchange(
            [{"cmd": "reset", "time": self.env_times[i]} for i in live],
            indices=live,
        )
        self._fail_or_quarantine(failed)
        if not replies:
            # the exchange in which the LAST live envs fail must raise,
            # not return an all-synthetic batch (which, before any env
            # ever delivered an obs, couldn't even be shaped correctly)
            raise TimeoutError(
                "all environments are quarantined: "
                + "; ".join(failed.values())
            )
        # commit every live obs BEFORE assembly so a quarantined slot can
        # synthesize a shape-matched placeholder even on the first batch
        for j, r in replies.items():
            self._last_obs[j] = r.pop("obs")
        obs, infos = [], []
        for i in range(self.num_envs):
            r = replies.get(i)
            if r is not None:
                self._needs_reset[i] = False
                # an explicit reset IS the episode boundary; any owed
                # quarantine done for this env is thereby delivered
                self._pending_done.discard(i)
                r.pop("rgb_array", None)
                r["healthy"] = True
                obs.append(self._last_obs[i])
            else:
                obs.append(self._synthetic_obs(i))
                r = {"healthy": False, "quarantined": True}
            infos.append(r)
        return collate(obs), infos

    def _readmission_entry_locked(self, i):
        """Arbitrate the re-admission race for env ``i`` (lock held) and
        return its completed transition, or ``None`` when no unconsumed
        resync reply is waiting.

        When re-admission won the race with the training loop, the
        interrupted episode's terminal transition (``done=True`` on the
        last real obs) must still surface exactly once — it is emitted
        NOW and the fresh resync obs stays held for the next
        consumption.  Otherwise the resync observation surfaces through
        the autoreset contract (``readmitted=True``, zero reward).  Both
        lock-step ``step()`` and ``step_async`` route re-admission
        through here so the race arbitration can never diverge between
        the two modes.
        """
        if self._fresh[i] is None or self._quarantined[i]:
            return None
        if i in self._pending_done:
            self._pending_done.discard(i)
            self._needs_reset[i] = False
            return {
                "env": i, "obs": self._synthetic_obs(i), "reward": 0.0,
                "done": True,
                "info": {"healthy": True, "quarantined": True,
                         "interrupted": True},
            }
        f = self._fresh[i]
        self._fresh[i] = None
        self._last_obs[i] = f.pop("obs")
        f.pop("rgb_array", None)
        f.pop(wire.BTMID_KEY, None)
        f.pop(wire.SPANS_KEY, None)
        f.update(healthy=True, readmitted=True)
        self._needs_reset[i] = False
        return {
            "env": i, "obs": self._last_obs[i], "reward": 0.0,
            "done": False, "info": f,
        }

    def step(self, actions):
        """Step all instances with a length-N batch of actions.

        Returns ``(obs, rewards, dones, infos)`` with obs collated and
        rewards/dones as float32/bool arrays.  With ``autoreset``,
        instances that reported done on the previous step are reset now.

        Under quarantine, isolated envs return synthetic transitions
        (``info['healthy'] = False``) and freshly re-admitted envs return
        their resync observation through the autoreset contract
        (``info['readmitted'] = True``, zero reward).
        """
        if len(actions) != self.num_envs:
            raise ValueError(f"expected {self.num_envs} actions, got {len(actions)}")
        if any(self._inflight) or self._ready:
            # the two modes share env_times/needs_reset state and must not
            # interleave: the producers' REP sockets fair-queue across the
            # REQ and DEALER connections, so a lock-step request could
            # overtake queued pipeline requests and desync the clocks
            raise RuntimeError(
                "lock-step step() called with async requests in flight; "
                "drain them with step_wait() (or reset()) first"
            )
        self.probe(block_ms=0)
        with self._lock:
            quarantined = self._quarantined.copy()
            # env -> completed re-admission transition (the fresh resync
            # obs, or the interrupted episode's owed terminal), consumed
            # ahead of the exchange exactly as the async path does
            pre = {}
            for i in range(self.num_envs):
                entry = self._readmission_entry_locked(i)
                if entry is not None:
                    pre[i] = entry
        if quarantined.all():
            raise TimeoutError("all environments are quarantined")
        if not self.quarantine and quarantined.any():
            # strict mode never serves synthetic transitions — a
            # supervisor (or caller) may still quarantine_env() on
            # producer death, and the strict caller opted to fail instead
            # of training on fabricated data
            raise TimeoutError(
                "environment(s) "
                f"{[int(i) for i in np.flatnonzero(quarantined)]} are "
                "quarantined (strict mode: no degraded batches)"
            )
        send_idx, requests = [], []
        for i, action in enumerate(actions):
            if quarantined[i] or i in pre:
                continue
            send_idx.append(i)
            if self.autoreset and self._needs_reset[i]:
                requests.append({"cmd": "reset", "time": self.env_times[i]})
            else:
                requests.append(
                    {"cmd": "step", "action": action, "time": self.env_times[i]}
                )
        replies, failed = self._exchange(requests, indices=send_idx)
        self._fail_or_quarantine(failed)
        if not replies and not pre:
            # every remaining live env failed in THIS call: raise rather
            # than hand back a batch with no real transition in it
            raise TimeoutError(
                "all environments are quarantined: "
                + "; ".join(failed.values())
            )
        with self._lock:
            quarantined = self._quarantined.copy()
            # an env owes its one quarantine done=True only while it is
            # actually served synthetically: a reply that raced the
            # quarantine keeps its real transition, and a slot being served
            # from `pre` this step emits its own bookkeeping — in every
            # excluded case the pending done survives and fires on that
            # env's next synthetic step instead of vanishing
            q_done = {
                i for i in self._pending_done
                if quarantined[i]
                and i not in replies
                and i not in pre
            }
            self._pending_done -= q_done

        # commit every live obs BEFORE assembly so a quarantined slot can
        # synthesize a shape-matched placeholder even on the first batch
        # (re-admission obs were committed by _readmission_entry_locked)
        for j, r in replies.items():
            self._last_obs[j] = r.pop("obs")
        obs, rewards, dones, infos = [], [], [], []
        for i in range(self.num_envs):
            r = replies.get(i)
            if i in pre:
                e = pre[i]
                obs.append(e["obs"])
                rewards.append(e["reward"])
                dones.append(e["done"])
                infos.append(e["info"])
            elif r is not None:
                was_reset = self.autoreset and self._needs_reset[i]
                obs.append(self._last_obs[i])
                rewards.append(0.0 if was_reset else float(r.pop("reward", 0.0)))
                done = False if was_reset else bool(r.pop("done", False))
                dones.append(done)
                self._needs_reset[i] = done
                r.pop("rgb_array", None)
                r["healthy"] = True
                infos.append(r)
            else:
                obs.append(self._synthetic_obs(i))
                rewards.append(0.0)
                dones.append(i in q_done)
                self._needs_reset[i] = False
                infos.append({"healthy": False, "quarantined": True})
        return (
            collate(obs),
            np.asarray(rewards, np.float32),
            np.asarray(dones, bool),
            infos,
        )

    # -- async pipelined API ------------------------------------------------
    #
    # step_async/step_wait overlap env physics with learner compute: a
    # producer with a queued request simulates its next frame while the
    # consumer is still processing the previous reply, so the steady-state
    # cost per transition is max(physics, consumer work) instead of
    # RTT + physics + consumer work.  The pair is single-consumer: call it
    # from one thread (quarantine/probe traffic from a supervisor thread
    # remains safe, as with lock-step step()).

    def step_async(self, actions, indices=None):
        """Submit one request per env without waiting for replies.

        Params
        ------
        actions:
            One action per target env.  Without ``indices``, must have
            length ``num_envs`` (one submission per env); with
            ``indices``, ``actions[j]`` goes to env ``indices[j]`` —
            repeating an index submits several requests to that env
            (bounded by ``pipeline_depth`` outstanding).
        indices: iterable[int] | None
            Target envs; the natural argument is the index array the
            previous ``step_wait`` returned, which keeps every env's
            pipeline at constant depth.

        Every submission eventually yields exactly one transition from
        ``step_wait``: live envs answer with real transitions;
        quarantined envs (and envs that fail mid-flight) yield synthetic
        ones; a freshly re-admitted env yields its resync observation
        through the autoreset contract.  ONE exception: requests already
        queued behind an episode's terminal ``done`` carry post-terminal
        frames and are consumed silently (counted in
        ``inflight_discards`` and reported as
        ``info['inflight_discarded']`` on the terminal transition) — a
        constant-depth caller should resubmit that many extra actions to
        the env to keep its pipeline full across episode boundaries.
        With ``autoreset``, an env whose last collected transition was
        ``done`` is sent ``reset`` instead of ``step``.  Raises
        ``TimeoutError`` when every env is quarantined (or, strict mode,
        when any is) and ``RuntimeError`` when an env's pipeline is
        already at ``pipeline_depth``.
        """
        if indices is None:
            if len(actions) != self.num_envs:
                raise ValueError(
                    f"expected {self.num_envs} actions, got {len(actions)}"
                )
            indices = range(self.num_envs)
        else:
            indices = [int(i) for i in indices]
            if len(actions) != len(indices):
                raise ValueError(
                    f"expected {len(indices)} actions for {len(indices)} "
                    f"indices, got {len(actions)}"
                )
        self.probe(block_ms=0)
        wait_s = self._recv_wait_ms() / 1e3
        failed = {}  # env -> reason (for quarantine/strict routing)
        failed_counts = {}  # env -> failed submissions (owed synthetics)
        with self._lock:
            if self._quarantined.all():
                raise TimeoutError("all environments are quarantined")
            if not self.quarantine and self._quarantined.any():
                raise TimeoutError(
                    "environment(s) "
                    f"{[int(i) for i in np.flatnonzero(self._quarantined)]} "
                    "are quarantined (strict mode: no degraded batches)"
                )
            for i, action in zip(indices, actions):
                entry = self._readmission_entry_locked(i)
                if entry is not None:
                    self._ready.append(entry)
                    continue
                if self._quarantined[i]:
                    self._ready.append(self._synthetic_ready_locked(i))
                    continue
                live = sum(
                    1 for r in self._inflight[i] if not r["discard"]
                )
                if live >= self.pipeline_depth:
                    raise RuntimeError(
                        f"environment {i} already has {live} requests in "
                        f"flight (pipeline_depth={self.pipeline_depth})"
                    )
                if len(self._inflight[i]) >= wire.REPLY_CACHE_DEPTH:
                    # discard-marked post-terminal frames still occupy
                    # the producer's dedupe window; outrunning it would
                    # let a retry double-simulate a frame
                    raise RuntimeError(
                        f"environment {i} has "
                        f"{len(self._inflight[i])} requests outstanding, "
                        f"the producer dedupe window "
                        f"(wire.REPLY_CACHE_DEPTH={wire.REPLY_CACHE_DEPTH});"
                        " collect transitions before resubmitting"
                    )
                if self._states[i].circuit_open():
                    self.counters.incr("circuit_rejections")
                    failed[i] = (
                        f"environment {i} circuit open after "
                        f"{self._states[i].consecutive_failures} consecutive "
                        "failures"
                    )
                    failed_counts[i] = failed_counts.get(i, 0) + 1
                    continue
                if self.autoreset and self._needs_reset[i]:
                    request = {"cmd": "reset", "time": self.env_times[i]}
                    # optimistic flip: a depth>1 caller submitting again
                    # before collecting must not queue a second reset
                    self._needs_reset[i] = False
                else:
                    request = {
                        "cmd": "step", "action": action,
                        "time": self.env_times[i],
                    }
                mid = wire.stamp_message_id(request)
                if self.spans is not None:
                    wire.stamp_span_context(request, mid)
                # span start BEFORE the send: the producer stamps its
                # span at receipt, which can precede our next
                # instruction once the zmq enqueue is out
                t0_us = now_us() if self.spans is not None else 0
                now = time.monotonic()
                try:
                    wire.send_message_dealer(
                        self._dealer_socket(i), request, flags=zmq.DONTWAIT
                    )
                except zmq.Again:
                    self.counters.incr("timeouts")
                    self._states[i].record_failure(self.counters)
                    failed[i] = f"send to environment {i} timed out"
                    failed_counts[i] = failed_counts.get(i, 0) + 1
                    continue
                self._inflight[i].append({
                    "mid": mid, "cmd": request["cmd"], "request": request,
                    "sent_at": now, "expires_at": now + wait_s,
                    "attempt": 0, "discard": False, "reply": None,
                    "t0_us": t0_us,
                })
        self._fail_or_quarantine(failed)  # strict mode raises here
        if failed_counts:
            # each failed submission still owes its transition — counted
            # per submission, since a repeated index can fail twice; the
            # quarantine above synthesized only previously-outstanding ones
            with self._lock:
                for i, n in failed_counts.items():
                    for _ in range(n):
                        self._ready.append(self._synthetic_ready_locked(i))

    def step_wait(self, min_ready=None, timeout_ms=None):
        """Collect completed transitions, ready-first.

        Blocks until at least ``min_ready`` transitions are available
        (default: every transition currently owed — full barrier), then
        returns ALL completed ones as ``(indices, obs, rewards, dones,
        infos)`` where ``indices`` maps each row to its env (an env at
        depth > 1 may contribute several rows, oldest first; per-env
        ordering is preserved).  ``min_ready`` is clamped to the number
        of transitions actually owed, so a partially-submitted pool can
        never deadlock.  ``timeout_ms`` bounds the wait: on expiry
        whatever is ready is returned (possibly zero rows).

        Failure semantics match ``step()``: an in-flight request that
        exhausts the policy's retries quarantines its env (the owed
        transitions arrive synthetically) or, with ``quarantine=False``,
        raises a ``TimeoutError`` naming it — already-completed
        transitions stay queued for the next ``step_wait``.
        """
        return self._assemble_ready(
            self._step_wait_entries(min_ready, timeout_ms)
        )

    def _step_wait_entries(self, min_ready, timeout_ms):
        """The ready-first collection loop; returns raw entry dicts."""
        deadline = (
            None if timeout_ms is None
            else time.monotonic() + timeout_ms / 1e3
        )
        wait_s = self._recv_wait_ms() / 1e3
        waited = False
        while True:
            with self._lock:
                pending = [
                    i for i in range(self.num_envs) if self._inflight[i]
                ]
                expected = len(self._ready) + sum(
                    1 for i in pending for r in self._inflight[i]
                    if not r["discard"]
                )
                target = (
                    expected if min_ready is None
                    else min(int(min_ready), expected)
                )
                # the full barrier also waits out discard-marked records
                # (post-terminal frames, no row owed): it must leave the
                # pool quiesced — step_wait() is lock-step step()'s
                # documented remedy, so it cannot strand replies in flight
                complete = (
                    not pending if min_ready is None
                    else len(self._ready) >= target
                )
                if complete:
                    out = list(self._ready)
                    self._ready.clear()
                    return out
                socks = {i: self._dealers[i] for i in pending
                         if self._dealers[i] is not None
                         and not self._dealer_stale[i]}
                # stashed-reply records are complete (held only for
                # in-order surfacing): never let their old deadlines zero
                # the poll budget.  Non-empty: a queue head is always
                # reply-less, else it would have surfaced.
                next_expiry = min(
                    r["expires_at"]
                    for i in pending for r in self._inflight[i]
                    if r.get("reply") is None
                )
            # fast path: drain replies already sitting in the zmq queues
            # (the steady pipelined state — producers run ahead of the
            # consumer) without paying for a Poller + poll syscall
            if self._drain_async_replies(socks):
                continue  # re-check the target before blocking
            if not waited:
                waited = True
                self.counters.incr("ready_waits")
            # poll outside the lock: a slow env must not starve the
            # supervisor's probe/quarantine machinery
            now = time.monotonic()
            budget_s = next_expiry - now
            if deadline is not None:
                budget_s = min(budget_s, deadline - now)
            # bounded park: a supervisor-thread quarantine_env() completes
            # owed transitions straight into _ready, and nothing on the
            # (dead) sockets would wake the poll — slice the wait so a
            # proactive quarantine surfaces within ~50 ms, not the full
            # recv budget
            budget_s = min(budget_s, 0.05)
            if socks and budget_s > 0:
                poller = zmq.Poller()
                for s in socks.values():
                    poller.register(s, zmq.POLLIN)
                if poller.poll(max(1, int(budget_s * 1000))):
                    self._drain_async_replies(socks)
            elif not socks:
                # every pending env's channel is stale (quarantined
                # mid-wait): loop back and let the bookkeeping settle
                time.sleep(0.001)
            # age the in-flight requests against the policy deadline
            now = time.monotonic()
            failed = {}
            with self._lock:
                for i in pending:
                    if self._quarantined[i]:
                        continue
                    for rec in list(self._inflight[i]):
                        if rec.get("reply") is not None:
                            continue  # complete, held for in-order surfacing
                        if rec["expires_at"] > now:
                            continue
                        self.counters.incr("timeouts")
                        self._states[i].record_failure(self.counters)
                        if (rec["attempt"] >= self.policy.max_retries
                                or self._mid_echo[i] is False):
                            # legacy producer (no correlation-id echo): a
                            # re-send would be simulated as a SECOND frame
                            # and its extra mid-less reply would shift the
                            # FIFO fallback matching off by one for every
                            # later transition — escalate instead of
                            # retrying
                            self.counters.incr("failures")
                            failed[i] = (
                                f"no response from environment {i} within "
                                "timeout"
                                + ("" if self._mid_echo[i] is not False else
                                   " (producer echoes no correlation id: "
                                   "retries unsafe on the pipelined path)")
                            )
                            break
                        rec["attempt"] += 1
                        self.counters.incr("retries")
                        try:
                            # same correlation id: a producer that already
                            # simulated the frame re-serves its cached
                            # reply instead of stepping twice
                            wire.send_message_dealer(
                                self._dealer_socket(i), rec["request"],
                                flags=zmq.DONTWAIT,
                            )
                        except zmq.Again:
                            self.counters.incr("failures")
                            failed[i] = f"send to environment {i} timed out"
                            break
                        rec["expires_at"] = (
                            now + wait_s
                            + self._states[i].backoff(rec["attempt"])
                        )
            self._fail_or_quarantine(failed)  # strict mode raises here
            if deadline is not None and time.monotonic() >= deadline:
                with self._lock:
                    out = list(self._ready)
                    self._ready.clear()
                return out

    def _drain_async_replies(self, socks):
        """NOBLOCK-receive every queued reply on ``socks``; returns the
        number of messages consumed (0 = nothing was waiting)."""
        drained = 0
        failed = {}
        for i, s in socks.items():
            while True:
                try:
                    ddict = wire.recv_message_dealer(s, flags=zmq.NOBLOCK)
                except zmq.Again:
                    break
                except Exception:
                    # a garbled/unpicklable reply is an env fault: let
                    # the deadline/retry machinery deal with the env
                    logger.warning(
                        "env %d: malformed reply discarded", i,
                        exc_info=True,
                    )
                    continue
                reason = self._process_async_reply(i, ddict)
                drained += 1
                if reason is not None:
                    failed[i] = reason
                    break
        self._fail_or_quarantine(failed)  # strict mode raises here
        return drained

    def step_wait_full(self, timeout_ms=None):
        """Barrier variant of :meth:`step_wait` shaped like ``step()``:
        waits for every owed transition and returns ``(obs, rewards,
        dones, infos)`` in env order, one row per env.  Requires each env
        to owe exactly one transition (the ``step_async(actions)``
        full-batch pattern); extra rows from a deeper pipeline stay
        queued for the next wait, and an env owing none raises."""
        entries = self._step_wait_entries(None, timeout_ms)
        first = {}
        leftover = []
        for entry in entries:
            if entry["env"] in first:
                leftover.append(entry)
            else:
                first[entry["env"]] = entry
        missing = [i for i in range(self.num_envs) if i not in first]
        if missing:
            # put everything back (original order) before failing: the
            # collected rows may include terminal transitions an env will
            # never re-emit
            with self._lock:
                for entry in reversed(entries):
                    self._ready.appendleft(entry)
                unsubmitted = [i for i in missing if not self._inflight[i]]
            if unsubmitted:
                raise RuntimeError(
                    "step_wait_full: no transition owed by env(s) "
                    f"{unsubmitted}; submit with step_async(actions) first"
                )
            # every missing env still has its request in flight: the
            # timeout_ms deadline expired, not an unsubmitted pool
            raise TimeoutError(
                f"step_wait_full: timed out waiting on env(s) {missing} "
                "(requests still in flight; collected rows requeued)"
            )
        if leftover:
            # deeper-pipeline extras go back to the ready queue, order kept
            with self._lock:
                for entry in reversed(leftover):
                    self._ready.appendleft(entry)
        ordered = [first[i] for i in range(self.num_envs)]
        return (
            collate([e["obs"] for e in ordered]),
            np.asarray([e["reward"] for e in ordered], np.float32),
            np.asarray([e["done"] for e in ordered], bool),
            [e["info"] for e in ordered],
        )

    def _process_async_reply(self, i, ddict):
        """Match a reply to its in-flight record, then surface completed
        records strictly in submission order.

        A reply that overtakes a lost older one (drop/garble chaos ate
        the older reply on the wire — a healthy DEALER<->REP channel is
        FIFO, so a gap means loss) is stashed on its record, the older
        requests are immediately re-sent under their original correlation
        ids (the producer's reply cache answers without simulating the
        frames twice), and everything surfaces once the head of the queue
        is complete — per-env ordering and the one-transition-per-
        submission invariant both hold through reply loss.

        Returns ``None``, or a failure-reason string when the env must
        be failed/quarantined by the caller (a producer revealed itself
        as non-echoing AFTER a retry already went out — the FIFO
        fallback can no longer attribute replies safely)."""
        mid = ddict.pop(wire.BTMID_KEY, None)
        piggyback = wire.pop_spans(ddict)
        with self._lock:
            dq = self._inflight[i]
            self._mid_echo[i] = mid is not None
            if mid is None:
                # legacy producer (no correlation echo): REP guarantees
                # per-connection FIFO, so the oldest record matches —
                # sound because the aging pass never re-sends to a
                # KNOWN non-echoing producer (no duplicate replies to
                # shift the matching)
                if any(r["attempt"] > 0 and r.get("reply") is None
                       for r in dq):
                    # ... but a re-send DID go out while echo support was
                    # still unknown (slow first reply): the producer may
                    # have simulated that frame twice, and its duplicate
                    # mid-less reply would land on the wrong record —
                    # attribution is unrecoverable, fail the env cleanly
                    # rather than deliver shifted transitions
                    self.counters.incr("failures")
                    return (
                        f"environment {i} echoes no correlation id but "
                        "was already retried: reply attribution "
                        "unrecoverable"
                    )
                rec = dq[0] if dq else None
            else:
                rec = next((r for r in dq if r["mid"] == mid), None)
            if rec is None or rec.get("reply") is not None:
                self.counters.incr("stale_replies")
                return None
            rec["reply"] = ddict
            if self.spans is not None:
                self.spans.ingest(piggyback)
                self.spans.record(make_span(
                    f"env_{rec['cmd']}", rec["t0_us"], trace=rec["mid"],
                    cat="envpool", args={"env": i},
                ))
            self._states[i].record_success()
            now = time.monotonic()
            wait_s = self._recv_wait_ms() / 1e3
            for r in dq:
                if r is rec:
                    break
                if r.get("reply") is not None:
                    continue
                # older request whose reply was lost: recover it now
                # instead of waiting out the deadline (budget permitting
                # — past it, the aging pass escalates to failure)
                if r["attempt"] >= self.policy.max_retries:
                    continue
                r["attempt"] += 1
                self.counters.incr("retries")
                try:
                    wire.send_message_dealer(
                        self._dealer_socket(i), r["request"],
                        flags=zmq.DONTWAIT,
                    )
                except zmq.Again:
                    continue  # aging pass will deal with it
                r["expires_at"] = (
                    now + wait_s + self._states[i].backoff(r["attempt"])
                )
            while dq and dq[0].get("reply") is not None:
                r = dq.popleft()
                reply = r["reply"]
                self.env_times[i] = reply.get("time")
                if r["discard"]:
                    continue  # post-done frame: consumed, never surfaced
                self._last_obs[i] = reply.pop("obs")
                reply.pop("rgb_array", None)
                if r["cmd"] == "reset":
                    reward, done = 0.0, False
                else:
                    reward = float(reply.pop("reward", 0.0))
                    done = bool(reply.pop("done", False))
                if done:
                    self._needs_reset[i] = True
                    # frames already queued behind the terminal one belong
                    # to the dead episode: consume their replies silently
                    # (they carry post-terminal state and extra dones).
                    # The count rides the terminal transition's info so a
                    # constant-depth caller can top up its resubmission —
                    # without it the env's pipeline shrinks by this many
                    # slots at every episode boundary.
                    dropped = 0
                    for rr in dq:
                        if not rr["discard"]:
                            rr["discard"] = True
                            dropped += 1
                            self.counters.incr("inflight_discards")
                    if dropped:
                        reply["inflight_discarded"] = dropped
                reply["healthy"] = True
                self._ready.append({
                    "env": i, "obs": self._last_obs[i], "reward": reward,
                    "done": done, "info": reply,
                })

    def _synthetic_ready_locked(self, i):
        """One synthetic transition for quarantined env ``i`` (lock
        held): mirrors the lock-step synthetic slot, including the
        exactly-once ``done``."""
        done = i in self._pending_done
        self._pending_done.discard(i)
        self._needs_reset[i] = False
        return {
            "env": i, "obs": self._synthetic_obs(i), "reward": 0.0,
            "done": done, "info": {"healthy": False, "quarantined": True},
        }

    def _assemble_ready(self, entries):
        idx = np.asarray([e["env"] for e in entries], dtype=np.intp)
        if not entries:
            template = next(
                (o for o in self._last_obs if o is not None), None
            )
            return (
                idx,
                _empty_batch_like(template) if template is not None
                else np.empty((0,), np.float32),
                np.empty((0,), np.float32),
                np.empty((0,), bool),
                [],
            )
        return (
            idx,
            collate([e["obs"] for e in entries]),
            np.asarray([e["reward"] for e in entries], np.float32),
            np.asarray([e["done"] for e in entries], bool),
            [e["info"] for e in entries],
        )

    def _synthetic_obs(self, i):
        """Placeholder observation for a quarantined slot: the env's last
        delivered obs, else a zero of any sibling's obs (static batch
        shape either way; live obs are committed to ``_last_obs`` before
        assembly, so a template exists from the very first batch).  The
        bare-0.0 fallback is only reachable when no env has ever
        delivered an observation."""
        if self._last_obs[i] is not None:
            return self._last_obs[i]
        for template in self._last_obs:
            if template is not None:
                return _zero_like(template)
        return 0.0

    def close(self):
        # detach the socket list first (new probes see a closed pool),
        # then wait out any probe mid-flight in its unlocked poll phase —
        # closing a zmq socket under another thread's poll is undefined
        # behavior, and probe phases are bounded by block_ms
        with self._lock:
            socks, self.sockets = self.sockets, []
            dealers, self._dealers = self._dealers, [None] * self.num_envs
            for dq in self._inflight:
                dq.clear()
            self._ready.clear()
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            with self._lock:
                if not any(p and p.get("busy") for p in self._probe):
                    break
            time.sleep(0.01)
        with self._lock:
            for s in socks:
                s.close(0)
            for s in dealers:
                if s is not None:
                    s.close(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


@contextmanager
def launch_env_pool(
    scene,
    script,
    num_instances,
    background=False,
    timeoutms=DEFAULT_TIMEOUTMS,
    autoreset=True,
    start_port=11000,
    fault_policy=None,
    quarantine=True,
    counters=None,
    pipeline_depth=1,
    trace=False,
    span_recorder=None,
    seed=None,
    **kwargs,
):
    """Launch N Blender env instances and yield a connected EnvPool.

    The pool analog of :func:`blendjax_torch.btt.env.launch_env`; extra
    kwargs become CLI flags for every instance's env script.
    ``start_port`` seeds the per-instance address allocation (pick a
    distinct base when several pools may run concurrently on one host);
    instance ``i`` gets ``-btseed seed + i`` (random when ``seed`` is
    None).
    """
    from blendjax_torch.btt.launcher import BlenderLauncher

    with BlenderLauncher(
        scene=scene,
        script=script,
        num_instances=num_instances,
        named_sockets=["GYM"],
        instance_args=[list(kwargs_to_cli(kwargs)) for _ in range(num_instances)],
        background=background,
        start_port=start_port,
        seed=seed,
    ) as bl:
        pool = EnvPool(
            bl.launch_info.addresses["GYM"],
            timeoutms=timeoutms,
            autoreset=autoreset,
            fault_policy=fault_policy,
            quarantine=quarantine,
            counters=counters,
            pipeline_depth=pipeline_depth,
            trace=trace,
            span_recorder=span_recorder,
        )
        try:
            yield pool
        finally:
            pool.close()
