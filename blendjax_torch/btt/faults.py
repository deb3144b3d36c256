"""Fault policy for fleet RPCs: retries, backoff, deadlines, circuit
breaking.  A copy of ``blendjax.btt.faults``.

:class:`FaultPolicy` describes how hard to try (attempts, exponential
backoff with deterministic jitter, an overall per-call deadline) and when
to stop trying (a circuit breaker that opens after K consecutive failures
and rejects calls until a cooldown elapses); :meth:`FaultPolicy.run`
executes any callable under those rules.

Consumers: :meth:`blendjax_torch.btt.env.RemoteEnv._reqrep` (one env) and
:class:`blendjax_torch.btt.envpool.EnvPool` (pipelined exchange and
quarantine probes).  Every retry, timeout and circuit event increments a
named counter in an :class:`blendjax_torch.utils.timing.EventCounters`
(the process-wide ``fleet_counters`` by default).

Determinism: jitter comes from a ``random.Random`` seeded per
:class:`FaultState` from ``(policy.seed, key)``, so two runs of the same
fault schedule produce the same backoff sequence.

Caveat for non-idempotent RPCs: a retry re-sends the request.  For
``reset`` and probe traffic that is idempotent; for ``step`` the re-send
carries the same correlation id (``wire.BTMID_KEY``: ``RemoteEnv`` stamps
it whenever a policy is attached, the pipelined ``EnvPool`` always), so a
producer-side :class:`~blendjax_torch.btb.env.RemoteControlledAgent` that
already simulated the frame re-serves its cached reply instead of stepping
twice.  Producers that ignore the id can advance one extra frame on a
retry; fleets of those should run ``FaultPolicy(max_retries=0)`` and rely
on quarantine and re-admission alone.
"""

from __future__ import annotations

import random
import time

from blendjax_torch.obs.flight import flight_recorder
from blendjax_torch.utils.timing import fleet_counters


class CircuitOpenError(TimeoutError):
    """Raised (without attempting the call) while a circuit is open.

    Subclasses :class:`TimeoutError` so callers treating timeouts as
    retriable-later handle circuit rejections the same way.
    """


class FaultState:
    """Mutable per-target state a :class:`FaultPolicy` operates on: the
    consecutive-failure count driving the circuit breaker, plus the
    deterministic jitter stream.  One state per remote target (per env of
    a pool, per ``RemoteEnv``); the policy itself stays immutable and
    shareable."""

    def __init__(self, policy, key=0):
        self.policy = policy
        self.consecutive_failures = 0
        self.open_until = 0.0  # monotonic time the circuit re-closes
        self._rng = random.Random((policy.seed, key).__hash__())

    def backoff(self, attempt):
        """Delay before retry ``attempt`` (1-based): exponential, capped,
        with deterministic multiplicative jitter."""
        p = self.policy
        base = min(p.backoff_max, p.backoff_base * (p.backoff_factor ** (attempt - 1)))
        if p.jitter <= 0:
            return base
        return base * (1.0 + self._rng.uniform(-p.jitter, p.jitter))

    def circuit_open(self, now=None):
        """True while calls should be rejected outright."""
        if self.open_until <= 0:
            return False
        now = self.policy._clock() if now is None else now
        return now < self.open_until

    def record_success(self):
        self.consecutive_failures = 0
        self.open_until = 0.0

    def record_failure(self, counters=None):
        """Count one failure; returns True when this failure opened the
        circuit."""
        self.consecutive_failures += 1
        p = self.policy
        if (
            p.circuit_threshold > 0
            and self.consecutive_failures >= p.circuit_threshold
            and not self.circuit_open()
        ):
            self.open_until = p._clock() + p.circuit_cooldown_s
            if counters is not None:
                counters.incr("circuit_opens")
            return True
        return False


class FaultPolicy:
    """How hard to retry a fleet RPC, and when to give up on a target.

    Params
    ------
    max_retries: int
        Retries after the first attempt (0 = single attempt).
    backoff_base / backoff_factor / backoff_max: float
        Retry ``n`` (1-based) sleeps ``base * factor**(n-1)`` seconds,
        capped at ``backoff_max``.
    jitter: float
        Multiplicative jitter fraction (0.25 = ±25%), drawn from the
        per-state deterministic RNG.
    deadline_s: float | None
        Overall wall-clock budget for one logical call including retries
        and backoff; also the per-attempt wait :class:`EnvPool` uses for
        its pipelined recv when set.  None defers to the caller's socket
        timeout.
    circuit_threshold: int
        Consecutive failures that open the circuit (0 disables).
    circuit_cooldown_s: float
        How long an open circuit rejects calls before allowing one
        half-open trial.
    seed: int
        Seeds the jitter stream (per-state, via ``(seed, key)``).
    """

    def __init__(
        self,
        max_retries=1,
        backoff_base=0.05,
        backoff_factor=2.0,
        backoff_max=2.0,
        jitter=0.25,
        deadline_s=None,
        circuit_threshold=5,
        circuit_cooldown_s=5.0,
        seed=0,
        _clock=time.monotonic,
    ):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_factor = backoff_factor
        self.backoff_max = backoff_max
        self.jitter = jitter
        self.deadline_s = deadline_s
        self.circuit_threshold = circuit_threshold
        self.circuit_cooldown_s = circuit_cooldown_s
        self.seed = seed
        self._clock = _clock  # injectable: a deterministic clock

    def new_state(self, key=0):
        return FaultState(self, key=key)

    def run(
        self,
        fn,
        state=None,
        counters=None,
        name="rpc",
        retryable=(TimeoutError,),
        sleep=time.sleep,
    ):
        """Execute ``fn(attempt)`` under this policy.

        ``fn`` is called with the 0-based attempt number; any exception in
        ``retryable`` triggers retry/backoff, anything else propagates
        immediately.  Raises the last retryable error when attempts (or
        the deadline) are exhausted, or :class:`CircuitOpenError` without
        calling ``fn`` while the state's circuit is open.
        """
        state = state or self.new_state()
        counters = fleet_counters if counters is None else counters
        now = self._clock()
        if state.circuit_open(now):
            counters.incr("circuit_rejections")
            raise CircuitOpenError(
                f"{name}: circuit open after "
                f"{state.consecutive_failures} consecutive failures "
                f"(cooldown {self.circuit_cooldown_s}s)"
            )
        deadline = None if self.deadline_s is None else now + self.deadline_s
        attempt = 0
        while True:
            try:
                result = fn(attempt)
            except retryable as exc:
                # flight-recorder annotations ride the failure path only
                # (retries already pay a backoff sleep), so the ring
                # costs nothing while the fleet is healthy
                if state.record_failure(counters):
                    flight_recorder.note(
                        "circuit_open", target=name,
                        consecutive_failures=state.consecutive_failures,
                        cooldown_s=self.circuit_cooldown_s,
                    )
                counters.incr("timeouts")
                out_of_budget = deadline is not None and (
                    self._clock() >= deadline
                )
                if attempt >= self.max_retries or out_of_budget:
                    counters.incr("failures")
                    flight_recorder.note(
                        "rpc_failure", target=name, attempts=attempt + 1,
                        error=f"{type(exc).__name__}: {exc}",
                    )
                    raise
                attempt += 1
                counters.incr("retries")
                flight_recorder.note(
                    "retry", target=name, attempt=attempt,
                    error=f"{type(exc).__name__}: {exc}",
                )
                delay = state.backoff(attempt)
                if deadline is not None:
                    delay = min(delay, max(0.0, deadline - self._clock()))
                if delay > 0:
                    sleep(delay)
                continue
            state.record_success()
            return result
