"""ServeClient: one episode's blocking RPC channel to a PolicyServer, the
port of ``blendjax.serve.client.ServeClient``.

It dials through a :class:`~blendjax_torch.btt.transport.RpcChannel`: a
DEALER socket speaking the empty-delimiter framing of
:mod:`blendjax_torch.wire`, upgraded to a same-host shared-memory ring
pair (ShmRPC, :mod:`blendjax_torch.btt.shm_rpc`) once the server has
answered and accepts (``shm="auto"``; ``shm=False`` or
``BJX_NO_SHM_RPC=1`` pins it to ZMQ).  Every RPC runs the exactly-once
discipline of :func:`blendjax_torch.btt.rpc.exactly_once_rpc`: a fresh
``wire.BTMID_KEY`` correlation id, retries under a
:class:`~blendjax_torch.btt.faults.FaultPolicy` that re-send the same id
(the server's reply cache answers it without a second decode), and replies
whose id does not match dropped as stale.  It talks to either package's
server::

    client = ServeClient("tcp://host:24000")
    slot = client.reset()            # admit an episode (KV-cache slot)
    for obs in episode:
        pred = client.step(obs)["pred"]
    client.close_episode()           # release the slot

Behind a :class:`~blendjax_torch.serve.gateway.ServeGateway` every reply
carries the serving ``replica`` (kept in :attr:`ServeClient.replica` and
named in transport-error text).  Behind a sharded gateway a reset reply
names the worker that owns the lease (``gw_worker``, ``gw_workers``) and
the client re-dials that worker directly; if the worker goes silent the
client falls back to the front, after a bounded, jittered backoff.  A step
against a restarted server raises ``RuntimeError`` naming the unknown
lease: call :meth:`~ServeClient.reset` and resume.
"""

from __future__ import annotations

import logging
import random
import time

import numpy as np

from blendjax_torch.btt.faults import FaultPolicy
from blendjax_torch.btt.rpc import ServeRPCError, exactly_once_rpc
from blendjax_torch.utils.timing import fleet_counters

__all__ = ["ServeClient", "ServeRPCError"]

logger = logging.getLogger("blendjax_torch")


class ServeClient:
    """Blocking exactly-once RPCs to one policy server (ROUTER/batched or
    REP/serial: the DEALER framing serves both)."""

    def __init__(self, address, *, fault_policy=None, counters=None, timeoutms=5000,
                 span_recorder=None, model=None, shm="auto", shm_chaos=None,
                 follow_redirects=True, fallback_backoff_s=0.05,
                 fallback_backoff_max_s=2.0):
        self.address = address
        #: the address the client was built with: against a sharded
        #: gateway, the front, where the client falls back when the worker
        #: it was handed to goes silent
        self._front_address = address
        #: follow a sharded front's ``gw_workers`` handoff; ``False`` pins
        #: every request to the constructed address (chaos proxies)
        self.follow_redirects = bool(follow_redirects)
        self.policy = fault_policy or FaultPolicy()
        self.state = self.policy.new_state()
        self.counters = counters if counters is not None else fleet_counters
        self.timeoutms = int(timeoutms)
        self.slot = None  # the live episode's slot after reset()
        self.episode = None  # ... and its lease id
        #: model id this client's episodes run on (None: the default)
        self.model = model
        #: the replica that served the last reply (stamped by a gateway)
        self.replica = None
        #: the sharded gateway's worker that served the last reply
        self.gw_worker = None
        #: cross-process span sink (None: tracing off)
        self.spans = span_recorder
        #: the weight version of the last reply that carried one (a server
        #: subscribed to a WeightBus stamps every reply once it adopted a
        #: snapshot); it rides the transport-error text and the RPC span
        self.weight_version = None
        self._shm_mode = shm
        self._shm_chaos = shm_chaos
        self._chan = None
        #: consecutive transport failures since the last good reply; each
        #: fallback to the front first sleeps :meth:`_fallback_delay`
        self._fallback_failures = 0
        self._fallback_backoff_s = float(fallback_backoff_s)
        self._fallback_backoff_max_s = float(fallback_backoff_max_s)

    def _channel(self):
        if self._chan is None:
            from blendjax_torch.btt.transport import RpcChannel

            self._chan = RpcChannel(self.address, shm=self._shm_mode,
                                    shm_chaos=self._shm_chaos)
        return self._chan

    @property
    def transport(self):
        """The wire the next RPC rides: ``"shm"`` or ``"tcp"``."""
        return self._chan.transport if self._chan is not None else "tcp"

    def reset_channel(self):
        """Drop the channel (the DEALER socket and any shm ring pair) so the
        next RPC dials fresh (stale replies of a dead server die with it)."""
        if self._chan is not None:
            self._chan.reset()

    close = reset_channel

    def rpc(self, cmd, payload=None, *, timeout_ms=None, raw_buffers=False):
        """One exactly-once RPC under the fault policy; returns the decoded
        reply.  Raises :class:`ServeRPCError` (transport) or RuntimeError
        (the server executed the request and reported a failure)."""
        msg = dict(payload or {})
        msg["cmd"] = cmd
        # the last replica, gateway worker and weight version that answered
        # ride the error text and the client span
        stamps = {"replica": self.replica, "gw_worker": self.gw_worker,
                  "weight_version": self.weight_version}
        span_args = {k: v for k, v in stamps.items() if v is not None}
        via = "".join(f", {label}{span_args[k]}" for k, label in (
            ("replica", "last replica "), ("gw_worker", "gateway worker "),
            ("weight_version", "weights v")) if k in span_args)
        try:
            reply = exactly_once_rpc(
                self._channel(), msg, policy=self.policy, state=self.state,
                counters=self.counters,
                wait_ms=self.timeoutms if timeout_ms is None else int(timeout_ms),
                raw_buffers=raw_buffers, spans=self.spans,
                remote_name="policy server", span_label="serve_rpc",
                span_cat="serve_client", span_args=span_args or None,
                rpc_name=f"serve:{cmd}",
                exc_factory=lambda text: ServeRPCError(
                    f"policy server ({self.address}{via}): {text}"),
                retryable=(ServeRPCError,), pop_mid=True)
        except ServeRPCError:
            self._fallback_failures += 1
            if self.follow_redirects and self.address != self._front_address:
                # the worker this client was handed to went silent: fall
                # back to the front so the next RPC re-resolves, paced so
                # clients losing one worker do not re-dial in lockstep
                delay = self._fallback_delay()
                logger.warning("gateway worker %s at %s unresponsive; falling back "
                               "to the front at %s (after %.3fs)", self.gw_worker,
                               self.address, self._front_address, delay)
                if delay > 0:
                    time.sleep(delay)
                self._channel().redirect(self._front_address)
                self.address = self._front_address
            raise
        self._fallback_failures = 0
        for key in stamps:
            if reply.get(key) is not None:
                setattr(self, key, reply[key])
        self._maybe_follow(reply)
        return reply

    def _fallback_delay(self):
        """The paced re-dial delay for the current count of consecutive
        failures: ``min(cap, base * 2**(n-1))``, jittered to 50-100%."""
        if self._fallback_backoff_s <= 0 or self._fallback_failures <= 0:
            return 0.0
        raw = self._fallback_backoff_s * 2.0 ** (self._fallback_failures - 1)
        return min(self._fallback_backoff_max_s, raw) * random.uniform(0.5, 1.0)

    def _maybe_follow(self, reply):
        """A sharded front's handoff: a reply naming the worker that
        answered (``gw_worker``) and the live worker map (``gw_workers``)
        moves the channel onto that worker's own address."""
        if not self.follow_redirects:
            return
        gwmap = reply.get("gw_workers")
        tag = reply.get("gw_worker")
        if not isinstance(gwmap, dict) or tag is None:
            return
        target = gwmap.get(tag)
        if target is None or target == self.address:
            return
        self._channel().redirect(target)
        self.address = target

    # -- episode protocol ----------------------------------------------------

    def hello(self, timeout_ms=None):
        return self.rpc("hello", timeout_ms=timeout_ms)

    def _model_payload(self, payload):
        if self.model is not None:
            payload["model"] = self.model
        return payload

    def reset(self, prefix=None, timeout_ms=None, scenario=None):
        """Admit an episode: returns (and remembers) its slot; its lease id
        rides every later step and close.  With ``prefix`` ((T, obs_dim)
        observations) the server replays it in one teacher-forced pass and
        the whole reply is returned: ``pred`` (the prediction for position
        T) and ``pos`` (the position the next step consumes).  ``scenario``
        labels the episode: a gateway attributes its requests and latencies
        to it in ``scenario_stats`` (a bare server ignores it)."""
        payload = self._model_payload({})
        if prefix is not None:
            payload["prefix"] = np.asarray(prefix, np.float32)
        if scenario is not None:
            payload["scenario"] = str(scenario)
        reply = self.rpc("reset", payload, timeout_ms=timeout_ms,
                         raw_buffers=prefix is not None)
        self.slot = int(reply["slot"])
        self.episode = reply.get("episode")
        if prefix is not None:
            reply["pred"] = np.asarray(reply["pred"])
            return reply
        return self.slot

    def step(self, obs, slot=None, timeout_ms=None):
        """One served step: the reply (``pred``, and for stateful models
        ``pos``, the position this observation consumed)."""
        use = self.slot if slot is None else slot
        if use is None:
            raise RuntimeError("step() before reset(): no episode slot")
        reply = self.rpc(
            "step",
            self._model_payload({"slot": int(use), "episode": self.episode,
                                 "obs": np.asarray(obs, np.float32)}),
            timeout_ms=timeout_ms, raw_buffers=True)
        reply["pred"] = np.asarray(reply["pred"])
        return reply

    def close_episode(self, timeout_ms=None):
        if self.slot is None:
            return False
        reply = self.rpc("close",
                         self._model_payload({"slot": self.slot, "episode": self.episode}),
                         timeout_ms=timeout_ms)
        self.slot = None
        self.episode = None
        return bool(reply.get("closed"))

    def stats(self, timeout_ms=None):
        return self.rpc("stats", timeout_ms=timeout_ms)

    def telemetry(self, timeout_ms=None):
        """The server process's counters and stage summaries."""
        return self.rpc("telemetry", timeout_ms=timeout_ms)

    def register_with_hub(self, hub, name="serve"):
        """Register the served process with a
        :class:`~blendjax_torch.obs.hub.TelemetryHub` as a remote source,
        pulled per scrape over this client (a dead server lands in
        ``remote_errors``, never a failed scrape)."""
        hub.register_remote(name, lambda: self.telemetry(timeout_ms=500))
        return hub
