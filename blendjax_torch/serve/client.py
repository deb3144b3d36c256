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

Not ported yet: the gateway's redirects and hub registration (ROADMAP
Queue 1, item 9).
"""

from __future__ import annotations

import numpy as np

from blendjax_torch.btt.faults import FaultPolicy
from blendjax_torch.btt.rpc import ServeRPCError, exactly_once_rpc
from blendjax_torch.utils.timing import fleet_counters

__all__ = ["ServeClient", "ServeRPCError"]


class ServeClient:
    """Blocking exactly-once RPCs to one policy server (ROUTER/batched or
    REP/serial: the DEALER framing serves both)."""

    def __init__(self, address, *, fault_policy=None, counters=None, timeoutms=5000,
                 span_recorder=None, model=None, shm="auto", shm_chaos=None):
        self.address = address
        self.policy = fault_policy or FaultPolicy()
        self.state = self.policy.new_state()
        self.counters = counters if counters is not None else fleet_counters
        self.timeoutms = int(timeoutms)
        self.slot = None  # the live episode's slot after reset()
        self.episode = None  # ... and its lease id
        #: model id this client's episodes run on (None: the default)
        self.model = model
        #: cross-process span sink (None: tracing off)
        self.spans = span_recorder
        #: the weight version of the last reply that carried one (a server
        #: subscribed to a WeightBus stamps every reply once it adopted a
        #: snapshot); it rides the transport-error text and the RPC span
        self.weight_version = None
        self._shm_mode = shm
        self._shm_chaos = shm_chaos
        self._chan = None

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
        wv = self.weight_version
        via = f", weights v{wv}" if wv is not None else ""
        reply = exactly_once_rpc(
            self._channel(), msg, policy=self.policy, state=self.state,
            counters=self.counters,
            wait_ms=self.timeoutms if timeout_ms is None else int(timeout_ms),
            raw_buffers=raw_buffers, spans=self.spans,
            remote_name="policy server", span_label="serve_rpc", span_cat="serve_client",
            span_args={"weight_version": wv} if wv is not None else None,
            rpc_name=f"serve:{cmd}",
            exc_factory=lambda text: ServeRPCError(f"policy server ({self.address}{via}): {text}"),
            retryable=(ServeRPCError,), pop_mid=True)
        if reply.get("weight_version") is not None:
            self.weight_version = reply["weight_version"]
        return reply

    # -- episode protocol ----------------------------------------------------

    def hello(self, timeout_ms=None):
        return self.rpc("hello", timeout_ms=timeout_ms)

    def _model_payload(self, payload):
        if self.model is not None:
            payload["model"] = self.model
        return payload

    def reset(self, prefix=None, timeout_ms=None):
        """Admit an episode: returns (and remembers) its slot; its lease id
        rides every later step and close.  With ``prefix`` ((T, obs_dim)
        observations) the server replays it in one teacher-forced pass and
        the whole reply is returned: ``pred`` (the prediction for position
        T) and ``pos`` (the position the next step consumes)."""
        payload = self._model_payload({})
        if prefix is not None:
            payload["prefix"] = np.asarray(prefix, np.float32)
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
