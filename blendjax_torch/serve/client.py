"""ServeClient: one episode's blocking RPC channel to a PolicyServer, the
port of ``blendjax.serve.client.ServeClient``.

A plain DEALER socket speaking the empty-delimiter framing of
:mod:`blendjax_torch.wire`; every RPC is stamped with a ``wire.BTMID_KEY``
correlation id and run under a :class:`~blendjax_torch.btt.faults.
FaultPolicy`: a retry re-sends the same id (the server's reply cache
answers it without a second decode), and replies whose id does not match
the outstanding request are dropped as stale.  It talks to either
package's server::

    client = ServeClient("tcp://host:24000")
    slot = client.reset()            # admit an episode (KV-cache slot)
    for obs in episode:
        pred = client.step(obs)["pred"]
    client.close_episode()           # release the slot

Not ported yet: the transport channel with its ``shm://`` upgrade
(``RpcChannel``, ROADMAP Queue 1, item 8) and the gateway's redirects and
hub registration (item 9).
"""

from __future__ import annotations

import time

import numpy as np

from blendjax_torch import wire
from blendjax_torch.btt.faults import CircuitOpenError, FaultPolicy
from blendjax_torch.obs.spans import make_span, now_us
from blendjax_torch.utils.timing import fleet_counters


class ServeRPCError(TimeoutError):
    """A serve RPC failed at the transport level (no reply within the
    policy, circuit open)."""


class ServeClient:
    """Blocking exactly-once RPCs to one policy server (ROUTER/batched or
    REP/serial: the DEALER framing serves both)."""

    def __init__(self, address, *, fault_policy=None, counters=None, timeoutms=5000,
                 span_recorder=None, model=None):
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
        self._sock = None

    def _socket(self):
        if self._sock is None:
            import zmq

            self._sock = zmq.Context.instance().socket(zmq.DEALER)
            self._sock.setsockopt(zmq.LINGER, 0)
            self._sock.connect(self.address)
        return self._sock

    def reset_channel(self):
        """Drop the socket so the next RPC dials fresh (stale replies of a
        dead server die with it)."""
        if self._sock is not None:
            self._sock.close(0)
            self._sock = None

    close = reset_channel

    def rpc(self, cmd, payload=None, *, timeout_ms=None, raw_buffers=False):
        """One exactly-once RPC under the fault policy; returns the decoded
        reply.  Raises :class:`ServeRPCError` (transport) or RuntimeError
        (the server executed the request and reported a failure)."""
        import zmq

        msg = dict(payload or {})
        msg["cmd"] = cmd
        mid = wire.stamp_message_id(msg)
        if self.spans is not None:
            wire.stamp_span_context(msg, mid)
        t0_us = now_us() if self.spans is not None else 0
        wait_ms = self.timeoutms if timeout_ms is None else int(timeout_ms)

        def attempt(n):
            sock = self._socket()
            wire.send_message_dealer(sock, msg, raw_buffers=raw_buffers)
            deadline = time.monotonic() + wait_ms / 1000.0
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ServeRPCError(
                        f"policy server ({self.address}): no reply to {cmd!r} "
                        f"within {wait_ms} ms (attempt {n + 1})")
                if not sock.poll(max(1, min(50, int(remaining * 1000))), zmq.POLLIN):
                    continue
                reply = wire.recv_message_dealer(sock)
                if reply.get(wire.BTMID_KEY) != mid:
                    # an earlier attempt's late reply: this one is still owed
                    self.counters.incr("stale_replies")
                    continue
                piggyback = wire.pop_spans(reply)
                if self.spans is not None:
                    self.spans.ingest(piggyback)
                    self.spans.record(make_span(f"serve_rpc:{cmd}", t0_us, trace=mid,
                                                cat="serve_client"))
                if "error" in reply:
                    raise RuntimeError(
                        f"policy server: {cmd!r} failed remotely: {reply['error']}")
                reply.pop(wire.BTMID_KEY, None)
                return reply

        try:
            return self.policy.run(attempt, state=self.state, counters=self.counters,
                                   name=f"serve:{cmd}", retryable=(ServeRPCError,))
        except CircuitOpenError as exc:
            raise ServeRPCError(f"policy server ({self.address}): {exc}") from exc

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
