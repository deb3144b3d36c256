"""The exactly-once RPC discipline, the port of ``blendjax.btt.rpc``.

An RPC client stamps a fresh ``wire.BTMID_KEY`` correlation id (and
optionally a span context), sends over a transport channel, polls for the
reply whose id matches (dropping mismatches as stale: an earlier attempt's
late reply, or a dead server incarnation's), raises on a remote ``error``
reply, and runs the whole attempt under a
:class:`~blendjax_torch.btt.faults.FaultPolicy` whose retries re-send the
same id, so the server's reply cache makes them exactly-once.

The port's one caller is :class:`~blendjax_torch.serve.client.ServeClient`,
so the names and the error class are the serve tier's (the reference
parameterizes them for its gateway and replay clients: ROADMAP Queue 1,
item 9).
"""

from __future__ import annotations

import time

from blendjax_torch import wire
from blendjax_torch.btt.faults import CircuitOpenError
from blendjax_torch.obs.spans import make_span, now_us


class ServeRPCError(TimeoutError):
    """A serve RPC failed at the transport level (no reply within the
    policy, circuit open)."""


def exactly_once_rpc(channel, msg, *, policy, state, counters, wait_ms, raw_buffers=False,
                     spans=None):
    """One exactly-once RPC to a policy server; returns the decoded reply
    dict, its correlation id removed.

    Params
    ------
    channel: RpcChannel
        The client's :class:`blendjax_torch.btt.transport.RpcChannel`
        (``send_request``/``poll_reply``/``recv_reply``/``notify_timeout``),
        which picks ZMQ or the shm ring pair for each request.
    msg: dict
        The request, ``cmd`` included; stamped with a fresh correlation id
        here (a retry re-sends the same stamped dict).
    policy / state / counters:
        The caller's :class:`FaultPolicy`, its :class:`FaultState`, and
        the counter sink (``stale_replies`` and the policy's counters).
    wait_ms: int
        Per-attempt reply deadline.
    spans: SpanRecorder | None
        When set, the request carries a span context and the reply's
        piggybacked server spans are ingested beside a client-side
        ``serve_rpc:{cmd}`` span.
    """
    cmd = msg.get("cmd")
    mid = wire.stamp_message_id(msg)
    if spans is not None:
        wire.stamp_span_context(msg, mid)
    t0_us = now_us() if spans is not None else 0

    def fail(text):
        return ServeRPCError(f"policy server ({channel.address}): {text}")

    def attempt(n):
        channel.send_request(msg, raw_buffers=raw_buffers)
        deadline = time.monotonic() + wait_ms / 1000.0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # over shm a missed deadline is the peer-death signal:
                # demote, so the retry rides ZMQ
                channel.notify_timeout()
                raise fail(f"no reply to {cmd!r} within {wait_ms} ms (attempt {n + 1})")
            slice_ms = max(1, min(50, int(remaining * 1000)))
            reply = channel.recv_reply() if channel.poll_reply(slice_ms) else None
            if reply is None:
                continue  # timeout slice or spurious wakeup (wrap marker, dropped record)
            if reply.get(wire.BTMID_KEY) != mid:
                # an earlier attempt's late reply: this one is still owed
                counters.incr("stale_replies")
                continue
            piggyback = wire.pop_spans(reply)
            if spans is not None:
                spans.ingest(piggyback)
                spans.record(make_span(f"serve_rpc:{cmd}", t0_us, trace=mid,
                                       cat="serve_client"))
            if "error" in reply:
                raise RuntimeError(f"policy server: {cmd!r} failed remotely: {reply['error']}")
            reply.pop(wire.BTMID_KEY, None)
            return reply

    try:
        return policy.run(attempt, state=state, counters=counters, name=f"serve:{cmd}",
                          retryable=(ServeRPCError,))
    except CircuitOpenError as exc:
        raise fail(str(exc)) from exc
