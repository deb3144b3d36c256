"""The exactly-once RPC discipline, the port of ``blendjax.btt.rpc``.

An RPC client stamps a fresh ``wire.BTMID_KEY`` correlation id (and
optionally a span context), sends over a transport channel, polls for the
reply whose id matches (dropping mismatches as stale: an earlier attempt's
late reply, or a dead server incarnation's), raises on a remote ``error``
reply, and runs the whole attempt under a
:class:`~blendjax_torch.btt.faults.FaultPolicy` whose retries re-send the
same id, so the server's reply cache makes them exactly-once.

Its two callers, :class:`~blendjax_torch.serve.client.ServeClient` and
:class:`~blendjax_torch.replay.shard_client.ShardClient`, pass their own
naming (error text, span label and category, the policy's call name) and
error class, as in the reference.  The reference's bare-DEALER branch has
no caller in the port: both clients dial an ``RpcChannel``.
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
                     spans=None, remote_name, span_label, span_cat, span_args=None,
                     rpc_name, exc_factory, retryable, pop_mid=False):
    """One exactly-once RPC; returns the decoded reply dict.

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
        ``{span_label}:{cmd}`` span (category ``span_cat``).
    remote_name: str
        Names the remote in remote-failure text.
    rpc_name: str
        The fault policy's call name (counter and flight-recorder label).
    exc_factory: callable
        ``exc_factory(message) -> Exception``, the caller's transport
        error (one of ``retryable``).
    retryable: tuple
        Exception classes the policy retries.
    pop_mid: bool
        Strip the echoed correlation id from the returned reply.
    """
    cmd = msg.get("cmd")
    mid = wire.stamp_message_id(msg)
    if spans is not None:
        wire.stamp_span_context(msg, mid)
    t0_us = now_us() if spans is not None else 0

    def attempt(n):
        channel.send_request(msg, raw_buffers=raw_buffers)
        deadline = time.monotonic() + wait_ms / 1000.0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # over shm a missed deadline is the peer-death signal:
                # demote, so the retry rides ZMQ
                channel.notify_timeout()
                raise exc_factory(f"no reply to {cmd!r} within {wait_ms} ms "
                                  f"(attempt {n + 1})")
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
                spans.record(make_span(f"{span_label}:{cmd}", t0_us, trace=mid,
                                       cat=span_cat, args=span_args))
            if "error" in reply:
                raise RuntimeError(f"{remote_name}: {cmd!r} failed remotely: {reply['error']}")
            if pop_mid:
                reply.pop(wire.BTMID_KEY, None)
            return reply

    try:
        return policy.run(attempt, state=state, counters=counters, name=rpc_name,
                          retryable=retryable)
    except CircuitOpenError as exc:
        raise exc_factory(str(exc)) from exc
