"""Transport selection for the RPC clients: ZMQ always, shm when it can.
The port of ``blendjax.btt.transport``.

:class:`RpcChannel` is what :class:`~blendjax_torch.serve.client.ServeClient`
dials through instead of a bare DEALER socket.  It speaks the channel
protocol that :func:`blendjax_torch.btt.rpc.exactly_once_rpc` consumes:

- ``send_request(msg, raw_buffers)`` — encode and send one request;
- ``poll_reply(ms)`` / ``recv_reply()`` — a bounded wait, and one decoded
  reply (None when the wakeup was spurious);
- ``notify_timeout()`` — the attempt's deadline expired (over shm, the
  demote signal: the fault-policy retry then rides ZMQ).

Selection is automatic and conservative:

1. every channel starts on ZMQ (the control plane and the remote path);
2. once the peer has answered and the channel has carried
   :data:`UPGRADE_AFTER` RPCs (probe clients that send one ``hello`` never
   pay the negotiation), the client attempts the shm upgrade: two
   uncounted control RPCs (``shm_connect``/``shm_attach``, see
   :mod:`blendjax_torch.btt.shm_rpc`) negotiate a ring pair, and from then
   on requests and replies move through shared memory;
3. a server that refuses (its kill switch, another host, a server without
   the transport) turns the upgrade off for the channel's lifetime;
   transient failures back off and retry after the next healthy ZMQ reply;
4. any shm failure in flight — a vanished ring (the server respawned), a
   reply timeout, a full request ring — demotes the channel to ZMQ at
   once.  The retry rides the same correlation id over ZMQ, and the
   channel re-upgrades onto a fresh ring generation once the server
   answers again.

``BJX_NO_SHM_RPC=1`` (or ``shm=False``) pins the channel to ZMQ.
:meth:`RpcChannel.redirect` re-points a channel at a new peer (a sharded
gateway's worker handoff).  The reference's forced ``shm=True``,
per-channel ring size, zero-copy reply views and ``shm_active`` have no
caller in the port.
"""

from __future__ import annotations

import logging
import time

from blendjax_torch import wire
from blendjax_torch.btt import shm_rpc

logger = logging.getLogger("blendjax_torch")

#: RPCs a channel carries before it pays the upgrade negotiation (the 2nd
#: RPC upgrades: one-shot probe clients never negotiate).
UPGRADE_AFTER = 2

#: per-control-RPC reply deadline during the upgrade handshake.
UPGRADE_TIMEOUT_MS = 750


class RpcChannel:
    """One client channel: a lazy DEALER socket plus, when the peer
    cooperates, an shm ring pair it prefers.

    Params
    ------
    address: str
        The peer's ZMQ endpoint (the control plane and fallback).
    shm: "auto" | False
        ``"auto"`` upgrades when :func:`blendjax_torch.btt.shm_rpc.enabled`
        and the peer accepts; ``False`` pins to ZMQ.  The request ring holds
        :data:`shm_rpc.REQ_CAPACITY` bytes; a larger request rides ZMQ while
        the channel stays upgraded.
    shm_chaos: ShmChaos | None
        Frame-layer fault injection on the upgraded channel (tests).
    name: str
        Names the channel in its log lines (``replay-shard-3``).
    """

    def __init__(self, address, *, shm="auto", shm_chaos=None, name="rpc channel"):
        if shm not in ("auto", False):
            raise ValueError(f"shm must be 'auto' or False, not {shm!r}")
        self.address = address
        self._zsock = None
        self._shm = None
        self._shm_allowed = shm == "auto" and shm_rpc.enabled()
        self.name = name
        self._chaos = shm_chaos
        self._state = "idle"  # idle | active | backoff | off
        self._rpcs = 0
        self._alive = False
        self._backoff_s = 1.0
        self._next_try = 0.0
        self._last_via = "tcp"
        #: transport generation: bumps on every successful upgrade
        self.generations = 0
        #: demotions to ZMQ after an shm failure
        self.demotions = 0

    # -- introspection -------------------------------------------------------

    @property
    def transport(self):
        """The wire the next request rides: ``"shm"`` or ``"tcp"``."""
        return "shm" if self._shm is not None else "tcp"

    # -- plumbing ------------------------------------------------------------

    def _sock(self):
        import zmq

        if self._zsock is None:
            s = zmq.Context.instance().socket(zmq.DEALER)
            s.setsockopt(zmq.LINGER, 0)
            s.connect(self.address)
            self._zsock = s
        return self._zsock

    def _drop_shm(self):
        chan, self._shm = self._shm, None
        try:
            chan.close(unlink=True)
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass

    def _demote(self, reason):
        if self._shm is None:
            return
        self._drop_shm()
        self.demotions += 1
        self._state = "backoff"
        self._alive = False  # re-upgrade only after a ZMQ reply proves the peer
        self._next_try = time.monotonic() + self._backoff_s
        self._backoff_s = min(self._backoff_s * 2, 30.0)
        logger.warning("%s (%s): shm demoted to zmq (%s)", self.name, self.address, reason)

    # -- upgrade -------------------------------------------------------------

    def _should_upgrade(self):
        return (self._shm_allowed and self._state != "off"
                and self._rpcs >= UPGRADE_AFTER and self._alive
                and time.monotonic() >= self._next_try)

    def _rpc_inline(self, payload, timeout_ms):
        """One private control RPC over the ZMQ socket (its own correlation
        id; stale replies of earlier workload attempts are dropped)."""
        import zmq

        msg = dict(payload)
        mid = wire.stamp_message_id(msg)
        sock = self._sock()
        wire.send_message_dealer(sock, msg)
        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            if sock.poll(max(1, int(remaining * 1000)), zmq.POLLIN):
                reply = wire.recv_message_dealer(sock)
                if reply.get(wire.BTMID_KEY) == mid:
                    wire.pop_spans(reply)
                    return reply

    def _try_upgrade(self):
        self._next_try = time.monotonic() + self._backoff_s
        r1 = self._rpc_inline({"cmd": "shm_connect", "host": shm_rpc.host_token()},
                              UPGRADE_TIMEOUT_MS)
        if r1 is None:
            self._backoff_s = min(self._backoff_s * 2, 30.0)
            return
        if "error" in r1 or "shm_channel" not in r1:
            # a considered refusal (kill switch, host mismatch, a server
            # without the transport): permanent for this channel
            self._state = "off"
            logger.info("%s (%s): shm upgrade refused (%s)", self.name, self.address,
                        r1.get("error", "no channel"))
            return
        chan = None
        try:
            chan = shm_rpc.ShmClientChannel(r1["shm_channel"], r1["shm_bell"],
                                            chaos=self._chaos)
            r2 = self._rpc_inline({"cmd": "shm_attach", "channel": chan.name,
                                   "bell": chan.bell_path}, UPGRADE_TIMEOUT_MS)
            if r2 is None or "error" in r2:
                raise ConnectionError((r2 or {}).get("error", "shm_attach timed out"))
            chan.finish(open_timeout_ms=2000)
        except Exception as exc:  # noqa: BLE001 - degrade, never fail
            if chan is not None:
                try:
                    chan.close(unlink=True)
                except Exception:  # noqa: BLE001
                    pass
            self._state = "backoff"
            self._backoff_s = min(self._backoff_s * 2, 30.0)
            logger.info("%s (%s): shm upgrade failed, staying on zmq (%s: %s)",
                        self.name, self.address, type(exc).__name__, exc)
            return
        self._shm = chan
        self._state = "active"
        self._backoff_s = 1.0
        self.generations += 1
        logger.info("%s (%s): upgraded to shm channel %s (generation %d)",
                    self.name, self.address, chan.name, self.generations)

    # -- the channel protocol ------------------------------------------------

    def send_request(self, msg, raw_buffers=False):
        self._rpcs += 1
        if self._shm is None and self._should_upgrade():
            self._try_upgrade()
        if self._shm is not None:
            try:
                frames = wire.encode(msg, raw_buffers=raw_buffers)
                if self._shm.send(frames, timeout_ms=1000):
                    self._last_via = "shm"
                    return
                self._demote("request ring full")
            except ValueError:
                # a request larger than the ring rides ZMQ; the channel
                # itself stays upgraded
                pass
            except (OSError, EOFError) as exc:
                self._demote(f"{type(exc).__name__}: {exc}")
        wire.send_message_dealer(self._sock(), msg, raw_buffers=raw_buffers)
        self._last_via = "tcp"

    def poll_reply(self, timeout_ms):
        import zmq

        if self._last_via == "shm" and self._shm is not None:
            try:
                return self._shm.poll(timeout_ms)
            except (OSError, EOFError) as exc:
                self._demote(f"{type(exc).__name__}: {exc}")
                return False
        return bool(self._sock().poll(timeout_ms, zmq.POLLIN))

    def recv_reply(self):
        """One decoded reply, or None when the wakeup was spurious (a ring
        wrap marker, a chaos-dropped record, an oversized-reply stand-in)."""
        if self._last_via == "shm" and self._shm is not None:
            try:
                reply = self._shm.try_recv()
            except (OSError, EOFError) as exc:
                self._demote(f"{type(exc).__name__}: {exc}")
                return None
            if isinstance(reply, dict) and reply.get(shm_rpc.OVERFLOW_KEY):
                # the server's real reply did not fit the reply ring: demote
                # so the same-mid retry rides ZMQ, where any size fits
                self._demote("reply exceeded the reply ring capacity")
                return None
            if reply is not None:
                self._alive = True
            return reply
        reply = wire.recv_message_dealer(self._zsock)
        self._alive = True
        return reply

    def notify_timeout(self):
        """The caller's attempt deadline expired with no reply.  Over shm
        that is the death signal (a live same-host peer answers in
        microseconds): demote so the same-mid retry rides ZMQ to wherever
        the peer respawned."""
        if self._last_via == "shm":
            self._demote("reply timeout")

    def reset(self):
        """Drop both transports so the next RPC dials fresh: stale replies
        of a dead server incarnation die with the old channel.  Re-upgrade
        is re-armed (no backoff) but still waits for a live ZMQ reply."""
        if self._zsock is not None:
            self._zsock.close(0)
            self._zsock = None
        if self._shm is not None:
            self._drop_shm()
        if self._state != "off":
            self._state = "idle"
        self._next_try = 0.0
        self._backoff_s = 1.0
        self._alive = False

    def redirect(self, address):
        """Re-point the channel at a new peer (a sharded gateway's worker
        handoff: the front's reset reply names the worker that owns the
        lease).  Both transports drop as in :meth:`reset`; a permanent shm
        refusal is cleared too, since it belonged to the old peer (a
        pure-ZMQ front refuses, the worker it hands off to accepts)."""
        if address == self.address:
            return
        self.reset()
        if self._state == "off":
            self._state = "idle"
        self._rpcs = 0
        self.address = address

    close = reset
