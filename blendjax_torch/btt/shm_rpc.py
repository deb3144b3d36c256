"""ShmRPC: duplex shared-memory transport for same-host RPC, the port of
``blendjax.btt.shm_rpc``.

The ``shm://`` ring (:mod:`blendjax_torch.native.ring`) is one-directional;
this module makes it duplex.  One RPC channel is a pair of SPSC rings

- ``<channel>.c2s`` — the request ring, created and written by the client,
- ``<channel>.s2c`` — the reply ring, created and written by the server,

plus two fd-shaped doorbells (:class:`blendjax_torch.native.ring.DoorBell`
FIFOs: the server's bell is shared by all its channels and registered in
its ``zmq.Poller`` beside the ZMQ socket; each channel's client bell wakes
the blocking RPC wait), so neither side sleep-polls.

Frames inside a ring record are the exact :func:`blendjax_torch.wire.encode`
multipart encoding: ``BTMID_KEY`` correlation ids, span piggybacks,
raw-buffer array frames and the exactly-once discipline of
:func:`blendjax_torch.btt.rpc.exactly_once_rpc` ride through unchanged;
only the bytes' route differs (one GIL-released copy into the arena and
one out, in place of pickle and two kernel copies per direction).  The
protocol is the JAX package's, so either package's client upgrades
against either package's server.

Rendezvous rides the ZMQ channel, which stays the control plane and the
remote-peer fallback: a client that wants the upgrade sends two uncounted
control RPCs over its DEALER socket —

1. ``shm_connect {host}`` — the server checks the host token (same
   machine, same boot) and allocates a channel name under its base;
2. (the client creates its ring and bell) ``shm_attach {channel, bell}``
   — the server opens the request ring, creates the reply ring, and from
   then on serves the channel from its main loop.

Naming: every object of one server lives under its ``base`` prefix
(``/dev/shm/{base}*``): the server's bell, every channel's rings and the
client bells, so ``unlink_base(base)`` sweeps what a killed server left.

Respawn heal: a killed server's channels go silent.  The client's attempt
times out, the channel demotes to ZMQ (whose reconnect reaches the
respawned process), the fault-policy retry rides the same correlation id,
and once a ZMQ reply proves the server alive the client re-upgrades onto a
fresh ring generation.  ``BJX_NO_SHM_RPC=1`` turns the whole transport off
on both sides, leaving the ZMQ path as it is without it.
"""

from __future__ import annotations

import logging
import os
import select
import socket as _socket
import sys
import time

from blendjax_torch import wire

logger = logging.getLogger("blendjax_torch")

#: kill-switch: set to 1 to disable shm RPC everywhere (servers bind no
#: shm endpoint, clients never attempt the upgrade) — the ZMQ fallback
#: path is then byte-identical in behavior to the pre-ShmRPC code.
KILL_ENV = "BJX_NO_SHM_RPC"

#: control commands (answered at the transport layer, never counted in
#: the serve/replay request vocabularies and never forwarded by the
#: gateway — they negotiate the wire, they are not workload)
CONTROL_CMDS = ("shm_connect", "shm_attach")

#: default ring capacities.  /dev/shm is tmpfs: pages allocate on first
#: touch, so a generous reply ring costs address space, not memory,
#: until real traffic fills it.  A message larger than its ring cannot
#: be sent at all (the ring holds whole records) — the client falls
#: back to ZMQ for oversized requests, and a server reply that cannot
#: fit is answered with an actionable error naming the knob.
REQ_CAPACITY = 16 << 20
REP_CAPACITY = 32 << 20

#: how long a server blocks writing a reply into a full reply ring
#: before dropping it (a client that stopped reading is crashed or
#: demoted; its retry re-fetches through the reply cache over ZMQ).
SEND_TIMEOUT_MS = 200

#: key stamped into the stand-in reply a server sends when the REAL
#: reply exceeded the reply ring: an :class:`~blendjax_torch.btt.transport.
#: RpcChannel` that sees it demotes to ZMQ and treats the reply as
#: never-delivered, so the same-mid retry rides ZMQ — where any size
#: fits (mutating commands never hit this: their replies are small and
#: the retry is answered from the reply cache either way).  Clients
#: without the channel layer surface the embedded error text instead.
OVERFLOW_KEY = "bjx_shm_overflow"


def enabled():
    """True when this process may speak shm RPC at all: Linux with a
    ``/dev/shm``, the native ring built, and no kill-switch."""
    if os.environ.get(KILL_ENV, "") not in ("", "0"):
        return False
    if not sys.platform.startswith("linux") or not os.path.isdir("/dev/shm"):
        return False
    from blendjax_torch.native import ring

    return ring.native_available()


def host_token():
    """Identity of this machine's ``/dev/shm`` namespace: hostname +
    boot id.  Two processes that disagree cannot share memory, so the
    server refuses their ``shm_connect`` before paying any ring-open
    timeout (a containerized peer on the same kernel but a private
    ``/dev/shm`` still fails the attach open and degrades to ZMQ)."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:
        boot = ""
    return f"{_socket.gethostname()}|{boot}"


def new_base(tag="srv"):
    """A fresh server base prefix.  Supervised fleets generate one per
    server UP FRONT and pass it via ``--shm-base``, so the parent can
    :func:`unlink_base` everything the (possibly SIGKILLed) server and
    its clients created."""
    return f"bjxrpc-{tag}-{os.getpid():x}-{wire.new_message_id()[:8]}"


def unlink_base(base):
    """Remove every ``/dev/shm`` object under ``base`` (rings, bells —
    the server's AND its clients', which name their objects under the
    server-allocated channel prefix).  Returns the paths removed."""
    import glob

    removed = []
    for path in glob.glob(f"/dev/shm/{base}*"):
        try:
            os.unlink(path)
            removed.append(path)
        except OSError:
            pass
    return removed


def leaked_objects(base):
    """``/dev/shm`` paths still present under ``base`` (the chaos-test
    leak check)."""
    import glob

    return sorted(glob.glob(f"/dev/shm/{base}*"))


#: the transport-neutral wire-bytes unit (one definition, wire.py's)
frames_nbytes = wire.frames_nbytes


def control_reply(transport, msg):
    """Answer a shm control command, or return None for workload
    traffic.  Every server recv path calls this FIRST: control commands
    never reach the request counters, the reply cache, or (gateway) the
    fleet.  ``transport=None`` (shm disabled/unsupported) answers with
    the actionable refusal the client's upgrade logic treats as
    permanent."""
    cmd = msg.get("cmd")
    if cmd not in CONTROL_CMDS:
        return None
    if transport is None:
        reply = {"error": "shm rpc disabled on this server"}
    else:
        try:
            reply = transport.handle_control(msg)
        except Exception as exc:  # noqa: BLE001 - surfaced to the client
            logger.exception("shm rpc: %r failed", cmd)
            reply = {"error": f"{type(exc).__name__}: {exc}"}
    mid = msg.get(wire.BTMID_KEY)
    if mid is not None:
        reply[wire.BTMID_KEY] = mid
    return reply


class ServerChannel:
    """One accepted client channel, server side: the request-ring
    reader, the reply-ring writer, and the client's bell."""

    #: duck-type marker: server reply paths dispatch idents on it
    shm_channel = True

    __slots__ = ("name", "reader", "writer", "bell", "t_accept")

    def __init__(self, name, reader, writer, bell):
        self.name = name
        self.reader = reader
        self.writer = writer
        self.bell = bell
        self.t_accept = time.monotonic()


class ShmRpcServer:
    """The server half of the transport: accepts channels negotiated
    over the ZMQ control plane and pumps them from the server's main
    loop.

    Params
    ------
    base: str
        ``/dev/shm`` name prefix for every object of this server
        (``--shm-base`` from a supervising parent, else :func:`new_base`).
    counters: EventCounters
        Every request/reply payload byte moved through shm lands on its
        ``bytes_counter`` — the observable half of the shm-vs-tcp byte
        saving.
    bytes_counter: str
        ``serve_shm_bytes`` for a policy server, ``replay_shm_bytes`` for
        a replay shard.
    who: str
        Names the server in its log lines.
    """

    def __init__(self, base, counters, *, bytes_counter="serve_shm_bytes",
                 who="shm rpc server"):
        from blendjax_torch.native.ring import DoorBell

        self.base = base
        self.who = who
        self.bytes_counter = bytes_counter
        #: ring sizes for channels this server accepts
        self.req_capacity = REQ_CAPACITY
        self.rep_capacity = REP_CAPACITY
        self.counters = counters
        self._chan_seq = 0
        self._channels = {}  # name -> ServerChannel
        self._pending = {}   # name -> allocation awaiting shm_attach
        #: channels with committed-but-unannounced records (batched
        #: doorbell: a burst of co-admitted replies costs ONE wake per
        #: channel, flushed by :meth:`flush_bells` at the end of the
        #: burst instead of one ding per record)
        self._deferred_bells = set()
        self.bell = DoorBell(f"/dev/shm/{self.base}.bell", create=True)

    # -- advertisement -------------------------------------------------------

    @property
    def endpoint(self):
        """The advertised ``shm://`` endpoint (launch-info / hello
        surface).  It names the server's object prefix — rendezvous
        itself still rides the ZMQ control plane."""
        return f"shm://{self.base}"

    def info(self):
        """Capability blob for ``hello``/``telemetry`` replies."""
        return {
            "endpoint": self.endpoint,
            "host": host_token(),
            "channels": len(self._channels),
        }

    @property
    def fd(self):
        """The bell fd to register in the serve loop's poller."""
        return self.bell.fd

    # -- control plane -------------------------------------------------------

    def handle_control(self, msg):
        cmd = msg.get("cmd")
        if cmd == "shm_connect":
            peer = msg.get("host")
            if peer != host_token():
                return {"error": (
                    "shm rpc needs a same-host peer (host token "
                    f"mismatch: {peer!r} vs {host_token()!r}); use tcp"
                )}
            self._chan_seq += 1
            name = f"{self.base}.c{self._chan_seq:x}"
            self._pending[name] = time.monotonic()
            # forget stale allocations whose client never attached
            cutoff = time.monotonic() - 30.0
            for stale in [n for n, t in self._pending.items() if t < cutoff]:
                del self._pending[stale]
            return {
                "shm_channel": name,
                "shm_bell": self.bell.path,
                "shm_req_capacity": self.req_capacity,
                "shm_rep_capacity": self.rep_capacity,
            }
        if cmd == "shm_attach":
            from blendjax_torch.native.ring import (
                DoorBell,
                ShmRingReader,
                ShmRingWriter,
            )

            name = msg.get("channel")
            if name not in self._pending:
                return {"error": (
                    f"unknown shm channel {name!r} (never allocated, "
                    "expired, or a previous server incarnation's): "
                    "reconnect"
                )}
            del self._pending[name]
            # the client created its ring before sending shm_attach, so
            # this open is immediate; a short timeout still bounds a
            # liar/racing peer
            reader = ShmRingReader(f"shm://{name}.c2s",
                                   open_timeout_ms=2000, auto_reopen=False)
            writer = ShmRingWriter(f"shm://{name}.s2c",
                                   capacity_bytes=self.rep_capacity)
            bell_path = msg.get("bell")
            bell = DoorBell(bell_path) if bell_path else None
            self._channels[name] = ServerChannel(name, reader, writer, bell)
            logger.info("%s: shm channel %s attached", self.who, name)
            return {"shm_ok": True, "channel": name}
        raise ValueError(f"unknown shm control command {cmd!r}")

    # -- data plane ----------------------------------------------------------

    def pump(self, handler):
        """Drain the bell and every channel's request ring; each decoded
        request dict goes to ``handler(channel, msg)``.  Returns the
        number of requests dispatched.  A vanished/closed request ring
        drops its channel (the client demoted, died, or reconnected
        under a new name); an undecodable record costs that record only
        — the same survival discipline as ``drain_socket``."""
        self.bell.drain()
        n = 0
        for chan in list(self._channels.values()):
            while True:
                try:
                    frames = chan.reader.recv_frames(0)
                except (EOFError, ConnectionResetError):
                    self._drop(chan)
                    break
                if frames is None:
                    break
                self.counters.incr(self.bytes_counter, frames_nbytes(frames))
                try:
                    msg = wire.decode(frames)
                except Exception as exc:  # noqa: BLE001 - tier survives
                    logger.warning(
                        "%s: undecodable shm request dropped (%s: %s)",
                        self.who, type(exc).__name__, exc,
                    )
                    continue
                n += 1
                try:
                    handler(chan, msg)
                except Exception:  # noqa: BLE001 - the tier survives
                    logger.exception(
                        "%s: handling an shm request failed (dropped)", self.who)
        return n

    def send(self, chan, reply, ding=True):
        """Write one reply to a channel and ding its bell.  False when
        the reply could not be delivered (full ring / dead channel) —
        the client's same-mid retry re-fetches it from the reply cache,
        over whichever transport it lands on.  ``ding=False`` defers
        the wake to the caller's next :meth:`flush_bells` — the batched
        multi-record doorbell a reply burst rides (the record is
        committed and readable either way; only the wake is deferred,
        so the flush MUST come before the sender blocks)."""
        try:
            frames = wire.encode(reply, raw_buffers=True)
            ok = chan.writer.send_frames(frames, timeout_ms=SEND_TIMEOUT_MS)
        except ValueError:
            # reply larger than the reply ring: answer with an
            # OVERFLOW_KEY stand-in — the client channel demotes and
            # its same-mid retry rides ZMQ, where any size fits (the
            # embedded text serves channel-less consumers)
            err = {
                OVERFLOW_KEY: True,
                "error": (
                    "reply exceeds the shm reply ring capacity "
                    f"({self.rep_capacity} bytes, shm_rpc.REP_CAPACITY); "
                    "served over zmq instead"
                ),
            }
            mid = reply.get(wire.BTMID_KEY)
            if mid is not None:
                err[wire.BTMID_KEY] = mid
            frames = wire.encode(err)
            try:
                ok = chan.writer.send_frames(frames,
                                             timeout_ms=SEND_TIMEOUT_MS)
            except OSError:
                return False
        except OSError:
            return False
        if ok:
            self.counters.incr(self.bytes_counter, frames_nbytes(frames))
            self._ding(chan, ding)
        return ok

    def _ding(self, chan, now):
        if chan.bell is None:
            return
        if now:
            chan.bell.ding()
        else:
            self._deferred_bells.add(chan.name)

    def flush_bells(self):
        """Ring every bell deferred by ``send(..., ding=False)`` — one ding
        per channel however many records the burst committed.  Dropped channels are skipped
        (their client is gone; its retry re-dials)."""
        if not self._deferred_bells:
            return 0
        n = 0
        for name in self._deferred_bells:
            chan = self._channels.get(name)
            if chan is not None and chan.bell is not None:
                chan.bell.ding()
                n += 1
        self._deferred_bells.clear()
        return n

    def _drop(self, chan):
        self._channels.pop(chan.name, None)
        self._deferred_bells.discard(chan.name)
        try:
            chan.reader.close(unlink=True)
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass
        try:
            chan.writer.close(unlink=True)
        except Exception:  # noqa: BLE001
            pass
        if chan.bell is not None:
            chan.bell.close(unlink=False)
        # the client's bell fifo rides the channel prefix; sweep it so
        # a churning client population cannot accumulate stale fifos
        try:
            os.unlink(f"/dev/shm/{chan.name}.cbell")
        except OSError:
            pass
        logger.info("%s: shm channel %s dropped", self.who, chan.name)

    def close(self, unlink=True):
        for chan in list(self._channels.values()):
            self._drop(chan)
        self.bell.close(unlink=unlink)
        if unlink:
            unlink_base(self.base)


class ShmClientChannel:
    """The client half of one duplex channel: request-ring writer,
    reply-ring reader, and the two bells.  Built in two steps around
    the ``shm_attach`` control RPC (create -> attach -> :meth:`finish`).

    ``chaos`` accepts a :class:`ShmChaos` shim for deterministic
    frame-layer fault injection (a wire with no TCP segment to drop).
    Replies are copied out of the ring before their record is released."""

    def __init__(self, name, server_bell_path, *, bell=None, chaos=None):
        from blendjax_torch.native.ring import DoorBell, ShmRingWriter

        self.name = name
        self.writer = ShmRingWriter(f"shm://{name}.c2s",
                                    capacity_bytes=REQ_CAPACITY)
        #: the reply-wake bell: one per channel, unless the caller
        #: multiplexes many channels in one loop (the gateway's replica
        #: backends) and passes its shared bell
        self._own_bell = bell is None
        self.bell = bell if bell is not None else DoorBell(
            f"/dev/shm/{name}.cbell", create=True)
        self.server_bell = DoorBell(server_bell_path)
        self.reader = None  # until finish()
        self.chaos = chaos
        #: payload bytes moved through this channel (both directions)
        self.bytes_moved = 0

    @property
    def bell_path(self):
        return self.bell.path

    def finish(self, open_timeout_ms=2000):
        """Open the reply ring (the server created it while handling
        ``shm_attach``, so this is immediate)."""
        from blendjax_torch.native.ring import ShmRingReader

        self.reader = ShmRingReader(f"shm://{self.name}.s2c",
                                    open_timeout_ms=open_timeout_ms,
                                    auto_reopen=False)
        return self

    # -- data plane ----------------------------------------------------------

    def send(self, frames, timeout_ms=1000):
        """Write one request; True when delivered.  Raises ValueError
        for a request larger than the ring (the caller falls back to
        ZMQ for that message) and OSError family when the channel is
        dead."""
        sends = (self.chaos.on_send(frames) if self.chaos is not None
                 else (frames,))
        for f in sends:
            if not self.writer.send_frames(f, timeout_ms=timeout_ms):
                return False
            self.bytes_moved += frames_nbytes(f)
            self.server_bell.ding()
        # a chaos-dropped request (empty ``sends``) reports True: the
        # loss is silent by design — the caller's reply timeout and
        # same-mid retry are what the fault exercises
        return True

    def try_recv(self):
        """One reply dict if a record is pending, else None.  Raises
        ``ConnectionResetError``/``EOFError`` when the server side is
        gone (vanished ring / clean close) — the demote signal."""
        if self.reader is None:
            return None
        while True:
            frames = self.reader.recv_frames(0)
            if frames is None:
                if self.chaos is not None:
                    dup = self.chaos.take_pending_dup()
                    if dup is not None:
                        return wire.decode(dup)
                return None
            self.bytes_moved += frames_nbytes(frames)
            if self.chaos is not None:
                frames = self.chaos.on_recv(frames)
                if frames is None:
                    continue  # dropped reply: keep draining
            try:
                return wire.decode(frames)
            except Exception as exc:  # noqa: BLE001 - record-scoped
                logger.warning(
                    "shm channel %s: undecodable reply dropped (%s: %s)",
                    self.name, type(exc).__name__, exc,
                )
                continue

    def poll(self, timeout_ms):
        """True when a reply record is (probably) pending — parks on
        the bell fd, so the wait is event-driven, and falls back to the
        ring's own bounded wait when the bell has no fd."""
        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            if self.reader is not None and self.reader.pending_bytes() > 0:
                return True
            if self.chaos is not None and self.chaos.has_pending_dup():
                return True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            fd = self.bell.fd
            if fd is None:
                return False
            r, _, _ = select.select([fd], [], [], min(remaining, 0.05))
            if r:
                self.bell.drain()

    def close(self, unlink=True):
        if self.reader is not None:
            try:
                self.reader.close(unlink=unlink)
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass
            self.reader = None
        try:
            self.writer.close(unlink=unlink)
        except Exception:  # noqa: BLE001
            pass
        if self._own_bell:
            self.bell.close(unlink=unlink)
        self.server_bell.close(unlink=False)


class ShmChaos:
    """Deterministic frame-layer fault injection for the shm wire — the
    :class:`blendjax.btt.chaos.ChaosProxy` analogue for a transport
    with no TCP chunk to intercept.  Attached to a
    :class:`ShmClientChannel` (``chan.chaos = ShmChaos()``); actions
    are consumed one per frame-list in schedule order.

    - ``drop_next("up")``    — the next request is never written (lost
      datagram: the client's reply timeout and same-mid retry heal it).
    - ``dup_next("up")``     — the next request is written twice: the
      server's reply cache / in-queue dedupe must make it exactly-once.
    - ``drop_next("down")``  — the next reply is read and discarded
      (lost reply: the client's same-mid retry must be answered from
      the reply cache without re-execution).
    - ``dup_next("down")``   — the next reply is delivered twice: the
      second must be dropped as stale by the mid discipline.
    """

    def __init__(self):
        self._sched = {"up": [], "down": []}
        self._dup_down = None
        self.dropped = 0
        self.duplicated = 0

    def _push(self, direction, action):
        self._sched[direction].append(action)

    def drop_next(self, direction="down"):
        self._push(direction, "drop")

    def dup_next(self, direction="down"):
        self._push(direction, "dup")

    # -- channel hooks -------------------------------------------------------

    def on_send(self, frames):
        """Request-path hook: returns the tuple of frame-lists to
        actually write."""
        if not self._sched["up"]:
            return (frames,)
        action = self._sched["up"].pop(0)
        if action == "drop":
            self.dropped += 1
            return ()
        if action == "dup":
            self.duplicated += 1
            return (frames, frames)
        return (frames,)

    def on_recv(self, frames):
        """Reply-path hook: returns frames to deliver, or None (drop)."""
        if not self._sched["down"]:
            return frames
        action = self._sched["down"].pop(0)
        if action == "drop":
            self.dropped += 1
            return None
        if action == "dup":
            self.duplicated += 1
            self._dup_down = [
                bytes(f) if not hasattr(f, "tobytes") else f.tobytes()
                for f in frames
            ]
            return frames
        return frames

    def has_pending_dup(self):
        return self._dup_down is not None

    def take_pending_dup(self):
        dup, self._dup_down = self._dup_down, None
        return dup
