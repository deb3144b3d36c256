"""WeightBus: live versioned weight publication, learner -> serve tier, the
port of ``blendjax.weights.bus``.

- :class:`WeightPublisher` — a ROUTER socket any number of subscribers
  dial.  :meth:`~WeightPublisher.publish` snapshots a parameter tree into
  a versioned, checksummed :class:`~blendjax_torch.weights.snapshot.Snapshot`
  (monotonic version id, learner step, per-leaf digest), optionally
  quantizes it for the wire, chunks large leaves, and streams
  ``begin``/``chunk``/``commit`` to every known subscriber.  Late joiners
  ask (``wb_sync``) and get the latest full snapshot before riding
  leaf-level deltas; a bounded history serves
  :meth:`~WeightPublisher.republish`, the rollback primitive (a prior
  version's weights under a fresh, higher version id);
- :class:`WeightSubscriber` — the server-side half, polled from the serve
  loop between ticks (never a thread of its own).  It drains its DEALER
  socket non-blocking, assembles and digest-verifies snapshots, discards
  torn (``weight_torn_discarded``) and mismatched
  (``weight_digest_rejected``) ones without half-applying, and asks for a
  full sync on a missed delta base or a silent publisher respawn.

The wire carries the reference's layout: :meth:`WeightPublisher.publish`
takes the parameter tree as the JAX package publishes it (nested dicts and
lists of numpy arrays; a torch learner converts its flat params with
:func:`blendjax_torch.models.convert.params_to_jax`), so either package's
subscriber reads either package's publisher.  The module imports no
torch: only ``publish`` with ``quantize=`` does, inside the call.

Run a standalone publisher process (the chaos tests SIGKILL it
mid-snapshot; it imports no torch)::

    python -m blendjax_torch.weights.bus --address tcp://127.0.0.1:24200 \
        --obs-dim 8 --interval-ms 500

It publishes ``{"w": ...}`` linear-model trees whose weights derive from
the version id (:func:`linear_tree`), so a test can tell from a serving
prediction which version produced it.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading
import time

import numpy as np

from blendjax_torch import wire
from blendjax_torch.utils.timing import fleet_counters
from blendjax_torch.weights.snapshot import (
    DEFAULT_CHUNK_BYTES,
    Snapshot,
    SnapshotAssembler,
    snapshot_messages,
)

logger = logging.getLogger("blendjax_torch")

#: Bound on remembered subscriber identities (idents of dead
#: subscribers age out oldest-first; a live one re-registers with every
#: sync/ack).
SUBSCRIBER_CAP = 256

#: How often an idle subscriber re-announces itself (``wb_sync``): the
#: keepalive that heals a silently-respawned publisher (fresh ROUTER,
#: empty subscriber table) and doubles as the late-joiner catch-up —
#: the publisher answers with a tiny version note when nothing is new.
RESYNC_INTERVAL_S = 2.0


def linear_tree(version, obs_dim):
    """The standalone publisher CLI's deterministic payload: a
    ``{"w": (obs_dim, obs_dim) f32}`` tree seeded by the version id (the
    recipe of ``LinearModel(seed=version)``), so a chaos test can tell
    from a serving prediction alone which version a replica is at."""
    rng = np.random.default_rng(int(version))
    return {"w": rng.standard_normal((int(obs_dim), int(obs_dim))).astype(np.float32)}


class WeightPublisher:
    """The learner-side half of the bus (module docstring).

    Params
    ------
    address: str
        Endpoint to bind (``tcp://host:*`` binds an ephemeral port;
        resolved endpoint on :attr:`address`).
    quantize: str | None
        Quantize snapshots for the wire (``"seqformer"`` / ``"policy"`` /
        ``"detector"``): the tree is converted to the port's params on the
        CPU, quantized by :func:`blendjax_torch.ops.quant.quantize_for_wire`
        and converted back, so its ``w_q`` and scales are bit-equal to the
        reference's quantizers on the same weights.  The subscribing
        server must serve the matching precision (``--int8``).  None ships
        float.
    chunk_bytes: int
        Chunk payload size (large leaves span chunks).
    history: int
        Published snapshots kept for late-joiner syncs and
        :meth:`republish` rollbacks.
    version_base: int | None
        Version ids start above this.  The default (None) derives the
        base from the wall clock, so ANY respawned publisher — embedded
        in a restarted learner, or the standalone process — starts
        above a predecessor that published less than one version per
        second, keeping versions monotonic across process deaths
        (subscribers never adopt backwards).  Pass an explicit base for
        deterministic version ids (tests).
    counters: EventCounters | None
        ``WEIGHT_EVENTS`` sink (the process-wide one when omitted).
    """

    def __init__(self, address="tcp://127.0.0.1:*", *, quantize=None,
                 chunk_bytes=DEFAULT_CHUNK_BYTES, history=4,
                 version_base=None, counters=None):
        import zmq

        self.quantize = quantize
        self.chunk_bytes = int(chunk_bytes)
        self.history_depth = max(1, int(history))
        self.counters = counters if counters is not None else fleet_counters
        self._ctx = zmq.Context.instance()
        self._lock = threading.RLock()
        self._sock = self._ctx.socket(zmq.ROUTER)
        self._sock.setsockopt(zmq.LINGER, 0)
        # a full pipe to one dead subscriber must cost THAT stream, not
        # block the learner's publish under the lock
        self._sock.setsockopt(zmq.SNDTIMEO, 100)
        if address.endswith(":*") or address.endswith(":0"):
            base = address.rsplit(":", 1)[0]
            port = self._sock.bind_to_random_port(base)
            self.address = f"{base}:{port}"
        else:
            self._sock.bind(address)
            self.address = address
        self._poller = zmq.Poller()
        self._poller.register(self._sock, zmq.POLLIN)
        self._version = (int(time.time()) if version_base is None
                         else int(version_base))
        self._history = []        # [(version, Snapshot)] newest last
        self._subs = {}           # ident -> last acked version (or None)
        self._hold = None         # chaos: (version, after_chunks)
        self._serve_thread = None
        self._serve_stop = None

    # -- publishing ----------------------------------------------------------

    @property
    def version(self):
        """The latest published version id (``version_base`` before the
        first publish)."""
        return self._version

    @property
    def subscribers(self):
        """``{ident bytes: last acked version}`` snapshot."""
        with self._lock:
            return dict(self._subs)

    def _latest(self):
        return self._history[-1] if self._history else None

    def publish(self, params, step=0, *, model=None):
        """Snapshot ``params`` (quantized for the wire when configured)
        under the next version id and stream it — as a leaf-level delta
        against the previous publish where digests allow — to every
        known subscriber.  Returns the version id."""
        if self.quantize is not None:
            from blendjax_torch.models.convert import params_from_jax, params_to_jax
            from blendjax_torch.ops.quant import quantize_for_wire

            params = params_to_jax(quantize_for_wire(
                params_from_jax(params, device="cpu"), self.quantize))
        with self._lock:
            self._version += 1
            snap = Snapshot.from_params(params, self._version, step,
                                        model=model)
            prev = self._latest()
            msgs = snapshot_messages(snap, prev=prev,
                                     chunk_bytes=self.chunk_bytes)
            self._history.append(snap)
            del self._history[:-self.history_depth]
            for ident in list(self._subs):
                self._stream(ident, msgs)
            self.counters.incr("weight_published")
            self.counters.incr(
                "weight_publish_bytes",
                msgs[0]["total_bytes"] * max(1, len(self._subs)),
            )
        return snap.version

    def republish(self, version):
        """The rollback primitive: re-publish the weights of a PRIOR
        version under a fresh, higher version id (version ids are
        monotonic — the fleet rolls *forward* to the old weights).
        Raises ``KeyError`` when the version has aged out of history."""
        with self._lock:
            old = next((s for s in self._history
                        if s.version == int(version)), None)
            if old is None:
                raise KeyError(
                    f"version {version} not in publisher history "
                    f"({[s.version for s in self._history]}); raise "
                    "history="
                )
            self._version += 1
            snap = Snapshot(self._version, old.step, old.leaves,
                            model=old.model, digests=old.digests)
            msgs = snapshot_messages(snap, prev=self._latest(),
                                     chunk_bytes=self.chunk_bytes)
            self._history.append(snap)
            del self._history[:-self.history_depth]
            for ident in list(self._subs):
                self._stream(ident, msgs)
            self.counters.incr("weight_published")
            self.counters.incr("weight_rollback_publishes")
        return snap.version

    def _stream(self, ident, msgs):
        """One subscriber's message stream; a send failure abandons the
        stream (the subscriber's stall timeout tears it and its next
        sync catches up)."""
        import zmq

        for msg in msgs:
            if self._hold is not None and msg.get("wb") == "chunk" \
                    and msg["version"] >= self._hold[0] \
                    and msg["seq"] >= self._hold[1]:
                # chaos hold: park mid-snapshot forever (the test
                # SIGKILLs us here — a deterministic torn stream)
                while True:
                    time.sleep(0.5)
            try:
                wire.send_message_router(self._sock, ident, msg,
                                         raw_buffers=True)
            except zmq.ZMQError:
                return

    # -- subscriber requests -------------------------------------------------

    def poll(self, timeout_ms=0):
        """Answer pending subscriber requests (``wb_sync``/``wb_ack``).
        Thread-safe with :meth:`publish`; the standalone process wraps
        it in :meth:`serve_forever`, an embedded publisher (inside a
        learner) calls :meth:`start` for a daemon thread."""
        import zmq

        if not self._poller.poll(timeout_ms):
            return 0
        n = 0
        with self._lock:
            while True:
                try:
                    ident, msg, _ = wire.recv_message_router_sized(
                        self._sock, flags=zmq.NOBLOCK
                    )
                except zmq.Again:
                    return n
                except zmq.ZMQError:
                    raise
                except Exception:  # noqa: BLE001 - rogue peer survives
                    continue
                n += 1
                cmd = msg.get("cmd")
                if cmd == "wb_ack":
                    if ident in self._subs:
                        # pop+reinsert: every sync/ack refreshes the
                        # ident's age, so the cap eviction below is
                        # LRU — churn of dead idents cannot evict a
                        # live, acking subscriber
                        self._subs.pop(ident)
                        self._subs[ident] = msg.get("version")
                    continue
                if cmd != "wb_sync":
                    continue
                self._subs[ident] = self._subs.pop(ident, None)
                while len(self._subs) > SUBSCRIBER_CAP:
                    self._subs.pop(next(iter(self._subs)))
                latest = self._latest()
                if latest is None:
                    self._reply(ident, {"wb": "none"})
                elif msg.get("have") == latest.version:
                    self._reply(ident, {"wb": "version",
                                        "version": latest.version})
                else:
                    # late joiner / re-sync: the FULL latest snapshot
                    # (no delta — we cannot know what base it holds)
                    self.counters.incr("weight_syncs")
                    self._stream(ident, snapshot_messages(
                        latest, prev=None, chunk_bytes=self.chunk_bytes
                    ))

    def _reply(self, ident, msg):
        import zmq

        try:
            wire.send_message_router(self._sock, ident, msg)
        except zmq.ZMQError:
            pass

    def serve_forever(self, stop_event=None, poll_ms=50):
        import zmq

        while stop_event is None or not stop_event.is_set():
            try:
                self.poll(poll_ms)
            except zmq.ZMQError:
                return  # socket closed under us: clean shutdown

    def start(self, poll_ms=50):
        """Serve subscriber requests from a daemon thread (re-startable
        after :meth:`stop`)."""
        if self._serve_thread is not None:
            return self
        self._serve_stop = threading.Event()
        self._serve_thread = threading.Thread(
            target=self.serve_forever,
            kwargs={"stop_event": self._serve_stop, "poll_ms": poll_ms},
            daemon=True, name="bjx-weight-publisher",
        )
        self._serve_thread.start()
        return self

    def stop(self):
        """Stop the serve thread (the socket stays bound: publishes
        still stream, but syncs go unanswered until :meth:`start`)."""
        if self._serve_thread is not None:
            self._serve_stop.set()
            self._serve_thread.join(timeout=5)
            self._serve_thread = None
            self._serve_stop = None

    def close(self):
        self.stop()
        try:
            self._sock.close(0)
        except Exception:  # noqa: BLE001 - shutdown best-effort
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class WeightSubscriber:
    """The serving-side half of the bus: polled (never threaded) from
    the server's tick loop, so a verified snapshot is staged off-tick
    and hot-swapped *between* ticks.

    ``counters``/``timer`` default to None and are inherited from the
    attaching :class:`~blendjax_torch.serve.server.PolicyServer` (or fall
    back to the process-wide registry when used standalone)."""

    def __init__(self, address, *, model=None, counters=None, timer=None,
                 stall_timeout_s=5.0):
        import zmq

        self.address = address
        #: hosted-model id snapshots apply to (None = server default)
        self.model = model
        self.counters = counters
        self.timer = timer
        self._ctx = zmq.Context.instance()
        self.sock = self._ctx.socket(zmq.DEALER)
        self.sock.setsockopt(zmq.LINGER, 0)
        self.sock.connect(address)
        self._asm = SnapshotAssembler(stall_timeout_s=stall_timeout_s)
        self._next_sync = 0.0  # sync immediately on first poll
        self._next_stale_warn = 0.0

    @property
    def _ctrs(self):
        return self.counters if self.counters is not None \
            else fleet_counters

    @property
    def version(self):
        """Version of the last complete, verified snapshot (None before
        the first)."""
        return self._asm.version

    def _send(self, msg):
        import zmq

        try:
            wire.send_message_dealer(self.sock, msg,
                                     flags=zmq.DONTWAIT)
        except zmq.ZMQError:
            pass  # publisher gone; the next resync interval retries

    def request_sync(self):
        """Ask the publisher for the latest full snapshot (late-joiner
        catch-up; also the heal after a torn delta base)."""
        self._send({"cmd": "wb_sync", "have": self.version})
        self._next_sync = time.monotonic() + RESYNC_INTERVAL_S

    def _warn_stale(self, version):
        """A publisher whose latest version sits BELOW our adopted one
        can never update this fleet (versions never adopt backwards) —
        usually a respawned publisher whose version base was not raised
        past its predecessor.  Warn, debounced: silently holding the
        last good version forever would be indistinguishable from a
        healthy idle bus."""
        now = time.monotonic()
        if now < self._next_stale_warn:
            return
        self._next_stale_warn = now + 5.0
        logger.warning(
            "weight subscriber (%s): publisher offers v%s but v%s is "
            "already adopted — versions never run backwards, so this "
            "publisher can NEVER update us (a respawned publisher must "
            "start above its predecessor; WeightPublisher's default "
            "wall-clock version_base does, an explicit low base does "
            "not).  Holding the last good version.",
            self.address, version, self.version,
        )

    def poll(self):
        """Drain the socket non-blocking; returns the NEWEST complete,
        digest-verified :class:`Snapshot` staged by this drain (or
        None).  Torn and digest-rejected streams are discarded and
        counted here — the caller only ever sees whole snapshots."""
        import zmq

        if self._asm.check_stalled() == "torn":
            self._ctrs.incr("weight_torn_discarded")
            self.request_sync()
        staged = None
        while True:
            try:
                msg = wire.recv_message_dealer(self.sock,
                                               flags=zmq.NOBLOCK)
            except zmq.Again:
                break
            except zmq.ZMQError:
                raise
            except Exception:  # noqa: BLE001 - undecodable frame
                self._ctrs.incr("weight_torn_discarded")
                continue
            if msg.get("wb") in ("none", "version"):
                v = msg.get("version")
                if v is not None and self.version is not None \
                        and v < self.version:
                    self._warn_stale(v)
                continue
            t0 = time.perf_counter()
            snap, reason = self._asm.feed(msg)
            if reason == "torn":
                self._ctrs.incr("weight_torn_discarded")
            elif reason == "stale":
                self._warn_stale(int(msg.get("version", -1)))
            elif reason == "digest":
                self._ctrs.incr("weight_digest_rejected")
                self.request_sync()
            elif reason == "need_full":
                self.request_sync()
            if snap is not None:
                if self.timer is not None:
                    self.timer.add("weight_assemble",
                                   time.perf_counter() - t0)
                staged = snap  # newest wins within one drain
                self._send({"cmd": "wb_ack", "version": snap.version})
        if time.monotonic() >= self._next_sync \
                and not self._asm.in_flight:
            # first-contact sync, publisher-respawn heal, and keepalive
            # in one: a publisher that already answered with our exact
            # version costs one tiny message per interval.  Decided
            # AFTER the drain and suppressed mid-assembly — a sync
            # fired while a stream is arriving buys a duplicate full
            # snapshot (a stream slower than the resync interval would
            # re-trigger one every interval); a stream that DIED
            # mid-assembly is check_stalled's to tear (which re-arms
            # the sync above)
            self.request_sync()
        return staged

    def close(self):
        try:
            self.sock.close(0)
        except Exception:  # noqa: BLE001 - shutdown best-effort
            pass


# ---------------------------------------------------------------------------
# standalone publisher process (chaos surface)
# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Standalone WeightPublisher: streams versioned "
                    "linear-model weight snapshots (version-seeded, so "
                    "a serving prediction identifies its version)."
    )
    ap.add_argument("--address", required=True)
    ap.add_argument("--obs-dim", type=int, default=8)
    ap.add_argument("--interval-ms", type=float, default=500.0)
    ap.add_argument("--publishes", type=int, default=0,
                    help="stop after N publishes (0 = run until "
                         "signalled)")
    ap.add_argument("--version-base", type=int, default=None,
                    help="version ids start above this; default derives "
                         "from the wall clock so a respawned publisher "
                         "stays monotonic past its predecessor")
    ap.add_argument("--chunk-bytes", type=int,
                    default=DEFAULT_CHUNK_BYTES)
    ap.add_argument("--hold-at-version", type=int, default=None,
                    help="chaos: park forever mid-snapshot once this "
                         "version's stream reaches --hold-after-chunks "
                         "(the test SIGKILLs the parked process)")
    ap.add_argument("--hold-after-chunks", type=int, default=1)
    ap.add_argument("--wait-subscribers", type=int, default=0,
                    help="block the first publish until this many "
                         "subscribers have announced themselves (tests "
                         "use it to make publish-vs-subscribe ordering "
                         "deterministic)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    pub = WeightPublisher(args.address, version_base=args.version_base,
                          chunk_bytes=args.chunk_bytes)
    if args.hold_at_version is not None:
        pub._hold = (args.hold_at_version, args.hold_after_chunks)
    stop = threading.Event()

    def _term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    logger.info("weight publisher at %s (version base %d)",
                pub.address, pub.version)
    published = 0
    try:
        while not stop.is_set() and \
                len(pub.subscribers) < args.wait_subscribers:
            pub.poll(20)
        while not stop.is_set():
            v = pub.publish(linear_tree(pub.version + 1, args.obs_dim), step=published)
            published += 1
            logger.info("published weights v%d", v)
            if args.publishes and published >= args.publishes:
                break
            deadline = time.monotonic() + args.interval_ms / 1000.0
            while not stop.is_set() and time.monotonic() < deadline:
                pub.poll(20)
    finally:
        pub.close()


if __name__ == "__main__":
    main()
