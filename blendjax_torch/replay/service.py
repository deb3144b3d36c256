"""Replay shard service: one durable :class:`ColumnStore` behind the wire,
the port of ``blendjax.replay.service``.

The split of responsibilities:

- a **shard** (this module) is storage and durability: a columnar ring
  (:class:`~blendjax_torch.replay.ring.ColumnStore`) served over the
  DEALER<->REP wire protocol, every accepted append journaled to a
  ``.btr`` spill log (:class:`~blendjax_torch.btt.file.FileRecorder`,
  flushed before the ack, so an acked row survives a SIGKILL the next
  instant) and checkpointed atomically
  (:func:`blendjax_torch.utils.checkpoint.save_state`).  Restart = load
  the latest checkpoint, replay the spill tail (the crash-tolerant
  :func:`~blendjax_torch.btt.file.scan_messages` scan), serve: the
  pre-crash contents, bit for bit;
- the **client** (:class:`~blendjax_torch.replay.shard_client.ShardedReplay`)
  owns every sampling decision: the sum tree, the seeded RNG, the
  eligibility and generation masks.  Shards never agree on a draw, and a
  dead shard costs exactly its slot range.

The wire, the checkpoint and the spill are the reference's, so either
package's client drives either package's shards.

Exactly-once RPCs: the client stamps every request with a
``wire.BTMID_KEY`` correlation id and a fault-policy retry re-sends the
same id; the shard answers a retried mutating request (``append``,
``save``) from a bounded reply cache instead of applying it twice.

Run a shard as a process (imports neither torch nor jax, for a fast
start and a fast respawn)::

    python -m blendjax_torch.replay.service --address tcp://127.0.0.1:23000 \
        --capacity 65536 --shard-id 0 --dir /data/replay \
        --checkpoint-every 4096

or in-process via :func:`start_shard_thread`, or as a supervised fleet via
:class:`ShardFleet` (a launcher-compatible surface, so
:class:`~blendjax_torch.btt.supervise.FleetSupervisor` respawns dead shard
processes and drives the client's re-admission probes).
``ShardFleet.grow(restore_ckpt=)`` and ``retire`` are the storage half of
live resharding (:func:`blendjax_torch.autoscale.reshard_replay`).  The
reference's zero-copy gather straight into the reply ring is not ported: a
gather over shm is copied once into recycled buffers and once into the
ring.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from collections import OrderedDict, deque

import numpy as np

from blendjax_torch import wire
from blendjax_torch.btt import shm_rpc
from blendjax_torch.btt.file import FileRecorder, scan_messages
from blendjax_torch.obs.spans import make_span, now_us
from blendjax_torch.replay.ring import ColumnStore
from blendjax_torch.utils.timing import StageTimer, fleet_counters

logger = logging.getLogger("blendjax_torch")

#: Checkpoint format tag (shard side; the client checkpoint carries
#: ``blendjax_torch.replay.sharded/1``).
SHARD_FORMAT = "blendjax.replay.shard/1"

#: Spill-log capacity per file when auto-checkpointing is off.  A spill
#: that fills forces a checkpoint (rotating to a fresh file) rather
#: than dropping records — the append ack promises durability — so this
#: also bounds the recovery-replay tail.  Kept moderate because the
#: ``.btr`` header is a pickled int64 offsets array of this length,
#: written at open and rewritten at close (8 bytes/slot of header I/O
#: per rotation).
SPILL_CAPACITY = 65536

#: How long a fleet's shard processes have to answer ``hello`` at start.
READY_TIMEOUT_S = 30.0

#: Bound on the in-memory (seq, slot) tail mirror behind the
#: ``written_since`` RPC.  At the cap, the oldest entry evicts and the
#: tail's completeness floor rises to its seq — a query below the
#: floor reports INCOMPLETE and the client rolls the whole shard range
#: back instead of trusting a partial answer.
TAIL_SLOTS_CAP = 65536


class ReplayShard:
    """One replay storage shard: columnar ring + spill log + checkpoints,
    served over a REP socket.

    Params
    ------
    address: str
        Endpoint to bind.  ``tcp://host:*`` binds an ephemeral port;
        the resolved endpoint is available as :attr:`address`.
    capacity: int
        Ring slots this shard owns.
    shard_id: int
        Identity reported in ``hello`` replies and used in on-disk
        names (``shard_{id:02d}.*``).
    data_dir: str | None
        Durability root.  None disables both tiers (a pure in-memory
        shard — fine for benchmarks, no crash recovery).
    checkpoint_every: int
        Auto-checkpoint after this many appends since the last one
        (0 = only on explicit ``save`` RPCs).  The spill log rotates at
        every checkpoint, so recovery replays a bounded tail.
    counters: EventCounters | None
        Sink for ``record_drops`` etc.; defaults to the process-wide
        ``fleet_counters``.
    shm_base: str | None
        ``/dev/shm`` name prefix for this shard's ShmRPC transport
        (``--shm-base``): supervised fleets pass one so the PARENT can
        sweep leaked objects after a SIGKILL (docs/transport.md).
        Generated when None.  The transport itself only exists when
        :func:`blendjax_torch.btt.shm_rpc.enabled` (kill-switch
        ``BJX_NO_SHM_RPC=1`` pins the shard to pure ZMQ).
    """

    def __init__(self, address, capacity, *, shard_id=0, data_dir=None,
                 checkpoint_every=0, counters=None,
                 shm_base=None):
        import zmq

        self.shard_id = int(shard_id)
        self.capacity = int(capacity)
        self.data_dir = data_dir
        self.checkpoint_every = int(checkpoint_every)
        self.counters = counters if counters is not None else fleet_counters
        #: server-side stage timer (``shard_srv_<cmd>`` per request, with
        #: latency histograms) — shipped to clients by the ``telemetry``
        #: RPC so a consumer-side TelemetryHub can merge this process's
        #: percentiles without any exporter running here
        self.timer = StageTimer()
        self.store = ColumnStore(self.capacity)
        #: total rows ever accepted (the durability cursor: checkpoint
        #: meta and spill records carry it, restore resumes from it)
        self.seq = 0
        self._last_ckpt_seq = 0
        self.restored_from = None  # (ckpt_seq, tail_records) after restore
        #: (seq, slot) of recent appends — the in-memory mirror behind
        #: the ``written_since`` RPC (learner-failover restore
        #: reconciles a rewound client against the slots written past
        #: its cut; see docs/fault_tolerance.md "Learner failover").
        #: Retained ACROSS checkpoints — a client's cut can predate the
        #: shard's latest checkpoint (the learner died between a
        #: barrier's shard save and its manifest commit) and the query
        #: must still answer.  ``_tail_floor`` is the durability cursor
        #: the tail is complete back to: it rises only when the bounded
        #: deque evicts (or on process restart, where appends before
        #: the restored checkpoint are unknowable) — a query below the
        #: floor is honestly incomplete instead of wrong.
        self._tail_slots = deque()
        self._tail_floor = 0
        self._spill = None
        if data_dir is not None:
            os.makedirs(data_dir, exist_ok=True)
            self._restore_from_disk()
            self._open_spill()
        self._reply_cache = OrderedDict()  # mid -> reply (mutating cmds)
        self._gather_bufs = {}  # recycled gather-reply buffers (shm path)
        self._reply_synchronous = False  # True while serving an shm request
        self._sock = zmq.Context.instance().socket(zmq.REP)
        self._sock.setsockopt(zmq.LINGER, 0)
        if address.endswith(":*") or address.endswith(":0"):
            base = address.rsplit(":", 1)[0]
            port = self._sock.bind_to_random_port(base)
            self.address = f"{base}:{port}"
        else:
            self._sock.bind(address)
            self.address = address
        #: same-host shm transport (None when disabled/unavailable):
        #: the ZMQ socket stays the control plane and remote fallback
        self._shm = None
        if shm_rpc.enabled():
            self._shm = shm_rpc.ShmRpcServer(
                base=shm_base or shm_rpc.new_base(f"rs{self.shard_id}"),
                counters=self.counters, bytes_counter="replay_shm_bytes",
                who=f"replay shard {self.shard_id}",
            )

    @property
    def shm_endpoint(self):
        """The advertised ``shm://`` endpoint (None on pure-ZMQ shards)."""
        return self._shm.endpoint if self._shm is not None else None

    # -- durability ----------------------------------------------------------

    def _ckpt_path(self):
        return os.path.join(
            self.data_dir, f"shard_{self.shard_id:02d}.ckpt.npz"
        )

    def _spill_paths(self):
        return sorted(glob.glob(os.path.join(
            self.data_dir, f"shard_{self.shard_id:02d}.spill-*.btr"
        )))

    def _open_spill(self):
        path = os.path.join(
            self.data_dir,
            f"shard_{self.shard_id:02d}.spill-{self.seq:012d}.btr",
        )
        # header cost is 8 bytes per slot at open AND close: size the
        # file to its actual rotation interval instead of a worst case
        cap = (
            max(1024, 4 * self.checkpoint_every)
            if self.checkpoint_every > 0 else SPILL_CAPACITY
        )
        self._spill = FileRecorder(
            path, max_messages=cap, counters=self.counters
        ).__enter__()

    def _restore_from_disk(self):
        """Latest checkpoint + spill tail -> exact pre-crash contents."""
        from blendjax_torch.utils.checkpoint import load_state

        ckpt = self._ckpt_path()
        if os.path.exists(ckpt):
            arrays, meta = load_state(ckpt)
            if meta.get("format") != SHARD_FORMAT:
                raise ValueError(
                    f"{ckpt} is not a replay shard checkpoint "
                    f"(format {meta.get('format')!r})"
                )
            if int(meta["capacity"]) != self.capacity:
                raise ValueError(
                    f"shard {self.shard_id}: checkpoint capacity "
                    f"{meta['capacity']} != configured {self.capacity}"
                )
            self.store.load_state_arrays(arrays)
            self.seq = int(meta["seq"])
            self._last_ckpt_seq = self.seq
            # appends before the restored checkpoint left no tail
            # record; the spill replay below re-adds everything newer
            self._tail_floor = self.seq
        tail = 0
        for path in self._spill_paths():
            # scan, never FileReader: a killed shard's spill has an
            # unfinalized header, and the tail past the checkpoint is
            # exactly the data a crash would otherwise lose
            for rec in scan_messages(path):
                if int(rec["seq"]) <= self.seq:
                    continue  # covered by the checkpoint
                self.store.write_row(int(rec["slot"]), rec["row"])
                self.seq = int(rec["seq"])
                self._tail_note(int(rec["slot"]))
                tail += 1
        if os.path.exists(ckpt) or tail:
            self.restored_from = (self._last_ckpt_seq, tail)
            logger.info(
                "replay shard %d restored: checkpoint seq %d + %d spill-"
                "tail rows -> seq %d", self.shard_id, self._last_ckpt_seq,
                tail, self.seq,
            )

    def checkpoint(self):
        """Atomic snapshot of the columns + seq cursor, then spill-log
        rotation (old spills are fully covered by the snapshot and
        deleted; a crash between the two steps is safe — restore skips
        spill records at or below the checkpoint seq)."""
        if self.data_dir is None:
            return None
        from blendjax_torch.utils.checkpoint import save_state

        path = self._ckpt_path()
        save_state(
            path, dict(self.store.state_arrays()),
            {
                "format": SHARD_FORMAT,
                "shard_id": self.shard_id,
                "capacity": self.capacity,
                "seq": self.seq,
            },
        )
        self._last_ckpt_seq = self.seq
        if self._spill is not None:
            self._spill.__exit__(None, None, None)
        for old in self._spill_paths():
            try:
                os.unlink(old)
            except OSError:
                pass
        self._open_spill()
        return path

    # -- request handling ----------------------------------------------------

    def handle(self, msg):
        """Dispatch one decoded request dict -> reply dict (correlation
        id echoed; retried mutating requests served from the reply
        cache — exactly-once at the storage level).  A request carrying
        a span context (``wire.SPAN_KEY``) gets this shard's
        recv->storage->reply span piggybacked on the reply (a cached
        reply keeps the ORIGINAL simulation's span — the retry did no
        storage work)."""
        mid = msg.get(wire.BTMID_KEY)
        cmd = msg.get("cmd")
        if mid is not None and cmd in ("append", "save") \
                and mid in self._reply_cache:
            return self._reply_cache[mid]
        span_ctx = msg.get(wire.SPAN_KEY)
        t0_us = now_us() if isinstance(span_ctx, dict) else 0
        t0 = time.perf_counter()
        try:
            reply = getattr(self, f"_cmd_{cmd}", self._cmd_unknown)(msg)
        except Exception as exc:  # noqa: BLE001 - surfaced to the client
            logger.exception(
                "replay shard %d: %r failed", self.shard_id, cmd
            )
            reply = {"error": f"{type(exc).__name__}: {exc}"}
        # stage name clamped to DISPATCHED commands: the cmd string is
        # client-supplied, and one histogram per distinct garbage value
        # would grow timer memory (and scrape cardinality) unboundedly
        stage = (
            f"shard_srv_{cmd}"
            if hasattr(self, f"_cmd_{cmd}") else "shard_srv_unknown"
        )
        self.timer.add(stage, time.perf_counter() - t0)
        if isinstance(span_ctx, dict) and span_ctx.get("trace") is not None:
            reply[wire.SPANS_KEY] = [make_span(
                f"shard{self.shard_id}:{cmd}", t0_us,
                trace=span_ctx["trace"], cat="replay_shard",
            )]
        if mid is not None:
            reply[wire.BTMID_KEY] = mid
            if cmd in ("append", "save"):
                self._reply_cache[mid] = reply
                while len(self._reply_cache) > wire.REPLY_CACHE_DEPTH:
                    self._reply_cache.popitem(last=False)
        return reply

    def _cmd_unknown(self, msg):
        raise ValueError(f"unknown replay shard command {msg.get('cmd')!r}")

    def _cmd_hello(self, msg):
        return {
            "shard_id": self.shard_id,
            "capacity": self.capacity,
            "seq": self.seq,
            "keys": list(self.store.keys),
            "restored_from": self.restored_from,
            # shm endpoint advertisement (None = pure-ZMQ shard); the
            # actual upgrade negotiation rides shm_connect/shm_attach
            "shm": self._shm.info() if self._shm is not None else None,
        }

    def _cmd_append(self, msg):
        slots = msg["slots"]
        rows = msg["rows"]
        if len(slots) != len(rows):
            raise ValueError(
                f"append: {len(slots)} slots vs {len(rows)} rows"
            )
        for slot, row in zip(slots, rows):
            self.store.write_row(int(slot), row)
            self.seq += 1
            self._tail_note(int(slot))
            if self._spill is not None:
                rec = {"slot": int(slot), "seq": self.seq, "row": row}
                if not self._spill.save(rec):
                    # spill at capacity: the ack below promises this row
                    # survives a crash, so roll a checkpoint (which
                    # rotates to a fresh spill) instead of dropping
                    self.checkpoint()
                    if not self._spill.save(rec):
                        raise RuntimeError(
                            f"shard {self.shard_id}: spill refused a "
                            "record even after rotation"
                        )
        if self._spill is not None:
            # durability point: the ack promises crash-exact recovery,
            # so the spill bytes must reach the OS before the reply does
            self._spill.flush()
        if self.checkpoint_every > 0 and \
                self.seq - self._last_ckpt_seq >= self.checkpoint_every:
            self.checkpoint()
        return {"seq": self.seq}

    def _cmd_gather(self, msg):
        indices = np.asarray(msg["indices"], np.int64)
        keys = msg.get("keys")
        out = self._gather_dst if self._reply_synchronous else None
        data = self.store.gather(indices, keys=keys, out=out)
        return {"data": data, "seq": self.seq}

    def _gather_dst(self, key, shape, dtype):
        """Recycled gather-reply buffers: fresh multi-MB batches pay
        page faults on every RPC that a reused destination never sees.
        Only offered on the shm reply path (``_reply_synchronous``):
        ``send_frames`` memcpys into the ring BEFORE returning, so the
        next request can never observe a half-overwritten buffer —
        whereas ZMQ's ``copy=False`` send keeps the frames referenced
        asynchronously."""
        buf = self._gather_bufs.get(key)
        if buf is None or buf.shape != shape or buf.dtype != dtype:
            buf = self._gather_bufs[key] = np.empty(shape, dtype)
        return buf

    def _cmd_stats(self, msg):
        return {
            "shard_id": self.shard_id,
            "capacity": self.capacity,
            "seq": self.seq,
            "nbytes": self.store.nbytes,
            "keys": list(self.store.keys),
            "last_checkpoint_seq": self._last_ckpt_seq,
            "spill_dropped": (
                self._spill.dropped if self._spill is not None else 0
            ),
        }

    def _cmd_save(self, msg):
        path = self.checkpoint()
        return {"path": path, "seq": self.seq}

    def _tail_note(self, slot):
        self._tail_slots.append((self.seq, slot))
        if len(self._tail_slots) > TAIL_SLOTS_CAP:
            evicted_seq, _ = self._tail_slots.popleft()
            self._tail_floor = evicted_seq

    def _cmd_written_since(self, msg):
        """Slots this shard wrote after durability cursor ``seq`` —
        the learner-failover reconcile query (a client restored from a
        checkpoint cut at ``seq`` invalidates exactly these slots: they
        hold rows its rewound draw state does not describe, and the
        resumed appends will rewrite them in the same ring order).
        The tail survives checkpoints — a cut can legitimately predate
        the shard's LATEST checkpoint when the learner died between a
        barrier's shard save and its manifest commit.
        ``complete=False`` when the tail cannot answer exactly (the cut
        predates the bounded mirror's floor: eviction, or a process
        restart whose pre-checkpoint appends are unknowable) — the
        caller rolls the whole range back instead of trusting a
        partial list."""
        since = int(msg["seq"])
        complete = since >= self._tail_floor
        slots = sorted({
            slot for q, slot in self._tail_slots if q > since
        }) if complete else []
        return {
            "seq": self.seq,
            "complete": bool(complete),
            "slots": slots,
        }

    def _cmd_telemetry(self, msg):
        """This process's telemetry in the TelemetryHub merge shape:
        counters + per-stage latency histograms (serialized sparse).
        The PULL half of cross-process scraping — a consumer-side hub
        registers ``lambda: client.rpc("telemetry")`` as a remote and
        this shard needs no exporter, no extra socket, no jax."""
        return {
            "shard_id": self.shard_id,
            "pid": os.getpid(),
            "seq": self.seq,
            "counters": self.counters.snapshot(),
            "stages": self.timer.snapshot_serialized(),
        }

    # -- serving -------------------------------------------------------------

    def _handle_shm(self, chan, msg):
        """One shm-delivered request: same dispatch, reply down the
        same channel (span piggybacks, reply cache, correlation ids —
        all transport-blind inside :meth:`handle`).  The synchronous
        reply write unlocks the recycled gather buffers."""
        self._reply_synchronous = True
        try:
            reply = self.handle(msg)
            self._shm.send(chan, reply)
        finally:
            self._reply_synchronous = False

    def serve_forever(self, stop_event=None, poll_ms=100):
        """Serve loop until ``stop_event`` (or :meth:`close`): the REP
        socket (one request == one reply; raw-buffer replies keep image
        gathers off the pickle path) and, when ShmRPC is up, every
        attached shm channel — the transport's doorbell fd parks in the
        same poller, so shm requests wake the loop as promptly as ZMQ
        ones."""
        import zmq

        poller = zmq.Poller()
        poller.register(self._sock, zmq.POLLIN)
        if self._shm is not None and self._shm.fd is not None:
            poller.register(self._shm.fd, zmq.POLLIN)
        while stop_event is None or not stop_event.is_set():
            try:
                events = dict(poller.poll(poll_ms))
            except zmq.ZMQError:
                return  # socket closed under us: clean shutdown
            if self._shm is not None:
                self._shm.pump(self._handle_shm)
            if self._sock not in events:
                continue
            try:
                msg, nbytes = wire.recv_message_sized(self._sock)
            except zmq.ZMQError:
                return
            self.counters.incr("replay_wire_bytes", nbytes)
            # shm control commands are transport negotiation, not
            # storage workload: answered outside handle() (no reply
            # cache, no stage timer, no request counters)
            reply = shm_rpc.control_reply(self._shm, msg)
            if reply is None:
                reply = self.handle(msg)
            try:
                sent = wire.send_message(self._sock, reply,
                                         raw_buffers=True)
                self.counters.incr("replay_wire_bytes", sent)
            except zmq.ZMQError:
                return

    def close(self):
        try:
            self._sock.close(0)
        except Exception:  # noqa: BLE001 - shutdown best-effort
            pass
        if self._shm is not None:
            try:
                self._shm.close(unlink=True)
            except Exception:  # noqa: BLE001
                pass
            self._shm = None
        if self._spill is not None:
            try:
                self._spill.__exit__(None, None, None)
            except Exception:  # noqa: BLE001
                pass
            self._spill = None


class _LocalShardHandle:
    """An in-process shard server (thread) for tests and benchmarks."""

    def __init__(self, shard, thread, stop):
        self.shard = shard
        self.address = shard.address
        self._thread = thread
        self._stop = stop

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.shard.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_shard_thread(capacity, *, shard_id=0, data_dir=None,
                       checkpoint_every=0, address="tcp://127.0.0.1:*",
                       counters=None):
    """Serve a :class:`ReplayShard` from a daemon thread; returns a
    handle with ``.address`` and ``.close()``.  Same wire surface as a
    shard process — the benchmark's service windows and most service
    tests run on these."""
    shard = ReplayShard(
        address, capacity, shard_id=shard_id, data_dir=data_dir,
        checkpoint_every=checkpoint_every, counters=counters,
    )
    stop = threading.Event()
    thread = threading.Thread(
        target=shard.serve_forever, kwargs={"stop_event": stop},
        daemon=True, name=f"bjx-replay-shard-{shard_id}",
    )
    thread.start()
    return _LocalShardHandle(shard, thread, stop)


class _ShardLaunchInfo:
    """Duck-typed ``launch_info`` so :class:`~blendjax_torch.btt.watchdog.
    FleetWatchdog` / :class:`~blendjax_torch.btt.supervise.FleetSupervisor`
    supervise shard processes exactly like Blender producers.  The
    shards' ``shm://`` endpoints ride along under ``REPLAY_SHM`` (empty
    when ShmRPC is disabled) — the launch-info half of the transport
    advertisement; clients negotiate the actual upgrade in-band."""

    def __init__(self, processes, addresses, shm_addresses=()):
        self.processes = processes
        self.addresses = {"REPLAY": addresses,
                          "REPLAY_SHM": list(shm_addresses)}


class ShardFleet:
    """N replay shard *processes* with a launcher-compatible surface.

    Each shard binds ``tcp://127.0.0.1:<port_i>``, persists under
    ``data_dir`` and is spawned in its own session (so
    :func:`blendjax_torch.btt.chaos.kill_instance` kills the shard, not the
    test).  ``respawn(idx)`` relaunches the same command line — the
    restarted process restores its checkpoint + spill tail on its own —
    which is what :class:`~blendjax_torch.btt.supervise.FleetSupervisor` calls
    after a death.

    Usage::

        with ShardFleet(3, capacity_per_shard=4096, data_dir=d) as fleet:
            sharded = ShardedReplay(fleet.addresses, seed=0)
            sup = FleetSupervisor(fleet, pool=None, replay=sharded,
                                  counters=sharded.counters)
    """

    def __init__(self, num_shards, capacity_per_shard, data_dir, *,
                 checkpoint_every=1024):
        if num_shards < 1 or capacity_per_shard < 1:
            raise ValueError(
                "num_shards and capacity_per_shard must be >= 1"
            )
        self.num_shards = int(num_shards)
        self.capacity_per_shard = int(capacity_per_shard)
        self.data_dir = data_dir
        self.checkpoint_every = int(checkpoint_every)
        self.addresses = []
        self.launch_info = None
        self._cmds = []
        #: per-shard /dev/shm prefixes, allocated HERE (the parent) so
        #: teardown and the watchdog respawn path can sweep the objects
        #: a SIGKILLed shard (and its clients) left behind
        self.shm_bases = [
            shm_rpc.new_base(f"sf{i}") if shm_rpc.enabled() else None
            for i in range(self.num_shards)
        ]

    def _spawn(self, cmd):
        # shared child-environment policy (see launcher.child_env:
        # repo root prepended to PYTHONPATH); function-level import so
        # the shard child's own fast-start surface stays lean
        from blendjax_torch.btt.launcher import child_env

        return subprocess.Popen(cmd, env=child_env(),
                                start_new_session=True)

    def __enter__(self):
        from blendjax_torch.replay.shard_client import free_port

        os.makedirs(self.data_dir, exist_ok=True)
        procs = []
        try:
            for i in range(self.num_shards):
                addr = f"tcp://127.0.0.1:{free_port()}"
                cmd = [
                    sys.executable, "-m", "blendjax_torch.replay.service",
                    "--address", addr,
                    "--capacity", str(self.capacity_per_shard),
                    "--shard-id", str(i),
                    "--dir", str(self.data_dir),
                    "--checkpoint-every", str(self.checkpoint_every),
                ]
                if self.shm_bases[i] is not None:
                    cmd += ["--shm-base", self.shm_bases[i]]
                procs.append(self._spawn(cmd))
                self.addresses.append(addr)
                self._cmds.append(cmd)
            self.launch_info = _ShardLaunchInfo(
                procs, self.addresses, self._shm_addresses()
            )
            self.wait_ready(READY_TIMEOUT_S)
        except BaseException:
            self.launch_info = _ShardLaunchInfo(
                procs, self.addresses, self._shm_addresses()
            )
            self.close()
            raise
        return self

    def _shm_addresses(self):
        return [f"shm://{b}" for b in self.shm_bases if b is not None]

    def wait_ready(self, timeout=30.0):
        """Block until every shard answers ``hello`` — the deterministic
        startup barrier (counters measured after it reflect injected
        faults only, never shard boot time)."""
        deadline = time.monotonic() + timeout
        for i, addr in enumerate(self.addresses):
            self._wait_one(i, addr, deadline - time.monotonic())

    @staticmethod
    def _wait_one(i, addr, timeout):
        from blendjax_torch.replay.shard_client import ShardClient

        deadline = time.monotonic() + timeout
        while True:
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"replay shard {i} at {addr} not ready within "
                    f"{timeout:.1f}s"
                )
            client = ShardClient(addr, i, timeoutms=500)
            try:
                client.rpc("hello", timeout_ms=500)
                return
            except TimeoutError:
                continue
            finally:
                client.close()

    def respawn(self, idx):
        """Relaunch shard ``idx`` with its original command line (the
        watchdog's contract).  The fresh process restores checkpoint +
        spill tail from ``data_dir`` before serving.  The dead
        incarnation's ``/dev/shm`` objects (rings, bells — a SIGKILL
        runs no cleanup) are swept FIRST, so generations cannot pile up
        across a chaos run's kill/respawn cycles."""
        if (self.launch_info is not None
                and self.launch_info.processes[idx] is None):
            raise RuntimeError(
                f"replay shard {idx} is retired; a retired slot is "
                "never respawned"
            )
        if self.shm_bases[idx] is not None:
            shm_rpc.unlink_base(self.shm_bases[idx])
        proc = self._spawn(self._cmds[idx])
        self.launch_info.processes[idx] = proc
        return proc

    def grow(self, restore_ckpt=None):
        """Spawn one more shard process (the storage half of live replay
        resharding).  With ``restore_ckpt`` the new shard boots holding a
        source shard's rows: the checkpoint file is copied under the new
        shard's own name before launch, so its restore adopts it (the
        restore checks format and capacity, not the shard id).  Without it
        any stale state for the new index is removed and the shard boots
        empty.  Blocks until the shard answers ``hello``; on failure the
        process is retired.  Returns ``(idx, address)``."""
        import shutil

        from blendjax_torch.replay.shard_client import free_port

        if self.launch_info is None:
            raise RuntimeError("ShardFleet.grow before __enter__")
        idx = self.num_shards
        os.makedirs(self.data_dir, exist_ok=True)
        ckpt = os.path.join(self.data_dir, f"shard_{idx:02d}.ckpt.npz")
        for stale in glob.glob(os.path.join(
                self.data_dir, f"shard_{idx:02d}.spill-*.btr")):
            os.remove(stale)
        if restore_ckpt is not None:
            shutil.copyfile(restore_ckpt, ckpt)
        elif os.path.exists(ckpt):
            os.remove(ckpt)
        addr = f"tcp://127.0.0.1:{free_port()}"
        base = shm_rpc.new_base(f"sf{idx}") if shm_rpc.enabled() else None
        cmd = [
            sys.executable, "-m", "blendjax_torch.replay.service",
            "--address", addr,
            "--capacity", str(self.capacity_per_shard),
            "--shard-id", str(idx),
            "--dir", str(self.data_dir),
            "--checkpoint-every", str(self.checkpoint_every),
        ]
        if base is not None:
            cmd += ["--shm-base", base]
        proc = self._spawn(cmd)
        self.shm_bases.append(base)
        self._cmds.append(cmd)
        self.num_shards = idx + 1
        self.addresses.append(addr)  # aliased by launch_info (REPLAY)
        self.launch_info.processes.append(proc)
        if base is not None:
            self.launch_info.addresses["REPLAY_SHM"].append(f"shm://{base}")
        try:
            self._wait_one(idx, addr, READY_TIMEOUT_S)
        except BaseException:
            self.retire(idx)
            raise
        logger.info("replay shard %d grown at %s (restore_ckpt=%s)",
                    idx, addr, restore_ckpt)
        return idx, addr

    def retire(self, idx):
        """Stop shard ``idx`` and mark its slot retired (``None``): the
        watchdog skips it and :meth:`respawn` refuses it.  Sweeps its
        ``/dev/shm`` objects.  Idempotent; returns True when a live process
        was stopped."""
        procs = self.launch_info.processes if self.launch_info else []
        p = procs[idx] if 0 <= idx < len(procs) else None
        if p is not None:
            # the slot goes None before the kill: a watchdog polling
            # between the two must see a retired slot, not a death
            procs[idx] = None
            try:
                p.terminate()
                p.wait(timeout=5)
            except Exception:  # noqa: BLE001
                try:
                    p.kill()
                    p.wait(timeout=5)
                except Exception:  # noqa: BLE001
                    pass
        if idx < len(self.shm_bases) and self.shm_bases[idx] is not None:
            shm_rpc.unlink_base(self.shm_bases[idx])
        if p is not None:
            logger.info("replay shard %d retired", idx)
        return p is not None

    def close(self):
        info = self.launch_info
        if info is None:
            return
        for p in info.processes:
            if p is None:
                continue
            try:
                p.terminate()
            except Exception:  # noqa: BLE001
                pass
        for p in info.processes:
            if p is None:
                continue
            try:
                p.wait(timeout=5)
            except Exception:  # noqa: BLE001
                try:
                    p.kill()
                except Exception:  # noqa: BLE001
                    pass
        # the processes are down: sweep every shm object of the fleet
        # (the registered-names half of the no-leaked-/dev/shm contract)
        for base in self.shm_bases:
            if base is not None:
                shm_rpc.unlink_base(base)

    def __exit__(self, *exc):
        self.close()
        return False


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve one blendjax_torch replay storage shard."
    )
    ap.add_argument("--address", required=True,
                    help="endpoint to bind, e.g. tcp://127.0.0.1:23000")
    ap.add_argument("--capacity", type=int, required=True)
    ap.add_argument("--shard-id", type=int, default=0)
    ap.add_argument("--dir", default=None,
                    help="durability root (checkpoints + .btr spill)")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--shm-base", default=None,
                    help="/dev/shm name prefix for the ShmRPC transport "
                         "(supervising parents pass one so they can "
                         "sweep a SIGKILLed shard's objects)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    shard = ReplayShard(
        args.address, args.capacity, shard_id=args.shard_id,
        data_dir=args.dir, checkpoint_every=args.checkpoint_every,
        shm_base=args.shm_base,
    )
    stop = threading.Event()

    def _term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    logger.info(
        "replay shard %d serving %s (capacity %d, dir %s)",
        args.shard_id, shard.address, args.capacity, args.dir,
    )
    try:
        shard.serve_forever(stop_event=stop)
    finally:
        shard.close()


if __name__ == "__main__":
    main()
