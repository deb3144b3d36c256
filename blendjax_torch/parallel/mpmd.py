"""MPMD pipeline parallelism: stage *processes* with 1F1B microbatch
interleaving; the port of ``blendjax.parallel.mpmd``.

:mod:`blendjax_torch.parallel.pipeline` is the SPMD leg: every stage is a
rank of one mesh axis, and activations ride the rank exchange.  This
module is the MPMD leg: N independent **stage processes** (``python -m
blendjax_torch.parallel.stage``), each owning one contiguous slice of the
model's layers and computing its forward and backward in torch autograd on
its device, exchanging activation and gradient microbatches over
:class:`~blendjax_torch.btt.transport.RpcChannel` (ShmRPC when driver and
stages share a host, ZMQ otherwise) as raw-buffer wire frames under the
BTMID exactly-once discipline of every other tier.  The wire is the
reference's: either package's driver can feed either package's stages.

Topology (docs/pipeline.md)::

    driver ──fwd(u,mb,x)──> stage 0 ──fwd──> stage 1 ──fwd──> stage N-1
    driver ──────────────tgt(u,mb,t)────────────────────────> stage N-1
    stage 0 <──bwd── stage 1 <──bwd── ... <──bwd(u,mb,g)───── stage N-1

The schedule is 1F1B by construction: each stage computes a record the
moment it arrives, and the last stage backpropagates a microbatch the
instant its forward completes (forward, loss and backward in one unit).
The driver's bounded feed window is the backpressure: a full pipeline
parks the feed (``pipe_feed_parks``).

Records travel as numpy on the wire.  A stage copies each ``fwd``/``bwd``
record onto its device and its result back to the host, explicitly
(:meth:`MpmdStage._to_device`, :meth:`MpmdStage._to_host`); the wire's
bytes are counted in ``pipe_wire_bytes``.

Model family: the policy MLP (:func:`blendjax_torch.models.policy.init`,
flat ``{path: tensor}`` params): ``layers.0`` is the input projection
(stage 0's ``in``), the ``n_layers`` wire-width tanh layers split
contiguously across stages (each stage's ``layers.0``, ``layers.1``, ...),
and the ``out`` head and the loss live on the last stage.  That split is
:func:`~blendjax_torch.parallel.pipeline.make_pipeline_train`'s
``in_proj``/``stage_fn``/``out_proj`` factoring (:func:`reference_pieces`).

Parameters come from ``spec['seed']`` through a CPU ``torch.Generator``
(:func:`build_full_params`), so the driver's references, every stage and
a rollback to update 0 start from the same numbers on any device.  They
are not the reference's numbers (its stages draw from ``jax.random``); a
stage restores the latest cut of its per-stage checkpoint directory
(``stage_XX``, ``{"params": local}`` in the reference's npz layout), which
either package can write.

Crash-exactness: stages apply plain SGD at update boundaries only,
checkpoint through :class:`blendjax_torch.utils.checkpoint.CheckpointManager`
every ``ckpt_every`` commits, and a SIGKILL and respawn
(``FleetWatchdog(restart=True)`` over :class:`StageFleet`) is healed by
the driver: it reconciles every stage's ``applied`` counter, rolls stages
that committed the in-flight update back to the common boundary, and
replays the update from its held microbatches; records re-sent under the
same mid are deduplicated by the stage's reply cache.

Left out for want of a caller: the reference's ``context=`` arguments, and
``MpmdTrain(window=, rpc_timeout_ms=, recover_timeout_s=, max_restarts=)``,
``AsyncPusher(resend_s=)`` and ``StageFleet(python=, ready_timeout=)``,
which are the constants below.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from blendjax_torch import wire
from blendjax_torch.btt import shm_rpc
from blendjax_torch.btt.faults import FaultPolicy
from blendjax_torch.models import policy
from blendjax_torch.models.layers import dense_apply, layer
from blendjax_torch.utils.device import resolve_device
from blendjax_torch.utils.timing import EventCounters, StageTimer

logger = logging.getLogger("blendjax_torch")

#: the keys of a pipeline spec
SPEC_KEYS = ("family", "d_in", "wire", "d_out", "n_layers", "n_procs",
             "lr", "seed")

#: the driver's per-RPC reply deadline, its wait for a respawned fleet to
#: reconcile, and the restarts it tries before an update fails
RPC_TIMEOUT_MS = 5000
RECOVER_TIMEOUT_S = 90.0
MAX_RESTARTS = 4
#: an unacknowledged record is re-sent under its mid after this long
RESEND_S = 2.5
#: a stage process must answer ``hello`` this soon after its launch
READY_TIMEOUT_S = 120.0


def default_window(n_procs):
    """The driver's feed window (microbatches in flight past stage 0):
    deep enough to keep every stage busy (the 1F1B steady state needs
    about n in flight), shallow enough that a full pipeline parks the feed
    instead of queueing without bound."""
    return 2 * int(n_procs)


class PipeRpcError(ConnectionError):
    """Transport-level failure talking to a stage (timeout, circuit
    open): the retryable class under the driver's FaultPolicy."""


class PipeRestart(RuntimeError):
    """The in-flight update cannot complete against the current stage
    incarnations (a stage died or answered ``restart_needed``): the
    driver reconciles and replays the update."""


class _RestartNeeded(RuntimeError):
    """A record or command for an update this stage incarnation cannot
    serve (it restored from a checkpoint, or the driver is replaying);
    the error text starts with ``restart_needed`` so the driver routes it
    into recovery."""


def normalize_spec(spec):
    """Validate and default a pipeline spec dict.

    Keys: ``family`` (``"mse"``, a regression stand-in, or ``"pg"``, the
    learner's importance-weighted policy gradient), ``d_in``, ``wire``
    (the inter-stage activation width), ``d_out``, ``n_layers`` (wire-width
    tanh layers split across stages; the d_in -> wire input projection is
    stage 0's on top of its slice), ``n_procs``, ``lr`` (per-stage SGD),
    ``seed``.
    """
    s = dict(spec)
    s.setdefault("family", "mse")
    s.setdefault("lr", 1e-2)
    s.setdefault("seed", 0)
    missing = [k for k in SPEC_KEYS if k not in s]
    if missing:
        raise ValueError(f"pipeline spec missing keys {missing}")
    if s["family"] not in ("mse", "pg"):
        raise ValueError(f"unknown pipeline family {s['family']!r}")
    if int(s["n_procs"]) < 1:
        raise ValueError("n_procs must be >= 1")
    if int(s["n_layers"]) < 1:
        raise ValueError("n_layers must be >= 1")
    for k in ("d_in", "wire", "d_out", "n_layers", "n_procs", "seed"):
        s[k] = int(s[k])
    s["lr"] = float(s["lr"])
    return s


def stage_slice(n_layers, n_procs, proc_index):
    """Contiguous [lo, hi) of the ``n_layers`` wire-width layers owned by
    stage ``proc_index`` (remainder layers go to the early stages, so the
    last stage's fused unit is not the straggler)."""
    base, rem = divmod(int(n_layers), int(n_procs))
    lo = proc_index * base + min(proc_index, rem)
    hi = lo + base + (1 if proc_index < rem else 0)
    return lo, hi


def build_full_params(spec, device="cpu"):
    """The full model's params (flat, :mod:`blendjax_torch.models.policy`'s
    layout), drawn from a CPU ``torch.Generator`` seeded by
    ``spec['seed']`` and placed on ``device``: the one source the driver's
    references, every stage and a rollback to update 0 build from."""
    params = policy.init(torch.Generator().manual_seed(spec["seed"]), spec["d_in"],
                         spec["d_out"], hidden=(spec["wire"],) * (spec["n_layers"] + 1),
                         device="cpu")
    return {k: v.to(device) for k, v in params.items()}


def stage_local_params(full, spec, proc_index):
    """Stage ``proc_index``'s slice of the full params: its layers renumbered
    from ``layers.0``, plus ``in.*`` on stage 0 and ``out.*`` on the last."""
    lo, hi = stage_slice(spec["n_layers"], spec["n_procs"], proc_index)
    local = {}
    for i in range(lo, hi):
        for leaf in ("w", "b"):
            local[f"layers.{i - lo}.{leaf}"] = full[f"layers.{1 + i}.{leaf}"]
    if proc_index == 0:
        local["in.w"], local["in.b"] = full["layers.0.w"], full["layers.0.b"]
    if proc_index == spec["n_procs"] - 1:
        local["out.w"], local["out.b"] = full["out.w"], full["out.b"]
    return local


def assemble_full_params(locals_by_stage, spec):
    """Inverse of :func:`stage_local_params` over every stage, in the full
    params' order."""
    full = {}
    for p, local in enumerate(locals_by_stage):
        lo, hi = stage_slice(spec["n_layers"], spec["n_procs"], p)
        if p == 0:
            full["layers.0.w"], full["layers.0.b"] = local["in.w"], local["in.b"]
        for i in range(lo, hi):
            for leaf in ("w", "b"):
                full[f"layers.{1 + i}.{leaf}"] = local[f"layers.{i - lo}.{leaf}"]
        if p == spec["n_procs"] - 1:
            full["out.w"], full["out.b"] = local["out.w"], local["out.b"]
    return full


def make_loss_fn(family):
    """``loss(pred, tgt_dict) -> scalar`` for a family; ``tgt_dict`` is the
    microbatched target record the driver pushes to the last stage
    (``{"y"}`` for mse; ``{"action", "adv", "w"}`` for pg, the advantage
    normalized over the whole batch on the driver so equal-size
    microbatch means average to the whole batch's loss)."""
    if family == "mse":
        def loss(pred, tgt):
            return torch.mean((pred - tgt["y"]) ** 2)
    else:
        def loss(pred, tgt):
            lp = torch.log_softmax(pred, dim=-1)
            logp = lp.gather(-1, tgt["action"].long()[..., None])[..., 0]
            return -torch.mean(tgt["w"] * logp * tgt["adv"])

    return loss


def reference_pieces(spec):
    """``(in_proj, stage_fn, out_proj, loss_fn)`` factored exactly like the
    stage split, for :func:`~blendjax_torch.parallel.pipeline.
    make_pipeline_train`.  Needs ``n_layers % n_procs == 0`` (stacked stage
    params must agree in shape)."""
    if spec["n_layers"] % spec["n_procs"]:
        raise ValueError(
            f"reference factoring needs n_layers ({spec['n_layers']}) "
            f"divisible by n_procs ({spec['n_procs']})"
        )
    per = spec["n_layers"] // spec["n_procs"]

    def in_proj(ep, x):
        return torch.tanh(dense_apply(ep, x))

    def stage_fn(sp, x):
        for i in range(per):
            x = torch.tanh(dense_apply({"w": sp["w"][i], "b": sp["b"][i]}, x))
        return x

    def out_proj(rp, x):
        return dense_apply(rp, x)

    return in_proj, stage_fn, out_proj, make_loss_fn(spec["family"])


def reference_stacked(full, spec):
    """``(stacked_stage_params, proj_params)`` for the reference factoring,
    from the same full params the stages split (tensors, or the numpy
    arrays :meth:`MpmdTrain.gather_params` returns)."""
    from blendjax_torch.parallel.pipeline import stack_stage_params

    def t(name):  # a tensor, or a numpy array (a driver's gather)
        v = full[name]
        return v if isinstance(v, torch.Tensor) else torch.tensor(v)

    per = spec["n_layers"] // spec["n_procs"]
    stages = []
    for p in range(spec["n_procs"]):
        lo = p * per
        stages.append({leaf: torch.stack([t(f"layers.{1 + lo + i}.{leaf}") for i in range(per)])
                       for leaf in ("w", "b")})
    proj = tuple({leaf: t(f"{name}.{leaf}") for leaf in ("w", "b")}
                 for name in ("layers.0", "out"))
    return stack_stage_params(stages), proj


# ---------------------------------------------------------------------------
# the stage server
# ---------------------------------------------------------------------------


class MpmdStage:
    """One pipeline stage: a REP server (plus the ShmRPC doorbell in the
    same poller, as the replay shard) owning its layer slice and its
    compute on ``device``, pushing activations downstream and gradients
    upstream through :class:`AsyncPusher` instances.

    Exactly-once: every mutating command's reply is cached by its BTMID,
    and fwd/bwd/tgt records are also deduplicated by ``(update, mb)``: a
    neighbour's same-mid resend after a lost ack re-buys the cached ack,
    never a second compute (``pipe_dup_records``).  Runs on the card unless
    ``device="cpu"``.
    """

    def __init__(self, address, spec, proc_index, *, prev_address=None, next_address=None,
                 shm_base=None, ckpt_dir=None, ckpt_every=1, work_us=0, counters=None,
                 device="cuda"):
        import zmq

        self.spec = normalize_spec(spec)
        self.proc_index = int(proc_index)
        self.n_procs = self.spec["n_procs"]
        if not (0 <= self.proc_index < self.n_procs):
            raise ValueError(
                f"proc_index {proc_index} out of range for {self.n_procs} procs"
            )
        self.device = resolve_device(device)
        self.is_first = self.proc_index == 0
        self.is_last = self.proc_index == self.n_procs - 1
        self.prev_address = prev_address
        self.next_address = next_address
        self.work_us = int(work_us)
        self.counters = counters if counters is not None else EventCounters()
        self.timer = StageTimer()
        #: a fresh token per process start: the driver detects respawns
        #: (and counts ``pipe_stage_respawns``) by watching it change
        self.incarnation = os.urandom(4).hex()

        self._build_compute()
        self._applied = 0
        self._last_loss = None
        self.restored_from = None
        self._ckpt_every = max(0, int(ckpt_every))
        self._mgr = None
        if ckpt_dir:
            from blendjax_torch.utils.checkpoint import CheckpointManager

            self._mgr = CheckpointManager(
                os.path.join(ckpt_dir, f"stage_{self.proc_index:02d}"), max_to_keep=4)
            step = self._mgr.latest_step()
            if step is not None:
                self._params = self._restore(step)
                self._applied = step
                self.restored_from = step
                self.counters.incr("pipe_ckpt_restores")
                logger.info("pipe stage %d restored checkpoint update %d",
                            self.proc_index, step)

        self._reset_accum()
        self._cur_update = None
        self._m = 0
        self._reply_cache = OrderedDict()

        self._sock = zmq.Context.instance().socket(zmq.REP)
        self._sock.setsockopt(zmq.LINGER, 0)
        if address.endswith(":*") or address.endswith(":0"):
            base = address.rsplit(":", 1)[0]
            port = self._sock.bind_to_random_port(base)
            self.address = f"{base}:{port}"
        else:
            self._sock.bind(address)
            self.address = address
        self._shm = None
        if shm_rpc.enabled():
            self._shm = shm_rpc.ShmRpcServer(
                base=shm_base or shm_rpc.new_base(f"pst{self.proc_index}"),
                counters=self.counters, bytes_counter="pipe_wire_bytes",
                who=f"pipe stage {self.proc_index}",
            )
        # neighbour pushers dial lazily (single-stage pipelines have none)
        self._down = None
        self._up = None

    # -- compute -------------------------------------------------------------

    def _build_compute(self):
        spec = self.spec
        self._params = stage_local_params(build_full_params(spec, self.device), spec,
                                          self.proc_index)
        lo, hi = stage_slice(spec["n_layers"], spec["n_procs"], self.proc_index)
        self._n_local = hi - lo
        #: layer units this stage owns: the benchmark's compute stand-in
        #: sleeps ``work_us`` per unit per direction, so a 1-proc fleet
        #: carries exactly the whole fleet's work
        self.n_units = (hi - lo) + (1 if self.is_first else 0) + (1 if self.is_last else 0)
        self._loss_fn = make_loss_fn(spec["family"])

    def _chain(self, params, x):
        if "in.w" in params:
            x = torch.tanh(dense_apply(layer(params, "in"), x))
        for i in range(self._n_local):
            x = torch.tanh(dense_apply(layer(params, f"layers.{i}"), x))
        return x

    def _vjp(self, fn, x, grad_output=None):
        """``fn(params, x)`` recomputed from the saved input ``x`` with
        autograd; returns ``(output, param grads, x's grad)`` of the output
        (a loss), or of its product with ``grad_output``."""
        params = {k: v.detach().requires_grad_(True) for k, v in self._params.items()}
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            out = fn(params, x)
            got = torch.autograd.grad(out, [*params.values(), x], grad_outputs=grad_output,
                                      allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(params.items(), got[:-1])}
        return out.detach(), grads, got[-1]

    def _to_device(self, arr):
        """A wire record's array, copied onto the stage's device."""
        return torch.tensor(np.asarray(arr), device=self.device)

    @staticmethod
    def _to_host(t):
        """A result, copied back to the host for the wire."""
        return t.detach().cpu().numpy()

    def _restore(self, step):
        from blendjax_torch.models.convert import params_from_jax, params_to_jax

        tree = self._mgr.restore({"params": params_to_jax(self._params)}, step=step)
        return params_from_jax(tree["params"], device=self.device)

    def _save(self, step):
        from blendjax_torch.models.convert import params_to_jax

        self._mgr.save(step, {"params": params_to_jax(self._params)})

    def _work(self, units):
        if self.work_us:
            time.sleep(self.work_us * units / 1e6)

    def _reset_accum(self):
        self._grads_acc = None
        self._acts = {}
        self._tgts = {}
        self._seen_fwd = set()
        self._seen_bwd = set()
        self._bwd_done = 0
        self._loss_sum = 0.0
        self._ready = False

    # -- neighbour pushers ---------------------------------------------------

    def _pusher(self, address, direction):
        from blendjax_torch.btt.transport import RpcChannel

        return AsyncPusher(RpcChannel(address, name=f"pipe-s{self.proc_index}-{direction}"),
                           self.counters, name=f"stage{self.proc_index}->{direction}")

    def _pusher_down(self):
        if self._down is None:
            self._down = self._pusher(self.next_address, "down")
        return self._down

    def _pusher_up(self):
        if self._up is None:
            self._up = self._pusher(self.prev_address, "up")
        return self._up

    # -- dispatch ------------------------------------------------------------

    def handle(self, msg):
        cmd = msg.get("cmd")
        mid = msg.get(wire.BTMID_KEY)
        if mid is not None and mid in self._reply_cache:
            self.counters.incr("pipe_dup_records")
            return self._reply_cache[mid]
        try:
            reply = getattr(self, f"_cmd_{cmd}", self._cmd_unknown)(msg)
        except Exception as exc:  # noqa: BLE001 - surfaced to the peer
            if not isinstance(exc, _RestartNeeded):
                logger.exception("pipe stage %d: %r failed", self.proc_index, cmd)
            reply = {"error": f"{type(exc).__name__}: {exc}"}
        if mid is not None:
            reply[wire.BTMID_KEY] = mid
            if cmd in ("begin", "fwd", "bwd", "tgt", "commit", "rollback"):
                self._reply_cache[mid] = reply
                while len(self._reply_cache) > wire.REPLY_CACHE_DEPTH:
                    self._reply_cache.popitem(last=False)
        return reply

    def _cmd_unknown(self, msg):
        raise ValueError(f"unknown pipe stage command {msg.get('cmd')!r}")

    def _cmd_hello(self, msg):
        return {
            "proc": self.proc_index,
            "procs": self.n_procs,
            "applied": self._applied,
            "incarnation": self.incarnation,
            "restored": self.restored_from,
            "shm": self._shm.info() if self._shm is not None else None,
        }

    def _cmd_stage_info(self, msg):
        return {
            "proc": self.proc_index,
            "applied": self._applied,
            "current": self._cur_update,
            "ready": self._ready,
            "bwd_done": self._bwd_done,
            "incarnation": self.incarnation,
            "device": str(self.device),
            "counters": self.counters.snapshot(),
        }

    def _check_update(self, u):
        """Gate a data record against the update in progress.  True when
        the record is stale (an already committed update: a same-mid resend
        whose original landed before the commit, or a neighbour's push that
        outran an abort): it is acked as a duplicate so the sender retires
        it."""
        if u <= self._applied:
            self.counters.incr("pipe_dup_records")
            return True
        if self._cur_update != u:
            raise _RestartNeeded(
                f"restart_needed: record for update {u} but stage "
                f"{self.proc_index} is at applied={self._applied} "
                f"current={self._cur_update}"
            )
        return False

    def _cmd_begin(self, msg):
        u, m = int(msg["update"]), int(msg["m"])
        if u <= self._applied:
            # a replayed begin after this stage already committed the
            # update (driver recovery races): an idempotent no-op
            return {"applied": self._applied, "skip": True}
        if u != self._applied + 1:
            raise _RestartNeeded(
                f"restart_needed: begin {u} but stage {self.proc_index} "
                f"applied={self._applied}"
            )
        if self._cur_update == u and not msg.get("restart"):
            return {"applied": self._applied}
        self._cur_update = u
        self._m = m
        self._reset_accum()
        if msg.get("restart"):
            # drop in-flight pushes of the aborted attempt: the replay
            # re-feeds every record under fresh mids
            for pusher in (self._down, self._up):
                if pusher is not None:
                    pusher.clear()
        return {"applied": self._applied}

    def _cmd_fwd(self, msg):
        u, mb = int(msg["update"]), int(msg["mb"])
        if self._check_update(u):
            return {"ok": True, "stale": True}
        if mb in self._seen_fwd:
            self.counters.incr("pipe_dup_records")
            return {"ok": True, "dup": True}
        self._seen_fwd.add(mb)
        if self.is_last:
            self._acts[mb] = self._to_device(msg["x"])
            self._maybe_last(mb)
            return {"ok": True}
        with self.timer.stage("pipe_fwd"):
            x = self._to_device(msg["x"])
            with torch.no_grad():
                y = self._to_host(self._chain(self._params, x))
            self._work(self.n_units)
        self._acts[mb] = x
        self._pusher_down().push({"cmd": "fwd", "update": u, "mb": mb, "x": y})
        return {"ok": True}

    def _cmd_tgt(self, msg):
        u, mb = int(msg["update"]), int(msg["mb"])
        if self._check_update(u):
            return {"ok": True, "stale": True}
        if mb in self._tgts or mb in self._seen_bwd:
            self.counters.incr("pipe_dup_records")
            return {"ok": True, "dup": True}
        self._tgts[mb] = {k: self._to_device(v) for k, v in msg["tgt"].items()}
        self._maybe_last(mb)
        return {"ok": True}

    def _maybe_last(self, mb):
        """The last stage's fused unit: once microbatch ``mb`` has both its
        activation and its target, run forward, loss and backward in one go
        and push the cotangent upstream (1F1B's eager backward, scheduled
        by arrival)."""
        if mb not in self._acts or mb not in self._tgts or mb in self._seen_bwd:
            return
        self._seen_bwd.add(mb)
        a = self._acts.pop(mb)
        tgt = self._tgts.pop(mb)
        with self.timer.stage("pipe_bwd"):
            loss, dp, da = self._vjp(
                lambda p, a: self._loss_fn(dense_apply(layer(p, "out"), self._chain(p, a)), tgt),
                a)
            loss = float(loss)
            da = None if self.is_first else self._to_host(da)
            self._work(2 * self.n_units)
        self._loss_sum += loss
        self._accumulate(dp)
        if not self.is_first:
            self._pusher_up().push({"cmd": "bwd", "update": self._cur_update, "mb": mb,
                                    "g": da})
        self._note_bwd_done()

    def _cmd_bwd(self, msg):
        u, mb = int(msg["update"]), int(msg["mb"])
        if self._check_update(u):
            return {"ok": True, "stale": True}
        if mb in self._seen_bwd:
            self.counters.incr("pipe_dup_records")
            return {"ok": True, "dup": True}
        if mb not in self._acts:
            raise ValueError(
                f"bwd for microbatch {mb} before its forward on stage {self.proc_index}"
            )
        self._seen_bwd.add(mb)
        x = self._acts.pop(mb)
        with self.timer.stage("pipe_bwd"):
            _, dp, dx = self._vjp(self._chain, x, self._to_device(msg["g"]))
            dx = None if self.is_first else self._to_host(dx)
            self._work(self.n_units)
        self._accumulate(dp)
        if not self.is_first:
            self._pusher_up().push({"cmd": "bwd", "update": u, "mb": mb, "g": dx})
        self._note_bwd_done()
        return {"ok": True}

    def _accumulate(self, dp):
        if self._grads_acc is None:
            self._grads_acc = dp
        else:
            for k, g in dp.items():
                self._grads_acc[k] += g

    def _note_bwd_done(self):
        self._bwd_done += 1
        self.counters.incr("pipe_microbatches")
        if self._bwd_done == self._m:
            self._ready = True

    def _cmd_finish(self, msg):
        u = int(msg["update"])
        if u <= self._applied:
            return {"ready": True, "applied": self._applied, "bwd_done": self._m}
        return {"ready": self._ready and self._cur_update == u,
                "applied": self._applied, "bwd_done": self._bwd_done}

    def _cmd_commit(self, msg):
        u = int(msg["update"])
        if u <= self._applied:
            return {"applied": self._applied, "loss": self._last_loss}
        if u != self._applied + 1 or not self._ready or self._cur_update != u:
            raise _RestartNeeded(
                f"restart_needed: commit {u} but stage {self.proc_index} "
                f"applied={self._applied} ready={self._ready}"
            )
        lr, m = self.spec["lr"], float(self._m)
        with self.timer.stage("pipe_apply"), torch.no_grad():
            self._params = {k: p - lr * self._grads_acc[k] / m
                            for k, p in self._params.items()}
        self._applied = u
        self._last_loss = (self._loss_sum / self._m) if self.is_last else None
        self._cur_update = None
        self._reset_accum()
        self.counters.incr("pipe_updates")
        if self._mgr is not None and self._ckpt_every and u % self._ckpt_every == 0:
            self._save(u)
        return {"applied": self._applied, "loss": self._last_loss}

    def _cmd_rollback(self, msg):
        to = int(msg["to_update"])
        if to != self._applied:
            if to == 0:
                self._params = stage_local_params(build_full_params(self.spec, self.device),
                                                  self.spec, self.proc_index)
            else:
                if self._mgr is None:
                    raise RuntimeError(
                        f"stage {self.proc_index}: rollback to update {to} needs a "
                        "checkpoint dir"
                    )
                self._params = self._restore(to)
            self._applied = to
            self.counters.incr("pipe_rollbacks")
        self._cur_update = None
        self._reset_accum()
        return {"applied": self._applied}

    def _cmd_get_params(self, msg):
        return {"params": {k: self._to_host(v) for k, v in self._params.items()},
                "applied": self._applied}

    # -- serve loop ----------------------------------------------------------

    def serve_forever(self, stop_event=None, poll_ms=20):
        """Serve until ``stop_event``: the REP socket and (when ShmRPC is
        up) the transport doorbell park in one poller, as the replay shard's;
        each pass also pumps the neighbour pushers (acks drained, overdue
        records re-sent under their mids)."""
        import zmq

        poller = zmq.Poller()
        poller.register(self._sock, zmq.POLLIN)
        if self._shm is not None and self._shm.fd is not None:
            poller.register(self._shm.fd, zmq.POLLIN)
        while stop_event is None or not stop_event.is_set():
            for pusher in (self._down, self._up):
                if pusher is not None:
                    pusher.pump()
            try:
                events = dict(poller.poll(poll_ms))
            except zmq.ZMQError:
                return
            if self._shm is not None:
                self._shm.pump(self._handle_shm)
            if self._sock not in events:
                continue
            try:
                msg, nbytes = wire.recv_message_sized(self._sock)
            except zmq.ZMQError:
                return
            self.counters.incr("pipe_wire_bytes", nbytes)
            reply = shm_rpc.control_reply(self._shm, msg)
            if reply is None:
                reply = self.handle(msg)
            try:
                sent = wire.send_message(self._sock, reply, raw_buffers=True)
                self.counters.incr("pipe_wire_bytes", sent)
            except zmq.ZMQError:
                return

    def _handle_shm(self, chan, msg):
        self._shm.send(chan, self.handle(msg))

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
        for pusher in (self._down, self._up):
            if pusher is not None:
                pusher.close()
        self._down = self._up = None


# ---------------------------------------------------------------------------
# the async exactly-once record pusher
# ---------------------------------------------------------------------------


class AsyncPusher:
    """Non-blocking exactly-once record pushes over an
    :class:`~blendjax_torch.btt.transport.RpcChannel`.

    ``push`` stamps a BTMID and sends without waiting; ``pump`` drains acks
    (correlated by mid) and re-sends overdue records under the same mid
    (``pipe_resends``): the receiver's reply cache and ``(update, mb)``
    dedup make a resend after a lost ack free.  The first resend of a
    record first tells the channel its deadline passed, so a dead shm peer
    demotes and the retry rides ZMQ to wherever the peer respawned.  Error
    acks park in :attr:`errors` for the owner's loop (the driver turns them
    into recovery; a stage ignores them, the driver coordinates)."""

    def __init__(self, channel, counters, *, name="push"):
        self.channel = channel
        self.counters = counters
        self.resend_s = RESEND_S
        self.name = name
        self._out = OrderedDict()  # mid -> [msg, deadline, resends]
        self.errors = []

    @property
    def outstanding(self):
        return len(self._out)

    def push(self, msg):
        mid = wire.stamp_message_id(msg)
        self._out[mid] = [msg, time.monotonic() + self.resend_s, 0]
        self.channel.send_request(msg, raw_buffers=True)
        return mid

    def pump(self, wait_ms=0):
        """Drain every ready ack (waiting at most ``wait_ms`` for the
        first), then re-send overdue records."""
        while self._out:
            if not self.channel.poll_reply(wait_ms):
                break
            wait_ms = 0
            reply = self.channel.recv_reply()
            if reply is None:
                continue
            ent = self._out.pop(reply.get(wire.BTMID_KEY), None)
            if ent is None:
                self.counters.incr("stale_replies")
                continue
            if "error" in reply:
                self.errors.append((ent[0], reply["error"]))
        now = time.monotonic()
        for ent in list(self._out.values()):
            if now < ent[1]:
                continue
            if ent[2] == 0:
                self.channel.notify_timeout()
            ent[1] = now + self.resend_s * min(4, 1 + ent[2])
            ent[2] += 1
            self.counters.incr("pipe_resends")
            self.channel.send_request(ent[0], raw_buffers=True)

    def clear(self):
        self._out.clear()
        self.errors = []

    def reset(self):
        self.clear()
        self.channel.reset()

    def close(self):
        self.clear()
        self.channel.close()


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


class MpmdTrain:
    """The pipeline driver: feeds microbatches into stage 0 (and targets
    into the last stage), runs the begin/finish/commit update protocol, and
    heals stage deaths by reconcile, rollback and replay.

    ``update(x, targets, num_microbatches)`` returns the mean microbatch
    loss; numerically it is :func:`~blendjax_torch.parallel.pipeline.
    make_pipeline_train` plus SGD on the same spec.  The driver computes
    nothing: it moves numpy records.
    """

    def __init__(self, addresses, spec, *, counters=None, finish_timeout_s=60.0):
        from blendjax_torch.btt.transport import RpcChannel

        self.spec = normalize_spec(spec)
        self.addresses = list(addresses)
        if len(self.addresses) != self.spec["n_procs"]:
            raise ValueError(
                f"{len(self.addresses)} stage addresses for n_procs={self.spec['n_procs']}"
            )
        self.counters = counters if counters is not None else EventCounters()
        self.timer = StageTimer()
        self.window = default_window(self.spec["n_procs"])
        self.finish_timeout_s = float(finish_timeout_s)
        self.policy = FaultPolicy()
        self._ctrl = [RpcChannel(a, name=f"pipe-ctl{i}") for i, a in enumerate(self.addresses)]
        self._states = [self.policy.new_state(key=i) for i in range(len(self.addresses))]
        self._feed = AsyncPusher(RpcChannel(self.addresses[0], name="pipe-feed"),
                                 self.counters, name="driver->s0")
        self._tgt_push = self._feed if len(self.addresses) == 1 else AsyncPusher(
            RpcChannel(self.addresses[-1], name="pipe-tgt"), self.counters,
            name="driver->last")
        self._update_no = 0
        self._incarnations = {}

    @property
    def updates_done(self):
        return self._update_no

    # -- RPC plumbing --------------------------------------------------------

    def _rpc(self, i, cmd, payload=None, *, timeout_ms=None):
        from blendjax_torch.btt.rpc import exactly_once_rpc

        msg = dict(payload or {})
        msg["cmd"] = cmd
        return exactly_once_rpc(
            self._ctrl[i], msg, policy=self.policy, state=self._states[i],
            counters=self.counters,
            wait_ms=RPC_TIMEOUT_MS if timeout_ms is None else int(timeout_ms),
            remote_name=f"pipe stage {i}", span_label=f"pipe{i}_rpc",
            span_cat="pipe_driver", rpc_name=f"pipe-stage-{i}:{cmd}",
            exc_factory=lambda text: PipeRpcError(
                f"pipe stage {i} ({self.addresses[i]}): {text}"),
            retryable=(PipeRpcError,),
        )

    def hello_all(self, timeout_s=60.0):
        """Wait until every stage answers ``hello`` (the startup barrier);
        tracks incarnations, so later respawns are counted."""
        deadline = time.monotonic() + timeout_s
        return [self._hello_until(i, deadline) for i in range(len(self.addresses))]

    def _hello_until(self, i, deadline):
        while True:
            try:
                r = self._rpc(i, "hello", timeout_ms=1000)
            except (PipeRpcError, RuntimeError):
                if time.monotonic() >= deadline:
                    raise
                self._ctrl[i].reset()
                time.sleep(0.1)
                continue
            prev = self._incarnations.get(i)
            if prev is not None and prev != r["incarnation"]:
                self.counters.incr("pipe_stage_respawns")
                if r.get("restored") is not None:
                    self.counters.incr("pipe_ckpt_restores")
            self._incarnations[i] = r["incarnation"]
            return r

    # -- the update protocol -------------------------------------------------

    def update(self, x, targets, num_microbatches):
        """One pipeline-parallel training update over a whole batch.

        ``x``: (B, d_in); ``targets``: the family's target record, an array
        (mse's ``y``) or a dict of (B, ...) arrays.  Both split into
        ``num_microbatches`` equal microbatches
        (:func:`~blendjax_torch.parallel.pipeline.microbatch` raises on a
        ragged split).  Returns the mean microbatch loss."""
        from blendjax_torch.parallel.pipeline import microbatch

        tgt = targets if isinstance(targets, dict) else {"y": targets}
        m = int(num_microbatches)
        xs = microbatch(np.asarray(x), m)
        tgts = microbatch({k: np.asarray(v) for k, v in tgt.items()}, m)
        u = self._update_no + 1
        restart = False
        for attempt in range(MAX_RESTARTS + 1):
            try:
                return self._run_update(u, xs, tgts, m, restart)
            except PipeRestart as exc:
                if attempt == MAX_RESTARTS:
                    raise RuntimeError(
                        f"pipeline update {u} failed after {MAX_RESTARTS} restarts: {exc}"
                    ) from exc
                logger.warning("pipeline update %d restarting: %s", u, exc)
                self.counters.incr("pipe_restarts")
                self._recover(u)
                u = self._update_no + 1
                restart = True

    def _guard(self, exc):
        """A stage failure as restart or fatal: transport errors and
        ``restart_needed`` replies both mean the fleet changed under the
        update."""
        if isinstance(exc, PipeRpcError) or "restart_needed" in str(exc):
            raise PipeRestart(str(exc)) from exc
        raise exc

    def _pump_all(self, wait_ms=0):
        self._feed.pump(wait_ms)
        if self._tgt_push is not self._feed:
            self._tgt_push.pump()
        for pusher in (self._feed, self._tgt_push):
            if pusher.errors:
                msg, err = pusher.errors[0]
                pusher.clear()
                if "restart_needed" in err:
                    raise PipeRestart(err)
                raise RuntimeError(
                    f"pipeline record {msg.get('cmd')} (update {msg.get('update')} "
                    f"mb {msg.get('mb')}) failed remotely: {err}"
                )

    def _outstanding(self):
        return self._feed.outstanding + (
            self._tgt_push.outstanding if self._tgt_push is not self._feed else 0)

    def _run_update(self, u, xs, tgts, m, restart):
        last = len(self.addresses) - 1
        for i in range(len(self.addresses)):
            try:
                self._rpc(i, "begin", {"update": u, "m": m, "restart": restart})
            except (PipeRpcError, RuntimeError) as exc:
                self._guard(exc)
        for mb in range(m):
            with self.timer.stage("pipe_feed"):
                parked = False
                while self._outstanding() >= self.window:
                    if not parked:
                        parked = True
                        self.counters.incr("pipe_feed_parks")
                    self._pump_all(wait_ms=5)
                self._feed.push({"cmd": "fwd", "update": u, "mb": mb, "x": xs[mb]})
                self._tgt_push.push({"cmd": "tgt", "update": u, "mb": mb,
                                     "tgt": {k: v[mb] for k, v in tgts.items()}})
                self._pump_all()
            self.counters.incr("pipe_microbatches")
        deadline = time.monotonic() + self.finish_timeout_s
        with self.timer.stage("pipe_finish"):
            for i in range(len(self.addresses)):
                while True:
                    try:
                        r = self._rpc(i, "finish", {"update": u})
                    except (PipeRpcError, RuntimeError) as exc:
                        self._guard(exc)
                    if r["ready"]:
                        break
                    if time.monotonic() >= deadline:
                        raise PipeRestart(
                            f"stage {i} never reached grads-ready for update {u} "
                            f"(bwd_done={r.get('bwd_done')}/{m})"
                        )
                    self._pump_all(wait_ms=5)
        loss = None
        for i in range(len(self.addresses)):
            try:
                r = self._rpc(i, "commit", {"update": u})
            except (PipeRpcError, RuntimeError) as exc:
                self._guard(exc)
            if i == last:
                loss = r["loss"]
        # every record of this update was consumed (the finish barrier
        # proved it): retire any whose ack is still in flight, so the next
        # update's pump never resends a delivered record into the past
        self._feed.clear()
        if self._tgt_push is not self._feed:
            self._tgt_push.clear()
        self._update_no = u
        self.counters.incr("pipe_updates")
        return loss

    def _recover(self, u):
        """Reconcile after a stage death mid-update ``u``: wait out the
        watchdog's respawn, roll every stage back to the lowest applied
        boundary, and let the caller replay the update from its held
        microbatches."""
        self._feed.reset()
        if self._tgt_push is not self._feed:
            self._tgt_push.reset()
        for chan in self._ctrl:
            chan.reset()
        deadline = time.monotonic() + RECOVER_TIMEOUT_S
        applied = {i: self._hello_until(i, deadline)["applied"]
                   for i in range(len(self.addresses))}
        floor = min(applied.values())
        if floor < u - 1:
            raise RuntimeError(
                f"stage restored to update {floor}, below the driver's held update "
                f"{u} — run stages with ckpt_every=1 for crash-exact resume"
            )
        for i, a in applied.items():
            if a > floor:
                self._rpc(i, "rollback", {"to_update": floor})
                self.counters.incr("pipe_driver_rollbacks")
        self._update_no = floor

    # -- params --------------------------------------------------------------

    def gather_params(self):
        """The full model's params from every stage, flat numpy arrays in
        :func:`build_full_params`' layout (the learner's mirror)."""
        locals_by_stage = [self._rpc(i, "get_params")["params"]
                           for i in range(len(self.addresses))]
        return assemble_full_params(locals_by_stage, self.spec)

    def stage_infos(self):
        return [self._rpc(i, "stage_info") for i in range(len(self.addresses))]

    def close(self):
        self._feed.close()
        if self._tgt_push is not self._feed:
            self._tgt_push.close()
        for chan in self._ctrl:
            chan.close()


# ---------------------------------------------------------------------------
# in-process stage threads
# ---------------------------------------------------------------------------


class _LocalStageHandle:
    def __init__(self, stages, threads, stop):
        self.stages = stages
        self.addresses = [s.address for s in stages]
        self._threads = threads
        self._stop = stop

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        for s in self.stages:
            s.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_stage_threads(spec, *, ckpt_dir=None, device="cuda"):
    """Serve every stage of ``spec`` from daemon threads in this process,
    on ``device`` (the card unless ``"cpu"``), over the same wire as the
    process fleet.  ``ckpt_dir``: the stages' checkpoint root, each cut
    after every commit; a stage starts from the latest cut it finds
    there."""
    spec = normalize_spec(spec)
    stages = [MpmdStage("tcp://127.0.0.1:*", spec, p, ckpt_dir=ckpt_dir, device=device)
              for p in range(spec["n_procs"])]
    for p, s in enumerate(stages):
        s.prev_address = stages[p - 1].address if p > 0 else None
        s.next_address = stages[p + 1].address if p < len(stages) - 1 else None
    stop = threading.Event()
    threads = []
    for s in stages:
        t = threading.Thread(target=s.serve_forever, kwargs={"stop_event": stop},
                             daemon=True, name=f"bjx-pipe-stage-{s.proc_index}")
        t.start()
        threads.append(t)
    return _LocalStageHandle(stages, threads, stop)


# ---------------------------------------------------------------------------
# stage processes and the launcher surface
# ---------------------------------------------------------------------------


class _StageLaunchInfo:
    """``launch_info`` as :class:`~blendjax_torch.btt.watchdog.FleetWatchdog`
    reads it, so the watchdog supervises stage processes as it does
    Blender producers."""

    def __init__(self, processes, addresses):
        self.processes = processes
        self.addresses = {"PIPE": addresses}


class StageFleet:
    """N pipeline stage *processes* behind one launcher-like surface
    (``launch_info`` and ``respawn(idx)``).  The parent picks every stage's
    address and its ``/dev/shm`` name prefix up front, so teardown and the
    watchdog's respawn sweep whatever a SIGKILLed stage (and its clients)
    left behind.  The stages run on the card unless ``device="cpu"``; a
    stage that cannot have its device exits, and the fleet's start raises
    once it does not answer."""

    def __init__(self, spec, *, ckpt_dir=None, ckpt_every=1, work_us=0, device="cuda"):
        from blendjax_torch.replay.shard_client import free_port

        self.spec = normalize_spec(spec)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        self.work_us = int(work_us)
        self.device = str(device)
        n = self.spec["n_procs"]
        self.addresses = [f"tcp://127.0.0.1:{free_port()}" for _ in range(n)]
        self.shm_bases = [shm_rpc.new_base(f"pst{i}") if shm_rpc.enabled() else None
                          for i in range(n)]
        self.launch_info = None

    def _cmd(self, idx):
        n = self.spec["n_procs"]
        cmd = [
            sys.executable, "-m", "blendjax_torch.parallel.stage",
            "--address", self.addresses[idx],
            "--proc-index", str(idx),
            "--spec", json.dumps(self.spec),
            "--ckpt-every", str(self.ckpt_every),
            "--device", self.device,
        ]
        if idx > 0:
            cmd += ["--prev-address", self.addresses[idx - 1]]
        if idx < n - 1:
            cmd += ["--next-address", self.addresses[idx + 1]]
        if self.shm_bases[idx] is not None:
            cmd += ["--shm-base", self.shm_bases[idx]]
        if self.ckpt_dir:
            cmd += ["--ckpt-dir", self.ckpt_dir]
        if self.work_us:
            cmd += ["--work-us", str(self.work_us)]
        return cmd

    def _spawn(self, idx):
        from blendjax_torch.btt.launcher import child_env

        return subprocess.Popen(self._cmd(idx), env=child_env(), start_new_session=True)

    def __enter__(self):
        procs = [self._spawn(i) for i in range(self.spec["n_procs"])]
        self.launch_info = _StageLaunchInfo(procs, list(self.addresses))
        try:
            self.wait_ready(READY_TIMEOUT_S)
        except BaseException:
            self.close()
            raise
        return self

    def wait_ready(self, timeout=READY_TIMEOUT_S):
        deadline = time.monotonic() + timeout
        for i, addr in enumerate(self.addresses):
            while True:
                proc = self.launch_info.processes[i]
                if proc.poll() is not None:
                    raise RuntimeError(f"pipe stage {i} exited with code {proc.returncode} "
                                       "before answering")
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"pipe stage {i} at {addr} not ready within {timeout:.1f}s"
                    )
                if _stage_hello(addr, timeout_ms=500) is not None:
                    break

    def respawn(self, idx):
        """Relaunch stage ``idx`` with its original command line (the
        watchdog's contract), after sweeping the dead incarnation's
        ``/dev/shm`` objects (a SIGKILL runs no cleanup)."""
        if self.launch_info is None:
            raise RuntimeError("fleet not launched")
        if self.shm_bases[idx] is not None:
            shm_rpc.unlink_base(self.shm_bases[idx])
        proc = self._spawn(idx)
        self.launch_info.processes[idx] = proc
        return proc

    def close(self):
        info = self.launch_info
        if info is None:
            return
        for p in info.processes:
            if p is not None and p.poll() is None:
                p.terminate()
        for p in info.processes:
            if p is None:
                continue
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for base in self.shm_bases:
            if base is not None:
                shm_rpc.unlink_base(base)
        self.launch_info = None

    def __exit__(self, *exc):
        self.close()
        return False


def _stage_hello(address, timeout_ms=500):
    """One throwaway ``hello`` to a stage (the readiness probe); the reply,
    or None on timeout."""
    import zmq

    sock = zmq.Context.instance().socket(zmq.DEALER)
    sock.setsockopt(zmq.LINGER, 0)
    sock.connect(address)
    try:
        msg = {"cmd": "hello"}
        mid = wire.stamp_message_id(msg)
        wire.send_message_dealer(sock, msg)
        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            if sock.poll(max(1, int(remaining * 1000)), zmq.POLLIN):
                reply = wire.recv_message_dealer(sock)
                if reply.get(wire.BTMID_KEY) == mid:
                    return reply
    finally:
        sock.close(0)
