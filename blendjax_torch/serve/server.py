"""PolicyServer: continuous batching of ``step()`` over the DEALER wire, on
the card.  The port of ``blendjax.serve.server``.

One model sits behind a ROUTER socket and serves many concurrent
episodes:

- **continuous batching**: the admission queue is drained every tick,
  pending ``step`` requests are padded to a bucketed batch size, one model
  call serves the tick, and the replies scatter back per client;
- **KV-cache slot pool** for the SeqFormer world model: every live episode
  holds a row of batched ``(slots + 1, ...)`` caches, decoded at per-row
  positions (:func:`blendjax_torch.models.seqformer.decode_step`); on the
  card each bucket's gather -> decode -> scatter is one captured CUDA graph
  (the counterpart of the reference's one jitted program per bucket);
- **exactly-once RPCs**: a retried ``step``/``reset``/``close`` (same
  ``wire.BTMID_KEY``) is answered from a bounded reply cache, and a
  duplicate of a request still queued is dropped at admission;
- ``int8=True`` serves the model through
  :func:`blendjax_torch.ops.quant.quantize_seqformer` /
  :func:`~blendjax_torch.ops.quant.quantize_policy`, the same model code;
- ``SERVE_EVENTS`` counters, ``SERVE_STAGES`` timings, a ``telemetry``
  RPC and trace spans riding ``BTMID_KEY``;
- **ShmRPC** (:mod:`blendjax_torch.btt.shm_rpc`): a same-host client that
  asks for the upgrade gets a shared-memory ring pair whose requests enter
  the same admission queue; the ZMQ socket stays the control plane and the
  remote path.  ``BJX_NO_SHM_RPC=1`` turns it off, and ``hello`` then
  reports ``"shm": None``.

- **WeightBus** (``subscriber=``, ``--subscribe``): a
  :class:`~blendjax_torch.weights.bus.WeightSubscriber` is polled between
  ticks, and a complete, digest-verified snapshot (published by either
  package) is copied into the served tensors in place, so the captured
  ticks keep their addresses; every reply then carries the executing
  model's ``weight_version``.

Either package's ``ServeClient`` drives it: the wire is the JAX package's.
Run a server as a process::

    python -m blendjax_torch.serve.server --address tcp://127.0.0.1:24000 \\
        --model seqformer --seed 0 --obs-dim 8 --slots 64 --length 128

(``--device cpu`` on a host without a card), or in-process via
:func:`start_server_thread`.  ``serial=True`` (a REP socket, one request
per exchange) is the baseline continuous batching is measured against.

Supervised processes: :class:`ServerProcess` runs one server as a child
process with a launcher-compatible surface (``launch_info`` and
``respawn(idx)``), so ``FleetWatchdog(restart=True)`` or a
``FleetSupervisor`` respawns it after a SIGKILL; :class:`ServerFleet` is N
such replicas behind one surface (the :mod:`blendjax_torch.serve.gateway`'s
fleet), with ``grow``/``retire`` for the autoscaler.  Their replicas run on
the card unless ``device="cpu"`` is given.  This module imports torch only
where a model needs it, so a linear replica starts without it.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from collections import OrderedDict, deque

import numpy as np

from blendjax_torch import wire
from blendjax_torch.btt import shm_rpc
from blendjax_torch.obs.spans import make_span, now_us
from blendjax_torch.serve.protocol import MUTATING_CMDS, REPLY_CACHE_DEPTH, drain_socket
from blendjax_torch.utils.timing import StageTimer, fleet_counters

__all__ = ["MUTATING_CMDS", "REPLY_CACHE_DEPTH", "drain_socket", "LinearModel",
           "PolicyModel", "SeqFormerModel", "PolicyServer", "start_server_thread",
           "ServerProcess", "ServerFleet", "default_buckets", "build_model", "main"]

logger = logging.getLogger("blendjax_torch")

#: Idle horizon after which a stateless episode leaves the admission
#: window's live count (window targeting only; its steps are never refused).
STATELESS_TTL_S = 30.0


def _check_tree_like(cur, new, what):
    """A snapshot must have the served params' leaves and per-leaf shapes
    before it replaces them (flat ``{path: tensor}`` dicts)."""
    if set(cur) != set(new):
        raise ValueError(
            f"published {what} snapshot structure does not match the served "
            f"params (leaves {sorted(set(new) ^ set(cur))} differ)"
        )
    for path, c in cur.items():
        if tuple(c.shape) != tuple(new[path].shape):
            raise ValueError(
                f"published {what} snapshot leaf {path} shape "
                f"{tuple(new[path].shape)} != served {tuple(c.shape)}"
            )


def default_buckets(max_batch):
    """Powers of two up to ``max_batch`` (inclusive as the cap): requests pad
    to the next bucket, one captured graph each."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


# ---------------------------------------------------------------------------
# served models
# ---------------------------------------------------------------------------


class LinearModel:
    """Stateful numpy stand-in: ``pred = obs @ W + pos`` with a per-slot
    position counter, deterministic from ``seed`` and position-sensitive (a
    double-applied step shifts every later prediction).  ``work_us`` adds a
    sleep of that many microseconds per row to each step, a stand-in for
    model compute that batching does not amortize (the gateway's scale and
    p99-regression cases need replicas whose requests cost something)."""

    kind = "linear"

    def __init__(self, obs_dim=8, slots=16, seed=0, work_us=0):
        self.obs_dim = int(obs_dim)
        self.slots = int(slots)
        self.work_us = float(work_us)
        rng = np.random.default_rng(seed)
        self.w = rng.standard_normal((self.obs_dim, self.obs_dim)).astype(np.float32)
        # +1: the pad row batched ticks scatter their padding into
        self.pos = np.zeros(self.slots + 1, np.int64)
        self.pad_slot = self.slots

    def apply_weights(self, tree):
        """Replace ``w`` from a published ``{"w": (obs_dim, obs_dim)}``."""
        w = np.asarray(tree["w"], np.float32)
        if w.shape != self.w.shape:
            raise ValueError(f"published w shape {w.shape} != served {self.w.shape}")
        self.w = w

    def reset_rows(self, idx):
        self.pos[idx] = 0

    def step_rows(self, idx, obs):
        if self.work_us:
            time.sleep(len(idx) * self.work_us / 1e6)
        pred = obs.astype(np.float32) @ self.w + self.pos[idx, None].astype(np.float32)
        self.pos[idx] += 1
        return pred

    def prefill_rows(self, idx, prefix):
        """Admit a T-step prefix in one pass: the slot's position jumps to T
        and the return is what the T'th serial step would have produced."""
        t = prefix.shape[0]
        self.pos[idx] = t
        return prefix[-1].astype(np.float32) @ self.w + np.float32(t - 1)


class _TorchModel:
    """What the torch adapters share: detached params on one device, and
    :meth:`apply_weights` — a published tree (the JAX package's layout, as
    :meth:`blendjax_torch.weights.snapshot.Snapshot.tree` gives it) checked
    against the served params and copied into them in place, so a captured
    graph goes on reading the same tensors."""

    int8 = False

    def _init_params(self, params, quantize):
        params = {k: v.detach() for k, v in params.items()}
        if self.int8:
            params = quantize(params)
        self.params = params
        self.device = next(iter(params.values())).device

    def _adopt(self, tree, what):
        import torch

        from blendjax_torch.models.convert import params_from_jax

        new = params_from_jax(tree, device=self.device)
        if self.int8 != any(k.endswith(".w_q") for k in new):
            raise ValueError(
                "published snapshot precision (int8=%s) != served precision "
                "(int8=%s); align the publisher's quantize= with the server's --int8"
                % (not self.int8, self.int8)
            )
        _check_tree_like(self.params, new, what)
        with torch.no_grad():
            for path, t in new.items():
                self.params[path].copy_(t)


class PolicyModel(_TorchModel):
    """Stateless MLP policy serving (:mod:`blendjax_torch.models.policy`):
    ``logits`` per tick on the params' device.  ``int8=True`` serves
    :func:`~blendjax_torch.ops.quant.quantize_policy` output through the
    same ``logits``."""

    kind = "policy"
    slots = 0  # stateless: no cache rows, reset is an accounting no-op
    pad_slot = 0

    def __init__(self, params, obs_dim, int8=False):
        from blendjax_torch.ops.quant import quantize_policy

        self.int8 = bool(int8)
        self._init_params(params, quantize_policy)
        self.obs_dim = int(obs_dim)

    def apply_weights(self, tree):
        """Adopt a published policy tree (float, or ``quantize_policy``
        output on an int8 server)."""
        self._adopt(tree, "policy")

    def reset_rows(self, idx):
        pass

    def step_rows(self, idx, obs):
        import torch

        from blendjax_torch.models import policy

        with torch.no_grad():
            out = policy.logits(self.params, torch.from_numpy(obs).to(self.device))
        return out.cpu().numpy()


class SeqFormerModel(_TorchModel):
    """Stateful world-model serving: a slot pool of batched KV caches
    (``init_cache(per_row=True)``) over ``slots + 1`` rows — the extra row
    absorbs the padding rows' writes — stepped by one gather ->
    ``decode_step`` -> scatter per tick.  On the card each bucket size's
    tick is a CUDA graph captured after eager warm-up ticks
    (:class:`blendjax_torch.models.train.Captured`), its ``idx`` and
    ``obs`` copied into the graph's static buffers before each replay;
    ``capture=False`` keeps it eager.  ``int8=True`` serves
    :func:`~blendjax_torch.ops.quant.quantize_seqformer` output through the
    same code.  It computes and caches in f32."""

    kind = "seqformer"

    def __init__(self, params, slots, length, *, window=None, int8=False, capture=None):
        import torch

        from blendjax_torch.models import seqformer
        from blendjax_torch.models.train import Captured
        from blendjax_torch.ops.quant import quantize_seqformer

        self.int8 = bool(int8)
        self._init_params(params, quantize_seqformer)
        self.slots = int(slots)
        self.length = int(length)
        self.window = window
        self.pad_slot = self.slots
        emb = "embed.w" if "embed.w" in self.params else "embed.w_q"
        self.obs_dim = self.params[emb].shape[0]
        self._cache = seqformer.init_cache(
            self.params, self.slots + 1, dtype=torch.float32, length=self.length,
            per_row=True)
        if capture and self.device.type != "cuda":
            raise RuntimeError("capture=True needs the params on a CUDA device")
        self.captured = self.device.type == "cuda" if capture is None else bool(capture)
        #: the captured ticks, by bucket signature
        self.graphs = Captured()
        self._bound = {("param", k): v for k, v in self.params.items()}
        for name in ("k", "v"):
            self._bound.update({(name, i): t for i, t in enumerate(self._cache[name])})
        self._bound["pos"] = self._cache["pos"]

    def _tick(self, batch):
        """Gather the rows' caches, decode one position, scatter them back;
        the padding rows all write the pad row, which is never read."""
        import torch

        from blendjax_torch.models import seqformer

        idx, cache = batch["idx"], self._cache
        rows = {"pos": cache["pos"][idx],
                "k": [k[idx] for k in cache["k"]],
                "v": [v[idx] for v in cache["v"]]}
        with torch.no_grad():
            pred, rows = seqformer.decode_step(
                self.params, rows, batch["obs"], compute_dtype=torch.float32,
                window=self.window)
        cache["pos"][idx] = rows["pos"]
        for name in ("k", "v"):
            for c, n in zip(cache[name], rows[name]):
                c[idx] = n
        return pred

    def warm(self, buckets):
        """Run every bucket's tick through its eager warm-ups and its
        capture on the pad row, which no episode reads, so no capture lands
        in served traffic."""
        from blendjax_torch.models.train import WARMUP_STEPS

        for b in buckets:
            for _ in range(WARMUP_STEPS + 1):
                self.step_rows(np.full(b, self.pad_slot, np.int64),
                               np.zeros((b, self.obs_dim), np.float32))

    def step_rows(self, idx, obs):
        import torch

        batch = {"idx": torch.from_numpy(np.asarray(idx, np.int64)).to(self.device),
                 "obs": torch.from_numpy(np.asarray(obs, np.float32)).to(self.device)}
        if self.captured:
            pred = self.graphs(self._tick, batch, self._bound)
        else:
            pred = self._tick(batch)
        return pred.cpu().numpy()  # fence: the compute stage ends on the host

    def prefill_rows(self, idx, prefix):
        """Admit a T-step prefix into slot ``idx`` with one teacher-forced
        pass; returns the prediction for position T (what the T'th serial
        step would have returned), and the slot's next step decodes at T."""
        import torch

        from blendjax_torch.models import seqformer

        t0 = int(prefix.shape[0])
        if t0 > self.length and (self.window is None or self.window > self.length):
            raise ValueError(
                f"prefix of {t0} steps exceeds the {self.length}-slot cache ring "
                "(and no window bounds attention): raise length= or serve a "
                "windowed model"
            )
        if "pos" in self.params and t0 > self.params["pos"].shape[0]:
            raise ValueError(
                f"prefix of {t0} steps exceeds the learned position table "
                f"({self.params['pos'].shape[0]}); use pos_encoding='rope' for "
                "longer prefixes"
            )
        rows = torch.as_tensor(np.asarray(idx, np.int64)[:1], device=self.device)
        prefix = torch.from_numpy(np.array(prefix, np.float32)).to(self.device)
        with torch.no_grad():
            preds = seqformer.prefill_cache(self.params, prefix[None], self._cache, rows,
                                            torch.float32, window=self.window)
        return preds[0, -1].cpu().numpy()

    def apply_weights(self, tree):
        """Adopt a published SeqFormer tree of this server's precision.  The
        slot pool is untouched: live episodes keep their rows and positions
        and decode under the new weights from the next tick."""
        self._adopt(tree, "seqformer")

    def reset_rows(self, idx):
        import torch

        # rewinding the position is the reset: the previous tenant's k/v
        # sit at negative slot positions and never attend
        self._cache["pos"][torch.as_tensor(np.asarray(idx, np.int64), device=self.device)] = 0


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


class _Pending:
    __slots__ = ("ident", "mid", "msg", "t_enq", "span_trace", "t0_us", "mstate")

    def __init__(self, ident, mid, msg, span_trace, t0_us, mstate):
        self.ident = ident
        self.mid = mid
        self.msg = msg
        self.t_enq = time.perf_counter()
        self.span_trace = span_trace
        self.t0_us = t0_us
        self.mstate = mstate


class _ModelState:
    """One hosted model's serving state: its slot pool (or stateless
    episode registry)."""

    __slots__ = ("mid", "model", "free", "live", "stateless_eps", "weight_version")

    def __init__(self, mid, model):
        self.mid = mid
        self.model = model
        #: the version of the last snapshot this model adopted (None: its
        #: initial params; its replies then carry no stamp)
        self.weight_version = None
        self.free = list(range(model.slots))
        self.live = {}  # slot -> [episode lease id, monotonic last-use]
        self.stateless_eps = {}  # stateless: episode id -> monotonic last-use


class PolicyServer:
    """One served model behind a ROUTER socket (continuous batching) or a
    REP socket (``serial=True``, one request per exchange).

    Params
    ------
    address: str
        Endpoint to bind (``tcp://host:*`` binds an ephemeral port; the
        resolved endpoint is :attr:`address`).
    model:
        A served-model adapter (:class:`LinearModel`, :class:`PolicyModel`,
        :class:`SeqFormerModel`), or a ``{model_id: adapter}`` dict hosting
        several behind one socket: requests carry ``model`` in the envelope
        (none: the first model), each model keeps its own slot pool, and a
        tick batches one model's requests.
    serial: bool
        REP socket, batch size 1, no queue.
    tick_ms: float
        How long a tick waits for co-arriving requests once one is queued.
    max_batch: int
        Largest bucket (and the most requests one tick serves); requests
        pad to :func:`default_buckets`.
    slot_ttl_s: float | None
        Idle-slot eviction horizon for a reset that finds no free slot
        (None: the reset is denied instead).
    shm_base: str | None
        ``/dev/shm`` name prefix of the ShmRPC transport (a supervising
        parent passes one so it can sweep what a killed server left;
        generated when None).
    subscriber: blendjax_torch.weights.WeightSubscriber | None
        WeightBus subscription, polled from the serve loop between ticks:
        a complete, digest-verified snapshot is copied into the hosted
        model (the snapshot's ``model`` id, else the subscriber's, else the
        default model), slots, leases and the reply cache untouched; a
        torn or refused snapshot leaves the last good version serving.
    """

    def __init__(self, address, model, *, serial=False, tick_ms=2.0, max_batch=64,
                 slot_ttl_s=None, counters=None, timer=None, subscriber=None,
                 shm_base=None):
        import zmq

        if isinstance(model, dict):
            if not model:
                raise ValueError("multi-model server needs >= 1 model")
            self._models = {str(k): _ModelState(str(k), m) for k, m in model.items()}
        else:
            self._models = {model.kind: _ModelState(model.kind, model)}
        self._default_id = next(iter(self._models))
        self.serial = bool(serial)
        self.tick_ms = float(tick_ms)
        if int(max_batch) < 1:
            raise ValueError(f"max_batch must be positive: {max_batch}")
        self.buckets = default_buckets(int(max_batch))
        self.max_batch = int(max_batch)
        self.slot_ttl_s = slot_ttl_s
        self.counters = counters if counters is not None else fleet_counters
        self.timer = timer if timer is not None else StageTimer()
        self._reply_cache = OrderedDict()
        self._queue = deque()
        self._pending = {}  # mid -> _Pending still queued (dedupe)
        # the episode-lease sequence is server-global: no two hosted
        # models hand out the same lease id
        self._episode_seq = 0
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.REP if self.serial else zmq.ROUTER)
        self._sock.setsockopt(zmq.LINGER, 0)
        if address.endswith(":*") or address.endswith(":0"):
            base = address.rsplit(":", 1)[0]
            port = self._sock.bind_to_random_port(base)
            self.address = f"{base}:{port}"
        else:
            self._sock.bind(address)
            self.address = address
        # the same-host ShmRPC transport (None when disabled) serves the same
        # admission queue and slot pools: a request is a request whichever
        # wire delivered it
        self._shm = None
        if shm_rpc.enabled():
            self._shm = shm_rpc.ShmRpcServer(shm_base or shm_rpc.new_base("ps"), self.counters)
        self._poller = zmq.Poller()
        self._poller.register(self._sock, zmq.POLLIN)
        if self._shm is not None and self._shm.fd is not None:
            self._poller.register(self._shm.fd, zmq.POLLIN)
        #: the latest adopted snapshot's version over all hosted models
        #: (stats and telemetry); replies carry their own model's
        self.subscriber = subscriber
        self.weight_version = None
        if subscriber is not None:
            # the subscriber counts into the server's sinks unless the
            # caller wired its own, and its pushed chunks wake the loop
            if subscriber.counters is None:
                subscriber.counters = self.counters
            if subscriber.timer is None:
                subscriber.timer = self.timer
            self._poller.register(subscriber.sock, zmq.POLLIN)

    @property
    def shm_endpoint(self):
        """The advertised ``shm://`` endpoint (None on a pure-ZMQ server)."""
        return self._shm.endpoint if self._shm is not None else None

    @property
    def model(self):
        """The default hosted model's adapter."""
        return self._models[self._default_id].model

    @property
    def models(self):
        """Hosted model ids, default first."""
        return tuple(self._models)

    def _state_or_error(self, msg):
        mid = msg.get("model")
        st = self._models.get(self._default_id if mid is None else mid)
        if st is None:
            return None, {"error": f"unknown model {mid!r}; hosted: {sorted(self._models)}"}
        return st, None

    # -- slot pool -----------------------------------------------------------

    def _alloc_slot(self, st):
        """Returns (slot, episode lease id), or (None, None) when full."""
        if st.model.slots == 0:
            self._episode_seq += 1
            st.stateless_eps[self._episode_seq] = time.monotonic()
            return -1, self._episode_seq
        if not st.free and self.slot_ttl_s is not None:
            now = time.monotonic()
            stale = [s for s, (_, ts) in st.live.items() if now - ts > self.slot_ttl_s]
            for s in stale:
                del st.live[s]
                st.free.append(s)
            if stale:
                self.counters.incr("serve_evictions", len(stale))
        if not st.free:
            return None, None
        slot = st.free.pop()
        self._episode_seq += 1
        st.live[slot] = [self._episode_seq, time.monotonic()]
        st.model.reset_rows(np.asarray([slot]))
        return slot, self._episode_seq

    def _free_slot(self, st, slot, episode=None):
        lease = st.live.get(slot)
        if lease is None:
            return False
        if episode is not None and lease[0] != episode:
            return False  # a stale close must not kill the new tenant
        del st.live[slot]
        st.free.append(slot)
        return True

    # -- request handling ----------------------------------------------------

    def _live_count(self, st):
        return len(st.live) if st.model.slots > 0 else len(st.stateless_eps)

    def _live_episodes(self):
        return sum(self._live_count(st) for st in self._models.values())

    def _capabilities(self, st):
        return {"model": st.model.kind, "obs_dim": st.model.obs_dim,
                "slots": st.model.slots, "serial": self.serial,
                "int8": bool(getattr(st.model, "int8", False)),
                "max_batch": self.max_batch, "buckets": list(self.buckets)}

    def _cmd_hello(self, msg):
        st = self._models[self._default_id]
        return {
            **self._capabilities(st),
            "free_slots": len(st.free),
            "models": {
                s.mid: {"kind": s.model.kind, "obs_dim": s.model.obs_dim,
                        "slots": s.model.slots, "free_slots": len(s.free),
                        "int8": bool(getattr(s.model, "int8", False))}
                for s in self._models.values()
            },
            "shm": self._shm.info() if self._shm is not None else None,
            "pid": os.getpid(),
        }

    def _cmd_reset(self, msg):
        st, err = self._state_or_error(msg)
        if err is not None:
            return err
        slot, episode = self._alloc_slot(st)
        if slot is None:
            self.counters.incr("serve_slot_denied")
            return {"error": (
                f"no free episode slot ({st.model.slots} live on model "
                f"{st.mid!r}); close an episode or raise slots="
            )}
        reply = {"slot": slot, "episode": episode}
        prefix = msg.get("prefix")
        if prefix is not None:
            err = self._prefill(st, slot, episode, prefix, reply)
            if err is not None:
                return err
        self.counters.incr("serve_resets")
        return reply

    def _prefill(self, st, slot, episode, prefix, reply):
        """Prefill admission: replay a T-step prefix into the new slot with
        one teacher-forced pass.  Fills ``reply`` on success; returns an
        error reply (the slot freed again) on failure."""
        def fail(text):
            if st.model.slots > 0:
                self._free_slot(st, slot, episode)
            else:
                st.stateless_eps.pop(episode, None)
            return {"error": text}

        if not hasattr(st.model, "prefill_rows") or st.model.slots == 0:
            return fail(f"model {st.mid!r} ({st.model.kind}) is stateless or has no "
                        "prefill path: admit without a prefix")
        try:
            prefix = np.asarray(prefix, np.float32)
        except (TypeError, ValueError) as exc:
            return fail(f"prefix not coercible to float32: {exc}")
        if prefix.ndim != 2 or prefix.shape[0] < 1 or prefix.shape[1] != st.model.obs_dim:
            return fail(f"prefix shape {prefix.shape} != (T >= 1, {st.model.obs_dim})")
        try:
            pred = st.model.prefill_rows(np.asarray([slot]), prefix)
        except Exception as exc:  # noqa: BLE001 - surfaced to client
            logger.exception("policy server: prefill failed")
            return fail(f"prefill failed: {type(exc).__name__}: {exc}")
        self.counters.incr("serve_prefills")
        reply["pred"] = np.ascontiguousarray(pred)
        reply["pos"] = int(prefix.shape[0])
        return None

    def _cmd_close(self, msg):
        st, err = self._state_or_error(msg)
        if err is not None:
            return err
        if st.model.slots == 0:
            closed = st.stateless_eps.pop(msg.get("episode"), None) is not None
        else:
            closed = self._free_slot(st, int(msg.get("slot", -1)), msg.get("episode"))
        if closed:
            # a no-op close is answered but not counted: resets and closes
            # must reconcile
            self.counters.incr("serve_closes")
        return {"closed": closed}

    def _cmd_stats(self, msg):
        st = self._models[self._default_id]
        return {
            "model": st.model.kind,
            "slots": st.model.slots,
            "live_slots": len(st.live),
            "live_episodes": self._live_count(st),
            "free_slots": len(st.free),
            "queued": len(self._queue),
            "serial": self.serial,
            "models": list(self._models),
            "weight_version": self.weight_version,
            "per_model": {
                s.mid: {"slots": s.model.slots, "free_slots": len(s.free),
                        "live_slots": len(s.live), "live_episodes": self._live_count(s)}
                for s in self._models.values()
            },
            "counters": self.counters.snapshot(),
            # per hosted model, the CUDA graphs its ticks captured so far
            # (a recapture after a weight swap would raise it)
            "captures": {s.mid: s.model.graphs.captures for s in self._models.values()
                         if hasattr(s.model, "graphs")},
            "pid": os.getpid(),
        }

    def _cmd_telemetry(self, msg):
        """This process's counters and stage summaries, with its load and
        capabilities."""
        st = self._models[self._default_id]
        return {
            "model": st.model.kind,
            "models": list(self._models),
            "queued": len(self._queue),
            "live_episodes": self._live_episodes(),
            "weight_version": self.weight_version,
            "hello": self._capabilities(st),
            "pid": os.getpid(),
            "counters": self.counters.snapshot(),
            "stages": self.timer.snapshot_serialized(),
        }

    def _control_reply(self, msg):
        cmd = msg.get("cmd")
        handler = getattr(self, f"_cmd_{cmd}", None)
        if handler is None:
            reply = {"error": f"unknown serve command {cmd!r}"}
        else:
            try:
                reply = handler(msg)
            except Exception as exc:  # noqa: BLE001 - surfaced to client
                logger.exception("policy server: %r failed", cmd)
                reply = {"error": f"{type(exc).__name__}: {exc}"}
        if "error" in reply:
            self.counters.incr("serve_errors")
        return reply

    def _poll_weights(self):
        """Drain the WeightBus subscription and hot-swap a staged snapshot,
        called from the serve loop between ticks (no batch in flight).  A
        snapshot the model refuses (structure, shape or precision) is
        counted and dropped; the last good version keeps serving."""
        if self.subscriber is None:
            return
        snap = self.subscriber.poll()
        if snap is None:
            return
        target = (snap.model if snap.model is not None
                  else self.subscriber.model if self.subscriber.model is not None
                  else self._default_id)
        st = self._models.get(target)
        t0 = time.perf_counter()
        try:
            if st is None:
                raise KeyError(f"snapshot for unhosted model {target!r} "
                               f"(hosted: {sorted(self._models)})")
            st.model.apply_weights(snap.tree())
        except Exception as exc:  # noqa: BLE001 - keep serving the last good version
            self.counters.incr("weight_apply_failed")
            logger.warning("policy server: weight snapshot v%d refused (%s: %s); still "
                           "serving v%s", snap.version, type(exc).__name__, exc,
                           self.weight_version)
            return
        st.weight_version = snap.version
        self.weight_version = snap.version
        self.counters.incr("weight_adopted")
        self.timer.add("weight_swap", time.perf_counter() - t0)
        logger.info("policy server: weights v%d hot-swapped (step %d)", snap.version,
                    snap.step)

    def _finish(self, ident, msg, reply, *, span_name, t0_us, ding=True):
        """Stamp the executing model's weight version, the correlation id and
        the span, cache mutating replies, send.  ``ding=False`` defers the
        shm doorbell to the caller's flush."""
        st = self._models.get(msg.get("model") or self._default_id)
        if st is not None and st.weight_version is not None:
            # stamped before the reply cache: a retry answered from it
            # reports the version that executed the request
            reply["weight_version"] = st.weight_version
        mid = msg.get(wire.BTMID_KEY)
        span_ctx = msg.get(wire.SPAN_KEY)
        if isinstance(span_ctx, dict) and span_ctx.get("trace") is not None:
            reply = dict(reply)
            reply[wire.SPANS_KEY] = [make_span(span_name, t0_us,
                                               trace=span_ctx["trace"], cat="serve")]
        if mid is not None:
            reply[wire.BTMID_KEY] = mid
            if msg.get("cmd") in MUTATING_CMDS:
                self._reply_cache[mid] = reply
                while len(self._reply_cache) > REPLY_CACHE_DEPTH:
                    self._reply_cache.popitem(last=False)
        self._send(ident, reply, ding=ding)

    def _send(self, ident, reply, ding=True):
        import zmq

        if getattr(ident, "shm_channel", False):
            # the request came over shm: the reply goes back down the same
            # channel (a dead or full channel drops it; the client demotes
            # and its same-mid retry is answered from the reply cache)
            if self._shm is not None and self._shm.send(ident, reply, ding=ding):
                self.counters.incr("serve_replies")
            return
        try:
            if self.serial:
                sent = wire.send_message(self._sock, reply, raw_buffers=True)
            else:
                sent = wire.send_message_router(self._sock, ident, reply, raw_buffers=True)
            self.counters.incr("serve_wire_bytes", sent)
            self.counters.incr("serve_replies")
        except zmq.ZMQError:
            pass  # client gone; its retry will re-dial

    def _admit(self, ident, msg):
        """One decoded request: answer control commands at once, queue
        ``step``s for the next tick, dedupe retries."""
        self.counters.incr("serve_requests")
        mid = msg.get(wire.BTMID_KEY)
        cmd = msg.get("cmd")
        t0_us = now_us()
        if mid is not None and cmd in MUTATING_CMDS and mid in self._reply_cache:
            # a retry of an executed request: the cached reply answers it
            self.counters.incr("serve_cache_hits")
            self._send(ident, self._reply_cache[mid])
            return
        if cmd != "step":
            reply = self._control_reply(msg)
            self._finish(ident, msg, reply, span_name=f"serve:{cmd}", t0_us=t0_us)
            return
        if mid is not None and mid in self._pending:
            # a retry of a request still queued: the original's reply
            # answers it, sent to the latest route
            self.counters.incr("serve_dup_inflight")
            self._pending[mid].ident = ident
            return
        st, err = self._state_or_error(msg)
        if err is not None:
            self.counters.incr("serve_errors")
            self._finish(ident, msg, err, span_name="serve:step", t0_us=t0_us)
            return
        span_ctx = msg.get(wire.SPAN_KEY)
        trace = (span_ctx or {}).get("trace") if isinstance(span_ctx, dict) else None
        ent = _Pending(ident, mid, msg, trace, t0_us, st)
        self._queue.append(ent)
        if mid is not None:
            self._pending[mid] = ent

    def _step_entry_error(self, ent, text, lease=None):
        """Error-reply one queued step; ``lease`` ("unknown"/"stale") rides
        as a structured field."""
        self.counters.incr("serve_errors")
        reply = {"error": text}
        if lease is not None:
            reply["lease"] = lease
        self._finish(ent.ident, ent.msg, reply, span_name="serve:step", t0_us=ent.t0_us)

    def _tick(self):
        """Drain up to ``max_batch`` queued steps of one model (the queue
        head's) into one padded, bucketed model call and scatter the
        replies.  Returns True when entries of another model were left at
        the front of the queue (the serve loop ticks again at once)."""
        t_assemble = time.perf_counter()
        head = None
        skipped = deque()
        batch = []
        while self._queue and len(batch) < self.max_batch:
            ent = self._queue.popleft()
            if head is None:
                head = ent.mstate
            elif ent.mstate is not head:
                skipped.append(ent)
                continue
            if ent.mid is not None:
                self._pending.pop(ent.mid, None)
            st = ent.mstate
            stateful = st.model.slots > 0
            slot = int(ent.msg.get("slot", -1)) if stateful else -1
            if not stateful:
                ep = ent.msg.get("episode")
                if ep is not None:
                    st.stateless_eps[ep] = time.monotonic()
            if stateful:
                lease = st.live.get(slot)
                if lease is None:
                    self._step_entry_error(ent, (
                        f"unknown episode slot {slot} (closed, evicted, or a "
                        "restarted server): reset() and resume"), lease="unknown")
                    continue
                if ent.msg.get("episode") not in (None, lease[0]):
                    self._step_entry_error(ent, (
                        f"stale episode lease for slot {slot} (evicted and "
                        "reassigned): reset() and resume"), lease="stale")
                    continue
            try:
                obs = np.asarray(ent.msg.get("obs"), np.float32)
            except (TypeError, ValueError) as exc:
                self._step_entry_error(ent, f"step obs not coercible to float32: {exc}")
                continue
            if obs.shape != (head.model.obs_dim,):
                self._step_entry_error(
                    ent, f"step obs shape {obs.shape} != ({head.model.obs_dim},)")
                continue
            batch.append((ent, slot, obs))
        more = bool(skipped)
        while skipped:
            self._queue.appendleft(skipped.pop())
        if not batch:
            return more
        model = head.model
        stateful = model.slots > 0
        n = len(batch)
        bucket = next((b for b in self.buckets if b >= n), self.buckets[-1])
        for ent, _, _ in batch:
            self.timer.add("queue_wait", t_assemble - ent.t_enq)
        idx = np.full(bucket, model.pad_slot, np.int64)
        obs_arr = np.zeros((bucket, model.obs_dim), np.float32)
        pos_before = []
        now = time.monotonic()
        for j, (ent, slot, obs) in enumerate(batch):
            idx[j] = slot if stateful else j
            obs_arr[j] = obs
            if stateful:
                head.live[slot][1] = now
            pos_before.append(int(model.pos[slot])
                              if hasattr(model, "pos") and stateful else None)
        t_compute = time.perf_counter()
        self.timer.add("batch_assemble", t_compute - t_assemble)
        try:
            preds = model.step_rows(idx, obs_arr)
        except Exception as exc:  # noqa: BLE001 - server must survive
            logger.exception("policy server: batched step failed")
            for ent, _, _ in batch:
                self._step_entry_error(
                    ent, f"batched step failed: {type(exc).__name__}: {exc}")
            return more
        t_reply = time.perf_counter()
        self.timer.add("compute", t_reply - t_compute)
        self.counters.incr("serve_batches")
        if bucket > n:
            self.counters.incr("serve_batch_pad", bucket - n)
        for j, (ent, slot, _) in enumerate(batch):
            reply = {"pred": np.ascontiguousarray(preds[j])}
            if pos_before[j] is not None:
                reply["pos"] = pos_before[j]
            # the batch's shm replies ring one bell per channel (below)
            self._finish(ent.ident, ent.msg, reply, span_name="serve:step",
                         t0_us=ent.t0_us, ding=False)
        if self._shm is not None:
            self._shm.flush_bells()
        self.timer.add("reply", time.perf_counter() - t_reply)
        return more

    # -- serving -------------------------------------------------------------

    def _window_target(self):
        """Queue occupancy at which an admission window stops waiting:
        every live episode (each keeps at most one step in flight), capped
        at the largest bucket; idle stateless episodes are pruned after
        :data:`STATELESS_TTL_S`."""
        live = 0
        for st in self._models.values():
            if st.model.slots == 0 and st.stateless_eps:
                cutoff = time.monotonic() - STATELESS_TTL_S
                for ep, ts in list(st.stateless_eps.items()):
                    if ts < cutoff:
                        del st.stateless_eps[ep]
            live += self._live_count(st)
        return min(self.max_batch, max(1, live))

    def _drain(self):
        """Admit every request sitting on the socket."""
        import zmq

        def handle(out):
            ident, msg, nbytes = out
            self.counters.incr("serve_wire_bytes", nbytes)
            reply = shm_rpc.control_reply(self._shm, msg)
            if reply is not None:
                # transport negotiation, not workload: answered outside the
                # request counters and the reply cache
                try:
                    wire.send_message_router(self._sock, ident, reply)
                except zmq.ZMQError:
                    pass
                return
            self._admit(ident, msg)

        drain_socket(
            lambda: wire.recv_message_router_sized(self._sock, flags=zmq.NOBLOCK),
            handle, self.counters, "policy server", "request")

    def _handle_shm_msg(self, chan, msg):
        reply = shm_rpc.control_reply(self._shm, msg)
        if reply is not None:
            self._shm.send(chan, reply)
            return
        self._admit(chan, msg)
        if self.serial:
            # serial is per request: tick at once so co-pumped shm requests
            # never batch
            while self._queue:
                self._tick()

    def _drain_shm(self):
        """Admit every request pending on the shm channels (the channel
        rides as the request's reply ident)."""
        if self._shm is not None:
            self._shm.pump(self._handle_shm_msg)

    def serve_forever(self, stop_event=None, poll_ms=50):
        import zmq

        if self.serial:
            self._serve_serial(stop_event, poll_ms)
            return
        while stop_event is None or not stop_event.is_set():
            try:
                # between ticks: the hot-swap point
                self._poll_weights()
                if not self._queue:
                    self._poller.poll(poll_ms)
                    self._drain()
                    self._drain_shm()
                    if not self._queue:
                        continue
                # admission window: wait up to tick_ms for co-arriving
                # requests; leave on the first empty poll slice, a full
                # bucket, or once every live episode has a step queued
                t_end = time.perf_counter() + self.tick_ms / 1000.0
                while len(self._queue) < self._window_target():
                    rem_ms = (t_end - time.perf_counter()) * 1e3
                    if rem_ms <= 0:
                        break
                    if not self._poller.poll(max(1, int(rem_ms))):
                        break
                    self._drain()
                    self._drain_shm()
            except zmq.ZMQError:
                return  # socket closed under us: clean shutdown
            if self._queue:
                while self._tick():
                    pass

    def _serve_serial(self, stop_event, poll_ms):
        """The REP baseline: one request, one (batch-1) reply.  shm channels
        are served from the same loop (their replies ride their own rings,
        so the REP alternation governs only the ZMQ socket)."""
        import zmq

        while stop_event is None or not stop_event.is_set():
            try:
                events = dict(self._poller.poll(poll_ms))
                self._poll_weights()  # between (batch-1) ticks
                self._drain_shm()  # ticks per message (serial handler)
                if self._sock not in events:
                    continue
                try:
                    msg, nbytes = wire.recv_message_sized(self._sock)
                    self.counters.incr("serve_wire_bytes", nbytes)
                except zmq.ZMQError:
                    return
                except Exception as exc:  # noqa: BLE001 - see _drain
                    # REP alternation: the garbled request was consumed, so
                    # a reply is owed before the next recv
                    self.counters.incr("serve_errors")
                    logger.warning("policy server: undecodable request (%s: %s)",
                                   type(exc).__name__, exc)
                    self._send(None, {"error": "undecodable request (corrupt frames)"})
                    continue
            except zmq.ZMQError:
                return
            reply = shm_rpc.control_reply(self._shm, msg)
            if reply is not None:
                try:
                    wire.send_message(self._sock, reply)
                except zmq.ZMQError:
                    return
                continue
            self._admit(None, msg)
            while self._queue:
                self._tick()

    def close(self):
        try:
            self._sock.close(0)
        except Exception:  # noqa: BLE001 - shutdown best-effort
            pass
        if self.subscriber is not None:
            try:
                self.subscriber.close()
            except Exception:  # noqa: BLE001
                pass
        if self._shm is not None:
            try:
                self._shm.close(unlink=True)
            except Exception:  # noqa: BLE001
                pass
            self._shm = None


# ---------------------------------------------------------------------------
# in-process surface
# ---------------------------------------------------------------------------


class _LocalServerHandle:
    """An in-process server (thread) for tests and benchmarks."""

    def __init__(self, server, thread, stop):
        self.server = server
        self.address = server.address
        self._thread = thread
        self._stop = stop

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_server_thread(model, *, address="tcp://127.0.0.1:*", serial=False,
                        counters=None, timer=None, **kwargs):
    """Serve a :class:`PolicyServer` from a daemon thread; returns a handle
    with ``.address``, ``.server`` and ``.close()``."""
    server = PolicyServer(address, model, serial=serial, counters=counters, timer=timer,
                          **kwargs)
    stop = threading.Event()
    thread = threading.Thread(target=server.serve_forever, kwargs={"stop_event": stop},
                              daemon=True, name="bjx-policy-server")
    thread.start()
    return _LocalServerHandle(server, thread, stop)


class _ServeLaunchInfo:
    """Duck-typed ``launch_info``, so
    :class:`~blendjax_torch.btt.watchdog.FleetWatchdog` and
    :class:`~blendjax_torch.btt.supervise.FleetSupervisor` supervise server
    processes as they do producers and replay shards."""

    def __init__(self, processes, addresses):
        self.processes = processes
        self.addresses = {"SERVE": addresses}


class ServerProcess:
    """One policy-server process with a launcher-compatible surface
    (``launch_info`` and ``respawn(idx)``), so ``FleetWatchdog(restart=True)``
    respawns it after a SIGKILL with its original command line.  The model
    is rebuilt from ``--seed``; slots are fresh, which is the contract
    clients see: a step against a restarted server errors and the client
    resumes with ``reset()``.

    ``device`` is passed as ``--device``: the replica runs on the card
    unless ``device="cpu"``.  A child that cannot have its device exits,
    and :meth:`wait_ready` raises with the tail of the child's stderr.
    ``extra_args`` are appended to the command line (``--d-model`` and the
    other model widths, ``--int8``).  The parent allocates the server's
    ``/dev/shm`` base (``--shm-base``) and sweeps it at a respawn and at close.
    """

    def __init__(self, *, model="linear", address=None, seed=0, obs_dim=8, slots=16,
                 length=64, tick_ms=2.0, max_batch=64, work_us=0, subscribe=None,
                 device="cuda", ready_timeout=60.0, extra_args=()):
        from blendjax_torch.replay.shard_client import free_port

        self.address = address or f"tcp://127.0.0.1:{free_port()}"
        self.device = str(device)
        self.ready_timeout = float(ready_timeout)
        self.shm_base = shm_rpc.new_base("sp") if shm_rpc.enabled() else None
        self._cmd = [
            sys.executable, "-m", "blendjax_torch.serve.server",
            "--address", self.address, "--model", model, "--device", self.device,
            "--seed", str(seed), "--obs-dim", str(obs_dim), "--slots", str(slots),
            "--length", str(length), "--tick-ms", str(tick_ms),
            "--max-batch", str(max_batch),
        ]
        if self.shm_base is not None:
            self._cmd += ["--shm-base", self.shm_base]
        if work_us:
            self._cmd += ["--work-us", str(work_us)]
        if subscribe:
            self._cmd += ["--subscribe", subscribe]
        self._cmd += [str(a) for a in extra_args]
        self._stderr = None
        self.launch_info = None
        #: seconds from the last spawn to the first answered ``hello``
        self.ready_s = None
        self._spawned_at = None

    def _spawn(self):
        from blendjax_torch.btt.launcher import child_env

        # the child's stderr goes to an unnamed temporary file, so a child
        # that dies at startup can be quoted in wait_ready's error
        if self._stderr is not None:
            self._stderr.close()
        self._stderr = tempfile.TemporaryFile()
        self._spawned_at = time.monotonic()
        return subprocess.Popen(self._cmd, env=child_env(), stderr=self._stderr,
                                start_new_session=True)

    def stderr_tail(self, nbytes=4000):
        """The last ``nbytes`` of the current incarnation's stderr."""
        f = self._stderr
        if f is None:
            return ""
        f.flush()
        size = f.seek(0, os.SEEK_END)
        f.seek(max(0, size - nbytes))
        return f.read().decode(errors="replace")

    def start(self):
        """Spawn the process without waiting for it (see :meth:`wait_ready`)."""
        self.launch_info = _ServeLaunchInfo([self._spawn()], [self.address])
        return self

    def __enter__(self):
        self.start()
        try:
            self.wait_ready(self.ready_timeout)
        except BaseException:
            self.close()
            raise
        return self

    def wait_ready(self, timeout=60.0):
        """Block until the server answers ``hello``; raises RuntimeError
        with the child's stderr if it exits first, TimeoutError after
        ``timeout`` seconds."""
        from blendjax_torch.serve.client import ServeClient

        deadline = time.monotonic() + timeout
        while True:
            proc = self.launch_info.processes[0] if self.launch_info else None
            if proc is not None and proc.poll() is not None:
                raise RuntimeError(
                    f"policy server at {self.address} exited with code "
                    f"{proc.returncode} before it was ready:\n{self.stderr_tail()}")
            if time.monotonic() >= deadline:
                raise TimeoutError(f"policy server at {self.address} not ready within "
                                   f"{timeout:.1f}s:\n{self.stderr_tail()}")
            client = ServeClient(self.address, timeoutms=500, shm=False)
            try:
                client.hello(timeout_ms=500)
                self.ready_s = time.monotonic() - self._spawned_at
                return
            except TimeoutError:
                continue
            finally:
                client.close()

    def respawn(self, idx=0):
        """Relaunch with the original command line (the watchdog's
        contract), after sweeping the dead incarnation's ``/dev/shm``
        objects (a SIGKILL runs no cleanup)."""
        if self.shm_base is not None:
            shm_rpc.unlink_base(self.shm_base)
        proc = self._spawn()
        self.launch_info.processes[idx] = proc
        return proc

    def close(self):
        info = self.launch_info
        if info is not None:
            for p in info.processes:
                try:
                    p.terminate()
                except Exception:  # noqa: BLE001
                    pass
            for p in info.processes:
                try:
                    p.wait(timeout=10)
                except Exception:  # noqa: BLE001
                    try:
                        p.kill()
                        p.wait(timeout=5)
                    except Exception:  # noqa: BLE001
                        pass
        if self.shm_base is not None:
            shm_rpc.unlink_base(self.shm_base)
        if self._stderr is not None:
            self._stderr.close()
            self._stderr = None

    def __exit__(self, *exc):
        self.close()
        return False


def _wait_all(procs):
    """``wait_ready`` on every started process at once; raises the first
    failure."""
    errors = []

    def wait(p):
        try:
            p.wait_ready(p.ready_timeout)
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    threads = [threading.Thread(target=wait, args=(p,), daemon=True) for p in procs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


class ServerFleet:
    """N policy-server replica processes behind one launcher-compatible
    surface (a ``launch_info`` over every replica, and ``respawn(idx)``), so
    one watchdog or supervisor covers the whole serve fleet behind a
    :class:`~blendjax_torch.serve.gateway.ServeGateway`.  Every replica
    shares ``seed`` and so serves the same weights (what lease failover
    needs).  Keyword arguments go to each :class:`ServerProcess`
    (``device`` included: the card by default).

    Indices are stable: :meth:`grow` appends, :meth:`retire` leaves a
    ``None`` in its slot, so fleet index ``i`` is always the gateway's
    replica ``r<i>``."""

    def __init__(self, replicas, **kwargs):
        #: each replica's keyword arguments, newcomers' too
        self._kwargs = dict(kwargs)
        self._procs = [ServerProcess(**kwargs) for _ in range(int(replicas))]
        self.launch_info = None

    @property
    def addresses(self):
        return [None if p is None else p.address for p in self._procs]

    def __enter__(self):
        try:
            # spawn every replica, then wait for each in its own thread: the
            # boots overlap, and each replica's ready_s is its own
            for p in self._procs:
                p.start()
            _wait_all(self._procs)
        except BaseException:
            self.close()
            raise
        self.launch_info = _ServeLaunchInfo(
            [p.launch_info.processes[0] for p in self._procs], self.addresses)
        return self

    def respawn(self, idx):
        """Relaunch replica ``idx`` with its original command line."""
        if self._procs[idx] is None:
            raise RuntimeError(f"replica {idx} is retired; a retired slot is never "
                               "respawned (grow() to add capacity)")
        proc = self._procs[idx].respawn(0)
        self.launch_info.processes[idx] = proc
        return proc

    def grow(self, n=1):
        """Spawn ``n`` new replicas into the live fleet (autoscale
        scale-up), appended so existing indices never move; the spawns
        overlap, then each is waited ready.  Returns ``[(idx, address),
        ...]`` for the gateway's admission.  A newcomer that never comes up
        is retired on the spot and the error raised."""
        if self.launch_info is None:
            raise RuntimeError("grow() needs an entered fleet")
        added = []
        for _ in range(int(n)):
            p = ServerProcess(**self._kwargs)
            self._procs.append(p)
            idx = len(self._procs) - 1
            p.start()
            self.launch_info.processes.append(p.launch_info.processes[0])
            self.launch_info.addresses["SERVE"].append(p.address)
            added.append((idx, p.address))
        try:
            _wait_all([self._procs[idx] for idx, _ in added])
        except BaseException:
            for idx, _ in added:
                self.retire(idx)
            raise
        return added

    def retire(self, idx):
        """Retire replica ``idx`` for good (autoscale scale-down, after its
        gateway drain reached zero leases): terminate it and sweep its
        ``/dev/shm``.  The slot is kept as ``None`` so a watchdog skips it.
        Idempotent: returns False for a slot already retired."""
        p = self._procs[idx]
        if p is None:
            return False
        # the slot goes None before the kill: a watchdog polling between
        # the two must see a retired slot, not a death to respawn
        self._procs[idx] = None
        if self.launch_info is not None:
            self.launch_info.processes[idx] = None
        p.close()
        return True

    def shrink(self, victims):
        """Retire every index in ``victims``; returns those retired."""
        return [idx for idx in victims if self.retire(idx)]

    def close(self):
        for p in self._procs:
            if p is not None:
                p.close()
        self.launch_info = None

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# process entry point
# ---------------------------------------------------------------------------


def build_model(args, kind=None, seed=None):
    """Deterministic model construction from CLI args (params drawn from a
    generator seeded ``--seed`` on ``--device``).  ``kind``/``seed``
    override the args' own (the ``--extra-model`` path)."""
    kind = args.model if kind is None else kind
    seed = args.seed if seed is None else seed
    device = "cpu"
    if str(args.device) != "cpu":
        from blendjax_torch.utils.device import resolve_device

        # a replica asked for the card fails here when there is none,
        # whatever its model: nothing carries on quietly on the CPU
        device = resolve_device(args.device)
    if kind == "linear":
        return LinearModel(obs_dim=args.obs_dim, slots=args.slots, seed=seed,
                           work_us=getattr(args, "work_us", 0))
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "policy":
        from blendjax_torch.models import policy

        params = policy.init(gen, args.obs_dim, args.num_actions, device=device)
        return PolicyModel(params, args.obs_dim, int8=args.int8)
    if kind == "seqformer":
        from blendjax_torch.models import seqformer

        params = seqformer.init(gen, obs_dim=args.obs_dim, d_model=args.d_model,
                                n_heads=args.n_heads, n_layers=args.n_layers,
                                max_len=max(args.length, 8), device=device)
        return SeqFormerModel(params, args.slots, args.length, window=args.window,
                              int8=args.int8)
    raise ValueError(f"unknown --model {kind!r}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Serve one blendjax_torch policy/world-model.")
    ap.add_argument("--address", required=True)
    ap.add_argument("--model", default="linear", choices=("linear", "policy", "seqformer"))
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs-dim", type=int, default=8)
    ap.add_argument("--num-actions", type=int, default=4)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--length", type=int, default=64)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--serial", action="store_true")
    ap.add_argument("--tick-ms", type=float, default=2.0)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--work-us", type=float, default=0,
                    help="linear model only: a sleep of this many microseconds per row "
                         "and step, standing in for model compute")
    ap.add_argument("--shm-base", default=None,
                    help="/dev/shm name prefix for the ShmRPC transport (default: a "
                         "fresh one; BJX_NO_SHM_RPC=1 turns the transport off)")
    ap.add_argument("--extra-model", action="append", default=[], metavar="NAME=KIND",
                    help="host an additional model under NAME; the i'th extra model "
                         "inits from seed+1+i")
    ap.add_argument("--subscribe", default=None,
                    help="WeightBus publisher address: published snapshots hot-swap "
                         "into the served model between ticks")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    model = build_model(args)
    if args.extra_model:
        models = {model.kind: model}
        for i, spec in enumerate(args.extra_model):
            name, sep, kind = spec.partition("=")
            if not sep or not name or not kind:
                ap.error(f"--extra-model needs NAME=KIND, got {spec!r}")
            if name in models:
                ap.error(f"duplicate hosted model name {name!r}")
            models[name] = build_model(args, kind=kind, seed=args.seed + 1 + i)
        model = models
    subscriber = None
    if args.subscribe:
        from blendjax_torch.weights.bus import WeightSubscriber

        subscriber = WeightSubscriber(args.subscribe)
    server = PolicyServer(args.address, model, serial=args.serial, tick_ms=args.tick_ms,
                          max_batch=args.max_batch, shm_base=args.shm_base,
                          subscriber=subscriber)
    # a captured model captures every bucket's tick before it serves, so its
    # first requests never pay a capture
    for m in (model.values() if isinstance(model, dict) else [model]):
        if getattr(m, "captured", False):
            m.warm(server.buckets)
    stop = threading.Event()

    def _term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    logger.info("policy server (%s%s) serving %s", args.model,
                ", int8" if args.int8 else "", server.address)
    try:
        server.serve_forever(stop_event=stop)
    finally:
        server.close()


if __name__ == "__main__":
    main()
