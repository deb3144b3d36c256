"""Fixed-capacity experience replay over a columnar ring store: the port of
``blendjax.replay.buffer``.

The actor appends transitions at fleet rate, the learner samples batches
at device rate, and the two meet only at this buffer's lock (Podracer
architectures, arXiv:2104.06272).

- **columnar ring** (:class:`~blendjax_torch.replay.ring.ColumnStore`):
  one preallocated ``(capacity, *shape)`` array per transition key;
- **prioritized sampling** (:class:`~blendjax_torch.replay.sumtree.SumTree`):
  ``P(i) = p_i^alpha / sum p^alpha`` with importance-sampling weights
  ``w_i = (N * P(i))^-beta / max_j w_j`` (Schaul et al. 2015); new
  transitions enter at the running max priority; ``prioritized=False``
  draws uniformly over the eligible rows (weights identically 1);
- **seeded determinism**: one ``numpy.random.Generator`` drives every
  draw, so the same seed and the same appends give the same stream as
  the reference's buffer, index for index;
- **quarantine awareness**: appends flagged unhealthy are stored but never
  sampled, and counted under ``replay_excluded``;
- **thread safety**: one lock serializes row writes, index/priority state
  and gathers.

- **checkpoints**: :meth:`ReplayBuffer.save` writes the columns, the sum
  tree, the ring indices and the RNG's state in the reference's format
  (``"blendjax.replay/1"``, through :func:`~blendjax_torch.utils.checkpoint.save_state`),
  so either package restores the other's file and the restored buffer
  draws the exact stream the saved one would have.

- **scenario strata** (docs/scenarios.md): appends may carry a scenario
  id, kept as a per-slot stamp; a non-uniform ``scenario_mix=`` shapes a
  draw over the per-scenario strata (rows apportioned by largest
  remainder, drawn within each stratum by its own priority mass, IS
  weights for the true under-mix probability), index for index the
  reference's draw; ``None`` and uniform mixes take the plain draw.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from blendjax_torch.replay.ring import ColumnStore
from blendjax_torch.replay.sumtree import SumTree
from blendjax_torch.utils.timing import StageTimer, fleet_counters

#: Transition key reserved for the quarantine flag: consumed into the
#: eligibility mask at append time, never stored as a column (so a
#: ``.btr``-prefilled buffer is bit-identical to one fed by direct
#: appends — the flag travels inside the recorded message).
HEALTHY_KEY = "healthy"

#: Transition key reserved for the scenario id (docs/scenarios.md):
#: same in-band pattern as :data:`HEALTHY_KEY` — consumed into a
#: per-slot stamp at append time, never stored as a column, and it
#: travels inside recorded ``.btr`` messages so a prefilled buffer's
#: stamps (and stored bytes) are bit-identical to direct appends.
#: Stamps feed per-scenario strata (:meth:`ReplayBuffer.scenario_stats`
#: and the ``scenario_mix=`` draw shaping) and never touch the RNG or
#: the sum tree on their own, so a stamped-but-unmixed buffer draws the
#: exact scenario-less stream.
SCENARIO_KEY = "scenario"

#: The checkpoint format tag, the reference's.
REPLAY_FORMAT = "blendjax.replay/1"


def load_client_state(buf, arrays, meta):
    """Apply checkpointed sampling state (eligibility masks, generations,
    scenario stamps, sum tree, ring indices, RNG) to a freshly constructed
    buffer."""
    buf._valid = np.array(arrays["valid"], bool)
    buf._healthy = np.array(arrays["healthy"], bool)
    if "gen" in arrays:
        buf._gen = np.array(arrays["gen"], np.int64)
        buf._drawn_gen = np.array(arrays["drawn_gen"], np.int64)
    if "scenario" in arrays:
        # scenario stamps and the id<->name interning table (older
        # checkpoints carry neither: every slot restores unlabelled)
        buf._scenario = np.array(arrays["scenario"], np.int32)
        buf._scenario_names = list(meta.get("scenario_names", []))
        buf._scenario_ids = {n: i for i, n in enumerate(buf._scenario_names)}
    if buf.tree is not None:
        buf.tree.rebuild(arrays["tree_leaves"])
    buf._head = int(meta["head"])
    buf._size = int(meta["size"])
    buf._num_valid = int(meta["num_valid"])
    buf._max_priority = float(meta["max_priority"])
    buf._appends = int(meta["appends"])
    buf._overwrites = int(meta["overwrites"])
    buf._excluded = int(meta["excluded"])
    buf._samples = int(meta["samples"])
    state = meta["rng_state"]
    buf._rng = np.random.default_rng()
    try:
        buf._rng.bit_generator.state = state
    except (ValueError, TypeError):
        # a foreign bit generator (a checkpoint written under a numpy whose
        # default generator differs): rebuild it by name
        bg = getattr(np.random, state["bit_generator"])()
        bg.state = state
        buf._rng = np.random.Generator(bg)
    return buf


class ReplayBuffer:
    """Thread-safe prioritized experience replay.

    Params
    ------
    capacity: int
        Ring size in transitions; at capacity the oldest row is evicted
        per append.
    seed: int
        Seeds the sampling RNG (deterministic draw stream).
    prioritized: bool
        Sum-tree proportional sampling with IS weights; False = uniform.
    alpha: float
        Priority exponent (0 = uniform even when prioritized).
    beta: float
        IS-weight exponent (1 = full bias correction).
    eps: float
        Additive floor inside ``(|p| + eps)^alpha`` so zero-error
        transitions keep non-zero mass.
    counters: EventCounters | None
        Sink for the ``replay_*`` events; defaults to the process-wide
        :data:`blendjax_torch.utils.timing.fleet_counters`.
    timer: StageTimer | None
        Records ``replay_append`` / ``sample_wait`` / ``sample_gather``
        / ``priority_update`` stages; a private timer is created when
        omitted (always inspectable via ``buffer.timer``).
    name: str | None
        Label this buffer carries in every error it raises (a degraded
        run's traceback must identify WHICH buffer starved without
        log archaeology — the errors also embed a :meth:`stats`
        digest).  Defaults to ``replay[<capacity>]``.
    """

    def __init__(self, capacity, *, seed=0, prioritized=True, alpha=0.6,
                 beta=0.4, eps=1e-3, counters=None, timer=None, name=None):
        self.capacity = int(capacity)
        self.name = name or f"replay[{self.capacity}]"
        self.prioritized = bool(prioritized)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.eps = float(eps)
        self.seed = int(seed)
        self.store = ColumnStore(capacity)
        self.tree = SumTree(capacity) if self.prioritized else None
        self.counters = counters if counters is not None else fleet_counters
        self.timer = timer if timer is not None else StageTimer()
        self._rng = np.random.default_rng(seed)
        self._cond = threading.Condition()
        self._valid = np.zeros(self.capacity, bool)   # eligible for sampling
        self._healthy = np.ones(self.capacity, bool)  # quarantine flags
        # per-slot write generation, and the generation each slot carried
        # when it was last drawn: update_priorities refuses a slot whose
        # row was overwritten after its draw (the stale magnitude belongs
        # to the evicted transition, not the new occupant)
        self._gen = np.zeros(self.capacity, np.int64)
        self._drawn_gen = np.full(self.capacity, -1, np.int64)
        # per-slot scenario stamp (-1 = unlabelled) + the string<->int
        # interning table; stamps are pure bookkeeping — they never
        # touch the RNG or the tree, so the draw stream of a stamped
        # buffer is bit-identical to an unstamped one unless a
        # NON-uniform ``scenario_mix`` explicitly shapes a draw
        self._scenario = np.full(self.capacity, -1, np.int32)
        self._scenario_names = []
        self._scenario_ids = {}
        self._head = 0
        self._size = 0
        self._num_valid = 0
        self._max_priority = 1.0  # tree-space (already exponentiated)
        # local mirrors of the shared counters, for stats()/health()
        self._appends = 0
        self._overwrites = 0
        self._excluded = 0
        self._samples = 0

    def __len__(self):
        with self._cond:
            return self._size

    @property
    def num_eligible(self):
        """Rows currently eligible for sampling (healthy, live)."""
        with self._cond:
            return self._num_valid

    # -- error diagnostics ---------------------------------------------------

    def _diag_locked(self):
        """One-line stats digest for exception messages (caller holds the
        lock; the lock is not reentrant).  A TimeoutError in a degraded
        run must be diagnosable from the traceback alone (docs/replay.md),
        so every starvation/shard error embeds this."""
        return (
            f"size={self._size}/{self.capacity} eligible={self._num_valid} "
            f"excluded={self._excluded} appends={self._appends} "
            f"overwrites={self._overwrites} samples={self._samples}"
        )

    def _diag(self):
        with self._cond:
            return self._diag_locked()

    # -- append side ---------------------------------------------------------

    def _tree_priority(self, priority):
        """Map a caller-space priority (|TD error|-like magnitude) into
        tree space: ``(|p| + eps)^alpha``."""
        return float(abs(priority) + self.eps) ** self.alpha

    def _scenario_id_locked(self, scenario):
        """Intern a scenario name (caller holds the lock); -1 for None."""
        if scenario is None:
            return -1
        sid = self._scenario_ids.get(scenario)
        if sid is None:
            sid = len(self._scenario_names)
            self._scenario_names.append(str(scenario))
            self._scenario_ids[str(scenario)] = sid
        return sid

    def append(self, transition, *, healthy=True, priority=None,
               scenario=None):
        """Append one transition dict (O(1), no allocation after the
        first row fixes the schema).  Returns the ring slot written.

        A ``transition[HEALTHY_KEY]`` bool (as written by
        :func:`~blendjax_torch.replay.prefill.transition_to_message`) is
        consumed into the flag rather than stored; the ``healthy``
        kwarg ANDs with it.  Unhealthy rows are stored (inspectable via
        :meth:`get`) but never sampled.  A ``transition[SCENARIO_KEY]``
        string (or the ``scenario`` kwarg; the in-band value wins) is
        consumed into the slot's scenario stamp the same way —
        docs/scenarios.md — feeding the per-scenario strata without
        becoming a stored column.

        ``priority``: caller-space magnitude for prioritized mode; new
        rows default to the running max so they are sampled at least
        once before their first priority update.
        """
        if HEALTHY_KEY in transition or SCENARIO_KEY in transition:
            transition = dict(transition)
            if HEALTHY_KEY in transition:
                healthy = bool(transition.pop(HEALTHY_KEY)) \
                    and bool(healthy)
            if SCENARIO_KEY in transition:
                inband = transition.pop(SCENARIO_KEY)
                if inband is not None:
                    scenario = inband
        t0 = time.perf_counter()
        with self._cond:
            slot = self._head
            evicting = self._size == self.capacity
            self.store.write_row(slot, transition)
            self._head = (slot + 1) % self.capacity
            if not evicting:
                self._size += 1
            elif self._valid[slot]:
                self._overwrites += 1
                self.counters.incr("replay_overwrites")
                self._num_valid -= 1
            elif not self._healthy[slot]:
                self._excluded -= 1  # evicted an excluded row
            self._healthy[slot] = healthy
            self._valid[slot] = healthy
            sid = self._scenario_id_locked(scenario)
            self._scenario[slot] = sid
            if sid >= 0:
                self.counters.incr("scenario_rows_stamped")
            self._gen[slot] += 1
            if healthy:
                self._num_valid += 1
            else:
                self._excluded += 1
                self.counters.incr("replay_excluded")
            if self.tree is not None:
                if not healthy:
                    self.tree.set(slot, 0.0)
                else:
                    p = (
                        self._max_priority
                        if priority is None
                        else self._tree_priority(priority)
                    )
                    self._max_priority = max(self._max_priority, p)
                    self.tree.set(slot, p)
            self._appends += 1
            self.counters.incr("replay_appends")
            self._cond.notify_all()
        self.timer.add("replay_append", time.perf_counter() - t0)
        return slot

    def extend(self, transitions, *, healthy=None, scenarios=None):
        """Append a sequence of transition dicts; ``healthy`` is an
        optional parallel bool sequence (e.g. the pool's per-env health
        mask for one step) and ``scenarios`` an optional parallel
        scenario-name sequence (e.g. the per-env stamps one fleet step
        produced)."""
        for i, tr in enumerate(transitions):
            self.append(
                tr,
                healthy=True if healthy is None else bool(healthy[i]),
                scenario=None if scenarios is None else scenarios[i],
            )

    def get(self, index):
        """One stored transition (values copied out), including excluded
        rows — diagnostics and the naive-sampling baseline."""
        with self._cond:
            if not 0 <= index < self._size:
                raise IndexError(index)
            return self.store.read_row(index)

    # -- sample side ---------------------------------------------------------

    def _draw_locked(self, batch_size, beta):
        """Draw indices + IS weights under the lock (deterministic RNG
        order: one draw call per sample call)."""
        if self.tree is not None and self.tree.total > 0.0:
            total = self.tree.total
            # stratified: one uniform per equal-mass segment, so a batch
            # spans the priority range instead of clustering on the mode
            seg = total / batch_size
            masses = (np.arange(batch_size) + self._rng.random(batch_size)) * seg
            idx = self.tree.prefix_search_batch(
                np.minimum(masses, np.nextafter(total, 0))
            )
            probs = self.tree.get_many(idx) / total
            # float-edge descents can land on a zero-mass leaf; re-route
            # them to deterministic uniform picks over the eligible rows
            bad = probs <= 0.0
            if bad.any():
                eligible = np.flatnonzero(self._valid)
                idx[bad] = eligible[
                    self._rng.integers(0, eligible.size, int(bad.sum()))
                ]
                probs[bad] = 1.0 / self._num_valid
            weights = (self._num_valid * probs) ** -beta
            weights = (weights / weights.max()).astype(np.float32)
        else:
            eligible = np.flatnonzero(self._valid)
            idx = eligible[
                self._rng.integers(0, eligible.size, batch_size)
            ].astype(np.int64)
            weights = np.ones(batch_size, np.float32)
        return idx, weights

    def _drawable_mask_locked(self):
        """Rows drawable RIGHT NOW (caller holds the lock).  The base
        buffer draws from every eligible row; :class:`ShardedReplay`
        overrides this to exclude quarantined-shard and journaled rows,
        so the scenario-strata draw honors the same degraded-mode
        eligibility its base draw does."""
        return self._valid

    def _effective_mix_locked(self, scenario_mix):
        """Resolve a requested scenario mix to the strata the draw can
        actually honor (caller holds the lock), or None for the base
        draw path.

        None and UNIFORM mixes resolve to None — the scenario-less
        identity, byte-identical on the draw stream by construction
        (the regression-locked contract: scenario plane off, or on at
        uniform, changes nothing).  Scenarios with no eligible rows are
        dropped and the rest renormalized (degraded strata, the same
        spirit as shard-outage renormalization); a mix with NO
        satisfiable stratum also falls back to the base path rather
        than starving the learner."""
        if not scenario_mix:
            return None
        drawable = self._drawable_mask_locked()
        vals = [float(v) for v in scenario_mix.values()]
        if max(vals) - min(vals) < 1e-12:
            # uniform — the identity, but ONLY when it spans every
            # drawable row (the curriculum's uniform mix always names
            # the whole catalog).  An equal-weight PARTIAL mix (e.g.
            # one scenario pinned alone) genuinely restricts the draw
            # and must take the strata path.
            ids = [self._scenario_ids[n] for n in scenario_mix
                   if n in self._scenario_ids]
            if not drawable.any() or np.isin(
                self._scenario[drawable], ids
            ).all():
                return None
        live = {}
        for name, w in scenario_mix.items():
            if w <= 0:
                continue
            sid = self._scenario_ids.get(name)
            if sid is None:
                continue
            if bool((drawable
                     & (self._scenario == sid)).any()):
                live[name] = float(w)
        if not live:
            return None
        total = sum(live.values())
        return {n: w / total for n, w in live.items()}

    def _draw_strata_locked(self, batch_size, beta, mix):
        """Scenario-stratified draw (non-uniform mix only): batch rows
        apportioned per stratum (largest remainder, mix order), drawn
        within each stratum by the stratum's own tree-priority mass
        (uniform inside a stratum when unprioritized).  IS weights use
        the true under-mix sampling probability
        ``P(i) = mix[s] * p_i / mass_s``, so the PER bias correction
        stays exact under the reweighted draw."""
        from blendjax_torch.scenario.curriculum import apportion

        drawable = self._drawable_mask_locked()
        counts = {}
        for name in apportion(mix, batch_size):
            counts[name] = counts.get(name, 0) + 1
        idx_parts, prob_parts = [], []
        for name in mix:
            k = counts.get(name, 0)
            if k == 0:
                continue
            sid = self._scenario_ids[name]
            slots = np.flatnonzero(drawable & (self._scenario == sid))
            if self.tree is not None:
                p = self.tree.get_many(slots.astype(np.int64))
                mass = float(p.sum())
                probs = (p / mass) if mass > 0 else np.full(slots.size, 1.0 / slots.size)
            else:
                probs = np.full(slots.size, 1.0 / slots.size)
            pick = self._rng.choice(slots.size, size=k, p=probs)
            idx_parts.append(slots[pick].astype(np.int64))
            prob_parts.append(mix[name] * probs[pick])
        idx = np.concatenate(idx_parts)
        probs = np.concatenate(prob_parts)
        weights = (self._num_valid * np.maximum(probs, 1e-12)) ** -beta
        weights = (weights / weights.max()).astype(np.float32)
        self.counters.incr("scenario_strata_draws")
        return idx, weights

    def sample(self, batch_size, *, beta=None, min_size=None, timeout=30.0,
               out=None, stop_event=None, keys=None, scenario_mix=None):
        """Draw one prioritized (or uniform) batch.

        Returns ``(data, indices, weights)``: ``data`` is a dict of
        ``(batch_size, *shape)`` arrays gathered column-by-column (into
        ``out`` buffers when given — e.g. an arena's), ``indices`` are
        the ring slots (feed them back to :meth:`update_priorities`),
        ``weights`` the normalized IS weights (all ones when uniform).
        ``keys`` restricts the gather (and any device transfer behind
        it) to the columns the consumer actually reads.

        ``scenario_mix`` (docs/scenarios.md): a name->weight dict
        shapes the draw over per-scenario strata — rows apportioned per
        stratum, drawn within each by its own priority mass, IS weights
        corrected for the reweighting.  ``None`` and UNIFORM mixes take
        the exact scenario-less draw path (byte-identical stream);
        strata with no eligible rows are dropped and the rest
        renormalized.

        Blocks while fewer than ``min_size`` (default ``batch_size``)
        eligible rows exist — the learner outpacing the actor — timed
        under the ``sample_wait`` stage; raises TimeoutError after
        ``timeout`` seconds, returns None if ``stop_event`` fires.
        """
        need = batch_size if min_size is None else max(min_size, 1)
        deadline = time.monotonic() + timeout
        with self._cond:
            if self._num_valid < need:
                t0 = time.perf_counter()
                waited = False
                while self._num_valid < need:
                    if stop_event is not None and stop_event.is_set():
                        self.timer.add(
                            "sample_wait", time.perf_counter() - t0
                        )
                        return None
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self.timer.add(
                            "sample_wait", time.perf_counter() - t0
                        )
                        raise TimeoutError(
                            f"{self.name}: underfilled — {self._num_valid} "
                            f"eligible rows < {need} after {timeout:.1f}s "
                            f"({self._diag_locked()})"
                        )
                    if not waited:
                        # counted only when the call actually blocks — a
                        # deliberate timeout=0 probe (the learner's
                        # non-blocking off-policy tail) is not a "wait"
                        waited = True
                        self.counters.incr("replay_sample_waits")
                    self._cond.wait(min(0.1, remaining))
                self.timer.add("sample_wait", time.perf_counter() - t0)
            t0 = time.perf_counter()
            mix = self._effective_mix_locked(scenario_mix)
            if mix is None:
                idx, weights = self._draw_locked(
                    batch_size, self.beta if beta is None else beta
                )
            else:
                idx, weights = self._draw_strata_locked(
                    batch_size, self.beta if beta is None else beta, mix
                )
            self._drawn_gen[idx] = self._gen[idx]
            data = self.store.gather(idx, out=out, keys=keys)
            self._samples += 1
            self.counters.incr("replay_samples")
        self.timer.add("sample_gather", time.perf_counter() - t0)
        return data, idx, weights

    def update_priorities(self, indices, priorities):
        """Refresh sampled rows' priorities from fresh learner error
        magnitudes (caller space; ``(|p| + eps)^alpha`` applied here).

        Rows excluded since the draw are skipped, and so are rows whose
        slot was OVERWRITTEN after its last draw (generation check —
        the stale magnitude would otherwise land on an unrelated new
        occupant).  A slot never drawn at all (since construction or
        restore) accepts a direct priority set; once a slot has been
        drawn, updates apply only while the drawn row is still the
        occupant — a wrapped slot's new row rides its entering (max)
        priority until its own first draw re-arms updates (a stale
        update and a direct set are indistinguishable from here, so
        both are refused).  The one window left open: a slot
        overwritten and then re-drawn by a concurrent prefetched batch
        before this update applies accepts the stale value — bounded
        and self-correcting, since the later batch's own update follows
        with the fresh magnitude."""
        if self.tree is None:
            return
        t0 = time.perf_counter()
        with self._cond:
            for i, p in zip(np.asarray(indices, np.int64),
                            np.asarray(priorities, np.float64)):
                if not self._valid[i]:
                    continue
                if self._drawn_gen[i] >= 0 and \
                        self._gen[i] != self._drawn_gen[i]:
                    continue  # overwritten since its last draw

                tp = self._tree_priority(float(p))
                self._max_priority = max(self._max_priority, tp)
                self.tree.set(int(i), tp)
            self.counters.incr("replay_priority_updates")
        self.timer.add("priority_update", time.perf_counter() - t0)

    def sample_batches(self, batch_size, *, arena_pool=None, beta=None,
                       stop_event=None, timeout=30.0, keys=None,
                       scenario_mix=None):
        """Generator of sampled batches for the device feed: each batch
        is gathered straight into a recycled
        :class:`~blendjax_torch.btt.arena.Arena` when ``arena_pool`` is
        given and yielded as an :class:`~blendjax_torch.btt.arena.ArenaBatch`
        whose ``meta`` carries ``(indices, weights)`` — drain it through
        ``device_prefetch`` and the arena recycles once each batch's copy
        to the card has completed, as on the stream's feed.  ``is_weight`` and
        ``replay_idx`` also ride INSIDE the batch dict (the device
        prefetcher unwraps ArenaBatch, so in-band is how they reach a
        prefetched consumer).  Without a pool, plain dicts are yielded.
        """
        from blendjax_torch.btt.arena import ArenaBatch

        while stop_event is None or not stop_event.is_set():
            arena = None
            out = None
            if arena_pool is not None:
                with self.timer.stage("arena_wait"):
                    arena = arena_pool.acquire(
                        timeout=timeout, stop_event=stop_event
                    )
                if arena is None:
                    if stop_event is not None and stop_event.is_set():
                        return
                    # pool exhaustion is a stalled consumer, not end of
                    # data — ending the stream here would let an offline
                    # run truncate silently (same contract as the feed
                    # path's _acquire_arena)
                    raise TimeoutError(
                        f"{self.name}: no batch arena freed within "
                        f"{timeout:.1f}s (pool size "
                        f"{arena_pool.pool_size}); the consumer has "
                        "stalled or the pool is undersized "
                        f"({self._diag()})"
                    )
                # bind lazily per key (the Arena.get_buffer signature):
                # the schema may not even exist yet while sample() blocks
                # on the first appends
                out = arena.get_buffer
            try:
                res = self.sample(
                    batch_size, beta=beta, out=out,
                    stop_event=stop_event, timeout=timeout, keys=keys,
                    scenario_mix=scenario_mix,
                )
            except BaseException:
                if arena is not None:
                    arena.release()
                raise
            if res is None:
                if arena is not None:
                    arena.release()
                return
            data, idx, weights = res
            data = dict(data)
            data["replay_idx"] = idx
            data["is_weight"] = weights
            if arena is not None:
                yield ArenaBatch(data, arena, meta=(idx, weights))
            else:
                yield data

    # -- checkpoint ----------------------------------------------------------

    def _state_arrays_meta_locked(self):
        """The checkpointable state (caller holds the lock): named arrays
        and the JSON metadata, the reference's keys."""
        arrays = dict(self.store.state_arrays())
        arrays["valid"] = self._valid
        arrays["healthy"] = self._healthy
        arrays["gen"] = self._gen
        arrays["drawn_gen"] = self._drawn_gen
        arrays["scenario"] = self._scenario
        if self.tree is not None:
            arrays["tree_leaves"] = self.tree.leaves()
        meta = {
            "scenario_names": list(self._scenario_names),
            "format": REPLAY_FORMAT,
            "capacity": self.capacity,
            "head": self._head,
            "size": self._size,
            "num_valid": self._num_valid,
            "seed": self.seed,
            "prioritized": self.prioritized,
            "alpha": self.alpha,
            "beta": self.beta,
            "eps": self.eps,
            "max_priority": self._max_priority,
            "appends": self._appends,
            "overwrites": self._overwrites,
            "excluded": self._excluded,
            "samples": self._samples,
            "rng_state": self._rng.bit_generator.state,
        }
        return arrays, meta

    def save(self, path):
        """Checkpoint contents, sum tree, ring indices and RNG state
        (atomic; :func:`blendjax_torch.utils.checkpoint.save_state`)."""
        from blendjax_torch.utils.checkpoint import save_state

        with self._cond:
            arrays, meta = self._state_arrays_meta_locked()
            save_state(path, arrays, meta)
        return path

    @classmethod
    def restore(cls, path, *, counters=None, timer=None):
        """Rebuild a buffer from :meth:`save`'s output (either package's):
        columns, ring indices, sum tree and the RNG mid-stream, so the
        restored buffer draws the exact stream the saved one would have."""
        from blendjax_torch.utils.checkpoint import load_state

        arrays, meta = load_state(path)
        fmt = meta.get("format")
        if fmt != REPLAY_FORMAT:
            raise ValueError(f"not a replay checkpoint (format {fmt!r})")
        buf = cls(meta["capacity"], seed=meta["seed"], prioritized=meta["prioritized"],
                  alpha=meta["alpha"], beta=meta["beta"], eps=meta["eps"],
                  counters=counters, timer=timer)
        buf.store.load_state_arrays(arrays)
        load_client_state(buf, arrays, meta)
        return buf

    # -- observability -------------------------------------------------------

    def scenario_stats(self):
        """Per-scenario strata snapshot (docs/scenarios.md): for every
        interned scenario, its live ``rows``, sampling-``eligible``
        rows, and ``priority_mass`` (sum of its eligible rows' tree
        priorities — the evidence the
        :class:`~blendjax_torch.scenario.CurriculumScheduler` reweights
        on; the eligible count itself when unprioritized).  ``_unlabelled``
        rows ride under that key so the strata always account for every
        occupied slot.  Computed on demand — stamps cost nothing on the
        append/draw hot paths, and a buffer with NO stamps at all
        returns ``{}`` without touching the arrays (a scenario-less
        deployment's periodic health scrape stays O(1) here)."""
        with self._cond:
            if not self._scenario_names:
                return {}
            occupied = np.zeros(self.capacity, bool)
            occupied[:self._size] = True
            leaves = self.tree.leaves() if self.tree is not None else None
            out = {}
            for sid in range(-1, len(self._scenario_names)):
                mask = occupied & (self._scenario == sid)
                rows = int(mask.sum())
                if sid < 0 and rows == 0:
                    continue  # fully-labelled buffer: no _unlabelled row
                eligible = mask & self._valid
                name = ("_unlabelled" if sid < 0
                        else self._scenario_names[sid])
                out[name] = {
                    "rows": rows,
                    "eligible": int(eligible.sum()),
                    "priority_mass": float(
                        leaves[eligible].sum() if leaves is not None
                        else eligible.sum()
                    ),
                }
            return out

    def stats(self):
        """One snapshot of fill state, exclusion accounting and the replay
        stage timings."""
        scenarios = self.scenario_stats()
        with self._cond:
            return {
                "scenarios": scenarios,
                "name": self.name,
                "size": self._size,
                "capacity": self.capacity,
                "eligible": self._num_valid,
                "excluded": self._excluded,
                "appends": self._appends,
                "overwrites": self._overwrites,
                "samples": self._samples,
                "prioritized": self.prioritized,
                "priority_total": (
                    self.tree.total if self.tree is not None else None
                ),
                "stages": self.timer.summary(),
            }
