"""Sebulba-style decoupled actor/learner for remote Blender fleets: the port
of ``blendjax.models.actor_learner``.

Podracer architectures (arXiv:2104.06272) split RL into *actors* that step
environments and a *learner* that updates parameters, running concurrently
with a segment queue between them.  Env steps are host-bound RPCs
(``EnvPool.step``) while the update is device work: here one actor thread
per fleet keeps its fleet stepping, sampling on a snapshot of the
parameters, while the learner consumes fixed-length segments and publishes
fresh snapshots.  The actors' policy lags the learner by at most
``queue_size`` updates.

With more than one fleet (a list of pools), every fleet's segments fan
into ONE env-major batch per update
(:class:`~blendjax_torch.parallel.podracer.SegmentFanIn`); a fleet that
dies entirely is zero-masked out of the batch instead of stalling the
learner.  ``replay=`` adds the off-policy tail: the actors append every
transition (quarantine-aware), the learner follows each on-policy update
with ``replay_ratio`` sampled updates, and :meth:`ActorLearner.run_offline`
trains from the buffer alone.

What differs from the reference, and why:

- **The actors' parameter snapshot is a copy.**  The captured step
  (:mod:`blendjax_torch.models.train`) updates the parameters in place,
  where JAX arrays are immutable and the reference's actors alias
  ``state.params``.  After every update the learner clones the parameters
  on its own stream, records an event and swaps ``(snapshot, event)`` in
  as one attribute assignment; an actor takes the pair at the start of a
  segment, makes its stream wait on the event and ties the snapshot's
  memory to its stream (``record_stream``).
- **Two captured steps over one Adam.**  The on-policy and the replay
  update are two :func:`~blendjax_torch.models.train.make_train_step`
  closures over the same ``TrainState``: each captures its own graph over
  the same parameters and the same ``capturable=True`` optimizer state.
- **Each actor samples on its own CUDA stream** with its own
  ``torch.Generator``, seeded from the constructor seed and the fleet id
  (the counterpart of ``fold_in(PRNGKey(seed), 0xAC708 + fid)``), so its
  kernels never land on a stream the learner is capturing.  The sampling
  runs eagerly, as ``control.Rollout.step``'s does.
- **A checkpoint restores in place.**  ``checkpointer=`` (a
  :class:`~blendjax_torch.ha.checkpoint.TrainCheckpointer`) is called once
  per completed update, on the learner thread, as the reference calls it;
  :meth:`ActorLearner.load_checkpoint_state` writes a restored state into
  the learner's own tensors, so the captured steps keep their graphs.

- **A bus publish reads back a snapshot.**  With ``weight_bus=`` every
  ``publish_every``-th update converts the actors' fresh snapshot (made on
  the learner's stream after the update, so never torn) to the
  reference's layout with :func:`~blendjax_torch.models.convert.params_to_jax`
  and publishes it; the read-back synchronises the learner with the card
  once per publish, timed as the ``weight_publish`` stage.

``replay=`` takes an in-process ``ReplayBuffer`` or a
:class:`~blendjax_torch.replay.ShardedReplay` over shard processes;
``hub=`` registers the replay (each shard as a remote), the loop's
``stats``, the scenario plane and the checkpointer with a
:class:`~blendjax_torch.obs.TelemetryHub`.  Pools come as one ``EnvPool``,
a list of them or a :class:`~blendjax_torch.parallel.podracer.FleetSet`.

The scenario plane (docs/scenarios.md): ``scenarios=`` (a
:class:`~blendjax_torch.scenario.DomainRandomizer`) stamps every
transition with its env's scenario and carries the stamps into the replay
strata, re-pushes a re-admitted env's scenario, and counts env steps and
updates per scenario; ``curriculum=`` (a
:class:`~blendjax_torch.scenario.CurriculumScheduler`) is ticked once per
on-policy update and drives a changed mix through the randomizer;
``fanin_min_ready=`` lets the fan-in collect a batch before a slow fleet's
segment lands.  With all three None the loop is the plain one, step for
step.

**The data-parallel learner (``mesh=``) is one process per rank.**  The
reference drives every shard of its mesh from one process; here every rank
of the mesh's ``'data'`` axis runs its own ``ActorLearner`` over the fleets
it owns, its actors sampling on the rank's device from a snapshot, and
fills its ``Shard(0)`` rows of the global batch
(:class:`~blendjax_torch.parallel.podracer.SegmentFanIn` over the mesh).
The parameters replicate, and the updates go through
:func:`~blendjax_torch.parallel.sharding.make_sharded_train_step`, eager.
Every batch statistic of the losses (the mask's weight, the baseline, the
advantage's and the replay reward's normalization) is summed over the
ranks, and each rank's loss is scaled so that the step's mean over ranks
is the global batch's loss and gradient, whatever rows each rank holds.
The ranks stay in step: each update (and each replay update) starts only
once every rank has its batch, and a rank that stops or fails stops them
all.

**The MPMD pipeline learner (``pipeline_stages=``).**  The off-policy
update runs on a stage fleet through a
:class:`~blendjax_torch.parallel.mpmd.MpmdTrain` driver instead of the
in-process replay step: its ``pg`` family computes the same
importance-weighted loss, the advantage normalized over the whole batch on
the host (float64, then float32), so equal microbatch means average to the
learner's loss.  The fleet owns the parameters; the learner adopts them at
construction and after every update, copying them into its state's own
tensors (a captured step replays over them) inside the capture gate, and
its actors sample from a snapshot of them.  Sampled batches go to stage 0
as the sampler gathered them, with no stop on the learner's device.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from blendjax_torch.models import policy
from blendjax_torch.models.train import TrainState, capture_gate, make_train_step
from blendjax_torch.obs.flight import flight_recorder
from blendjax_torch.utils.device import resolve_device
from blendjax_torch.utils.timing import StageTimer

log = logging.getLogger("blendjax_torch")

def _as_pools(pool):
    """One EnvPool, a sequence of them (one per fleet), a
    :class:`~blendjax_torch.parallel.podracer.FleetSet`, or None
    (fleet-less, for :meth:`ActorLearner.run_offline`)."""
    if pool is None:
        return []
    if hasattr(pool, "pools"):  # FleetSet
        return list(pool.pools)
    if isinstance(pool, (list, tuple)):
        return list(pool)
    return [pool]


def fleet_seed(seed, fid):
    """The sampling seed of fleet ``fid``, derived from the constructor
    seed: runs are reproducible, fleets decorrelated."""
    state = np.random.SeedSequence([int(seed), 0xAC708 + int(fid)])
    return int(state.generate_state(1, np.uint64)[0])


class ActorLearner:
    """Overlapped actor/learner REINFORCE over one or more
    :class:`~blendjax_torch.btt.envpool.EnvPool` fleets.

    Params
    ------
    pool: EnvPool | sequence[EnvPool] | FleetSet | None
        Connected fleet(s) (autoreset recommended); the caller owns them.
        A sequence (or a FleetSet) runs one actor thread per fleet with the
        segments fanned into a single env-major batch per update.  None is allowed
        for the pure off-policy path (:meth:`run_offline`).
    obs_dim, num_actions: int
        Policy sizes (``continuous=True`` for a Gaussian head).
    rollout_len: int
        Steps per trajectory segment (the queue's unit of work).
    queue_size: int
        Segments buffered between actor and learner — also the bound on
        actor policy staleness, in updates.
    lr: float
        Adam's rate (the reference's default ``optax.adam(3e-3)``).
    action_map: callable | None
        Maps the sampled actions (a numpy array of shape (N,)) to the list
        the producers expect (e.g. discrete index -> motor force).
    pipeline: bool
        Double-buffer rollout collection over each pool's async path
        (``step_async``/``step_wait_full``): actions are submitted first
        and the fleet simulates while the actor hands over the previous
        segment.  False keeps the lock-step ``pool.step`` loop.
    num_fleets: int | None
        Validation marker for the multi-fleet configuration; when given
        it must match the number of pools passed.
    replay: blendjax_torch.replay.ReplayBuffer | ShardedReplay | None
        Off-policy path: the actor threads append every transition —
        quarantine-aware, so a degraded rollout's synthetic transitions
        land flagged and are never sampled — and the learner follows each
        on-policy update with ``replay_ratio`` sampled off-policy updates
        (importance-weighted single-step policy gradient, priorities
        refreshed from |advantage|).
    replay_ratio: int
        Off-policy updates per on-policy update (0 = append-only).
    replay_batch: int
        Transitions per off-policy update.
    device: str | torch.device
        Where the parameters live and the updates and sampling run; CUDA
        unless the caller asks for the CPU.
    checkpointer: blendjax_torch.ha.TrainCheckpointer | None
        Coordinated train-state checkpoints: ``maybe_checkpoint(self)``
        once per completed update (on- and off-policy), from the learner
        thread; it decides the cadence and never raises into the loop.
    hub: blendjax_torch.obs.TelemetryHub | None
        Registers the replay's counters and timer (a sharded replay with
        each shard process as a remote), a ``stats`` probe and the
        checkpointer, so one ``hub.scrape()`` covers acting and learning.
    weight_bus: blendjax_torch.weights.WeightPublisher | None
        Live weight publication: every ``publish_every``-th completed
        update (on- and off-policy) publishes the params as a versioned,
        checksummed snapshot; subscribed
        :class:`~blendjax_torch.serve.server.PolicyServer` replicas
        hot-swap it between ticks.  The caller owns the publisher (its
        ``quantize=`` must match the serving precision).  A failed publish
        is logged; training goes on.
    publish_every: int
        Updates between bus publishes (1 = every update).
    scenarios: blendjax_torch.scenario.DomainRandomizer | None
        The scenario plane: transitions are stamped with their env's
        scenario (the producer's in-band echo, else the fleet's
        assignment), per-scenario env-step and update counts accumulate
        (:meth:`stats`), re-admitted envs get their scenario re-pushed, and
        replay appends carry the stamps into the per-scenario strata.
    curriculum: blendjax_torch.scenario.CurriculumScheduler | None
        Ticked once per on-policy update: on its interval it reweights the
        mix from the replay strata and (with ``scenarios``) drives the new
        per-fleet assignment through the randomizer.
    fanin_min_ready: int | None
        Multi-fleet only: collect a global batch as soon as this many live
        fleets contributed a segment (absent fleets zero-masked) instead of
        waiting for every live fleet.  None keeps the all-live barrier.
    mesh: torch DeviceMesh | None
        The data-parallel learner (module docstring): a mesh with a
        ``'data'`` axis, made by every rank, each passing the pools it owns
        (or None for :meth:`run_offline`); the parameters and updates live
        on the mesh's device.  ``replay_batch`` (and ``run_offline``'s
        ``batch_size``) must divide by the axis's size: each rank samples
        its share from its own buffer.

    pipeline_stages: MpmdTrain | None
        The MPMD pipeline learner (module docstring): a driver over a stage
        fleet of family ``'pg'`` whose ``d_in``/``d_out`` are ``obs_dim``/
        ``num_actions``; discrete policies only, and not with ``mesh=``.
    pipeline_microbatches: int | None
        Microbatches per pipeline update; the fleet's stage count by
        default.
    """

    def __init__(self, pool, obs_dim, num_actions, *, rollout_len=32,
                 queue_size=4, lr=3e-3, gamma=0.99, seed=0, continuous=False,
                 action_map=None, pipeline=False, num_fleets=None,
                 replay=None, replay_ratio=0, replay_batch=64, device="cuda",
                 checkpointer=None, hub=None, weight_bus=None, publish_every=1,
                 scenarios=None, curriculum=None, fanin_min_ready=None, mesh=None,
                 pipeline_stages=None, pipeline_microbatches=None):
        self.pools = _as_pools(pool)
        if num_fleets is not None and self.pools and num_fleets != len(self.pools):
            raise ValueError(
                f"num_fleets={num_fleets} but {len(self.pools)} pools were "
                "passed — pass one EnvPool per fleet"
            )
        self.num_fleets = len(self.pools) or (num_fleets or 0)
        self.rollout_len = rollout_len
        self.queue_size = queue_size
        self.gamma = gamma
        self.continuous = continuous
        self.pipeline = bool(pipeline)
        self.action_map = action_map or (lambda a: list(np.asarray(a)))
        self.mesh = mesh
        #: the MPMD pipeline learner's driver (module docstring)
        self.pipeline_driver = pipeline_stages
        self.pipeline_microbatches = pipeline_microbatches
        if pipeline_stages is not None:
            spec = pipeline_stages.spec
            if mesh is not None:
                raise ValueError("pipeline_stages= and mesh= are different parallel axes "
                                 "of the learner; pass one")
            if spec["family"] != "pg":
                raise ValueError("pipeline_stages= needs an MpmdTrain with family='pg' (the "
                                 f"learner's off-policy loss); got {spec['family']!r}")
            if continuous:
                raise ValueError("pipeline_stages= supports discrete policies only (the pg "
                                 "stage loss is categorical)")
            if (spec["d_in"], spec["d_out"]) != (obs_dim, num_actions):
                raise ValueError(f"pipeline spec d_in/d_out ({spec['d_in']}, {spec['d_out']}) "
                                 f"!= learner obs_dim/num_actions ({obs_dim}, {num_actions})")
            if self.pipeline_microbatches is None:
                self.pipeline_microbatches = spec["n_procs"]
        self._data_size, self._reduce = 1, None
        if mesh is not None:
            from blendjax_torch.parallel.podracer import data_sum

            if "data" not in mesh.mesh_dim_names:
                raise ValueError(f"mesh {mesh} has no 'data' axis")
            self._reduce = data_sum(mesh)
            self._data_size = self._reduce.n_ranks
            device = mesh.device_type
            if replay is not None and int(replay_batch) % self._data_size:
                raise ValueError(
                    f"replay_batch={replay_batch} does not divide over the mesh's data "
                    f"axis ({self._data_size} shards); pick batch sizes divisible by the "
                    "mesh axes they shard over")
        self.device = resolve_device(device)
        #: env-major fan-in path: any mesh, or more than one fleet
        self._use_fanin = mesh is not None or len(self.pools) > 1
        self._seed = seed
        if pipeline_stages is None:
            params = policy.init(torch.Generator(device=self.device).manual_seed(seed),
                                 obs_dim, num_actions, continuous=continuous,
                                 device=self.device)
        else:
            # the stage fleet owns the parameters (restored from its own
            # checkpoints across respawns): the learner's state takes their
            # layout and values, not a second lineage from ``seed``
            params = {k: torch.tensor(v, device=self.device)
                      for k, v in pipeline_stages.gather_params().items()}
        if mesh is None:
            self.state = TrainState.create(params, lr=lr)
            make_step = make_train_step
        else:
            from blendjax_torch.parallel.sharding import make_sharded_train_step

            # replicated parameters; each rank's rows of the batch
            init_sharded, _ = make_sharded_train_step(None, mesh, lr=lr)
            self.state = init_sharded(params)

            def make_step(loss):
                return make_sharded_train_step(loss, mesh, lr=lr)[1]

        if self._use_fanin:
            from blendjax_torch.parallel.podracer import make_segment_loss

            self.loss_fn = make_segment_loss(gamma, continuous=continuous,
                                             reduce=self._reduce)
        else:
            def loss_fn(p, batch):
                returns = policy.discounted_returns(batch["rewards"], batch["dones"], gamma)
                t, n = batch["rewards"].shape
                return policy.reinforce_loss(
                    p,
                    batch["obs"].reshape(t * n, -1),
                    batch["actions"].reshape(t * n, *batch["actions"].shape[2:]),
                    returns.reshape(t * n),
                    continuous=continuous,
                )

            self.loss_fn = loss_fn

        def replay_loss_fn(p, batch):
            # importance-weighted single-step policy gradient over sampled
            # transitions: logp of the STORED action under the CURRENT
            # policy, advantage = batch-normalized reward (population std),
            # weighted by the sampler's IS weights
            if continuous:
                logp = policy.gaussian_log_prob(p, batch["obs"], batch["action"])
            else:
                logp = policy.categorical_log_prob(p, batch["obs"], batch["action"])
            adv, scale = policy.normalized_advantage(batch["reward"], reduce=self._reduce)
            return -(batch["is_weight"] * logp * adv).sum() * scale

        self.replay_loss_fn = replay_loss_fn
        # two steps (captured on the card without a mesh) over the one
        # TrainState (and its one Adam)
        self._step = make_step(self.loss_fn)
        self.replay = replay
        self.replay_ratio = int(replay_ratio)
        self.replay_batch = int(replay_batch)
        if replay_ratio and replay is None:
            raise ValueError("replay_ratio > 0 requires a replay buffer")
        self._replay_step = make_step(replay_loss_fn) if replay is not None else None
        #: the actors' sampling parameters: (a copy of state.params, the
        #: event after which the copy is complete, or None on the CPU)
        self._actor_params = self._snapshot()
        if pipeline_stages is not None:
            self.state.step = pipeline_stages.updates_done
        self._updates_done = 0
        self.weight_bus = weight_bus
        self.publish_every = max(1, int(publish_every))
        #: the last version published on the weight bus, recorded in every
        #: checkpoint
        self.last_published_version = None
        self.checkpointer = checkpointer
        #: per-stage times of the last run: per env step the actors'
        #: ``policy`` (obs to the device, sample, actions back) and
        #: ``env_step`` (pipelined: submission to the wait's return, the
        #: previous segment's hand-off inside it); per update the learner's
        #: ``segment_wait`` (until the batch is on the device), ``update``
        #: (to the loss on the host) and ``replay_update``
        self.timer = StageTimer()
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._fanin = None
        self._pending_group_batches = []  # (ArenaBatch, segment reward, fleets)
        self._stop = threading.Event()
        self._threads = []
        nf = max(1, self.num_fleets)
        self._actor_errors = [None] * nf
        self._env_steps_by_fleet = [0] * nf
        self._unhealthy_by_fleet = [0] * nf
        self._degraded_by_fleet = [False] * nf
        #: fleet re-admission (multi-fleet only): once a dead fleet's pool
        #: answers again, the learner restarts its actor thread; the
        #: cooldown stops a hot respawn loop
        self.fleet_restart_cooldown = 1.0
        self._fleet_restarts = [0] * nf
        self._fleet_restart_allowed = [0.0] * nf
        self._fleet_restart_steps = [0] * nf
        #: the scenario plane; with all three None every scenario branch is
        #: skipped and the loop is the plain one
        self.randomizer = scenarios
        self.curriculum = curriculum
        self.fanin_min_ready = None if fanin_min_ready is None else max(1, int(fanin_min_ready))
        # per-fleet dicts, each written by exactly one actor thread
        self._scenario_steps_by_fleet = [{} for _ in range(nf)]
        self._updates_by_scenario = {}  # learner thread only
        self._last_update_fleets = ()
        if hub is not None:
            self._register_with_hub(hub)

    def _register_with_hub(self, hub):
        replay = self.replay
        if replay is not None and hasattr(replay, "register_with_hub"):
            replay.register_with_hub(hub)
        elif replay is not None:
            hub.register(replay.name, counters=replay.counters, timer=replay.timer,
                         probe=replay.stats)
        hub.register("actor_learner", probe=self.stats)
        # one EventCounters shared by several components (the common setup)
        # must not fold twice: counters are deduplicated by identity
        seen = {id(replay.counters)} if replay is not None else set()
        for name, comp in (("scenario_randomizer", self.randomizer),
                           ("scenario_curriculum", self.curriculum),
                           ("ha_checkpointer", self.checkpointer)):
            if comp is None:
                continue
            dup = id(comp.counters) in seen
            seen.add(id(comp.counters))
            hub.register(name, counters=None if dup else comp.counters, timer=comp.timer,
                         probe=comp.stats)

    # -- aggregate views -----------------------------------------------------

    def stats(self):
        """Live training-loop accounting, readable mid-run (also the hub
        probe); with the scenario plane attached, per-scenario env-step and
        update counts, the assignments and the mix."""
        out = {
            "env_steps": self._env_steps,
            "unhealthy_env_steps": self._unhealthy_env_steps,
            "env_steps_by_fleet": list(self._env_steps_by_fleet),
            "updates": self._updates_done,
            "fleet_restarts": list(self._fleet_restarts),
            "dead_fleets": [fid for fid, e in enumerate(self._actor_errors)
                            if e is not None],
            "last_published_version": self.last_published_version,
        }
        if self.randomizer is not None or self.curriculum is not None:
            merged = {}
            for d in self._scenario_steps_by_fleet:
                for sid, n in list(d.items()):
                    merged[sid] = merged.get(sid, 0) + n
            out["env_steps_by_scenario"] = merged
            out["updates_by_scenario"] = dict(self._updates_by_scenario)
            if self.randomizer is not None:
                out["scenario_assignments"] = self.randomizer.assignments
            if self.curriculum is not None:
                out["scenario_mix"] = self.curriculum.mix()
        return out

    def checkpoint_state(self):
        """The learner-side scalars a checkpoint records next to the
        TrainState, the reference's keys: the update counter, the seed, the
        last published bus version, and with the scenario plane the
        curriculum's state and the assignments.  JSON-able: they ride inline
        in the :class:`~blendjax_torch.ha.checkpoint.TrainCheckpointer`
        manifest."""
        aux = {"updates": self._updates_done, "seed": self._seed,
               "last_published_version": self.last_published_version}
        if self.curriculum is not None:
            aux["curriculum"] = self.curriculum.state_dict()
        if self.randomizer is not None:
            aux["scenario_assignments"] = self.randomizer.assignments
        return aux

    def load_checkpoint_state(self, state, aux):
        """Adopt a restored TrainState and :meth:`checkpoint_state` dict.
        The state is written into the learner's own tensors unless it is
        them already (a :class:`~blendjax_torch.utils.checkpoint.CheckpointManager`
        restore into ``self.state``), so the captured steps keep their
        graphs; the update counter continues from the cut, the actors'
        snapshot is rebuilt from the restored params, the checkpoint's seed
        wins (the actors' sampling streams derive from it), the curriculum
        resumes mid-interval, and the checkpointed per-fleet assignment is
        pushed again into the producers (a respawned learner's fleets must
        not keep serving the default scene)."""
        if state is not self.state:
            from blendjax_torch.models import convert

            convert.load_train_state_arrays(self.state, convert.train_state_arrays(state))
        self._actor_params = self._snapshot()
        self._updates_done = int(aux.get("updates", 0))
        self.last_published_version = aux.get("last_published_version")
        seed = aux.get("seed")
        if seed is not None and int(seed) != self._seed:
            log.warning(
                "restoring checkpoint cut under seed %d into a learner "
                "constructed with seed %d; adopting the checkpoint's seed so "
                "the actor sampling streams continue the checkpointed run",
                int(seed), self._seed,
            )
            self._seed = int(seed)
        if self.curriculum is not None and aux.get("curriculum"):
            self.curriculum.load_state_dict(aux["curriculum"])
        assignment = aux.get("scenario_assignments")
        if self.randomizer is not None and assignment:
            self.randomizer.apply_assignment(list(assignment))

    @property
    def _env_steps(self):
        return sum(self._env_steps_by_fleet)

    @property
    def _unhealthy_env_steps(self):
        return sum(self._unhealthy_by_fleet)

    @property
    def _actor_error(self):
        return next((e for e in self._actor_errors if e is not None), None)

    def _snapshot(self):
        """A copy of the parameters (a replicated parameter's local tensor
        under a mesh), made on the learner's stream, and the event it is
        complete at (None on the CPU)."""
        params = {k: (v.to_local() if isinstance(v, DTensor) else v).detach().clone()
                  for k, v in self.state.params.items()}
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return params, event

    def _publish_params(self):
        """Swap the actors' sampling snapshot (one attribute assignment);
        called once per completed update, which also makes it the weight-bus
        publication point and the checkpoint hook."""
        self._actor_params = self._snapshot()
        self._updates_done += 1
        if self.weight_bus is not None and self._updates_done % self.publish_every == 0:
            from blendjax_torch.models.convert import params_to_jax

            t0 = time.perf_counter()
            try:
                # the snapshot was copied on this thread's stream after the
                # update, so the read-back waits for exactly that update
                self.last_published_version = self.weight_bus.publish(
                    params_to_jax(self._actor_params[0]), step=self._updates_done)
            except Exception:  # noqa: BLE001 - training outlives the bus
                log.exception("weight bus publish failed (training continues; the "
                              "serve tier keeps its last good version)")
            self.timer.add("weight_publish", time.perf_counter() - t0)
        if self.checkpointer is not None:
            self.checkpointer.maybe_checkpoint(self)

    # -- actor side ----------------------------------------------------------

    def _enqueue_segment(self, fid, seg_lists):
        """Hand a finished segment to the learner (bounded put, re-checked
        against stop).  Returns False once stop is set."""
        if self._fanin is not None:
            return self._fanin.put_segment(fid, seg_lists, self._stop)
        seg = tuple(np.stack(col) for col in seg_lists)
        while not self._stop.is_set():
            try:
                self._q.put(seg, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _take_params(self, stream):
        """The current snapshot, ordered before ``stream``'s next work and
        tied to it, so the allocator cannot reuse its memory while the
        actor still reads it."""
        params, event = self._actor_params
        if stream is not None:
            with capture_gate.device_work():
                stream.wait_event(event)
                for t in params.values():
                    t.record_stream(stream)
        return params

    def _sample(self, params, gen, obs):
        """Actions for ``obs`` (numpy, (N, D)) sampled on the device; the
        actions come back as numpy.  The copies to and from the card are
        pageable, so the sampling waits while the learner captures a step
        (:class:`~blendjax_torch.models.train.CaptureGate`)."""
        with capture_gate.device_work():
            obs_t = torch.as_tensor(obs, device=self.device)
            with torch.no_grad():
                action, _ = policy.sample_action(params, gen, obs_t)
            return action.cpu().numpy()

    def _actor(self, fid, pool):
        try:
            gen = torch.Generator(device=self.device).manual_seed(fleet_seed(self._seed, fid))
            stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                self._act(fid, pool, gen, stream)
        except BaseException as exc:  # noqa: BLE001 - surfaced by the learner
            self._actor_errors[fid] = exc
            if len(self.pools) <= 1:
                self._stop.set()
            else:
                # multi-fleet: the OTHER fleets keep training — the fan-in
                # zero-masks this fleet's rows from here on
                flight_recorder.note("fleet_actor_failed", target=f"fleet{fid}",
                                     error=f"{type(exc).__name__}: {exc}")
                log.warning("actor fleet %d failed (%s: %s); remaining fleets "
                            "continue", fid, type(exc).__name__, exc)

    def _act(self, fid, pool, gen, stream):
        """The actor loop of fleet ``fid`` (see :meth:`_actor`)."""
        timer = self.timer
        obs, _ = pool.reset()
        obs = np.asarray(obs, np.float32)
        if obs.ndim == 1:
            obs = obs[:, None]
        pending_seg = None  # finished segment owed to the learner
        while not self._stop.is_set():
            seg_obs, seg_act, seg_rew, seg_done = [], [], [], []
            params = self._take_params(stream)  # snapshot for the whole segment
            for _ in range(self.rollout_len):
                t0 = time.perf_counter()
                action = self._sample(params, gen, obs)
                t1 = time.perf_counter()
                if self.pipeline:
                    # double-buffer: submit first, so the fleet simulates the
                    # next frame while this thread hands over the previous
                    # segment (even blocking on a full queue)
                    pool.step_async(self.action_map(action))
                    if pending_seg is not None:
                        if not self._enqueue_segment(fid, pending_seg):
                            # stop arrived with a batch in flight: drain it
                            # so the pool is reusable by lock-step callers
                            pool.step_wait()
                            return
                        pending_seg = None
                    nobs, rew, done, infos = pool.step_wait_full()
                else:
                    nobs, rew, done, infos = pool.step(self.action_map(action))
                timer.add("policy", t1 - t0)
                timer.add("env_step", time.perf_counter() - t1)
                # degraded-mode accounting: quarantined slots return
                # synthetic zero-reward transitions
                unhealthy = sum(1 for inf in infos if not inf.get("healthy", True))
                if unhealthy:
                    self._unhealthy_by_fleet[fid] += unhealthy
                    if not self._degraded_by_fleet[fid]:
                        self._degraded_by_fleet[fid] = True
                        log.warning("actor rollout degraded (fleet %d): %d/%d envs "
                                    "quarantined (synthetic transitions in the "
                                    "batch)", fid, unhealthy, pool.num_envs)
                elif self._degraded_by_fleet[fid]:
                    self._degraded_by_fleet[fid] = False
                    log.warning("actor rollout healthy again (fleet %d)", fid)
                scen = None
                if self.randomizer is not None:
                    scen = self._stamp_scenarios(fid, infos)
                seg_obs.append(obs)
                seg_act.append(action)
                seg_rew.append(np.asarray(rew, np.float32))
                seg_done.append(np.asarray(done, bool))
                prev_obs = obs
                obs = np.asarray(nobs, np.float32)
                if obs.ndim == 1:
                    obs = obs[:, None]
                if self.replay is not None:
                    # quarantine-aware appends: a synthetic transition from
                    # a quarantined slot is stored flagged, never sampled
                    self.replay.extend(
                        ({"obs": prev_obs[i], "action": action[i],
                          "reward": seg_rew[-1][i], "next_obs": obs[i],
                          "done": seg_done[-1][i]}
                         for i in range(pool.num_envs)),
                        healthy=[inf.get("healthy", True) for inf in infos],
                        scenarios=scen,
                    )
                self._env_steps_by_fleet[fid] += pool.num_envs
            seg_lists = (seg_obs, seg_act, seg_rew, seg_done)
            if self.pipeline:
                pending_seg = seg_lists  # handed over in the next submission's window
            elif not self._enqueue_segment(fid, seg_lists):
                return

    def _stamp_scenarios(self, fid, infos):
        """Scenario attribution for one step of fleet ``fid``: the
        producer's in-band echo wins, a synthetic or pre-push transition
        falls back to the fleet's assignment.  A re-admitted env gets the
        fleet's scenario re-pushed.  Returns the per-env stamps for the
        replay appends."""
        assigned = self.randomizer.scenario_of(fid)
        steps = self._scenario_steps_by_fleet[fid]
        scen = []
        for i, inf in enumerate(infos):
            sid = inf.get("scenario") or assigned
            scen.append(sid)
            if sid is not None:
                steps[sid] = steps.get(sid, 0) + 1
            if inf.get("readmitted"):
                self.randomizer.reassign(fid, i)
            self.randomizer.note_info(fid, inf)
        self.randomizer.maybe_resample(fid)
        return scen

    # -- learner side --------------------------------------------------------

    def _to_device(self, arrays):
        return {k: torch.as_tensor(v, device=self.device) for k, v in arrays.items()}

    def _adopt_pipeline_params(self):
        """Mirror the stage fleet's parameters into the learner's state: they
        are copied into the state's own tensors in place (a captured step
        replays over them), inside the capture gate.  The actors keep their
        own snapshot until :meth:`_publish_params` swaps in one made after
        the copy, so they never see a half-copied tree."""
        fleet = self.pipeline_driver.gather_params()
        with capture_gate.device_work(), torch.no_grad():
            for k, v in fleet.items():
                self.state.params[k].copy_(torch.tensor(v))
        self.state.step = self.pipeline_driver.updates_done

    def _pipeline_replay_update(self, obs, action, reward, is_weight):
        """One off-policy update through the MPMD stage fleet: the advantage
        normalized here over the whole batch (so the per-microbatch loss
        means average to the learner's replay loss), the microbatched
        records streamed through the pipeline, and the committed parameters
        adopted."""
        r = torch.from_numpy(np.array(reward, np.float64))
        adv = policy.normalized_advantage(r)[0].float().numpy()
        loss = self.pipeline_driver.update(
            np.asarray(obs, np.float32),
            {"action": np.asarray(action), "adv": adv,
             "w": np.asarray(is_weight, np.float32)},
            self.pipeline_microbatches,
        )
        self._adopt_pipeline_params()
        return loss

    def _replay_step_and_refresh(self, batch, idx, reward):
        """The shared off-policy post-draw block (online tail AND
        run_offline): one sampled update (through the stage fleet in the
        pipeline learner, on host arrays), the actors' snapshot, and the
        sampled rows' priorities refreshed from |advantage| under the batch
        baseline (the same signal the loss weights)."""
        if self.pipeline_driver is not None:
            loss = self._pipeline_replay_update(batch["obs"], batch["action"],
                                                batch["reward"], batch["is_weight"])
        else:
            self.state, loss = self._replay_step(self.state, batch)
        self._publish_params()
        r = np.asarray(reward, np.float64)
        if self._reduce is None:
            mean = r.mean()
        else:  # the global batch's baseline, as the loss's
            sums = self._reduce(torch.tensor([r.sum(), r.size], dtype=torch.float64))
            mean = float(sums[0] / sums[1])
        self.replay.update_priorities(idx, np.abs(r - mean))
        return float(loss)

    def _replay_update(self, data, idx, weights):
        """One off-policy update from a host-side sampled batch (on the
        device, or as it is for the pipeline learner's stage 0)."""
        batch = {"obs": data["obs"], "action": data["action"], "reward": data["reward"],
                 "is_weight": weights}
        if self.pipeline_driver is None:
            batch = self._to_device(batch)
        return self._replay_step_and_refresh(batch, idx, data["reward"])

    def _agree(self, flag):
        """The least of every data rank's ``flag`` (this rank's alone
        without a mesh): ranks step together or not at all."""
        if self._reduce is None:
            return flag
        t = torch.tensor([flag])
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.mesh.get_group("data"))
        return int(t)

    def _drain_replay_ratio(self, replay_losses):
        """The learner's off-policy tail: up to ``replay_ratio`` sampled
        updates, skipped (not blocked on) while the buffer is short (on any
        rank, under a mesh).  ``timeout=0`` makes the shortfall check and
        the draw one atomic step."""
        for _ in range(self.replay_ratio):
            try:
                data, idx, w = self.replay.sample(
                    self.replay_batch // self._data_size, timeout=0.0,
                    keys=("obs", "action", "reward"))
                drawn = 1
            except TimeoutError:
                drawn = 0
            if not self._agree(drawn):
                self.replay.counters.incr("replay_sample_skips")
                return
            t0 = time.perf_counter()
            replay_losses.append(self._replay_update(data, idx, w))
            self.timer.add("replay_update", time.perf_counter() - t0)

    def run_offline(self, num_updates, batch_size=64, *, arena_pool=None, prefetch=2):
        """Train purely from the replay buffer — zero Blender processes.

        Sampled batches are gathered straight into recycled
        :class:`~blendjax_torch.btt.arena.ArenaPool` buffers and staged
        onto the device through ``device_prefetch``, whose ``device_put`` and
        ``recycle`` stages the replay timer records (the pipeline learner
        feeds them to its stage fleet as they are); sampling batch
        t+1 overlaps the update on batch t.  A prioritized buffer's draws
        therefore depend on how far the sampler runs ahead of the
        priority refreshes; a uniform buffer's depend only on its seed and
        appends.  Returns a stats dict.
        """
        from blendjax_torch.btt.arena import ArenaPool
        from blendjax_torch.btt.prefetch import device_prefetch

        if self.replay is None:
            raise RuntimeError("run_offline requires a replay buffer")
        if batch_size % self._data_size:
            raise ValueError(
                f"batch_size={batch_size} does not divide over the mesh's data axis "
                f"({self._data_size} shards); pick batch sizes divisible by the mesh "
                "axes they shard over")
        batch_size //= self._data_size  # each rank samples its share
        pool = arena_pool or ArenaPool(pool_size=prefetch + 2)
        stop = threading.Event()
        # gather (and copy) only what the off-policy loss and the priority
        # refresh read
        gen = self.replay.sample_batches(batch_size, arena_pool=pool, stop_event=stop,
                                         keys=("obs", "action", "reward"))
        losses = []
        t0 = time.perf_counter()
        if self.pipeline_driver is not None:
            # the pipeline learner: stage 0 takes the sampler's arena batches
            # as they are, with no stop on the device.  The driver's bounded
            # feed window and the bounded ArenaPool are one backpressure: a
            # parked feed keeps its buffer checked out, and the sampler
            # blocks on ``acquire``; each buffer is recycled once its
            # update has left it
            try:
                for ab in gen:
                    try:
                        data = ab.data
                        losses.append(self._replay_step_and_refresh(
                            data, np.asarray(data["replay_idx"]), np.asarray(data["reward"])))
                    finally:
                        ab.recycle()
                    if len(losses) >= num_updates:
                        break
            finally:
                stop.set()
                gen.close()
            return self._offline_stats(losses, t0)
        sharding = None
        if self.mesh is not None:
            from blendjax_torch.parallel.mesh import data_sharding

            sharding = data_sharding(self.mesh)  # this rank's rows of the global batch
        it = device_prefetch(gen, size=prefetch, device=self.device,
                             timer=self.replay.timer, sharding=sharding)

        def host(t):
            return (t.to_local() if isinstance(t, DTensor) else t).cpu().numpy()

        try:
            for dev_batch in it:
                # the sampler's indices came back in-band (the prefetcher
                # unwraps ArenaBatch), keying the priority refresh
                losses.append(self._replay_step_and_refresh(
                    {k: dev_batch[k] for k in ("obs", "action", "reward", "is_weight")},
                    host(dev_batch["replay_idx"]), host(dev_batch["reward"])))
                if len(losses) >= num_updates:
                    break
        finally:
            stop.set()
            it.close()
        return self._offline_stats(losses, t0)

    def _offline_stats(self, losses, t0):
        elapsed = time.perf_counter() - t0
        return {
            "updates": len(losses),
            "updates_per_sec": round(len(losses) / elapsed, 2),
            "losses": losses,
            "replay": self.replay.stats(),
            "elapsed_s": round(elapsed, 3),
        }

    def _fleet_alive(self, fid):
        return fid < len(self._threads) and self._threads[fid].is_alive()

    # -- scenario plane ------------------------------------------------------

    def _note_update_scenarios(self):
        """Attribute one completed on-policy update to the scenarios of its
        contributing fleets (learner thread only)."""
        if self.randomizer is None and self.curriculum is None:
            return
        fleets = self._last_update_fleets or tuple(range(max(1, len(self.pools))))
        for fid in fleets:
            sid = self.randomizer.scenario_of(fid) if self.randomizer is not None else None
            key = sid if sid is not None else "_unlabelled"
            self._updates_by_scenario[key] = self._updates_by_scenario.get(key, 0) + 1

    def _tick_curriculum(self):
        """One curriculum tick per completed on-policy update: on its
        interval the scheduler reweights the mix from the replay strata, and
        a changed mix is driven through the randomizer as a fresh per-fleet
        assignment."""
        if self.curriculum is None:
            return
        mix = self.curriculum.tick(self.replay.scenario_stats if self.replay is not None
                                   else None)
        if mix is not None and self.randomizer is not None and self.pools:
            assignment = self.curriculum.assign(len(self.pools))
            changed = self.randomizer.apply_assignment(assignment)
            if changed:
                log.info("curriculum reassigned fleets %s -> %s (mix %s)", changed,
                         [assignment[f] for f in changed], mix)

    def _maybe_restart_fleets(self):
        """Fleet re-admission: a fleet whose actor thread died (every env
        dead -> the pool raised) rejoins once its pool answers again.
        Single-fleet runs keep the fail-fast contract (the error stops the
        run)."""
        if len(self.pools) <= 1 or self._stop.is_set():
            return
        now = time.monotonic()
        for fid, pool in enumerate(self.pools):
            if self._actor_errors[fid] is None or self._fleet_alive(fid):
                continue
            if now < self._fleet_restart_allowed[fid]:
                continue
            if (self._fleet_restarts[fid] > 0
                    and self._env_steps_by_fleet[fid] <= self._fleet_restart_steps[fid]):
                # the previous restart died without stepping a single env:
                # the error is deterministic, not a pool death — leave the
                # fleet in dead_fleets with its real exception
                continue
            healthy = getattr(pool, "healthy", None)
            if healthy is not None and not np.asarray(healthy).any():
                continue  # still dead
            self._fleet_restart_allowed[fid] = now + self.fleet_restart_cooldown
            self._fleet_restart_steps[fid] = self._env_steps_by_fleet[fid]
            self._actor_errors[fid] = None
            self._fleet_restarts[fid] += 1
            t = threading.Thread(target=self._actor, args=(fid, pool), daemon=True,
                                 name=f"bjx-actor-{fid}.{self._fleet_restarts[fid]}")
            self._threads[fid] = t
            flight_recorder.note("fleet_restart", target=f"fleet{fid}",
                                 restart=self._fleet_restarts[fid])
            log.warning("fleet %d healed: restarting its actor thread (restart %d); "
                        "the fleet rejoins the fan-in", fid, self._fleet_restarts[fid])
            t.start()

    def _next_fanin_batch(self, deadline):
        """One global batch on the device from the fan-in, or ``None`` on
        deadline/stop, or raises once EVERY fleet has failed.  A collect
        whose segments differ in shape yields one batch per shape group;
        the rest queue for the following calls.  ``fanin_min_ready`` lets
        the collect return before slow fleets contribute (their rows
        zero-masked this round)."""
        while True:
            if self._pending_group_batches:
                batch, seg_reward, fleets = self._pending_group_batches.pop(0)
                self._last_update_fleets = fleets
                return self._fanin.to_device(batch), seg_reward
            if deadline is not None and time.perf_counter() >= deadline:
                return None
            self._maybe_restart_fleets()
            if self._stop.is_set():
                errs = [e for e in self._actor_errors if e is not None]
                if errs and len(errs) == len(self.pools):
                    raise RuntimeError(
                        f"all {len(self.pools)} actor fleets failed") from errs[0]
                return None
            mono_deadline = None
            if deadline is not None:
                mono_deadline = time.monotonic() + deadline - time.perf_counter()
            segs = self._fanin.collect(self._fleet_alive, self._stop,
                                       deadline=mono_deadline, min_ready=self.fanin_min_ready)
            if deadline is not None and time.perf_counter() >= deadline:
                self._fanin.recycle_segments(segs)
                return None
            if segs:
                if self.curriculum is not None and self.randomizer is not None:
                    # per-scenario return evidence for the curriculum
                    for f, seg in segs.items():
                        self.curriculum.observe_return(self.randomizer.scenario_of(f),
                                                       float(seg.data["rewards"].mean()))
                rewards = {f: (float(s.data["rewards"].sum()), s.data["rewards"].size)
                           for f, s in segs.items()}
                # split_groups interns each shape once, so this is the
                # grouping assemble_groups walks, in its order
                groups = [tuple(group) for _, group in self._fanin.split_groups(segs)]
                batches = self._fanin.assemble_groups(segs, stop_event=self._stop)
                if len(batches) < len(groups):  # stopped mid-assembly
                    for b in batches:
                        b.recycle()
                    return None
                for batch, group in zip(batches, groups):
                    rsum = sum(rewards[f][0] for f in group)
                    rn = sum(rewards[f][1] for f in group)
                    self._pending_group_batches.append((batch, rsum / max(rn, 1), group))
                continue
            if all(not self._fleet_alive(f) for f in range(len(self.pools))):
                errs = [e for e in self._actor_errors if e is not None]
                if errs:
                    raise RuntimeError(
                        f"all {len(self.pools)} actor fleets failed") from errs[0]
                return None

    def _next_queue_batch(self, deadline):
        """One segment from the single-fleet queue on the device, or
        ``None`` on deadline or once stop is set with the queue empty (the
        supervised learner's SIGTERM ends a run at once); raises when the
        actor failed."""
        while True:
            if self._actor_error is not None:
                raise RuntimeError("actor thread failed") from self._actor_error
            try:
                seg = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                if self._stop.is_set() and self._actor_error is None:
                    return None
                if deadline is not None and time.perf_counter() >= deadline:
                    return None
        batch = self._to_device({"obs": seg[0], "actions": seg[1],
                                 "rewards": seg[2], "dones": seg[3]})
        return batch, float(seg[2].mean())

    def run(self, num_updates=None, seconds=None):
        """Run the overlapped loop for ``num_updates`` learner steps OR a
        ``seconds`` wall-clock budget (both = either limit ends the run);
        returns a stats dict.

        Re-runnable: each call gets a fresh stop event, zeroed step
        counters and stage timer, and an emptied queue (a previous run's
        buffered segments carry a stale policy).
        """
        if not self.pools:
            raise RuntimeError(
                "no EnvPool attached; use run_offline() to train from the replay buffer")
        if num_updates is None and seconds is None:
            raise ValueError("pass num_updates and/or seconds")
        if any(t.is_alive() for t in self._threads):
            # a leaked actor sharing the pool's sockets with a fresh one
            # would corrupt the protocol and double-count env steps
            raise RuntimeError("previous run's actor thread is still alive; close "
                               "the pool or wait before re-running")
        n = len(self.pools)
        self._stop = threading.Event()
        self._actor_errors = [None] * n
        self._env_steps_by_fleet = [0] * n
        self._unhealthy_by_fleet = [0] * n
        self._degraded_by_fleet = [False] * n
        self._fleet_restarts = [0] * n
        self._fleet_restart_allowed = [0.0] * n
        self._fleet_restart_steps = [0] * n
        self._pending_group_batches = []
        self._scenario_steps_by_fleet = [{} for _ in range(n)]
        self._updates_by_scenario = {}
        self._last_update_fleets = ()
        if (self.randomizer is not None and self.curriculum is not None
                and not any(s is not None for s in self.randomizer.assignments)):
            # bootstrap: never-assigned fleets get the curriculum's starting
            # mix before the first rollout, so scenario labels exist from
            # the first transition
            self.randomizer.apply_assignment(self.curriculum.assign(n))
        self.timer = StageTimer()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._use_fanin:
            from blendjax_torch.parallel.podracer import SegmentFanIn

            # fresh fan-in per run: empty queues, recycled arenas
            self._fanin = SegmentFanIn([p.num_envs for p in self.pools], mesh=self.mesh,
                                       queue_size=self.queue_size, device=self.device)
        self._threads = [
            threading.Thread(target=self._actor, args=(fid, p), daemon=True,
                             name=f"bjx-actor-{fid}")
            for fid, p in enumerate(self.pools)
        ]
        t0 = time.perf_counter()
        deadline = t0 + seconds if seconds is not None else None
        for t in self._threads:
            t.start()
        losses, seg_rewards, replay_losses = [], [], []
        try:
            while True:
                if num_updates is not None and len(losses) >= num_updates:
                    break
                t1 = time.perf_counter()
                try:
                    if deadline is not None and t1 >= deadline:
                        got = None  # every stop goes through _agree: ranks stop together
                    else:
                        got = (self._next_fanin_batch(deadline) if self._fanin is not None
                               else self._next_queue_batch(deadline))
                except Exception:
                    self._agree(-1)  # a failed rank stops every rank
                    raise
                agreed = self._agree(0 if got is None else 1)
                if agreed < 0:
                    raise RuntimeError("another data rank's learner failed")
                if agreed == 0:
                    break
                batch, seg_reward = got
                t2 = time.perf_counter()
                self.state, loss = self._step(self.state, batch)
                self._publish_params()
                losses.append(float(loss))
                self.timer.add("segment_wait", t2 - t1)
                self.timer.add("update", time.perf_counter() - t2)
                seg_rewards.append(seg_reward)
                self._note_update_scenarios()
                self._tick_curriculum()
                if self.replay is not None and self.replay_ratio > 0:
                    self._drain_replay_ratio(replay_losses)
        finally:
            self._stop.set()
            for t in self._threads:
                t.join(timeout=10)
            for b, _, _ in self._pending_group_batches:
                b.recycle()  # stale-policy leftovers of this run
            self._pending_group_batches = []
        elapsed = time.perf_counter() - t0
        stats = {
            "updates": len(losses),
            "env_steps": self._env_steps,
            "unhealthy_env_steps": self._unhealthy_env_steps,
            "env_steps_per_sec": round(self._env_steps / elapsed, 1),
            "updates_per_sec": round(len(losses) / elapsed, 2),
            "first_segment_reward": seg_rewards[0] if seg_rewards else None,
            "last_segment_reward": seg_rewards[-1] if seg_rewards else None,
            "segment_rewards": seg_rewards,
            "losses": losses,
            "elapsed_s": round(elapsed, 3),
            "stages": self.timer.summary(),
        }
        if len(self.pools) > 1 or self.mesh is not None:
            stats["sharded"] = self.mesh is not None
            stats["num_fleets"] = len(self.pools)
            stats["env_steps_by_fleet"] = list(self._env_steps_by_fleet)
            stats["dead_fleets"] = [fid for fid, e in enumerate(self._actor_errors)
                                    if e is not None]
            stats["fleet_restarts"] = list(self._fleet_restarts)
        if self.replay is not None:
            stats["replay_updates"] = len(replay_losses)
            stats["replay_losses"] = replay_losses
            stats["replay"] = self.replay.stats()
        if self.randomizer is not None or self.curriculum is not None:
            live = self.stats()
            for key in ("env_steps_by_scenario", "updates_by_scenario", "scenario_mix",
                        "scenario_assignments"):
                if key in live:
                    stats[key] = live[key]
            if self.curriculum is not None:
                stats["curriculum"] = self.curriculum.stats()
        return stats
