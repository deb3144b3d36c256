"""The supervised learner process: ``python -m blendjax_torch.ha.learner``,
the port of ``blendjax.ha.learner``.

The process :class:`~blendjax_torch.ha.supervisor.LearnerProcess` spawns
(and ``FleetWatchdog(restart=True)`` respawns).  Startup is the resume
path:

1. find the latest complete manifest under ``--ckpt-dir``
   (:func:`~blendjax_torch.ha.checkpoint.latest_manifest`: damaged cuts are
   skipped, counted, warned);
2. rebuild the replay the cut describes
   (:func:`~blendjax_torch.ha.checkpoint.restore_replay`): a local buffer,
   or with ``--replay-shards`` the draw authority over the shard processes
   that outlived the learner, reconciled against what the dead learner
   appended past the cut;
3. reconnect the producer fleet (the producers never died: a fresh
   :class:`~blendjax_torch.btt.envpool.EnvPool` dials the same addresses)
   and restore the TrainState in place, the update counter and the seed
   continuing from the cut; with ``--weight-bus`` the restored params are
   republished under a fresh, higher version (the publisher's version base
   is the wall clock, so a respawned learner starts above its predecessor);
4. with ``--probe-batch``, draw one batch from the restored replay and
   record its index digest (``probe_digest``): the evidence that the
   resumed draw stream continues the cut;
5. write the ready stats mirror and train on.

A fresh directory starts from scratch through the same code path.  A
restored replay rides along (the actors append to it and the next cut
carries it).  The checkpointer mirrors ``stats()`` to
``<ckpt-dir>/learner_stats.json``: the supervisor's postmortem source and
the recovery clock.  The mirror also
carries this process's boot times (``boot``: the torch import, the
device's start, the learner's construction, the restore) and
``first_update_ts``, so a respawn's cost splits into its parts.

The learner runs on ``--device`` (the card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import hashlib
import logging
import os
import signal
import threading
import time

import numpy as np

logger = logging.getLogger("blendjax_torch")

#: each producer request's timeout, the reference's default
ENV_TIMEOUTMS = 15000
#: the longest run() chunk, seconds, so a SIGTERM mid-chunk ends within one
CHUNK_SECONDS = 10.0

def build_parser():
    ap = argparse.ArgumentParser(
        description="Supervised blendjax_torch learner (resumes from the latest "
                    "complete HA manifest at startup).")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--envs", default="", help="comma-separated producer GYM addresses")
    ap.add_argument("--obs-dim", type=int, default=1)
    ap.add_argument("--num-actions", type=int, default=2)
    ap.add_argument("--rollout-len", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-every", type=int, default=2,
                    help="checkpoint cadence in completed updates")
    ap.add_argument("--chunk-updates", type=int, default=4,
                    help="updates per run() chunk between stop checks")
    ap.add_argument("--action-values", default=None,
                    help="comma-separated floats mapping the discrete action index "
                         "to the producers' action space")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replay-shards", default="",
                    help="comma-separated replay shard addresses")
    ap.add_argument("--shard-capacity", type=int, default=None)
    ap.add_argument("--weight-bus", default=None,
                    help="weight-bus bind address (a fixed port, so a respawned "
                         "learner binds where the subscribers already dial)")
    ap.add_argument("--publish-every", type=int, default=1)
    ap.add_argument("--probe-batch", type=int, default=0,
                    help="after a resume, draw one batch of this size from the "
                         "restored replay and record its index digest")
    return ap


def main(argv=None):
    boot_ts = time.time()
    ap = build_parser()
    args = ap.parse_args(argv)
    env_addrs = [a for a in args.envs.split(",") if a]
    if not env_addrs:
        ap.error("--envs: give the producers' GYM addresses")
    logging.basicConfig(level=logging.INFO)

    t0 = time.perf_counter()
    import torch

    from blendjax_torch.ha.checkpoint import (
        TrainCheckpointer,
        latest_manifest,
        restore_replay,
    )
    from blendjax_torch.models.actor_learner import ActorLearner
    from blendjax_torch.utils.device import resolve_device
    from blendjax_torch.utils.timing import fleet_counters

    boot = {"boot_ts": boot_ts, "import_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.empty(1, device=device)  # the context starts here
        torch.cuda.synchronize(device)
    boot["device_init_s"] = time.perf_counter() - t0

    counters = fleet_counters
    t0 = time.perf_counter()
    manifest = latest_manifest(args.ckpt_dir, counters=counters)
    shard_addrs = [a for a in args.replay_shards.split(",") if a]
    replay = None
    if manifest is not None and manifest.get("replay"):
        replay = restore_replay(manifest, shard_addrs, counters=counters,
                                timeoutms=ENV_TIMEOUTMS)
    elif shard_addrs:
        from blendjax_torch.replay.shard_client import ShardedReplay

        replay = ShardedReplay(shard_addrs, seed=args.seed, counters=counters,
                               timeoutms=ENV_TIMEOUTMS, shard_capacity=args.shard_capacity)
    boot["restore_s"] = time.perf_counter() - t0

    bus = None
    if args.weight_bus:
        from blendjax_torch.weights.bus import WeightPublisher

        # the default (wall-clock) version base on purpose: a respawned
        # publisher starts above its predecessor, so subscribers roll forward
        bus = WeightPublisher(args.weight_bus, counters=counters).start()

    from blendjax_torch.btt.envpool import EnvPool

    pool = EnvPool(env_addrs, timeoutms=ENV_TIMEOUTMS, autoreset=True, counters=counters)
    ckptr = TrainCheckpointer(args.ckpt_dir, every_updates=args.ckpt_every, counters=counters)
    action_map = None
    if args.action_values:
        values = np.array([float(v) for v in args.action_values.split(",")], np.float64)
        action_map = lambda a: list(values[np.asarray(a)])  # noqa: E731

    t0 = time.perf_counter()
    learner = ActorLearner(
        pool, args.obs_dim, args.num_actions, rollout_len=args.rollout_len,
        seed=args.seed, action_map=action_map, replay=replay, checkpointer=ckptr,
        weight_bus=bus, publish_every=args.publish_every, device=device)
    boot["build_s"] = time.perf_counter() - t0

    ckptr.stats_extra["pid"] = os.getpid()
    resumed_from = None
    if manifest is not None:
        t0 = time.perf_counter()
        ckptr.restore(learner, manifest)  # the republish included
        boot["restore_s"] += time.perf_counter() - t0
        resumed_from = int(manifest["update"])
        ckptr.stats_extra["resumed_from"] = resumed_from
        if args.probe_batch and replay is not None:
            # the first draw after the resume, before any actor appends: its
            # digest is a function of the cut alone
            try:
                _, idx, _ = replay.sample(args.probe_batch, timeout=0.0)
                ckptr.stats_extra["probe_digest"] = hashlib.sha1(
                    np.ascontiguousarray(idx, np.int64).tobytes()).hexdigest()[:16]
            except TimeoutError:
                ckptr.stats_extra["probe_digest"] = "underfilled"
    elif bus is not None:
        # a fresh start puts a first version on the bus before the first
        # update, so a subscriber has a full sync target at once
        from blendjax_torch.models.convert import params_to_jax

        learner.last_published_version = bus.publish(params_to_jax(learner.state.params),
                                                     step=0)

    stop = threading.Event()

    def _term(signum, frame):
        stop.set()
        learner._stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)

    # the ready barrier LearnerProcess.wait_ready polls for
    boot["ready_ts"] = time.time()
    ckptr.stats_extra["boot"] = boot
    ckptr._write_stats(learner, force=True)
    logger.info("HA learner ready (pid %d) on %s: resumed_from=%s updates=%d envs=%d "
                "shards=%d bus=%s", os.getpid(), device, resumed_from, learner._updates_done,
                len(env_addrs), len(shard_addrs), getattr(bus, "address", None))

    try:
        while not stop.is_set():
            learner.run(num_updates=args.chunk_updates, seconds=CHUNK_SECONDS)
            ckptr._write_stats(learner, force=True)
    finally:
        ckptr.join(timeout=30)
        ckptr._write_stats(learner, force=True)
        pool.close()
        if bus is not None:
            bus.close()
        if replay is not None and hasattr(replay, "close"):
            replay.close()


if __name__ == "__main__":
    main()
