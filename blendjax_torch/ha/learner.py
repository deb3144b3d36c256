"""The supervised learner process: ``python -m blendjax_torch.ha.learner``,
the port of ``blendjax.ha.learner``.

The process :class:`~blendjax_torch.ha.supervisor.LearnerProcess` spawns
(and ``FleetWatchdog(restart=True)`` respawns).  Startup is the resume
path:

1. find the latest complete manifest under ``--ckpt-dir``
   (:func:`~blendjax_torch.ha.checkpoint.latest_manifest`: damaged cuts are
   skipped, counted, warned);
2. rebuild the local replay buffer if the cut has one
   (:func:`~blendjax_torch.ha.checkpoint.restore_replay`);
3. reconnect the producer fleet (the producers never died: a fresh
   :class:`~blendjax_torch.btt.envpool.EnvPool` dials the same addresses)
   and restore the TrainState in place, the update counter and the seed
   continuing from the cut;
4. write the ready stats mirror and train on.

A fresh directory starts from scratch through the same code path.  A
restored replay rides along (the actors append to it and the next cut
carries it).  The checkpointer mirrors ``stats()`` to
``<ckpt-dir>/learner_stats.json``: the supervisor's postmortem source and
the recovery clock.  The mirror also
carries this process's boot times (``boot``: the torch import, the
device's start, the learner's construction, the restore) and
``first_update_ts``, so a respawn's cost splits into its parts.

The learner runs on ``--device`` (the card unless ``--device cpu``).
``--replay-shards``, ``--shard-capacity``, ``--weight-bus`` and
``--publish-every`` exit 2: the shard services and the weight bus are
ROADMAP Queue 1, item 9.
"""

from __future__ import annotations

import argparse
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

#: the reference's flags that wait for the control plane
NOT_PORTED = {
    "--replay-shards": "the replay shard services",
    "--shard-capacity": "the replay shard services",
    "--weight-bus": "the weight bus",
    "--publish-every": "the weight bus",
}


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
    for flag, what in NOT_PORTED.items():
        ap.add_argument(flag, default=None, help=f"not ported: {what}")
    return ap


def main(argv=None):
    boot_ts = time.time()
    ap = build_parser()
    args = ap.parse_args(argv)
    for flag, what in NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag}: {what} is not ported yet (ROADMAP Queue 1, item 9)")
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
    replay = None
    if manifest is not None and manifest.get("replay"):
        replay = restore_replay(manifest, counters=counters)
    boot["restore_s"] = time.perf_counter() - t0

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
        device=device)
    boot["build_s"] = time.perf_counter() - t0

    ckptr.stats_extra["pid"] = os.getpid()
    resumed_from = None
    if manifest is not None:
        t0 = time.perf_counter()
        ckptr.restore(learner, manifest)
        boot["restore_s"] += time.perf_counter() - t0
        resumed_from = int(manifest["update"])
        ckptr.stats_extra["resumed_from"] = resumed_from

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
    logger.info("HA learner ready (pid %d) on %s: resumed_from=%s updates=%d envs=%d",
                os.getpid(), device, resumed_from, learner._updates_done, len(env_addrs))

    try:
        while not stop.is_set():
            learner.run(num_updates=args.chunk_updates, seconds=CHUNK_SECONDS)
            ckptr._write_stats(learner, force=True)
    finally:
        ckptr.join(timeout=30)
        ckptr._write_stats(learner, force=True)
        pool.close()


if __name__ == "__main__":
    main()
