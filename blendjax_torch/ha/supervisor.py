"""Supervised learner respawn, the port of ``blendjax.ha.supervisor``.

:class:`LearnerProcess` is the launcher-compatible surface (a duck-typed
``launch_info`` and ``respawn(idx)``) around one ``python -m
blendjax_torch.ha.learner`` child, so
:class:`~blendjax_torch.btt.watchdog.FleetWatchdog` supervises the learner
as it supervises Blender producers.  :class:`LearnerSupervisor` ties the
watchdog to the HA vocabulary: a death counts ``ha_learner_deaths`` and
dumps a flight-recorder postmortem naming the dead learner with its last
stats mirror attached (a SIGKILLed process cannot be asked anything); a
respawn counts ``ha_learner_respawns``.  The resume itself is the child's
startup (restore the latest complete manifest): the supervisor only brings
the process back.

The child runs where its ``--device`` says, the card unless the caller
passes ``device="cpu"``; its environment is the caller's, so it sees the
caller's cards.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time

from blendjax_torch.btt.watchdog import FleetWatchdog
from blendjax_torch.obs.flight import default_postmortem_dir, flight_recorder
from blendjax_torch.utils.timing import HA_EVENTS, fleet_counters

logger = logging.getLogger("blendjax_torch")


class _LearnerLaunchInfo:
    """Duck-typed ``launch_info``, so the watchdog supervises the learner
    process as every other tier's children."""

    def __init__(self, processes):
        self.processes = processes
        self.addresses = {}


class LearnerProcess:
    """One supervised learner process (``python -m
    blendjax_torch.ha.learner``) with a launcher-compatible surface, so
    ``FleetWatchdog(restart=True)`` respawns it after a SIGKILL with its
    original command line.  The respawned child resumes from the latest
    complete manifest under ``ckpt_dir`` on its own.

    Params mirror the child's CLI (see :mod:`blendjax_torch.ha.learner`):
    ``replay_shards`` (with ``shard_capacity``) puts the replay on shard
    processes, ``weight_bus`` is the publisher's bind address (a fixed
    port, so a respawned learner binds where the subscribers dial), and
    ``probe_batch`` records the digest of the first draw after a resume."""

    def __init__(self, *, ckpt_dir, env_addresses=(), replay_shards=(), shard_capacity=None,
                 weight_bus=None, publish_every=1, obs_dim=1, num_actions=2,
                 rollout_len=8, seed=0, ckpt_every=2, chunk_updates=4, action_values=None,
                 probe_batch=0, device="cuda", ready_timeout=90.0):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.stats_path = os.path.join(self.ckpt_dir, "learner_stats.json")
        self.ready_timeout = ready_timeout
        self._cmd = [
            sys.executable, "-m", "blendjax_torch.ha.learner",
            "--ckpt-dir", self.ckpt_dir,
            "--obs-dim", str(obs_dim),
            "--num-actions", str(num_actions),
            "--rollout-len", str(rollout_len),
            "--seed", str(seed),
            "--ckpt-every", str(ckpt_every),
            "--chunk-updates", str(chunk_updates),
            "--device", str(device),
        ]
        if env_addresses:
            self._cmd += ["--envs", ",".join(env_addresses)]
        if replay_shards:
            self._cmd += ["--replay-shards", ",".join(replay_shards)]
        if shard_capacity is not None:
            self._cmd += ["--shard-capacity", str(shard_capacity)]
        if weight_bus:
            self._cmd += ["--weight-bus", weight_bus, "--publish-every", str(publish_every)]
        if probe_batch:
            self._cmd += ["--probe-batch", str(probe_batch)]
        if action_values is not None:
            # one token: a leading minus would read as an option
            self._cmd += ["--action-values=" + ",".join(str(float(v)) for v in action_values)]
        self.launch_info = None

    def _spawn(self):
        from blendjax_torch.btt.launcher import child_env

        return subprocess.Popen(self._cmd, env=child_env(), start_new_session=True)

    def __enter__(self):
        self.launch_info = _LearnerLaunchInfo([self._spawn()])
        try:
            self.wait_ready(self.ready_timeout)
        except BaseException:
            self.close()
            raise
        return self

    def read_stats(self):
        """The child's latest stats mirror (None when absent or torn)."""
        try:
            with open(self.stats_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def wait_ready(self, timeout=90.0):
        """Block until the current child wrote a stats mirror (its ready
        barrier: after the torch import, the device's start and the
        restore)."""
        proc = self.launch_info.processes[0]
        deadline = time.monotonic() + timeout
        while True:
            stats = self.read_stats()
            if stats is not None and stats.get("pid") == proc.pid:
                return stats
            if proc.poll() is not None:
                raise RuntimeError(f"learner process exited with {proc.returncode} "
                                   "before becoming ready")
            if time.monotonic() >= deadline:
                raise TimeoutError(f"learner process not ready within {timeout:.1f}s")
            time.sleep(0.05)

    def respawn(self, idx=0):
        """Relaunch with the original command line (the watchdog's
        contract); the child restores the latest complete manifest."""
        proc = self._spawn()
        self.launch_info.processes[idx] = proc
        return proc

    def close(self):
        info = self.launch_info
        if info is None:
            return
        for p in info.processes:
            try:
                p.terminate()
            except OSError:
                pass
        for p in info.processes:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                try:
                    p.kill()
                    p.wait(timeout=10)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        self.launch_info = None

    def __exit__(self, *exc):
        self.close()
        return False


class LearnerSupervisor:
    """Death detection, respawn and postmortem for the learner process.

    Params
    ------
    process: LearnerProcess
        Inside its context (``launch_info`` populated).
    interval: float
        Watchdog poll period, seconds.
    counters: EventCounters | None
        ``HA_EVENTS`` sink; the process-wide default when omitted.
    postmortem_dir: str | None
        Postmortem destination (defaults to ``$BJX_POSTMORTEM_DIR``).
    """

    def __init__(self, process, *, interval=0.5, counters=None, postmortem_dir=None):
        self.process = process
        self.counters = counters if counters is not None else fleet_counters
        self.postmortem_dir = (postmortem_dir if postmortem_dir is not None
                               else default_postmortem_dir())
        self.last_postmortem = None
        self.watchdog = FleetWatchdog(process, interval=interval, on_death=self._on_death,
                                      restart=True, on_respawn=self._on_respawn)

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        self.watchdog.start()
        return self

    def stop(self):
        self.watchdog.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- death -> postmortem -> respawn --------------------------------------

    def _on_death(self, idx, code):
        self.counters.incr("ha_learner_deaths")
        stats = self.process.read_stats() or {}
        flight_recorder.note("learner_death", target="learner", exit_code=code,
                             updates=stats.get("updates"),
                             last_ckpt_update=stats.get("last_ckpt_update"))
        logger.warning("learner process died (exit %s) at update %s (last checkpoint "
                       "cut: update %s); respawning", code, stats.get("updates"),
                       stats.get("last_ckpt_update"))
        if self.postmortem_dir is not None:
            # the dead learner cannot be asked anything: attach the stats
            # mirror the checkpointer kept on disk
            self.last_postmortem = flight_recorder.dump(
                directory=self.postmortem_dir, reason="death-learner",
                extra={"target": "learner", "exit_code": code, "stats": stats,
                       "ckpt_dir": self.process.ckpt_dir})

    def _on_respawn(self, idx, proc):
        self.counters.incr("ha_learner_respawns")
        flight_recorder.note("learner_respawn", target="learner", pid=proc.pid)

    # -- observability -------------------------------------------------------

    def _await(self, cond, timeout):
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)
        return True

    def await_deaths(self, n=1, timeout=30.0):
        return self._await(lambda: self.counters.get("ha_learner_deaths") >= n, timeout)

    def await_respawns(self, n=1, timeout=30.0):
        return self._await(lambda: self.counters.get("ha_learner_respawns") >= n, timeout)

    def health(self):
        """Zero-filled ``HA_EVENTS``, the watchdog's liveness and the child's
        latest stats mirror, in one snapshot."""
        h = dict.fromkeys(HA_EVENTS, 0)
        h.update(self.counters.snapshot())
        h["alive"] = self.watchdog.alive
        h["learner_stats"] = self.process.read_stats()
        return h
