"""TrainCheckpointer: one consistent cut of the learner-side state, the port
of ``blendjax.ha.checkpoint``.

A cut holds what must agree for a resume the rest of the system cannot tell
from no crash:

1. the **TrainState** (parameters and Adam's state), written through
   :class:`~blendjax_torch.utils.checkpoint.CheckpointManager` in the
   reference's layout (fsync + atomic rename);
2. the learner's **scalars** (update counter, seed, last published bus
   version), inline in the manifest
   (:meth:`~blendjax_torch.models.actor_learner.ActorLearner.checkpoint_state`);
3. the **replay cut**, :meth:`~blendjax_torch.replay.ReplayBuffer.save`
   taken inside the same barrier, so the replay cursor and the learner
   step form one cut;
4. the **manifest**, a JSON file written (fsynced) last, naming the
   component files.  A checkpoint exists iff its manifest does.

Cuts are taken off the update loop: the synchronous barrier
(``ha_snapshot``) copies the TrainState to host buffers and takes the
replay cut; the npz writes, the manifest commit and retention run on a
background thread (``ha_serialize``).  A cut that comes due while the
previous serialization is in flight is skipped and counted
(``ha_ckpt_skipped``).  Files and manifests are the reference's, so a cut
written by either package restores in the other.

What differs from the reference, and why:

- **The barrier is ordered after the captured update.**  The update
  replays a CUDA graph that rewrites the parameters and Adam's tensors in
  place, so the barrier copies them on the learner thread, on the stream
  the update replays on, into reused (pinned) host buffers, and waits for
  that copy before ``ha_snapshot`` ends
  (:func:`~blendjax_torch.models.convert.train_state_arrays`).  The
  background thread touches numpy only.  Those host buffers are reused
  from cut to cut, which the skip-while-in-flight rule makes safe: no
  barrier starts while the previous cut is being written.
- **A restore lands in the learner's own tensors** (``copy_``/``fill_``),
  so its captured steps stay valid and nothing is captured again.
- A resume republish reads the restored params back from the card
  (:func:`~blendjax_torch.models.convert.params_to_jax`) and publishes
  them in the reference's layout under a fresh, higher version.
- The stats mirror also records ``first_update_ts``, when this process
  completed its first update: the end of a respawned learner's recovery.
- Its ``last_ckpt_update`` is the last cut whose manifest is committed, so
  a learner killed at any moment resumes from it or later; the cut taken
  but perhaps not yet written is ``last_ckpt_taken``.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import threading
import time

import numpy as np

from blendjax_torch.obs.flight import flight_recorder
from blendjax_torch.utils.checkpoint import CheckpointManager, _replace_durable
from blendjax_torch.utils.timing import StageTimer, fleet_counters

logger = logging.getLogger("blendjax_torch")

#: Manifest format tag, the reference's: the commit record of one cut.
MANIFEST_FORMAT = "blendjax.ha.manifest/1"

#: Budget for the synchronous barrier, seconds; exceeding it warns
#: (debounced).
STALL_BUDGET_S = 1.0


def _write_json_durable(path, doc):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    _replace_durable(tmp, path)


def _manifest_paths(directory):
    return sorted(glob.glob(os.path.join(directory, "manifest_*.json")))


def _verify_npz(path):
    """Integrity probe of a component npz: the zip central directory lives at
    the end of the file, so a torn write usually fails to open, and every
    member is read through so a truncated member behind an intact directory
    is caught here, at manifest selection, not inside the strict restore."""
    with np.load(path) as data:
        if not data.files:
            raise ValueError(f"{path}: empty checkpoint archive")
        for key in data.files:
            data[key]


def latest_manifest(directory, counters=None):
    """The newest complete manifest under ``directory`` (or None).

    Complete: the manifest parses, carries the format tag, and every
    component file it names exists and passes the integrity probe.  A
    damaged newer manifest is counted (``ha_restore_fallbacks``) and warned,
    and the previous one is offered instead."""
    for path in reversed(_manifest_paths(directory)):
        try:
            with open(path) as f:
                man = json.load(f)
            if man.get("format") != MANIFEST_FORMAT:
                raise ValueError(f"format {man.get('format')!r}")
            for key in ("train", "replay"):
                rel = man.get(key)
                if rel is not None:
                    _verify_npz(os.path.join(directory, rel))
        except Exception as exc:  # noqa: BLE001 - fall back, loudly
            if counters is not None:
                counters.incr("ha_restore_fallbacks")
            logger.warning("HA manifest %s is damaged (%s: %s); falling back to the "
                           "previous one", path, type(exc).__name__, exc)
            continue
        man["_path"] = path
        man["_directory"] = os.path.abspath(directory)
        return man
    return None


def restore_replay(manifest, shards=None, *, counters=None, timer=None, timeoutms=5000):
    """Rebuild the replay buffer a manifest's cut describes; None when the
    cut has no replay.

    A ``sharded`` cut needs the shard endpoints (the same deployment, still
    running: the learner died, its storage tier did not) and restores with
    ``reconcile=True``: the shards legitimately sit ahead of the
    cut by whatever the dead learner appended after it, and exactly those
    slots leave the draw domain until the resumed actors rewrite them.  A
    ``local`` cut restores the in-process
    :class:`~blendjax_torch.replay.ReplayBuffer` wholesale (its draw stream
    continues exactly)."""
    rel = manifest.get("replay")
    if rel is None:
        return None
    path = os.path.join(manifest["_directory"], rel)
    if manifest.get("replay_kind") == "sharded":
        if not shards:
            raise ValueError("manifest describes a sharded replay cut; pass the shard "
                             "endpoints to restore it")
        from blendjax_torch.replay.shard_client import ShardedReplay

        return ShardedReplay.restore(path, shards, counters=counters, timer=timer,
                                     timeoutms=timeoutms, reconcile=True)
    from blendjax_torch.replay.buffer import ReplayBuffer

    return ReplayBuffer.restore(path, counters=counters, timer=timer)


class TrainCheckpointer:
    """Coordinated, atomic, versioned learner checkpoints (module doc).

    Params
    ------
    directory: str
        Checkpoint root: ``train/step_<N>.npz`` (the TrainState),
        ``replay_<N>.npz`` (the replay cut, when a buffer is attached),
        ``manifest_<N>.json`` (the commit record), ``learner_stats.json``
        (the live stats mirror the supervisor's postmortem and the recovery
        clock read).
    every_updates: int
        Cadence in completed learner updates.
    every_seconds: float | None
        Additional wall-clock cadence (whichever fires first).
    max_to_keep: int
        Retention depth, in complete cuts.
    stats_path: str | None | "auto"
        Where :meth:`maybe_checkpoint` mirrors ``learner.stats()`` (a small
        JSON, atomically replaced, throttled): ``"auto"`` puts it in
        ``directory``; None disables.
    counters / timer:
        ``HA_EVENTS`` sink / ``HA_STAGES`` timer (process-wide counters and
        a private timer when omitted).
    """

    def __init__(self, directory, *, every_updates=50, every_seconds=None, max_to_keep=3,
                 stats_path="auto", counters=None, timer=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.every_updates = max(1, int(every_updates))
        self.every_seconds = None if every_seconds is None else float(every_seconds)
        self.max_to_keep = max(1, int(max_to_keep))
        self.counters = counters if counters is not None else fleet_counters
        self.timer = timer if timer is not None else StageTimer()
        self.train_mgr = CheckpointManager(os.path.join(self.directory, "train"),
                                           max_to_keep=self.max_to_keep,
                                           counters=self.counters)
        self.stats_path = (os.path.join(self.directory, "learner_stats.json")
                           if stats_path == "auto" else stats_path)
        #: extra fields merged into every stats mirror (the learner child
        #: sets its pid, resume point and boot times here)
        self.stats_extra = {}
        self._lock = threading.Lock()
        self._inflight = None
        #: host buffers of the barrier's copy, reused from cut to cut
        self._staging = {}
        #: the update of the last cut taken (the cadence counts from it)
        self._last_ckpt_update = 0
        #: the update of the last cut whose manifest is committed: what the
        #: stats report as ``last_ckpt_update``, since a crash may lose a cut
        #: taken but not yet written
        self._last_durable_update = 0
        self._last_ckpt_time = time.monotonic()
        self._last_stats_write = 0.0
        self._next_stall_warn = 0.0
        self._saves = 0
        self._skipped = 0
        self._failures = 0

    # -- cadence --------------------------------------------------------------

    def _due(self, updates):
        if updates - self._last_ckpt_update >= self.every_updates:
            return True
        return (self.every_seconds is not None
                and time.monotonic() - self._last_ckpt_time >= self.every_seconds
                and updates > self._last_ckpt_update)

    def maybe_checkpoint(self, learner):
        """The per-update hook (the learner thread calls it once per completed
        update): mirrors the stats file (throttled) and takes a cut when one
        is due and no serialization is in flight.  Never raises into the
        update loop.  Returns the cut's update number when one started, else
        None."""
        first = "first_update_ts" not in self.stats_extra
        if first:
            self.stats_extra["first_update_ts"] = time.time()
        self._write_stats(learner, force=first)
        if not self._due(learner._updates_done):
            return None
        with self._lock:
            if self._inflight is not None and self._inflight.is_alive():
                self._skipped += 1
                self.counters.incr("ha_ckpt_skipped")
                return None
        return self._checkpoint(learner, block=False)

    def checkpoint(self, learner, block=True):
        """Force one coordinated cut now.  ``block=True`` waits for the
        manifest commit (tests, clean shutdown).  Returns the cut's update
        number, or None on failure (counted, logged)."""
        prev = self._inflight
        if prev is not None:
            prev.join()
        return self._checkpoint(learner, block=block)

    # -- the cut --------------------------------------------------------------

    def _checkpoint(self, learner, block):
        from blendjax_torch.models import convert

        t0 = time.perf_counter()
        try:
            # the synchronous barrier: the TrainState copied to host buffers
            # after the last update (on its stream, waited for), and the
            # replay cut under the buffer's own lock
            aux = learner.checkpoint_state()
            update = int(aux["updates"])
            host_state = convert.train_state_arrays(learner.state, self._staging)
            replay_rel = replay_kind = None
            replay = learner.replay
            if replay is not None:
                replay_rel = f"replay_{update:08d}.npz"
                replay.save(os.path.join(self.directory, replay_rel))
                replay_kind = "sharded" if hasattr(replay, "num_shards") else "local"
        except Exception:  # noqa: BLE001 - training outlives checkpoints
            self._failures += 1
            self.counters.incr("ha_ckpt_failures")
            # a persistent failure (ENOSPC) costs one attempt per cadence
            self._last_ckpt_update = learner._updates_done
            self._last_ckpt_time = time.monotonic()
            logger.exception("HA checkpoint barrier failed (training continues; the "
                             "previous manifest keeps covering recovery)")
            return None
        finally:
            dt = time.perf_counter() - t0
            self.timer.add("ha_snapshot", dt)
        if dt > STALL_BUDGET_S:
            now = time.monotonic()
            if now >= self._next_stall_warn:
                self._next_stall_warn = now + 10.0
                logger.warning("HA checkpoint barrier took %.3fs (> stall budget %.3fs) at "
                               "update %d; raise every_updates", dt, STALL_BUDGET_S, update)
        self._last_ckpt_update = update
        self._last_ckpt_time = time.monotonic()
        args = (update, host_state, aux, replay_rel, replay_kind)
        if block:
            self._serialize(*args)
            return update
        t = threading.Thread(target=self._serialize, args=args, daemon=True,
                             name=f"bjx-ha-ckpt-{update}")
        with self._lock:
            self._inflight = t
        t.start()
        return update

    def _serialize(self, update, host_state, aux, replay_rel, replay_kind):
        """The background half: the TrainState npz (fsync + atomic rename),
        the manifest commit, retention.  Failures are counted, never raised:
        the previous manifest stays the recovery point."""
        t0 = time.perf_counter()
        try:
            train_path = self.train_mgr.save(update, host_state)
            nbytes = os.path.getsize(train_path)
            if replay_rel is not None:
                nbytes += os.path.getsize(os.path.join(self.directory, replay_rel))
            manifest = {
                "format": MANIFEST_FORMAT,
                "update": update,
                "ts": time.time(),
                "train": os.path.relpath(train_path, self.directory),
                "replay": replay_rel,
                "replay_kind": replay_kind,
                "aux": aux,
            }
            _write_json_durable(os.path.join(self.directory, f"manifest_{update:08d}.json"),
                                manifest)
            self._last_durable_update = max(self._last_durable_update, update)
            self._retain()
            self._saves += 1
            self.counters.incr("ha_ckpt_saves")
            self.counters.incr("ha_ckpt_bytes", int(nbytes))
        except Exception:  # noqa: BLE001 - see docstring
            self._failures += 1
            self.counters.incr("ha_ckpt_failures")
            logger.exception("HA checkpoint serialization failed at update %d (training "
                             "continues; the previous manifest keeps covering recovery)",
                             update)
        finally:
            self.timer.add("ha_serialize", time.perf_counter() - t0)

    def _retain(self):
        paths = _manifest_paths(self.directory)
        for path in paths[:max(0, len(paths) - self.max_to_keep)]:
            try:
                with open(path) as f:
                    man = json.load(f)
            except Exception:  # noqa: BLE001 - damaged manifest
                man = {}
            rel = man.get("replay")
            if rel:
                try:
                    os.unlink(os.path.join(self.directory, rel))
                except OSError:
                    pass
            try:
                os.unlink(path)
            except OSError:
                continue
            self.counters.incr("ha_ckpt_evicted")
        # train steps retire through the CheckpointManager's own retention

    # -- restore --------------------------------------------------------------

    def latest_manifest(self):
        return latest_manifest(self.directory, counters=self.counters)

    def restore(self, learner, manifest=None, *, republish=True):
        """Resume ``learner`` from a manifest (default: the latest complete
        one; FileNotFoundError when none exists): the manifest's TrainState
        step, written in place into ``learner.state`` (raises when it cannot
        be), and the update counter and seed through
        :meth:`ActorLearner.load_checkpoint_state`; when the learner carries
        a weight bus and ``republish``, the restored params are published
        under a fresh, higher version (``ha_resume_publishes``): the serve
        tier rolls forward across the respawn.  Returns the manifest."""
        if manifest is None:
            manifest = self.latest_manifest()
            if manifest is None:
                raise FileNotFoundError(f"no complete HA manifest under {self.directory}")
        t0 = time.perf_counter()
        state = self.train_mgr.restore(learner.state, step=int(manifest["update"]))
        learner.load_checkpoint_state(state, manifest.get("aux") or {})
        self._last_ckpt_update = self._last_durable_update = int(manifest["update"])
        self._last_ckpt_time = time.monotonic()
        self.counters.incr("ha_restores")
        self.timer.add("ha_restore", time.perf_counter() - t0)
        flight_recorder.note("learner_restored", target="learner",
                             update=int(manifest["update"]), manifest=manifest.get("_path"))
        if republish and learner.weight_bus is not None:
            from blendjax_torch.models.convert import params_to_jax

            v = learner.weight_bus.publish(params_to_jax(learner.state.params),
                                           step=learner._updates_done)
            learner.last_published_version = v
            self.counters.incr("ha_resume_publishes")
            logger.info("resume republish: checkpointed params (update %d) published as "
                        "weight version %s", learner._updates_done, v)
        return manifest

    # -- observability --------------------------------------------------------

    def join(self, timeout=None):
        """Wait for an in-flight background serialization."""
        t = self._inflight
        if t is not None:
            t.join(timeout)

    def _write_stats(self, learner, force=False):
        if self.stats_path is None:
            return
        now = time.monotonic()
        if not force and now - self._last_stats_write < 0.2:
            return
        self._last_stats_write = now
        try:
            doc = {
                "ts": time.time(),
                "pid": os.getpid(),
                "updates": learner._updates_done,
                "last_published_version": learner.last_published_version,
                "last_ckpt_update": self._last_durable_update,
                "last_ckpt_taken": self._last_ckpt_update,
            }
            try:
                doc["stats"] = learner.stats()
            except Exception:  # noqa: BLE001 - the mirror must not cascade
                pass
            doc.update(self.stats_extra)
            tmp = f"{self.stats_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=repr)
            os.replace(tmp, self.stats_path)
        except Exception:  # noqa: BLE001 - the mirror must not cascade
            logger.exception("HA stats mirror write failed")

    def stats(self):
        with self._lock:
            inflight = self._inflight is not None and self._inflight.is_alive()
        return {
            "directory": self.directory,
            "every_updates": self.every_updates,
            "every_seconds": self.every_seconds,
            "max_to_keep": self.max_to_keep,
            "saves": self._saves,
            "skipped": self._skipped,
            "failures": self._failures,
            "last_ckpt_update": self._last_durable_update,
            "last_ckpt_taken": self._last_ckpt_update,
            "manifests": len(_manifest_paths(self.directory)),
            "serialize_inflight": inflight,
        }
