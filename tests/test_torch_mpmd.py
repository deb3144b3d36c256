"""The port's MPMD pipeline: the twins of the 8 cases of
``tests/test_mpmd.py`` that are not bench-schema tests, two cases across
the packages, and a stage's code checked to run no kernel.

- The lock: K updates of the port's :class:`MpmdTrain` over a 2-stage
  fleet equal the port's ``make_pipeline_train('1f1b')`` plus SGD, run on
  a ``{"pipe": 2}`` group of 2 real gloo ranks (``helpers/torch_ranks.py``).
- The uneven ``pg`` split and the single stage equal full-model plain SGD
  (torch autograd, the stages' arithmetic: gradients summed over
  microbatches, ``p - lr * g / m``), from the same
  :func:`build_full_params`: ``chip_smoke.mpmd_plain_sgd``, the reference
  the smoke holds the fleets to on the card, run here on the CPU over
  ``chip_smoke.mpmd_batches``.
- The ragged refusal, the reply cache and the ``(update, mb)`` dedup, the
  learner's pipeline mode and its spec refusals.
- The SIGKILL drill (``slow`` and ``chaos``, as the reference's): a stage
  process killed mid-update under ``FleetWatchdog(restart=True)`` comes
  back from its checkpoint, and six updates equal the uninterrupted plain
  SGD run.
- Across the packages: a 2-stage port fleet seeded with the JAX package's
  ``build_full_params(spec)`` through its per-stage checkpoints
  (``stage_XX``, ``{"params": local}``) runs 3 updates equal to the JAX
  package's ``MpmdTrain`` on the same batches; and the pipeline learner so
  seeded, its ``run_offline`` updates over a prioritized buffer held to
  the JAX package's ``ActorLearner`` on the batches it drew.

Tolerances are the reference's: losses 1e-5 relative (1e-4 in the drill
and across the packages),
parameters 1e-4 relative and 1e-5 absolute, the learner's mirror 1e-6
relative.  Stages run as threads of this process on the CPU
(``start_stage_threads(device="cpu")``) but in the drill, which runs
``python -m blendjax_torch.parallel.stage --device cpu`` processes.
"""

import glob
import os
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from blendjax_torch import wire
from blendjax_torch.parallel.mpmd import (
    MpmdStage,
    MpmdTrain,
    StageFleet,
    normalize_spec,
    reference_stacked,
    stage_local_params,
    stage_slice,
    start_stage_threads,
)
from blendjax_torch.utils.timing import EventCounters
from helpers import torch_parallel_ranks
from helpers.time_limit import time_limit
from helpers.torch_ranks import Ranks


def _spec(n_procs, *, family="mse", n_layers=4, lr=0.05, seed=2):
    return normalize_spec({"family": family, "d_in": 4, "wire": 8, "d_out": 3,
                           "n_layers": n_layers, "n_procs": n_procs, "lr": lr, "seed": seed})


def _batches(spec, k, batch=12, seed=0):
    """K fixed (x, target-record) whole batches for the spec's family (the
    smoke's: ``pg`` importance weights off 1)."""
    return chip_smoke.mpmd_batches(np, spec, k, seed, batch)


def _plain_sgd(spec, batches, m):
    """Full-model SGD with the stages' arithmetic on the CPU (the smoke's
    reference)."""
    return chip_smoke.mpmd_plain_sgd(torch, spec, batches, m, device="cpu")


def _assert_close(got, want, **tol):
    tol.setdefault("rtol", 1e-4)
    tol.setdefault("atol", 1e-5)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), **tol)


def _run_driver(spec, batches, m, **threads_kw):
    """K updates through a thread-served stage fleet on the CPU; returns the
    gathered params, per-update losses, the driver's counters and the
    stages' infos."""
    counters = EventCounters()
    with start_stage_threads(spec, device="cpu", **threads_kw) as handle:
        driver = MpmdTrain(handle.addresses, spec, counters=counters)
        try:
            driver.hello_all()
            losses = [float(driver.update(x, tgt, m)) for x, tgt in batches]
            params = driver.gather_params()
            infos = driver.stage_infos()
        finally:
            driver.close()
    return params, losses, counters, infos


# -- numerics locks --------------------------------------------------------------


LOCK_SPEC, LOCK_M = _spec(2), 4
LOCK_BATCHES = _batches(LOCK_SPEC, 3)


@pytest.fixture(scope="module")
def lock_ranks():
    r = Ranks(torch_parallel_ranks.mpmd_lock, 2,
              {"spec": LOCK_SPEC, "m": LOCK_M, "batches": LOCK_BATCHES})
    try:
        yield r
    finally:
        r.close()


@time_limit(120)
def test_mpmd_matches_in_jit_1f1b_reference(lock_ranks):
    """The lock: K updates on a 2-stage fleet equal
    ``make_pipeline_train('1f1b')`` plus SGD on the same spec, the SPMD leg
    run on 2 gloo ranks: the schedule, the wire and the split are
    numerically invisible."""
    got, losses, counters, infos = _run_driver(LOCK_SPEC, LOCK_BATCHES, LOCK_M)
    ref = lock_ranks.result("lock", 110)
    for rec in ref.values():
        np.testing.assert_allclose(losses, rec["losses"], rtol=1e-5)
    stacked, proj = reference_stacked(got, LOCK_SPEC)
    for rec in ref.values():
        _assert_close({k: v[rec["row"]] for k, v in stacked.items()}, rec["stacked"])
        for p, want in zip(proj, rec["proj"]):
            _assert_close(p, want)
    # a clean run needed no recovery
    assert counters.get("pipe_restarts") == 0
    assert counters.get("pipe_updates") == len(LOCK_BATCHES)
    assert all(i["applied"] == len(LOCK_BATCHES) for i in infos)


@time_limit(60)
def test_mpmd_pg_family_matches_plain_sgd():
    """The learner's pg loss through 3 unevenly sliced stages (4 layers over
    3 procs, the remainder path) equals full-model SGD."""
    spec = _spec(3, family="pg")
    assert [stage_slice(4, 3, p) for p in range(3)] == [(0, 2), (2, 3), (3, 4)]
    batches = _batches(spec, 3)
    got, losses, _, _ = _run_driver(spec, batches, 3)
    want, ref_losses = _plain_sgd(spec, batches, 3)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    _assert_close(got, want)


@time_limit(60)
def test_mpmd_single_stage_degenerates_to_plain_sgd():
    """n_procs=1 is plain SGD with the wire in the loop."""
    spec = _spec(1, n_layers=2)
    batches = _batches(spec, 2)
    got, losses, _, _ = _run_driver(spec, batches, 2)
    want, ref_losses = _plain_sgd(spec, batches, 2)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    _assert_close(got, want)


@time_limit(60)
def test_ragged_microbatch_count_rejected():
    """A batch the microbatch count does not divide is refused at the
    driver with the shape error, never silently reweighted."""
    spec = _spec(2)
    with start_stage_threads(spec, device="cpu") as handle:
        driver = MpmdTrain(handle.addresses, spec)
        try:
            driver.hello_all()
            x, tgt = _batches(spec, 1, batch=10)[0]
            with pytest.raises(ValueError, match="divisible"):
                driver.update(x, tgt, 4)
        finally:
            driver.close()


# -- exactly-once wire discipline (direct handle() calls) --------------------------


@time_limit(60)
def test_stage_dedup_reply_cache_and_stale_records():
    """A same-mid resend, a fresh-mid repeat of a seen (update, mb), and a
    record for a committed update are all absorbed as acks, never a second
    compute; an update-sequence gap raises restart_needed."""
    spec = _spec(1, n_layers=2)
    counters = EventCounters()
    stage = MpmdStage("tcp://127.0.0.1:*", spec, 0, counters=counters, device="cpu")
    try:
        rng = np.random.default_rng(3)
        x = [rng.standard_normal((4, spec["d_in"])).astype(np.float32) for _ in range(2)]
        y = [rng.standard_normal((4, spec["d_out"])).astype(np.float32) for _ in range(2)]
        assert stage.handle({"cmd": "begin", "update": 1, "m": 2}) == {"applied": 0}

        msg = {"cmd": "fwd", "update": 1, "mb": 0, "x": x[0]}
        wire.stamp_message_id(msg)
        r1 = stage.handle(msg)
        assert r1["ok"] and "dup" not in r1
        assert stage.handle(msg) == r1  # same-mid resend: the cached reply
        assert counters.get("pipe_dup_records") == 1
        again = {"cmd": "fwd", "update": 1, "mb": 0, "x": x[0]}
        wire.stamp_message_id(again)
        assert stage.handle(again)["dup"] is True  # (update, mb) dedup
        assert counters.get("pipe_dup_records") == 2

        for mb in range(2):
            stage.handle({"cmd": "tgt", "update": 1, "mb": mb, "tgt": {"y": y[mb]}})
        stage.handle({"cmd": "fwd", "update": 1, "mb": 1, "x": x[1]})
        fin = stage.handle({"cmd": "finish", "update": 1})
        assert fin["ready"] and fin["bwd_done"] == 2
        assert counters.get("pipe_microbatches") == 2

        commit = stage.handle({"cmd": "commit", "update": 1})
        assert commit["applied"] == 1
        assert isinstance(commit["loss"], float)
        assert stage.handle({"cmd": "commit", "update": 1}) == commit  # idempotent

        late = {"cmd": "fwd", "update": 1, "mb": 0, "x": x[0]}
        wire.stamp_message_id(late)
        assert stage.handle(late)["stale"] is True  # the committed past: a stale ack
        assert counters.get("pipe_microbatches") == 2  # no recompute

        gap = stage.handle({"cmd": "begin", "update": 3, "m": 2})
        assert "restart_needed" in gap["error"]
    finally:
        stage.close()


@time_limit(120)
def test_a_stage_enrolls_no_kernel_wrapper(tmp_path):
    """A stage's code runs no hand-written kernel: stages serving both
    families, with checkpoints, through ``python -m
    blendjax_torch.parallel.stage``'s module, import no
    ``blendjax_torch.ops`` module and enroll no launch counter.  The
    smoke's pipe phase reads no stage process's counts on this ground."""
    import subprocess
    import sys

    code = f"""
import sys
import numpy as np
import chip_smoke
import blendjax_torch.parallel.stage
from blendjax_torch.parallel.mpmd import MpmdTrain, normalize_spec, start_stage_threads
from blendjax_torch.utils import launches
for family in ("mse", "pg"):
    spec = normalize_spec({{"family": family, "d_in": 4, "wire": 8, "d_out": 3, "n_layers": 2,
                           "n_procs": 2, "lr": 0.05, "seed": 2}})
    with start_stage_threads(spec, device="cpu", ckpt_dir={str(tmp_path)!r} + family) as h:
        driver = MpmdTrain(h.addresses, spec)
        driver.hello_all()
        for x, tgt in chip_smoke.mpmd_batches(np, spec, 2, 0, 12):
            driver.update(x, tgt, 2)
        driver.close()
print(sorted(m for m in sys.modules if m.startswith("blendjax_torch.ops")), len(launches._COUNTED))
"""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=100, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] 0"


# -- learner integration -----------------------------------------------------------


@time_limit(60)
def test_actor_learner_pipeline_mode_offline():
    """``ActorLearner(pipeline_stages=...)``: run_offline drives the stage
    fleet from the replay's sampler, and the learner's state mirrors the
    fleet's committed params."""
    from blendjax_torch.models.actor_learner import ActorLearner
    from blendjax_torch.replay import ReplayBuffer

    spec = _spec(2, family="pg")
    rng = np.random.default_rng(1)
    buf = ReplayBuffer(512, seed=0)
    for _ in range(96):
        buf.append({"obs": rng.standard_normal(spec["d_in"]).astype(np.float32),
                    "action": int(rng.integers(0, spec["d_out"])),
                    "reward": float(rng.standard_normal())})
    with start_stage_threads(spec, device="cpu") as handle:
        driver = MpmdTrain(handle.addresses, spec)
        try:
            driver.hello_all()
            al = ActorLearner(None, obs_dim=spec["d_in"], num_actions=spec["d_out"], seed=1,
                              replay=buf, pipeline_stages=driver, device="cpu")
            assert al.pipeline_microbatches == spec["n_procs"]
            stats = al.run_offline(num_updates=3, batch_size=24)
            fleet_params = driver.gather_params()
            assert driver.updates_done == 3
        finally:
            driver.close()
    assert stats["updates"] == 3
    assert al.state.step == 3
    _assert_close({k: v.detach().numpy() for k, v in al.state.params.items()}, fleet_params,
                  rtol=1e-6)


def test_actor_learner_pipeline_mode_rejects_bad_specs():
    """The constructor's guards: family, dimension agreement, mesh
    exclusivity and a discrete policy all fail fast."""
    from blendjax_torch.models.actor_learner import ActorLearner
    from blendjax_torch.replay import ReplayBuffer

    class _FakeDriver:
        def __init__(self, spec):
            self.spec = normalize_spec(spec)

    buf = ReplayBuffer(64, seed=0)
    with pytest.raises(ValueError, match="family='pg'"):
        ActorLearner(None, obs_dim=4, num_actions=3, replay=buf, device="cpu",
                     pipeline_stages=_FakeDriver(_spec(2, family="mse")))
    pg = _FakeDriver(_spec(2, family="pg"))
    with pytest.raises(ValueError, match="obs_dim"):
        ActorLearner(None, obs_dim=7, num_actions=3, replay=buf, device="cpu",
                     pipeline_stages=pg)
    with pytest.raises(ValueError, match="mesh="):
        ActorLearner(None, obs_dim=4, num_actions=3, replay=buf, device="cpu",
                     pipeline_stages=pg, mesh=object())
    with pytest.raises(ValueError, match="discrete"):
        ActorLearner(None, obs_dim=4, num_actions=3, replay=buf, device="cpu",
                     pipeline_stages=pg, continuous=True)


# -- across the packages -------------------------------------------------------------


def _seed_from_reference(spec, root):
    """Per-stage checkpoints (``stage_XX``, update 0) of the JAX package's
    ``build_full_params(spec)``, in the reference's npz layout: the port's
    stages restore them at start."""
    from blendjax.parallel.mpmd import build_full_params as jbuild_full_params
    from blendjax_torch.models.convert import params_from_jax, params_to_jax
    from blendjax_torch.utils.checkpoint import CheckpointManager

    full = params_from_jax(jbuild_full_params(spec), device="cpu")
    for p in range(spec["n_procs"]):
        CheckpointManager(os.path.join(root, f"stage_{p:02d}"), max_to_keep=4).save(
            0, {"params": params_to_jax(stage_local_params(full, spec, p))})
    return full


@time_limit(120)
def test_fleet_seeded_from_the_reference_matches_its_driver(tmp_path):
    """A 2-stage port fleet started from the JAX package's parameters (its
    stages' checkpoints) runs 3 updates equal to the JAX package's
    ``MpmdTrain`` over its own stage threads, loss for loss and leaf for
    leaf."""
    import jax

    from blendjax.parallel.mpmd import MpmdTrain as JMpmdTrain
    from blendjax.parallel.mpmd import start_stage_threads as jstart_stage_threads
    from blendjax_torch.models.convert import params_from_jax

    spec = _spec(2, family="pg", n_layers=4)
    batches = _batches(spec, 3)
    full = _seed_from_reference(spec, str(tmp_path / "ck"))
    got, losses, counters, infos = _run_driver(spec, batches, 2, ckpt_dir=str(tmp_path / "ck"))
    assert counters.get("pipe_restarts") == 0
    assert [i["counters"].get("pipe_ckpt_restores") for i in infos] == [1, 1]
    assert any(not np.array_equal(got[k], full[k].numpy()) for k in got)

    with jstart_stage_threads(spec) as handle:
        jdriver = JMpmdTrain(handle.addresses, spec)
        try:
            jdriver.hello_all()
            jlosses = [float(jdriver.update(x, tgt, 2)) for x, tgt in batches]
            want = params_from_jax(jax.tree.map(np.asarray, jdriver.gather_params()),
                                   device="cpu")
        finally:
            jdriver.close()
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    _assert_close(got, {k: v.numpy() for k, v in want.items()})


@time_limit(120)
def test_actor_learner_pipeline_mode_matches_the_reference(tmp_path):
    """The pipeline learner's updates equal the JAX package's: a port fleet
    seeded with the reference's parameters runs ``run_offline`` for 3
    updates over a prioritized buffer (importance weights off 1, rewards
    off mean 0 and std 1); the batches it drew go through the JAX
    package's ``ActorLearner._pipeline_replay_update`` over its own fleet,
    and the losses, the learner's state and the fleet's parameters
    agree.  A skipped normalization or a dropped weight shows here."""
    import jax

    from blendjax.models.actor_learner import ActorLearner as JActorLearner
    from blendjax.parallel.mpmd import MpmdTrain as JMpmdTrain
    from blendjax.parallel.mpmd import start_stage_threads as jstart_stage_threads
    from blendjax.replay import ReplayBuffer as JReplayBuffer
    from blendjax_torch.models.actor_learner import ActorLearner
    from blendjax_torch.models.convert import params_from_jax
    from blendjax_torch.replay import ReplayBuffer

    spec = _spec(2, family="pg")
    ck = str(tmp_path / "ck")
    _seed_from_reference(spec, ck)
    rng = np.random.default_rng(4)
    buf = ReplayBuffer(512, seed=0)
    for _ in range(96):
        buf.append({"obs": rng.standard_normal(spec["d_in"]).astype(np.float32),
                    "action": int(rng.integers(0, spec["d_out"])),
                    "reward": float(1.0 + 2.0 * rng.standard_normal())})
    buf.update_priorities(np.arange(96), rng.uniform(0.1, 2.0, 96))
    drawn = []
    with start_stage_threads(spec, device="cpu", ckpt_dir=ck) as handle:
        driver = MpmdTrain(handle.addresses, spec)
        try:
            driver.hello_all()
            al = ActorLearner(None, obs_dim=spec["d_in"], num_actions=spec["d_out"], seed=1,
                              replay=buf, pipeline_stages=driver, device="cpu")
            update = al._pipeline_replay_update

            def recorded(*batch):  # (obs, action, reward, is_weight), off the arena
                drawn.append([np.array(a) for a in batch])
                return update(*batch)

            al._pipeline_replay_update = recorded
            stats = al.run_offline(num_updates=3, batch_size=24)
            fleet = driver.gather_params()
        finally:
            driver.close()
    assert len(drawn) == 3
    assert all(not np.allclose(w, 1.0) for *_, w in drawn)

    with jstart_stage_threads(spec) as handle:
        jdriver = JMpmdTrain(handle.addresses, spec)
        try:
            jdriver.hello_all()
            jal = JActorLearner(None, obs_dim=spec["d_in"], num_actions=spec["d_out"], seed=1,
                                replay=JReplayBuffer(64, seed=0), pipeline_stages=jdriver)
            jlosses = [float(jal._pipeline_replay_update(*batch)) for batch in drawn]
            want = params_from_jax(jax.tree.map(np.asarray, jal.state.params), device="cpu")
        finally:
            jdriver.close()
    want = {k: v.numpy() for k, v in want.items()}
    np.testing.assert_allclose(stats["losses"], jlosses, rtol=1e-4)
    _assert_close(fleet, want)
    _assert_close({k: v.detach().numpy() for k, v in al.state.params.items()}, want)
    assert al.state.step == 3


# -- the SIGKILL drill ---------------------------------------------------------------


@pytest.mark.chaos
@pytest.mark.slow  # process-heavy
@time_limit(300)
def test_stage_kill_respawn_checkpoint_exact(tmp_path):
    """SIGKILL the middle stage process mid-update under
    ``FleetWatchdog(restart=True)``: the respawned incarnation restores its
    params from its checkpoint cut, the driver reconciles and replays, and
    after K updates the params equal an uninterrupted plain-SGD run: no
    microbatch lost, none applied twice.  Teardown leaves no /dev/shm
    object.  The kill is sent once the stage reports itself inside the
    update (the smoke's ``kill_mid_update``; a timer could land after the
    update on the CPU), and ``work_us`` keeps each update open for tens of
    ms."""
    from blendjax_torch.btt.watchdog import FleetWatchdog

    spec = _spec(3, n_layers=6)
    m, k_updates, kill_after = 3, 6, 3
    batches = _batches(spec, k_updates, batch=12)
    want, ref_losses = _plain_sgd(spec, batches, m)

    counters = EventCounters()
    kill = {}
    with StageFleet(spec, ckpt_dir=str(tmp_path / "ck"), ckpt_every=1, work_us=5000,
                    device="cpu") as fleet:
        bases = [b for b in fleet.shm_bases if b]
        with FleetWatchdog(fleet, interval=0.25, restart=True) as wd:
            driver = MpmdTrain(fleet.addresses, spec, counters=counters, finish_timeout_s=10.0)
            try:
                driver.hello_all()
                losses = []
                for k, (x, tgt) in enumerate(batches):
                    if k == kill_after:
                        # fire mid-update: the driver is inside the protocol
                        killer = threading.Thread(target=chip_smoke.kill_mid_update,
                                                  args=(fleet, 1, k + 1, kill))
                        killer.start()
                    losses.append(float(driver.update(x, tgt, m)))
                killer.join(timeout=30)
                got = driver.gather_params()
                infos = driver.stage_infos()
            finally:
                driver.close()
            deadline = time.monotonic() + 10
            while not wd.deaths and time.monotonic() < deadline:
                time.sleep(0.1)

    _assert_close(got, want)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert kill["kill_info"]["current"] == kill_after + 1
    assert [d[0] for d in wd.deaths] == [1]
    assert counters.get("pipe_stage_respawns") >= 1
    assert [i["applied"] for i in infos] == [k_updates] * 3
    assert infos[1]["counters"].get("pipe_ckpt_restores", 0) >= 1
    leaked = [p for b in bases for p in glob.glob(f"/dev/shm/{b}*")]
    assert not leaked, f"shm leaked: {leaked}"
