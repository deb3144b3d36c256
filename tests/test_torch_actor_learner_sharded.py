"""The port's data-parallel actor-learner against the reference's: the twins
of the 12 cases of ``tests/test_actor_learner_sharded.py``.

Where the reference drives every shard of its mesh from one process, the
port's ranks are processes, each owning its fleets and filling its own
rows of the global batch.  The mesh cases run in 8 real gloo ranks
(``helpers/torch_ranks.py``), started once for the module:

- **DP equivalence** (``{"data": 8}``, one row per rank) and **padding**
  (6 envs padded to 8 rows: ranks 6 and 7 hold only masked padding): the
  sharded update from the reference's initial params against the
  single-device update of both packages.  The loss within 1e-5 relative
  plus 1e-6 absolute (it is a cancelling sum near 0), the gradients within
  1e-5, and the parameters held by
  ``tests/test_torch_policy.py``'s rule for Adam's first step.  Not held to
  the reference's own sharded update, whose test fails in every run
  (ROADMAP Queue 3).
- **Fan-in padding and placement** (``{"data": 2}``): rank 0 owns fleets
  of 2 and 2 envs, rank 1 one of 2; 6 real rows pad to 8, the mask covers
  exactly the real rows, and each rank's rows land as its ``Shard(0)``.
- **Multi-fleet training** (``{"data": 2}``): each rank's ``FleetSet`` of
  2 fleets x 1 echo producer (``tests/blender/torch_env.blend.py``) feeds
  the sharded learner for 30 updates, then for budgets of 2 s and 30 s; then the same with rank 1's fleet 1 killed mid-run.
- **Sharded replay** (``{"data": 8}``): ``run_offline`` with each rank
  sampling its share, and the indivisible replay batches refused.

The cases without a mesh (a dead fleet's rows zeroed, a dead fleet's final
segment drained, the supervised re-admission, the validations) run here.
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax.models.actor_learner import ActorLearner as JActorLearner
from blendjax_torch.btt.chaos import kill_instance
from blendjax_torch.btt.faults import FaultPolicy
from blendjax_torch.models.actor_learner import ActorLearner
from blendjax_torch.models.convert import params_from_jax, params_to_jax
from blendjax_torch.parallel import FleetSet, SegmentFanIn
from helpers import BLEND_SCRIPTS, FAKE_BLENDER, torch_parallel_ranks
from helpers.time_limit import time_limit
from helpers.torch_ranks import Ranks
from test_torch_actor_learner import _hold_step, _port_learner, _ref_loss
from test_torch_env import _free_block

ENV_SCRIPT = os.path.join(BLEND_SCRIPTS, "torch_env.blend.py")
ATOL = 1e-5
#: the REINFORCE loss is a cancelling sum near 0 (-6.2e-3 on the DP case):
#: summed in another order its float32 value moves by ~1e-7, beyond the
#: reference's rtol of 1e-5 alone
LOSS_ATOL = 1e-6


def _rollout(rng, t, n, d, num_actions=2):
    """A fixed synthetic rollout, time-major (the single-device layout)."""
    return {
        "obs": rng.random((t, n, d)).astype(np.float32),
        "actions": rng.integers(0, num_actions, (t, n)).astype(np.int32),
        "rewards": rng.random((t, n)).astype(np.float32),
        "dones": rng.random((t, n)) < 0.1,
    }


def _env_major(batch_tm, n_padded=None):
    """The env-major layout with padding rows at mask 0."""
    n = batch_tm["rewards"].shape[1]
    n_padded = n_padded or n
    out = {}
    for k, v in batch_tm.items():
        em = np.ascontiguousarray(v.swapaxes(0, 1))
        if n_padded > n:
            em = np.concatenate([em, np.zeros((n_padded - n,) + em.shape[1:], em.dtype)])
        out[k] = em
    out["mask"] = np.zeros((n_padded,), np.float32)
    out["mask"][:n] = 1.0
    return out


def _dp_case(t, n, seed, rng_seed):
    """The reference's single-device learner, its params, loss, gradients,
    and the global env-major batch padded to 8 rows."""
    batch_tm = _rollout(np.random.default_rng(rng_seed), t, n, 3)
    al = JActorLearner(None, obs_dim=3, num_actions=2, seed=seed)
    tree = jax.device_get(al.state.params)
    return {"tree": tree, "batch_tm": batch_tm, "jax": al,
            "ranks": {"params": {k: v.numpy() for k, v in
                                 params_from_jax(tree, device="cpu").items()},
                      "batch": _env_major(batch_tm, n_padded=8)}}


DP = {"dp": _dp_case(16, 8, 3, 0), "padding": _dp_case(12, 6, 5, 1)}


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(torch_parallel_ranks.actor_learner_sharded_cases, 8,
              {"dp": DP["dp"]["ranks"], "padding": DP["padding"]["ranks"],
               "blender": FAKE_BLENDER, "env_script": ENV_SCRIPT, "port": _free_block(80)})
    try:
        yield r
    finally:
        r.close()


@pytest.fixture
def fake_blender(monkeypatch):
    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)
    monkeypatch.setenv("BLENDJAX_FAKE_BPY", "1")


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


class TestDpEquivalence:
    def _held(self, ranks, case):
        out = ranks.result(case, 110)
        c = DP[case]
        tree, batch_tm = c["tree"], c["batch_tm"]
        jal = c["jax"]
        jbatch = jax.tree.map(jnp.asarray, batch_tm)
        jloss = float(_ref_loss(jal._step)(tree, jbatch))
        jgrads = jax.grad(_ref_loss(jal._step))(tree, jbatch)
        port = _port_learner(tree, seed=c["jax"]._seed)
        state, ploss = port._step(port.state, _t(batch_tm))
        pgrads = {k: v.grad.detach().clone() for k, v in state.params.items()}
        pparams = {k: v.detach() for k, v in state.params.items()}
        for rec in out.values():
            assert rec["placements"] == ["Shard(dim=0)"] and rec["rows"] == 1
            np.testing.assert_allclose(rec["loss"], jloss, rtol=1e-5, atol=LOSS_ATOL)
            np.testing.assert_allclose(rec["loss"], float(ploss), rtol=1e-5, atol=LOSS_ATOL)
            grads = {k: torch.from_numpy(v) for k, v in rec["grads"].items()}
            for k, g in grads.items():
                np.testing.assert_allclose(g.numpy(), pgrads[k].numpy(), atol=ATOL, err_msg=k)
            got = {k: torch.from_numpy(v) for k, v in rec["params"].items()}
            _hold_step(got, tree, grads, jgrads)
            _hold_step(got, tree, grads, params_to_jax(pgrads))
            for k, v in got.items():  # the single-device port's own step
                np.testing.assert_allclose(v.numpy(), pparams[k].numpy(), atol=ATOL, err_msg=k)

    @time_limit(120)
    def test_sharded_update_matches_single_device(self, ranks):
        """8 envs over 8 ranks, one row each."""
        self._held(ranks, "dp")

    @time_limit(120)
    def test_padding_rows_do_not_change_the_update(self, ranks):
        """6 envs over 8 ranks pad to 8 rows: ranks 6 and 7 hold only
        masked padding, and the update is the unpadded single-device one."""
        self._held(ranks, "padding")


class TestSegmentFanIn:
    @time_limit(120)
    def test_padding_and_presharded_placement(self, ranks):
        """Fleets of 2 + 2 envs on rank 0 and 2 on rank 1: 6 real rows pad
        to 8, the mask covers exactly the real rows, and each rank's 4 rows
        land as its ``Shard(0)`` of the global batch."""
        out = ranks.result("fanin", 110)
        r0, r1 = out[0], out[1]
        assert [r0["n_real"], r1["n_real"]] == [4, 2]
        for rec in (r0, r1):
            assert rec["n_real_global"] == 6 and rec["n_padded"] == 8 and rec["n_local"] == 4
            assert rec["global_shape"] == (8, 4, 3) and rec["local_shape"] == (4, 4, 3)
            assert rec["rewards_shape"] == (8, 4)
            assert rec["placements"] == ["Shard(dim=0)"]
        assert r0["mask"] + r1["mask"] == [1, 1, 1, 1, 1, 1, 0, 0]
        np.testing.assert_array_equal(r0["obs"], np.concatenate(r0["segments"]))
        np.testing.assert_array_equal(r1["obs"][:2], r1["segments"][0])
        np.testing.assert_array_equal(r1["obs"][2:], 0.0)
        assert all(out[r] is None for r in range(2, 8))

    def _seg_lists(self, rng, t, n, d, fill=None):
        return torch_parallel_ranks._segment(rng, t, n, d, fill)

    def test_dead_fleet_rows_zeroed_and_masked(self):
        fanin = SegmentFanIn([2, 2], mesh=None, device="cpu")
        rng = np.random.default_rng(1)
        stop = threading.Event()
        fanin.put_segment(0, self._seg_lists(rng, 4, 2, 3), stop)
        fanin.put_segment(1, self._seg_lists(rng, 4, 2, 3, fill=7.0), stop)
        b1 = fanin.assemble(fanin.collect(lambda f: True, stop))
        assert b1.data["mask"].tolist() == [1, 1, 1, 1]
        b1.recycle()  # round 2 reuses these buffers
        fanin.put_segment(0, self._seg_lists(rng, 4, 2, 3), stop)
        t0 = time.perf_counter()
        segs = fanin.collect(lambda f: f == 0, stop)
        assert time.perf_counter() - t0 < 5.0  # no stall on the dead fleet
        assert sorted(segs) == [0]
        b2 = fanin.assemble(segs)
        assert b2.data["mask"].tolist() == [1, 1, 0, 0]
        np.testing.assert_array_equal(b2.data["obs"][2:], 0.0)

    def test_collect_drains_dead_fleets_final_segment(self):
        fanin = SegmentFanIn([2], mesh=None, device="cpu")
        stop = threading.Event()
        fanin.put_segment(0, self._seg_lists(np.random.default_rng(2), 2, 2, 3), stop)
        segs = fanin.collect(lambda f: False, stop)  # actor already dead
        assert sorted(segs) == [0]


def _learned(stats):
    first = np.mean(stats["segment_rewards"][:5])
    last = np.mean(stats["segment_rewards"][-5:])
    assert last > first
    assert last > 0.08, f"policy failed to converge: {last}"


class TestMultiFleetTraining:
    @time_limit(240)
    def test_two_fleets_sharded_end_to_end(self, ranks):
        """Each of 2 ranks owns 2 fleets x 1 echo env: 30 sharded updates,
        every fleet contributes, the echo policy is learned, and each rank's
        health snapshot sees its fleets."""
        out = ranks.result("two_fleets", 230)
        losses = []
        for rank in (0, 1):
            stats, health = out[rank]["stats"], out[rank]["health"]
            assert stats["updates"] == 30 and stats["sharded"]
            assert stats["num_fleets"] == 2 and stats["dead_fleets"] == []
            assert all(s > 0 for s in stats["env_steps_by_fleet"])
            assert stats["env_steps"] == sum(stats["env_steps_by_fleet"])
            _learned(stats)
            assert sorted(health["fleets"]) == [0, 1] and health["num_fleets"] == 2
            assert health["num_envs"] == 2 and health["healthy_envs"] == 2
            assert health["quarantines"] == 0 and health["dead_fleets"] == []
            losses.append(stats["losses"])
        assert losses[0] == losses[1]  # one global update on both ranks

    @time_limit(120)
    def test_seconds_budget_stops_ranks_together(self, ranks):
        """``run(seconds=)`` of 2 s on rank 0 and 30 s on rank 1 (a clock
        behind), rank 1's first batch 4 s late: rank 0's budget runs out
        while it waits in the first update, and both ranks stop after that
        one update (a rank that stopped on its own clock would leave the
        other in a collective)."""
        out = ranks.result("seconds", 110)
        assert [out[0]["updates"], out[1]["updates"]] == [1, 1], out
        assert out[0]["losses"] == out[1]["losses"]

    @time_limit(240)
    def test_kill_one_fleet_keeps_training(self, ranks):
        """Rank 1's fleet 1 is killed mid-run: both ranks complete their
        updates in step, and only rank 1's fleet 1 shows the death and the
        quarantine.  (The port's fleets are always supervised, with no
        ``restart=False``: the killed producer is respawned, so the fleet may
        rejoin before the run ends, where the reference's stays dead.)"""
        out = ranks.result("kill_one_fleet", 230)
        r0, r1 = out[0], out[1]
        assert r0["stats"]["updates"] == r1["stats"]["updates"] == 30
        assert r0["stats"]["losses"] == r1["stats"]["losses"]
        assert r0["stats"]["dead_fleets"] == [] and r1["stats"]["dead_fleets"] in ([], [1])
        assert r0["health"]["deaths"] == 0 and r0["health"]["quarantines"] == 0
        fleets = r1["health"]["fleets"]
        assert fleets[0]["deaths"] == 0 and fleets[0]["quarantines"] == 0
        assert fleets[1]["deaths"] >= 1 and fleets[1]["quarantines"] >= 1

    @pytest.mark.chaos
    @time_limit(120)
    def test_killed_fleet_rejoins_after_supervised_respawn(self, fake_blender):
        """Fleet re-admission, as the reference's (no mesh): fleet 1's only
        producer is SIGKILLed, its actor dies and its rows are masked; the
        fleet's supervisor respawns the producer, the pool heals, and the
        learner restarts the fleet's actor, so the fleet rejoins."""
        policy = FaultPolicy(max_retries=1, backoff_base=0.05, deadline_s=2.0,
                             circuit_threshold=0, seed=7)
        values = np.array([0.0, 1.0], np.float64)
        with FleetSet("", ENV_SCRIPT, num_fleets=2, envs_per_fleet=1,
                      start_port=_free_block(200), timeoutms=10000, fault_policy=policy,
                      interval=0.2, horizon=1_000_000) as fs:
            al = ActorLearner(fs, obs_dim=1, num_actions=2, rollout_len=8, seed=1,
                              action_map=lambda a: list(values[np.asarray(a)]),
                              device="cpu")
            al.fleet_restart_cooldown = 0.2
            marks, result = {}, {}

            def killer():
                while min(al._env_steps_by_fleet) < 16:
                    time.sleep(0.02)
                marks["steps_at_kill"] = al._env_steps_by_fleet[1]
                # a respawn fast enough that the actor's retry succeeds never
                # kills the fleet: kill again until the restart path engages
                for _ in range(5):
                    kill_instance(fs.launchers[1], 0)
                    deadline = time.monotonic() + 4
                    while time.monotonic() < deadline:
                        if al._actor_errors[1] is not None or al._fleet_restarts[1] >= 1:
                            return
                        time.sleep(0.05)

            rt = threading.Thread(
                target=lambda: result.update(al.run(num_updates=100_000, seconds=60)),
                daemon=True)
            kt = threading.Thread(target=killer, daemon=True)
            rt.start()
            kt.start()
            kt.join(timeout=30)
            assert "steps_at_kill" in marks, "fleets never started"
            deadline = time.monotonic() + 45
            while time.monotonic() < deadline:
                if (al._fleet_restarts[1] >= 1 and al._actor_errors[1] is None
                        and al._env_steps_by_fleet[1] > marks["steps_at_kill"] + 8):
                    break
                time.sleep(0.1)
            al._stop.set()
            rt.join(timeout=30)
            health = fs.health()
        assert result.get("fleet_restarts", [0, 0])[1] >= 1
        assert result["dead_fleets"] == []  # the fleet rejoined
        assert result["env_steps_by_fleet"][1] > marks["steps_at_kill"] + 8
        assert health["fleets"][1]["deaths"] >= 1
        assert health["fleets"][1]["restarts"] >= 1
        assert health["fleets"][0]["deaths"] == 0


class TestShardedReplay:
    @time_limit(240)
    def test_offline_batches_land_sharded(self, ranks):
        """``run_offline`` over ``{"data": 8}``: each rank samples its 4 of
        every 32 rows from its own buffer; 5 updates, finite losses, one
        global loss and one replica of the parameters on every rank."""
        out = ranks.result("offline", 230)
        for rec in out.values():
            assert rec["updates"] == 5 and all(np.isfinite(v) for v in rec["losses"])
            assert rec["losses"] == out[0]["losses"]
            for k, v in rec["params"].items():
                np.testing.assert_array_equal(v, out[0]["params"][k])

    @time_limit(240)
    def test_indivisible_replay_batch_rejected_early(self, ranks):
        out = ranks.result("indivisible", 230)
        for errors in out.values():
            assert len(errors) == 2 and all("divisible" in e for e in errors)
            assert "replay_batch=36" in errors[0] and "batch_size=30" in errors[1]


def test_fleetset_validates_sizes():
    with pytest.raises(ValueError, match=">= 1"):
        FleetSet("", ENV_SCRIPT, num_fleets=0, envs_per_fleet=2)


def test_actor_learner_num_fleets_mismatch_raises():
    with pytest.raises(ValueError, match="num_fleets"):
        ActorLearner([object(), object()], obs_dim=1, num_actions=2, num_fleets=3,
                     device="cpu")
