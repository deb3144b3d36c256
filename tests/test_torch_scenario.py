"""The port's scenario plane (``blendjax_torch.scenario``, the replay
strata, the heterogeneous fan-in, ``FleetSet`` and the actor-learner's
scenario options) against the reference's ``tests/test_scenario.py``, on
the CPU.

1. **The reference's cases** against the port: ``TestCatalog``,
   ``TestCurriculum``, ``TestRandomizer`` (in-process duplex peers),
   ``TestReplayStrata``, ``TestHeteroFanIn`` and ``TestScenarioTraining``:
   the three-fleet, two-scenario run with a pinned curriculum shift over a
   ``FleetSet`` of the port's echo producers
   (``tests/blender/torch_env.blend.py`` under the fake Blender with
   ``BLENDJAX_FAKE_BPY=1``), and the SIGKILL-mid-push reassignment
   (``chaos``).  Not ported: the serve-tier cases and the bench schemas
   (the gateway and the benchmarks are ROADMAP items 9 and 10).
2. **Across the packages**: a catalog file each package reads from the
   other (equal specs and seeded samples); ``apportion`` and seeded
   ``sample`` equal for the same seed; a ``CurriculumScheduler``
   ``state_dict`` that loads in both directions, and the prioritized mix
   sequence within 1e-12 under the same strata; strata draws equal to the
   reference's ``ReplayBuffer`` index for index with IS weights within
   1e-6 under the same appends, seed and mix (prioritized and uniform, the
   degraded-mask case, and ``ShardedReplay`` with a quarantined shard and
   journalled rows); ``assemble_groups`` byte-equal; each package's
   ``DomainRandomizer`` pushing into the other's producer; and an
   actor-learner update on a stamped, mixed-shape fan-in batch within 1e-5
   of the reference's, in losses and gradients.

Every live case waits on conditions under its own deadline, never on a
fixed sleep.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from blendjax.models.actor_learner import ActorLearner as JActorLearner
from blendjax.parallel.podracer import SegmentFanIn as JSegmentFanIn
from blendjax.replay import ReplayBuffer as JReplayBuffer
from blendjax.replay import ShardedReplay as JShardedReplay
from blendjax.replay.service import start_shard_thread as j_start_shard_thread
from blendjax.scenario import CurriculumScheduler as JCurriculumScheduler
from blendjax.scenario import DomainRandomizer as JDomainRandomizer
from blendjax.scenario import ScenarioCatalog as JScenarioCatalog
from blendjax.scenario import ScenarioSpec as JScenarioSpec
from blendjax.scenario import apportion as j_apportion
from blendjax_torch.btt.envpool import EnvPool
from blendjax_torch.btt.launcher import BlenderLauncher
from blendjax_torch.models.actor_learner import ActorLearner
from blendjax_torch.models.convert import params_from_jax, params_to_jax
from blendjax_torch.parallel import FleetSet, SegmentFanIn
from blendjax_torch.replay import ReplayBuffer, ShardedReplay
from blendjax_torch.replay.prefill import prefill_from_btr, transition_to_message
from blendjax_torch.replay.service import start_shard_thread
from blendjax_torch.scenario import (
    CurriculumScheduler,
    DomainRandomizer,
    ScenarioCatalog,
    ScenarioSpec,
    apportion,
)
from blendjax_torch.utils.timing import EventCounters
from helpers import BLEND_SCRIPTS, FAKE_BLENDER
from test_torch_env import _addr, _free_block

ENV_SCRIPT = f"{BLEND_SCRIPTS}/torch_env.blend.py"
REF_ENV_SCRIPT = f"{BLEND_SCRIPTS}/env.blend.py"
#: IS weights across the packages (the draws themselves are held exactly)
WEIGHT_ATOL = 1e-6
#: the curriculum's prioritized mixes across the packages
MIX_ATOL = 1e-12
#: losses and gradients of one update across the packages
LOSS_ATOL = 1e-5


@pytest.fixture
def fake_blender(monkeypatch):
    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)
    monkeypatch.setenv("BLENDJAX_FAKE_BPY", "1")


def two_scenarios(fast_us=0, slow_us=2000, spec=ScenarioSpec, catalog=ScenarioCatalog):
    return catalog([
        spec("lite", physics_rate_us=fast_us, ranges={"density": (0.1, 0.4)}),
        spec("rich", physics_rate_us=slow_us, ranges={"density": (0.6, 1.0)}),
    ])


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


# -- catalog --------------------------------------------------------------------------


class TestCatalog:
    def test_json_round_trip_and_seeded_sampling(self):
        cat = ScenarioCatalog([
            ScenarioSpec("a", params={"scene": "x"},
                         ranges={"d": (0.0, 1.0), "tex": ["wood", "tin"]},
                         physics_rate_us=150, resolution=(32, 48)),
            ScenarioSpec("b"),
        ])
        back = ScenarioCatalog.from_json(cat.to_json())
        assert back.names() == ["a", "b"]
        s1 = cat.sample("a", np.random.default_rng(9))
        s2 = back.sample("a", np.random.default_rng(9))
        assert s1 == s2
        assert s1["scenario"] == "a" and s1["physics_us"] == 150
        assert s1["resolution"] == [32, 48]
        assert 0.0 <= s1["d"] <= 1.0 and s1["tex"] in ("wood", "tin")
        assert cat.sample("a", np.random.default_rng(10))["d"] != s1["d"]

    def test_env_kwargs_is_the_launch_subset(self):
        assert ScenarioSpec("rich", physics_rate_us=4000).env_kwargs() == {
            "scenario": "rich", "physics_us": 4000}

    def test_zero_physics_rate_still_rides_every_sample(self):
        spec = ScenarioSpec("free", physics_rate_us=0)
        assert spec.sample(np.random.default_rng(0))["physics_us"] == 0
        assert spec.env_kwargs()["physics_us"] == 0

    def test_schema_validation(self):
        with pytest.raises(ValueError, match="inverted"):
            ScenarioSpec("bad", ranges={"d": (1.0, 0.0)})
        with pytest.raises(ValueError, match="range"):
            ScenarioSpec("bad", ranges={"d": "not-a-range"})
        with pytest.raises(ValueError, match="physics_rate_us"):
            ScenarioSpec("bad", physics_rate_us=-1)
        with pytest.raises(ValueError, match="resolution"):
            ScenarioSpec("bad", resolution=(0, 4))
        with pytest.raises(ValueError, match="duplicate"):
            ScenarioCatalog([ScenarioSpec("x"), ScenarioSpec("x")])
        with pytest.raises(ValueError, match="unknown spec field"):
            ScenarioSpec.from_dict("x", {"rangs": {}})
        with pytest.raises(ValueError, match="not a scenario catalog"):
            ScenarioCatalog.from_json("{\"format\": \"other/1\"}")
        with pytest.raises(KeyError, match="unknown scenario"):
            two_scenarios().get("nope")

    def test_save_load_file(self, tmp_path):
        cat = two_scenarios()
        path = cat.save(str(tmp_path / "cat.json"))
        assert ScenarioCatalog.load(path).names() == cat.names()


def _rich_catalog(spec, catalog):
    return catalog([
        spec("lite", params={"scene": "empty"},
             ranges={"density": (0.1, 0.4), "texture": ["wood", "metal"]},
             physics_rate_us=200),
        spec("rich", params={"scene": "warehouse", "clutter": 3},
             ranges={"density": (0.6, 1.0)}, physics_rate_us=4000, resolution=(128, 128)),
        spec("free"),
    ])


@pytest.mark.parametrize("direction", ["torch->jax", "jax->torch"])
def test_catalog_files_cross_packages(tmp_path, direction):
    """A catalog saved by either package loads in the other: the same
    document, the same names in the same order, and the same seeded draws
    from every spec."""
    port = _rich_catalog(ScenarioSpec, ScenarioCatalog)
    ref = _rich_catalog(JScenarioSpec, JScenarioCatalog)
    src, loader = (port, JScenarioCatalog) if direction == "torch->jax" else (ref, ScenarioCatalog)
    assert port.to_json() == ref.to_json()
    path = src.save(str(tmp_path / "cat.json"))
    back = loader.load(path)
    assert back.names() == src.names() == ["lite", "rich", "free"]
    assert back.to_json() == src.to_json()
    for name in back.names():
        assert back.get(name).env_kwargs() == src.get(name).env_kwargs()
        for seed in range(5):
            assert (back.sample(name, np.random.default_rng(seed))
                    == src.sample(name, np.random.default_rng(seed)))


def test_seeded_sample_streams_equal_across_packages():
    """One generator drawing spec after spec gives the same dicts in both
    packages (the randomizer's draw sequence)."""
    port = _rich_catalog(ScenarioSpec, ScenarioCatalog)
    ref = _rich_catalog(JScenarioSpec, JScenarioCatalog)
    ga, gb = np.random.default_rng(123), np.random.default_rng(123)
    for k in range(30):
        name = ("lite", "rich", "free")[k % 3]
        assert port.sample(name, ga) == ref.sample(name, gb)


# -- curriculum -----------------------------------------------------------------------


class TestCurriculum:
    def test_apportion_deterministic_largest_remainder(self):
        assert apportion({"a": 0.5, "b": 0.5}, 3) == ["a", "a", "b"]
        assert apportion({"a": 2, "b": 1}, 3) == ["a", "a", "b"]
        assert apportion({"a": 1.0, "b": 0.0}, 2) == ["a", "a"]
        assert len(apportion({"a": 1, "b": 1, "c": 1}, 7)) == 7

    def test_prioritized_reweights_toward_hard_scenarios(self):
        ctr = EventCounters()
        cur = CurriculumScheduler(two_scenarios(), policy="prioritized", interval=2,
                                  floor=0.1, counters=ctr)
        stats = {"lite": {"rows": 50, "eligible": 50, "priority_mass": 5.0},
                 "rich": {"rows": 50, "eligible": 50, "priority_mass": 45.0}}
        mix = cur.update(stats)
        assert mix["rich"] > mix["lite"]
        assert mix["lite"] >= 0.1 - 1e-9
        assert abs(sum(mix.values()) - 1.0) < 1e-9
        assert ctr.get("scenario_curriculum_updates") == 1
        assert ctr.get("scenario_mix_changes") == 1
        assert cur.replay_mix() is not None
        assert cur.tick(lambda: stats) is None
        assert cur.tick(lambda: stats) is not None

    def test_uniform_policy_is_the_identity(self):
        cur = CurriculumScheduler(["a", "b"], policy="uniform", counters=EventCounters())
        assert cur.update() == {"a": 0.5, "b": 0.5}
        assert cur.replay_mix() is None

    def test_pin_switches_policy_and_validates(self):
        ctr = EventCounters()
        cur = CurriculumScheduler(["a", "b"], policy="uniform", counters=ctr)
        with pytest.raises(ValueError, match="unknown scenario"):
            cur.pin({"zzz": 1.0})
        cur.pin({"b": 1.0})
        assert cur.policy == "pinned"
        assert cur.update()["b"] == 1.0
        assert cur.assign(3) == ["b", "b", "b"]
        assert ctr.get("scenario_mix_changes") == 1

    def test_constructor_validation(self):
        with pytest.raises(ValueError, match="policy"):
            CurriculumScheduler(["a"], policy="nope")
        with pytest.raises(ValueError, match="floor"):
            CurriculumScheduler(["a", "b", "c"], floor=0.5)
        with pytest.raises(ValueError, match="at least one"):
            CurriculumScheduler([])


def test_apportion_equals_the_references():
    rng = np.random.default_rng(0)
    mixes = [{"a": 0.5, "b": 0.5}, {"a": 2, "b": 1}, {"a": 1.0, "b": 0.0},
             {"a": 1, "b": 1, "c": 1}, {"x": 0.0, "y": 0.0}]
    for _ in range(40):
        k = int(rng.integers(1, 6))
        mixes.append({f"s{i}": float(rng.random()) for i in range(k)})
    for mix in mixes:
        for n in (1, 2, 3, 5, 7, 16, 64):
            assert apportion(mix, n) == j_apportion(mix, n), (mix, n)


def _curriculum_pair(**kw):
    names = ["lite", "rich", "free"]
    return (CurriculumScheduler(names, policy="prioritized", counters=EventCounters(), **kw),
            JCurriculumScheduler(names, policy="prioritized", counters=EventCounters(), **kw))


@pytest.mark.parametrize("direction", ["torch->jax", "jax->torch"])
def test_curriculum_state_dict_loads_in_both_directions(direction):
    """A scheduler's state, cut mid-interval with a pinned mix and return
    EMAs, loads in the other package's scheduler, which then ticks and
    assigns as the source does."""
    port, ref = _curriculum_pair(interval=4, temperature=2.0, floor=0.05)
    src, dst = (port, ref) if direction == "torch->jax" else (ref, port)
    src.update({"lite": {"rows": 8, "eligible": 8, "priority_mass": 4.0},
                "rich": {"rows": 8, "eligible": 8, "priority_mass": 9.0}})
    src.observe_return("rich", 1.5)
    src.observe_return("rich", 0.5)
    src.observe_return("lite", -2.0)
    for _ in range(3):
        src.tick()
    src.pin({"lite": 0.7, "rich": 0.3})
    dst.load_state_dict(src.state_dict())
    assert dst.state_dict() == src.state_dict()
    assert dst.mix() == src.mix() and dst.assign(5) == src.assign(5)
    assert src.tick() == dst.tick()  # the due tick stays due across the cut
    assert dst.mix() == src.mix() == {"lite": 0.7, "rich": 0.3, "free": 0.0}
    with pytest.raises(ValueError, match="same catalog"):
        type(dst)(["other"]).load_state_dict(src.state_dict())


def _stamped_pair(n=96, prioritized=True, seed=0, capacity=128, healthy=None):
    """Both packages' buffers with the same stamped appends."""
    rng = np.random.default_rng(seed)
    port = ReplayBuffer(capacity, seed=seed, prioritized=prioritized, counters=EventCounters())
    ref = JReplayBuffer(capacity, seed=seed, prioritized=prioritized, counters=EventCounters())
    names = ("lite", "rich", "free")
    for i in range(n):
        tr = {"obs": rng.standard_normal(3).astype(np.float32),
              "reward": np.float32(rng.random())}
        scen = names[int(rng.integers(0, 3))] if i % 11 else None
        ok = True if healthy is None else healthy(i)
        for buf in (port, ref):
            buf.append(dict(tr), scenario=scen, healthy=ok)
    return port, ref


def test_prioritized_mix_sequence_equal_across_packages():
    """The same strata (both packages' buffers fed and refreshed alike)
    drive both prioritized schedulers through the same mixes, within 1e-12,
    tick after tick, and apportion the same fleets."""
    port_buf, ref_buf = _stamped_pair(healthy=lambda i: i % 13 != 4)
    port, ref = _curriculum_pair(interval=2, temperature=1.5, floor=0.05)
    rng = np.random.default_rng(7)
    changed = 0
    for _ in range(24):
        _, ia, _ = port_buf.sample(16)
        _, ib, _ = ref_buf.sample(16)
        np.testing.assert_array_equal(ia, ib)
        pri = rng.exponential(1.0, 16) * rng.choice([0.1, 5.0], 16)
        port_buf.update_priorities(ia, pri)
        ref_buf.update_priorities(ib, pri)
        sa, sb = port_buf.scenario_stats(), ref_buf.scenario_stats()
        assert sa.keys() == sb.keys()
        for name in sa:
            assert sa[name]["rows"] == sb[name]["rows"]
            assert sa[name]["eligible"] == sb[name]["eligible"]
            assert abs(sa[name]["priority_mass"] - sb[name]["priority_mass"]) <= MIX_ATOL
        ma, mb = port.tick(port_buf.scenario_stats), ref.tick(ref_buf.scenario_stats)
        assert (ma is None) == (mb is None)
        if ma is not None:
            changed += 1
            for name in ma:
                assert abs(ma[name] - mb[name]) <= MIX_ATOL, (name, ma, mb)
            assert port.assign(7) == ref.assign(7)
    assert changed == 12
    assert port.stats()["mix_changes"] == ref.stats()["mix_changes"] > 1


# -- randomizer (in-process duplex peers) ----------------------------------------------


class TestRandomizer:
    def test_push_round_trip_and_confirmation(self):
        from blendjax_torch.btb.duplex import DuplexChannel as ProducerDuplex

        addr = _addr()
        prod = ProducerDuplex(addr, btid=0)
        ctr = EventCounters()
        rnd = DomainRandomizer(two_scenarios(), [addr], counters=ctr)
        try:
            assert rnd.assign(0, "rich") == 1
            msg = prod.recv(timeoutms=5000)
            assert msg["cmd"] == "scenario" and msg["scenario"] == "rich"
            assert msg["params"]["physics_us"] == 2000
            assert 0.6 <= msg["params"]["density"] <= 1.0
            assert ctr.get("scenario_pushes") == 1 and ctr.get("scenario_samples") == 1
            assert rnd.assignments == ["rich"]
            rnd.note_info(0, {"scenario": "lite"})  # a stale echo confirms nothing
            assert ctr.get("scenario_applies") == 0
            rnd.note_info(0, {"scenario": "rich"})
            rnd.note_info(0, {"scenario": "rich"})  # counted once
            assert ctr.get("scenario_applies") == 1
            assert rnd.stats()["confirmed"] == [True]
        finally:
            prod.close()
            rnd.close()

    def test_apply_assignment_pushes_only_changes(self):
        from blendjax_torch.btb.duplex import DuplexChannel as ProducerDuplex

        addrs = [_addr() for _ in range(2)]
        prods = [ProducerDuplex(a, btid=i) for i, a in enumerate(addrs)]
        ctr = EventCounters()
        rnd = DomainRandomizer(two_scenarios(), [[addrs[0]], [addrs[1]]], counters=ctr)
        try:
            assert rnd.apply_assignment(["lite", "rich"]) == [0, 1]
            assert rnd.apply_assignment(["lite", "rich"]) == []
            assert ctr.get("scenario_pushes") == 2
            assert rnd.apply_assignment(["rich", "rich"]) == [0]
            assert prods[0].recv(timeoutms=5000)["scenario"] == "lite"
            assert prods[0].recv(timeoutms=5000)["scenario"] == "rich"
            with pytest.raises(ValueError, match="fleets"):
                rnd.apply_assignment(["lite"])
        finally:
            for p in prods:
                p.close()
            rnd.close()

    def test_dead_producer_push_is_bounded_not_wedged(self):
        ctr = EventCounters()
        rnd = DomainRandomizer(two_scenarios(), [_addr()], counters=ctr, push_timeout_ms=120)
        try:
            t0 = time.monotonic()
            for _ in range(16):  # well past the PAIR HWM (10)
                rnd.assign(0, "lite")
            elapsed = time.monotonic() - t0
            assert elapsed < 8.0, f"pushes wedged for {elapsed:.1f}s"
            assert ctr.get("scenario_push_failures") > 0
            snap = ctr.snapshot()
            assert snap["scenario_pushes"] + snap["scenario_push_failures"] == 16
        finally:
            rnd.close()

    def test_resample_every_and_reassign(self):
        from blendjax_torch.btb.duplex import DuplexChannel as ProducerDuplex

        addr = _addr()
        prod = ProducerDuplex(addr, btid=0)
        ctr = EventCounters()
        rnd = DomainRandomizer(two_scenarios(), [addr], counters=ctr, resample_every=3)
        try:
            assert not rnd.reassign(0, 0)  # a never-assigned fleet is left alone
            rnd.assign(0, "lite")
            assert [rnd.maybe_resample(0) for _ in range(6)] == [False, False, True] * 2
            got = [prod.recv(timeoutms=5000) for _ in range(3)]
            assert [m["scenario"] for m in got] == ["lite"] * 3
            assert len({m["params"]["density"] for m in got}) == 3  # fresh draws
            rnd.note_info(0, {"scenario": "lite"})
            assert rnd.reassign(0, 0)  # over the env's existing channel
            assert ctr.get("scenario_reassignments") == 1
            assert rnd.stats()["confirmed"] == [False]  # the respawn owes a confirmation
        finally:
            prod.close()
            rnd.close()


def test_randomizer_draws_equal_the_references():
    """The same seed and pushes send the same param dicts from both
    packages' randomizers (to the same kind of producer-side channel)."""
    from blendjax_torch.btb.duplex import DuplexChannel as ProducerDuplex

    sent = {}
    for label, cls in (("port", DomainRandomizer), ("ref", JDomainRandomizer)):
        addrs = [_addr() for _ in range(2)]
        prods = [ProducerDuplex(a, btid=i) for i, a in enumerate(addrs)]
        rnd = cls(two_scenarios(), [addrs], seed=5, resample_every=2, counters=EventCounters())
        try:
            rnd.assign(0, "rich")
            rnd.assign(0, "lite")
            rnd.maybe_resample(0)
            rnd.maybe_resample(0)
            sent[label] = [(m["cmd"], m["scenario"], m["params"])
                           for p in prods for m in (p.recv(timeoutms=5000) for _ in range(3))]
        finally:
            for p in prods:
                p.close()
            rnd.close()
    assert sent["port"] == sent["ref"]


@pytest.mark.parametrize("direction", ["port randomizer -> reference producer",
                                       "reference randomizer -> port producer"])
def test_randomizer_pushes_into_the_other_packages_producer(fake_blender, direction):
    """Each package's randomizer retimes and relabels the other's running
    echo producer: the pushed scenario and physics rate come back on the
    data plane, and the push is confirmed there."""
    port_pushes = direction.startswith("port")
    script = REF_ENV_SCRIPT if port_pushes else ENV_SCRIPT
    cls = DomainRandomizer if port_pushes else JDomainRandomizer
    cat = two_scenarios(fast_us=0, slow_us=700)
    ctr = EventCounters()
    with BlenderLauncher(scene="", script=script, num_instances=1, named_sockets=["GYM", "CTRL"],
                         start_port=_free_block(4), background=True,
                         instance_args=[["--horizon", "1000000", "--scenario", "lite"]]) as bl:
        with EnvPool(bl.launch_info.addresses["GYM"], timeoutms=30000) as pool:
            rnd = cls(cat, [bl.launch_info.addresses["CTRL"]], counters=ctr)
            try:
                pool.reset()
                _, _, _, infos = pool.step([0.5])
                assert infos[0]["scenario"] == "lite" and infos[0]["physics_us_now"] == 0
                assert rnd.assign(0, "rich") == 1
                seen = []

                def rich_back():
                    _, _, _, infos = pool.step([0.5])
                    rnd.note_info(0, infos[0])
                    seen.append(infos[0])
                    return infos[0].get("scenario") == "rich"

                _wait(rich_back, 30, "the pushed scenario on the data plane")
                assert seen[-1]["physics_us_now"] == 700
                assert ctr.get("scenario_applies") == 1
                assert ctr.get("scenario_pushes") == 1
            finally:
                rnd.close()


# -- replay strata --------------------------------------------------------------------


def _fill(buf, n=64, stamp=True):
    for i in range(n):
        buf.append({"obs": np.float32(i), "reward": np.float32(i % 7)},
                   scenario=("lite" if i % 2 == 0 else "rich") if stamp else None)


class TestReplayStrata:
    def test_stamps_never_perturb_the_draw_stream(self):
        a = ReplayBuffer(128, seed=3, counters=EventCounters())
        b = ReplayBuffer(128, seed=3, counters=EventCounters())
        _fill(a, stamp=False)
        _fill(b, stamp=True)
        for _ in range(8):
            _, ia, wa = a.sample(16)
            _, ib, wb = b.sample(16)
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(wa, wb)
        assert b.counters.get("scenario_rows_stamped") == 64

    def test_uniform_mix_is_byte_identical_to_no_mix(self):
        a = ReplayBuffer(128, seed=5, counters=EventCounters())
        b = ReplayBuffer(128, seed=5, counters=EventCounters())
        _fill(a), _fill(b)
        for _ in range(6):
            _, ia, wa = a.sample(16, scenario_mix=None)
            _, ib, wb = b.sample(16, scenario_mix={"lite": 0.5, "rich": 0.5})
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(wa, wb)
        assert b.counters.get("scenario_strata_draws") == 0

    def test_nonuniform_mix_shapes_the_draw(self):
        buf = ReplayBuffer(256, seed=1, counters=EventCounters())
        _fill(buf, n=128)
        _, idx, w = buf.sample(40, scenario_mix={"lite": 0.75, "rich": 0.25})
        assert (buf._scenario[idx] == buf._scenario_ids["lite"]).sum() == 30
        assert w.max() == pytest.approx(1.0)
        assert buf.counters.get("scenario_strata_draws") == 1
        _, idx2, _ = buf.sample(8, scenario_mix={"ghost": 1.0})
        assert idx2.shape == (8,)
        _, idx3, _ = buf.sample(8, scenario_mix={"rich": 1.0})
        assert (buf._scenario[idx3] == buf._scenario_ids["rich"]).all()

    def test_scenario_stats_and_stats_surface(self):
        buf = ReplayBuffer(64, seed=0, counters=EventCounters())
        _fill(buf, n=32)
        buf.append({"obs": np.float32(0), "reward": np.float32(0)})
        st = buf.scenario_stats()
        assert st["lite"]["rows"] == 16 and st["rich"]["rows"] == 16
        assert st["lite"]["eligible"] == 16 and st["lite"]["priority_mass"] > 0
        assert st["_unlabelled"]["rows"] == 1
        assert buf.stats()["scenarios"]["rich"]["rows"] == 16

    def test_unhealthy_rows_excluded_from_strata_eligibility(self):
        buf = ReplayBuffer(32, seed=0, counters=EventCounters())
        buf.append({"obs": np.float32(1)}, scenario="lite")
        buf.append({"obs": np.float32(2)}, scenario="lite", healthy=False)
        st = buf.scenario_stats()
        assert st["lite"]["rows"] == 2 and st["lite"]["eligible"] == 1

    def test_strata_draw_honors_drawable_mask_override(self):
        buf = _half_dead(ReplayBuffer)(64, seed=2, counters=EventCounters())
        _fill(buf, n=64)
        _, idx, _ = buf.sample(16, scenario_mix={"lite": 0.7, "rich": 0.3})
        assert (idx >= 32).all(), idx
        _, idx2, _ = buf.sample(16, scenario_mix={"lite": 0.5, "rich": 0.5})
        assert idx2.shape == (16,)

    def test_save_restore_preserves_stamps_and_stream(self, tmp_path):
        buf = ReplayBuffer(64, seed=11, counters=EventCounters())
        _fill(buf, n=48)
        path = str(tmp_path / "ck.npz")
        buf.save(path)
        back = ReplayBuffer.restore(path, counters=EventCounters())
        np.testing.assert_array_equal(back._scenario, buf._scenario)
        assert back._scenario_names == buf._scenario_names
        assert back.scenario_stats() == buf.scenario_stats()
        for mix in (None, {"lite": 0.8, "rich": 0.2}):
            _, i1, w1 = buf.sample(12, scenario_mix=mix)
            _, i2, w2 = back.sample(12, scenario_mix=mix)
            np.testing.assert_array_equal(i1, i2)
            np.testing.assert_array_equal(w1, w2)

    def test_btr_prefill_bit_identical_with_stamps(self, tmp_path):
        from blendjax_torch.btt.file import FileRecorder

        rng = np.random.default_rng(2)
        transitions = [{"obs": rng.standard_normal(3).astype(np.float32),
                        "reward": np.float32(i)} for i in range(40)]
        scen = ["lite" if i % 3 else "rich" for i in range(40)]
        path = str(tmp_path / "run_00.btr")
        with FileRecorder(path, max_messages=100) as rec:
            for tr, s in zip(transitions, scen):
                rec.save(transition_to_message(tr, healthy=True, scenario=s))
        direct = ReplayBuffer(64, seed=4, counters=EventCounters())
        for tr, s in zip(transitions, scen):
            direct.append(dict(tr), scenario=s)
        pre = ReplayBuffer(64, seed=4, counters=EventCounters())
        assert prefill_from_btr(pre, path) == 40
        np.testing.assert_array_equal(pre._scenario, direct._scenario)
        assert pre._scenario_names == direct._scenario_names
        for key, col in direct.store.state_arrays().items():
            np.testing.assert_array_equal(pre.store.state_arrays()[key], col, err_msg=key)
        for _ in range(4):
            _, i1, _ = direct.sample(8)
            _, i2, _ = pre.sample(8)
            np.testing.assert_array_equal(i1, i2)


def _half_dead(base):
    """A buffer whose first half of the ring is undrawable, as a dead shard
    owning it would make it."""

    class HalfDead(base):
        def _drawable_mask_locked(self):
            mask = self._valid.copy()
            mask[: self.capacity // 2] = False
            return mask

    return HalfDead


MIXES = [{"lite": 0.7, "rich": 0.3}, {"rich": 1.0}, {"lite": 0.2, "rich": 0.5, "free": 0.3},
         {"lite": 1.0, "ghost": 3.0}, {"free": 0.5, "rich": 0.5}, None,
         {"lite": 1 / 3, "rich": 1 / 3, "free": 1 / 3}]


def _assert_draws_equal(port, ref, rounds=12, batch=20, refresh=True, seed=3):
    """``rounds`` draws under each of :data:`MIXES` from both buffers, the
    sampled rows' priorities refreshed alike between draws: indices equal,
    IS weights within :data:`WEIGHT_ATOL`, the strata-draw counts equal."""
    rng = np.random.default_rng(seed)
    for r in range(rounds):
        mix = MIXES[r % len(MIXES)]
        da, ia, wa = port.sample(batch, scenario_mix=mix)
        db, ib, wb = ref.sample(batch, scenario_mix=mix)
        np.testing.assert_array_equal(ia, ib, err_msg=f"round {r}, mix {mix}")
        np.testing.assert_allclose(wa, wb, atol=WEIGHT_ATOL, rtol=0)
        np.testing.assert_array_equal(da["obs"], db["obs"])
        if refresh:
            pri = rng.exponential(1.0, batch)
            port.update_priorities(ia, pri)
            ref.update_priorities(ib, pri)
    assert (port.counters.get("scenario_strata_draws")
            == ref.counters.get("scenario_strata_draws") > 0)


@pytest.mark.parametrize("prioritized", [True, False])
def test_strata_draws_equal_the_reference_buffer(prioritized):
    port, ref = _stamped_pair(n=200, prioritized=prioritized,
                              healthy=lambda i: i % 9 != 5)  # wraps, with dead rows
    _assert_draws_equal(port, ref, refresh=prioritized)


def test_strata_draws_equal_the_reference_under_a_degraded_mask():
    port = _half_dead(ReplayBuffer)(128, seed=6, counters=EventCounters())
    ref = _half_dead(JReplayBuffer)(128, seed=6, counters=EventCounters())
    rng = np.random.default_rng(6)
    for i in range(150):
        tr = {"obs": rng.standard_normal(3).astype(np.float32), "reward": np.float32(i)}
        scen = ("lite", "rich", "free")[i % 3]
        port.append(dict(tr), scenario=scen)
        ref.append(dict(tr), scenario=scen)
    _assert_draws_equal(port, ref)
    _, idx, _ = port.sample(16, scenario_mix={"lite": 0.6, "rich": 0.4})
    assert (idx >= 64).all()


def _row(i):
    return {"obs": np.full(3, i, np.float32), "reward": np.float32(i % 5)}


def test_sharded_strata_draw_skips_quarantined_shards_and_journal():
    """Over shard services, a strata draw leaves out the rows of a
    quarantined shard and the rows held in the journal, as the base draw
    does, and draws the reference's ``ShardedReplay``'s indices under the
    same appends, quarantine and mix."""
    port_h = [start_shard_thread(16, shard_id=i) for i in range(4)]
    ref_h = [j_start_shard_thread(16, shard_id=i) for i in range(4)]
    names = ("lite", "rich", "free")
    try:
        a = ShardedReplay([h.address for h in port_h], seed=8, counters=EventCounters())
        b = JShardedReplay([h.address for h in ref_h], seed=8, counters=EventCounters())
        for buf in (a, b):
            for i in range(60):
                buf.append(_row(i), scenario=names[i % 3])
            buf.quarantine_shard(1, reason="test")
            for i in range(60, 100):  # the head wraps through shard 1's range
                buf.append(_row(i), scenario=names[i % 3])
        assert a.stats()["shards"]["journal_pending"] > 0
        pending = a._pending.copy()
        for mix in ({"lite": 0.6, "rich": 0.4}, {"rich": 1.0}, {"free": 0.3, "lite": 0.7}):
            for _ in range(4):
                da, ia, wa = a.sample(12, scenario_mix=mix)
                db, ib, wb = b.sample(12, scenario_mix=mix)
                np.testing.assert_array_equal(ia, ib)
                np.testing.assert_allclose(wa, wb, atol=WEIGHT_ATOL, rtol=0)
                np.testing.assert_array_equal(da["obs"], db["obs"])
                assert not ((ia >= 16) & (ia < 32)).any(), ia
                assert not pending[ia].any(), ia
        assert a.counters.get("scenario_strata_draws") == 12
        a.close()
        b.close()
    finally:
        for h in port_h + ref_h:
            h.close()


# -- heterogeneous fan-in -------------------------------------------------------------


def _seg_lists(t, n, d, fill=1.0, act_dtype=np.int32):
    return ([np.full((n, d), fill, np.float32) for _ in range(t)],
            [np.zeros((n,), act_dtype) for _ in range(t)],
            [np.full((n,), fill, np.float32) for _ in range(t)],
            [np.zeros((n,), bool) for _ in range(t)])


class TestHeteroFanIn:
    def _seg(self, fanin, fid, t, n, d, fill=1.0):
        ev = threading.Event()
        assert fanin.put_segment(fid, _seg_lists(t, n, d, fill), ev)
        return fanin.queues[fid].get_nowait()

    def test_mixed_obs_shapes_assemble_per_group(self):
        fanin = SegmentFanIn([2, 2], device="cpu")
        segs = {0: self._seg(fanin, 0, 4, 2, 3, fill=1.0),
                1: self._seg(fanin, 1, 4, 2, 5, fill=2.0)}
        b0, b1 = fanin.assemble_groups(segs)
        np.testing.assert_array_equal(b0.data["mask"], [1, 1, 0, 0])
        np.testing.assert_array_equal(b1.data["mask"], [0, 0, 1, 1])
        assert b0.data["obs"].shape == (4, 4, 3) and b1.data["obs"].shape == (4, 4, 5)
        assert (b0.data["obs"][:2] == 1.0).all() and (b0.data["obs"][2:] == 0.0).all()
        assert (b1.data["obs"][2:] == 2.0).all()
        b0.recycle(), b1.recycle()
        segs = {0: self._seg(fanin, 0, 4, 2, 3), 1: self._seg(fanin, 1, 4, 2, 3)}
        batches = fanin.assemble_groups(segs)
        assert len(batches) == 1
        np.testing.assert_array_equal(batches[0].data["mask"], [1, 1, 1, 1])
        batches[0].recycle()
        assert fanin.arena_pool.in_use == 0

    def test_collect_min_ready_returns_without_slow_fleets(self):
        fanin = SegmentFanIn([1, 1], device="cpu")
        ev = threading.Event()
        fanin.put_segment(0, _seg_lists(3, 1, 2, 0.0), ev)  # only fleet 0 produced
        t0 = time.monotonic()
        segs = fanin.collect(lambda f: True, ev, min_ready=1, deadline=time.monotonic() + 10)
        assert list(segs) == [0]
        assert time.monotonic() - t0 < 5.0
        fanin.recycle_segments(segs)


def test_assemble_groups_byte_equal_to_the_reference():
    """Three fleets in two shape groups (fleet sizes differ): both
    packages' ``assemble_groups`` give the same batches, leaf for leaf."""
    sizes = [2, 2, 1]
    port, ref = SegmentFanIn(sizes, device="cpu"), JSegmentFanIn(sizes, mesh=None)
    ev = threading.Event()
    rng = np.random.default_rng(4)
    for f, n in enumerate(sizes):
        lists = ([rng.standard_normal((n, 3)).astype(np.float32) for _ in range(5)],
                 [rng.integers(0, 2, n).astype(np.int32) for _ in range(5)],
                 [rng.random(n).astype(np.float32) for _ in range(5)],
                 [rng.random(n) < 0.2 for _ in range(5)])
        assert port.put_segment(f, lists, ev) and ref.put_segment(f, lists, ev)
    got = port.assemble_groups(port.collect(lambda f: True, ev))
    want = ref.assemble_groups(ref.collect(lambda f: True, ev))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.data.keys() == w.data.keys()
        for key in w.data:
            assert g.data[key].dtype == w.data[key].dtype, key
            np.testing.assert_array_equal(g.data[key], w.data[key], err_msg=key)
        g.recycle(), w.recycle()


def test_update_on_a_stamped_mixed_shape_batch_matches_the_reference():
    """Both learners over the same three stamped fleets (lite, lite, rich;
    sizes 2, 2, 1, so two shape groups): each group's batch from
    ``_next_fanin_batch`` is the same, its update's loss and gradients are
    within 1e-5 of the reference's, and the updates, the curriculum's
    return evidence and the per-scenario counts attribute alike."""
    import inspect

    sizes, t = [2, 2, 1], 6
    cat = two_scenarios()
    jcat = two_scenarios(spec=JScenarioSpec, catalog=JScenarioCatalog)
    learners = []
    for cls, rnd_cls, cur_cls, fanin, c in (
            (ActorLearner, DomainRandomizer, CurriculumScheduler,
             SegmentFanIn(sizes, device="cpu"), cat),
            (JActorLearner, JDomainRandomizer, JCurriculumScheduler,
             JSegmentFanIn(sizes, mesh=None), jcat)):
        rnd = rnd_cls(c, [[_addr()] * n for n in sizes], counters=EventCounters())
        rnd._assigned = ["lite", "lite", "rich"]
        cur = cur_cls(c, counters=EventCounters())
        kw = {"device": "cpu"} if cls is ActorLearner else {}
        al = cls([object()] * 3, 1, 2, rollout_len=t, seed=2, scenarios=rnd, curriculum=cur,
                 fanin_min_ready=1, **kw)
        al._fanin, al._threads = fanin, []
        learners.append(al)
    port, ref = learners
    tree = jax.device_get(ref.state.params)
    port.load_checkpoint_state(type(port.state).create(params_from_jax(tree, device="cpu"),
                                                       lr=3e-3), {})
    ev = threading.Event()
    rng = np.random.default_rng(9)
    for f, n in enumerate(sizes):
        lists = ([rng.standard_normal((n, 1)).astype(np.float32) for _ in range(t)],
                 [rng.integers(0, 2, n).astype(np.int32) for _ in range(t)],
                 [rng.random(n).astype(np.float32) for _ in range(t)],
                 [rng.random(n) < 0.2 for _ in range(t)])
        assert port._fanin.put_segment(f, lists, ev) and ref._fanin.put_segment(f, lists, ev)
    ref_loss = inspect.getclosurevars(ref._step.__wrapped__).nonlocals["loss_fn"]
    for group in range(2):
        got_batch, got_r = port._next_fanin_batch(None)
        want_batch, want_r = ref._next_fanin_batch(None)
        assert got_r == pytest.approx(want_r, abs=1e-7)
        assert port._last_update_fleets == ref._last_update_fleets == ((0, 1), (2,))[group]
        for key in want_batch:
            np.testing.assert_array_equal(got_batch[key].numpy(), np.asarray(want_batch[key]))
        want, ref_grads = jax.value_and_grad(ref_loss)(tree, want_batch)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params_from_jax(tree, device="cpu").items()}
        loss = port.loss_fn(params, {k: v.long() if v.dtype == torch.int32 else v
                                     for k, v in got_batch.items()})
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        assert abs(float(loss.detach()) - float(want)) <= LOSS_ATOL
        for g, r in zip(jax.tree.leaves(params_to_jax(grads)), jax.tree.leaves(ref_grads)):
            np.testing.assert_allclose(g, np.asarray(r), atol=LOSS_ATOL, rtol=0)
        port._note_update_scenarios()
        ref._note_update_scenarios()
    assert port.stats()["updates_by_scenario"] == ref.stats()["updates_by_scenario"] == {
        "lite": 2, "rich": 1}
    assert port.curriculum.stats()["returns_ema"] == pytest.approx(
        ref.curriculum.stats()["returns_ema"], abs=1e-7)
    assert port.stats()["scenario_assignments"] == ref.stats()["scenario_assignments"]
    for al in learners:
        al.randomizer.close()


# -- the acceptance run and the chaos drill -------------------------------------------


class TestScenarioTraining:
    def test_three_fleet_two_scenario_run_with_curriculum_shift(self, fake_blender):
        """Three fleets, two scenarios at different physics rates over a
        ``FleetSet(ctrl=True)``: both scenarios fill the replay strata, the
        pinned shift reassigns every fleet through the randomizer, each
        pushed scenario is confirmed on the data plane, and the update
        budget completes far below the slow scene's all-barrier time."""
        cat = two_scenarios(fast_us=0, slow_us=3000)
        values = np.array([0.0, 1.0], np.float64)
        ctr = EventCounters()
        with FleetSet("", ENV_SCRIPT, num_fleets=3, envs_per_fleet=1,
                      start_port=_free_block(12), port_stride=4, timeoutms=30000,
                      horizon=1_000_000, ctrl=True,
                      fleet_env_kwargs=[cat.get("lite").env_kwargs(),
                                        cat.get("lite").env_kwargs(),
                                        cat.get("rich").env_kwargs()]) as fs:
            assert len(fs.ctrl_addresses) == 3
            rnd = DomainRandomizer(cat, fs.ctrl_addresses, counters=ctr)
            cur = CurriculumScheduler(cat, policy="uniform", interval=4, counters=ctr)
            replay = ReplayBuffer(4096, seed=0, counters=EventCounters())
            al = ActorLearner(fs, obs_dim=1, num_actions=2, rollout_len=8, seed=1,
                              replay=replay, scenarios=rnd, curriculum=cur,
                              fanin_min_ready=1, device="cpu",
                              action_map=lambda a: list(values[np.asarray(a)]))
            t0 = time.monotonic()
            stats1 = al.run(num_updates=16, seconds=60)
            assert stats1["updates"] == 16
            assert stats1["scenario_assignments"] == ["lite", "lite", "rich"]
            assert stats1["env_steps_by_scenario"]["lite"] > 0
            assert stats1["env_steps_by_scenario"]["rich"] > 0
            strata = replay.scenario_stats()
            assert strata["lite"]["rows"] > 0 and strata["rich"]["rows"] > 0
            assert strata["lite"]["eligible"] > 0 and strata["rich"]["eligible"] > 0
            assert replay.counters.get("scenario_rows_stamped") == stats1["env_steps"]
            cur.pin({"rich": 1.0})
            stats2 = al.run(num_updates=12, seconds=60)
            elapsed = time.monotonic() - t0
            assert stats2["updates"] == 12
            assert stats2["scenario_assignments"] == ["rich", "rich", "rich"]
            assert stats2["updates_by_scenario"].get("rich", 0) > 0
            assert ctr.get("scenario_mix_changes") >= 1
            assert ctr.get("scenario_pushes") >= 2 + 3  # the bootstrap and the shift
            # every fleet's push confirmed by the echo on the data plane
            assert rnd.stats()["confirmed"] == [True, True, True]
            assert elapsed < 90, f"learner stalled: {elapsed:.1f}s"
            live = al.stats()
            assert "env_steps_by_scenario" in live and "scenario_mix" in live
            health = fs.health()
            assert health["num_fleets"] == 3 and health["healthy_envs"] == 3
            rnd.close()
        assert fs.pools == [] and fs.launchers == [] and fs.supervisors == []

    @pytest.mark.chaos
    @pytest.mark.parametrize("outage_pushes", [12, 0])
    def test_sigkill_producer_mid_push_reassigns_on_respawn(self, fake_blender, outage_pushes):
        """SIGKILL a producer, then push into it: every push returns within
        its bound; the supervisor respawns the producer, and its scenario
        is re-pushed and follows it back.  The randomizer's channel to the
        killed env is live before the kill (the learner's case), so ZMQ has
        reconnected it to the new incarnation by the re-admission: the
        re-push must reach the producer over it (a re-dialled channel
        would be dropped by the producer's one-peer PAIR socket).

        With no push during the outage (``outage_pushes=0``) nothing is
        queued for the new incarnation: it must come back at its launch
        scene and stay there until :meth:`reassign`, whose push alone then
        turns it to the assigned scene."""
        from blendjax_torch.btt.chaos import kill_instance
        from blendjax_torch.btt.faults import FaultPolicy
        from blendjax_torch.btt.supervise import FleetSupervisor

        cat = two_scenarios(fast_us=0, slow_us=500)
        ctr = EventCounters()
        policy = FaultPolicy(max_retries=1, backoff_base=0.05, deadline_s=2.0,
                             circuit_threshold=0, seed=7)
        with BlenderLauncher(scene="", script=ENV_SCRIPT, num_instances=2,
                             named_sockets=["GYM", "CTRL"], start_port=_free_block(8),
                             background=True,
                             instance_args=[["--horizon", "1000000", "--scenario", "lite"]] * 2
                             ) as bl:
            pool = EnvPool(bl.launch_info.addresses["GYM"], timeoutms=10000,
                           fault_policy=policy, counters=ctr)
            rnd = DomainRandomizer(cat, [bl.launch_info.addresses["CTRL"]], counters=ctr,
                                   push_timeout_ms=150)
            with FleetSupervisor(bl, pool=pool, interval=0.2, counters=ctr) as sup:
                pool.reset()
                rnd.assign(0, "rich")
                steps = {"lite": 0, "rich": 0, None: 0}

                def step_all():
                    _, _, _, infos = pool.step([0.5, 0.5])
                    for inf in infos:
                        sid = inf.get("scenario")
                        steps[sid] = steps.get(sid, 0) + 1
                    return infos

                def pushed_rich_applied():
                    infos = step_all()
                    for inf in infos:
                        rnd.note_info(0, inf)
                    return all(inf.get("scenario") == "rich" for inf in infos)

                _wait(pushed_rich_applied, 30, "the first push applied")
                kill_instance(bl, 0)
                t0 = time.monotonic()
                for _ in range(outage_pushes):
                    rnd.assign(0, "rich")
                push_elapsed = time.monotonic() - t0
                assert push_elapsed < 6.0, f"pushes wedged {push_elapsed:.1f}s"
                assert sup.await_deaths(1, timeout=30)
                assert sup.await_healthy(timeout=30)
                reassigned = []
                if not outage_pushes:
                    _wait(lambda: step_all()[0].get("readmitted"), 30, "env 0 re-admitted")
                    held = [step_all()[0].get("scenario") for _ in range(3)]
                    assert held == ["lite"] * 3, f"the respawn left its launch scene: {held}"
                    reassigned.append(rnd.reassign(0, 0))
                back = False
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    infos = step_all()
                    for i, inf in enumerate(infos):
                        if inf.get("readmitted"):
                            reassigned.append(rnd.reassign(0, i))
                        rnd.note_info(0, inf)
                    if infos[0].get("scenario") == "rich":
                        back = True
                        break
                assert back, "scenario never followed the respawn"
                assert reassigned and all(reassigned), reassigned
                assert ctr.get("scenario_reassignments") == len(reassigned)
                total = sum(steps.values())
                assert total > 0
                assert steps.get("lite", 0) + steps.get("rich", 0) + steps.get(None, 0) == total
            pool.close()
            rnd.close()


def test_fleetset_validates_its_arguments():
    with pytest.raises(ValueError, match=">= 1"):
        FleetSet("", ENV_SCRIPT, num_fleets=0, envs_per_fleet=2)
    with pytest.raises(ValueError, match="port_stride"):
        FleetSet("", ENV_SCRIPT, num_fleets=2, envs_per_fleet=30, ctrl=True)
    FleetSet("", ENV_SCRIPT, num_fleets=2, envs_per_fleet=30)  # fits without CTRL
    with pytest.raises(ValueError, match="fleet_env_kwargs"):
        FleetSet("", ENV_SCRIPT, num_fleets=2, envs_per_fleet=1, fleet_env_kwargs=[{}])


def test_plane_off_learner_is_the_plain_one(fake_blender):
    """With no scenario options the stats carry no scenario keys and the
    replay rows no stamps: the loop is the plain one."""
    values = np.array([0.0, 1.0], np.float64)
    with FleetSet("", ENV_SCRIPT, num_fleets=2, envs_per_fleet=1, start_port=_free_block(4),
                  port_stride=2, timeoutms=30000, horizon=1_000_000) as fs:
        assert fs.ctrl_addresses == []
        replay = ReplayBuffer(1024, seed=0, counters=EventCounters())
        al = ActorLearner(fs, obs_dim=1, num_actions=2, rollout_len=4, seed=1, replay=replay,
                          device="cpu", action_map=lambda a: list(values[np.asarray(a)]))
        st = al.run(num_updates=3, seconds=60)
    assert st["updates"] == 3 and st["num_fleets"] == 2
    assert not any(k.startswith(("scenario", "env_steps_by_scenario", "updates_by"))
                   for k in list(st) + list(al.stats()))
    assert replay.scenario_stats() == {}
    assert replay.counters.get("scenario_rows_stamped") == 0
