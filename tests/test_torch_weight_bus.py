"""The port's WeightBus (``blendjax_torch.weights.bus``) and the
``PolicyServer(subscriber=)`` hot-swap, on the CPU.

1. **The reference's cases** (``tests/test_weights.py``) against the port:
   a late joiner's full sync, then pushes and a rollback republish; the
   publisher's subscriber table evicting LRU; a multi-model server routing
   an unstamped snapshot to its subscriber's model and stamping each reply
   with the executing model's version; the publisher process SIGKILLed
   mid-snapshot, invisible to the served client (``python -m
   blendjax_torch.weights.bus``, every wait bounded).  Also its hot-swap
   case: a live episode's lease and position survive the swap.
2. **Across the packages**: the reference's ``WeightPublisher`` of JAX
   params feeds the port's subscriber and SeqFormer server, and the port's
   publisher of torch params (through ``params_to_jax``) feeds the
   reference's subscriber and server, float and int8: the served
   predictions within 1e-5 (absolute, plus 1e-5 relative) of the other
   package's server holding the same weights.  With ``quantize=`` the
   port's ``w_q`` and scales on the wire equal the reference's
   ``quantize_for_wire`` bit for bit (``np.array_equal``).
3. **The canary controller** (``blendjax_torch.weights.controller``): the
   reference's four cases (promotion after a healthy window, rollback on a
   p99 regression with the stable weights republished, the verdict
   timeout of a wedged canary, a respawned replica kept out of canary
   traffic until it has caught up), and both packages' controllers taking
   the same action at every tick over the same scripted stats.
"""

import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax.models import policy as jpol
from blendjax.models import seqformer as jseq
from blendjax_torch.btt.faults import FaultPolicy
from blendjax_torch.models.convert import params_from_jax, params_to_jax
from blendjax_torch.serve import LinearModel, SeqFormerModel, ServeClient, start_server_thread
from blendjax_torch.serve.client import ServeRPCError
from blendjax_torch.utils.timing import EventCounters, StageTimer
from blendjax_torch.weights import WeightPublisher, WeightSubscriber, linear_tree
from helpers import REPO_ROOT
from helpers.time_limit import time_limit
from test_torch_serve import _episodes, _run_episodes


def _weight_counts(counters):
    return {k: v for k, v in counters.snapshot().items() if k.startswith("weight_")}


def _wait(predicate, timeout=10.0, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def _poll_snapshot(sub, timeout=10.0, msg="a snapshot"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        snap = sub.poll()
        if snap is not None:
            return snap
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5, rtol=1e-5)


# -- the reference's cases -------------------------------------------------------------


def test_late_joiner_syncs_then_rides_pushes_and_rollback_republish():
    counters = EventCounters()
    with WeightPublisher(counters=counters, history=4).start() as pub:
        v1 = pub.publish(linear_tree(1, 4), step=1)
        sub = WeightSubscriber(pub.address, counters=counters)
        try:
            snap = _poll_snapshot(sub, msg="late-joiner sync")
            assert snap.version == v1
            np.testing.assert_array_equal(snap.tree()["w"], linear_tree(1, 4)["w"])
            v2 = pub.publish(linear_tree(2, 4), step=2)
            assert _poll_snapshot(sub, msg="pushed v2").version == v2
            v3 = pub.republish(v1)
            assert v3 > v2
            snap = _poll_snapshot(sub, msg="republished v1 weights")
            assert snap.version == v3
            np.testing.assert_array_equal(snap.tree()["w"], linear_tree(1, 4)["w"])
            counts = _weight_counts(counters)
            assert counts["weight_published"] == 3
            assert counts["weight_rollback_publishes"] == 1
            assert counts["weight_syncs"] >= 1
            _wait(lambda: v3 in pub.subscribers.values(), msg="ack of v3")
            with pytest.raises(KeyError, match="not in publisher"):
                pub.republish(999)
        finally:
            sub.close()


def test_publisher_lru_refreshes_live_subscribers(monkeypatch):
    from blendjax_torch.weights import bus as bus_mod

    monkeypatch.setattr(bus_mod, "SUBSCRIBER_CAP", 2)
    counters = EventCounters()
    with WeightPublisher(counters=counters).start() as pub:
        s1 = WeightSubscriber(pub.address, counters=counters)
        s2 = WeightSubscriber(pub.address, counters=counters)
        s3 = WeightSubscriber(pub.address, counters=counters)
        try:
            s1.request_sync()
            _wait(lambda: len(pub.subscribers) == 1, msg="s1 announced")
            s2.request_sync()
            _wait(lambda: len(pub.subscribers) == 2, msg="s2 announced")
            v1 = pub.publish(linear_tree(1, 4))
            assert _poll_snapshot(s1, msg="s1 at v1").version == v1
            _wait(lambda: v1 in pub.subscribers.values(), msg="s1's ack refreshed its entry")
            s3.request_sync()
            _wait(lambda: len(pub.subscribers) == 2, msg="cap held")
            assert v1 in pub.subscribers.values(), pub.subscribers
        finally:
            for s in (s1, s2, s3):
                s.close()


def test_hot_swap_preserves_leases_positions_and_stamps_version():
    counters, timer = EventCounters(), StageTimer()
    obs = np.arange(4, dtype=np.float32)
    w0 = np.random.default_rng(0).standard_normal((4, 4)).astype(np.float32)
    with WeightPublisher(counters=counters).start() as pub:
        h = start_server_thread(LinearModel(obs_dim=4, slots=4, seed=0), counters=counters,
                                timer=timer, subscriber=WeightSubscriber(pub.address))
        try:
            c = ServeClient(h.address)
            c.reset()
            slot, episode = c.slot, c.episode
            for k in range(3):
                r = c.step(obs)
                assert "weight_version" not in r
                np.testing.assert_allclose(r["pred"], obs @ w0 + np.float32(k), rtol=1e-5)
            assert c.weight_version is None
            v1 = pub.publish(linear_tree(101, 4))
            w1 = linear_tree(101, 4)["w"]
            seen = []
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                r = c.step(obs)
                seen.append(r)
                if r.get("weight_version") == v1:
                    break
            assert seen[-1].get("weight_version") == v1, "swap never observed"
            assert (c.slot, c.episode) == (slot, episode)
            for r in seen:
                w = w1 if r.get("weight_version") == v1 else w0
                np.testing.assert_allclose(r["pred"], obs @ w + np.float32(r["pos"]), rtol=1e-5)
            assert [r["pos"] for r in seen] == list(range(3, 3 + len(seen)))
            assert c.weight_version == v1
            assert c.telemetry()["weight_version"] == v1
            assert _weight_counts(counters)["weight_adopted"] == 1
            assert timer.summary()["weight_swap"]["count"] == 1
            h.close()
            c.policy = FaultPolicy(max_retries=0, circuit_threshold=0)
            c.state = c.policy.new_state()
            with pytest.raises(ServeRPCError, match=r"weights v\d+"):
                c.step(obs, timeout_ms=200)
            c.close()
        finally:
            h.close()


def test_multi_model_subscriber_targets_and_stamps_per_model():
    counters = EventCounters()
    obs = np.arange(4, dtype=np.float32)
    with WeightPublisher(counters=counters).start() as pub:
        with start_server_thread(
                {"a": LinearModel(obs_dim=4, slots=2, seed=0),
                 "b": LinearModel(obs_dim=4, slots=2, seed=7)},
                counters=counters, subscriber=WeightSubscriber(pub.address, model="b")) as h:
            ca = ServeClient(h.address, model="a")
            cb = ServeClient(h.address, model="b")
            try:
                ca.reset()
                cb.reset()
                v = pub.publish(linear_tree(11, 4))
                wb = linear_tree(11, 4)["w"]
                _wait(lambda: cb.step(obs).get("weight_version") == v,
                      msg="model b at the published version")
                rb = cb.step(obs)
                np.testing.assert_allclose(rb["pred"], obs @ wb + np.float32(rb["pos"]),
                                           rtol=1e-5)
                assert cb.weight_version == v
                ra = ca.step(obs)
                assert "weight_version" not in ra, ra
                assert ca.weight_version is None
                np.testing.assert_allclose(
                    ra["pred"], obs @ LinearModel(obs_dim=4, slots=2, seed=0).w
                    + np.float32(ra["pos"]), rtol=1e-5)
            finally:
                ca.close()
                cb.close()


def _spawn_publisher(address, *extra):
    from blendjax_torch.btt.launcher import child_env

    cmd = [sys.executable, "-m", "blendjax_torch.weights.bus", "--address", address,
           "--obs-dim", "4"] + list(extra)
    return subprocess.Popen(cmd, env=child_env(), cwd=REPO_ROOT, start_new_session=True)


@pytest.mark.chaos
def test_publisher_sigkill_mid_snapshot_is_invisible_to_clients():
    """SIGKILL the publisher process parked mid-snapshot: the server keeps
    serving the last good version with zero client-visible errors, the
    torn counter pins, and the respawned publisher's higher version is
    adopted.  Every wait is bounded (at most 20 s each)."""
    from blendjax_torch.replay.shard_client import free_port

    counters = EventCounters()
    addr = f"tcp://127.0.0.1:{free_port()}"
    obs = np.arange(4, dtype=np.float32)
    pub_proc = _spawn_publisher(addr, "--interval-ms", "100", "--publishes", "2",
                                "--version-base", "0", "--chunk-bytes", "16",
                                "--hold-at-version", "2", "--hold-after-chunks", "1",
                                "--wait-subscribers", "1")
    h = None
    pub2 = None
    errors = []
    try:
        h = start_server_thread(
            LinearModel(obs_dim=4, slots=4, seed=0), counters=counters,
            subscriber=WeightSubscriber(addr, counters=counters, stall_timeout_s=1.0))
        c = ServeClient(h.address)
        c.reset()

        def step():
            try:
                return c.step(obs)
            except Exception as exc:  # noqa: BLE001 - the subject
                errors.append(exc)
                raise

        _wait(lambda: step().get("weight_version") == 1, timeout=20, msg="v1 adoption")
        w1 = linear_tree(1, 4)["w"]
        _wait(lambda: _weight_counts(counters).get("weight_torn_discarded", 0) >= 1,
              timeout=15, msg="torn counter")
        r = step()
        assert r["weight_version"] == 1
        np.testing.assert_allclose(r["pred"], obs @ w1 + np.float32(r["pos"]), rtol=1e-5)
        pub_proc.kill()
        pub_proc.wait(timeout=10)
        for _ in range(10):
            assert step()["weight_version"] == 1
        pub2 = _spawn_publisher(addr, "--interval-ms", "200", "--version-base", "100")
        _wait(lambda: (step().get("weight_version") or 0) > 100, timeout=20,
              msg="the respawned publisher's snapshot adopted")
        r = step()
        v = r["weight_version"]
        np.testing.assert_allclose(r["pred"], obs @ linear_tree(v, 4)["w"]
                                   + np.float32(r["pos"]), rtol=1e-5)
        assert errors == []
        c.close()
    finally:
        for p in (pub_proc, pub2):
            if p is not None:
                p.kill()
                p.wait(timeout=10)
        if h is not None:
            h.close()


def test_publisher_process_imports_no_torch():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from blendjax_torch.weights import bus\n"
         "pub = bus.WeightPublisher()\n"
         "pub.publish(bus.linear_tree(1, 4))\n"
         "pub.close()\n"
         "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))\n"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# -- across the packages -----------------------------------------------------------------

SEQ = dict(obs_dim=5, d_model=32, n_heads=4, n_layers=2, max_len=32)


def _jax_tree(seed):
    return jax.device_get(jseq.init(jax.random.PRNGKey(seed), **SEQ))


def _adopted(server, version):
    return lambda: server.weight_version == version


@pytest.mark.parametrize("int8", [False, True])
def test_reference_publisher_feeds_the_port_server(int8):
    from blendjax.serve import SeqFormerModel as JSeqFormerModel
    from blendjax.serve import start_server_thread as j_start
    from blendjax.weights.bus import WeightPublisher as JWeightPublisher

    new_tree = _jax_tree(7)
    model = SeqFormerModel(params_from_jax(_jax_tree(0), device="cpu"), slots=2, length=16,
                           int8=int8)
    episodes = _episodes(6, (6, 4))
    with JWeightPublisher(quantize="seqformer" if int8 else None).start() as pub:
        with start_server_thread(model, subscriber=WeightSubscriber(pub.address)) as h:
            v = pub.publish(new_tree, step=3)
            _wait(_adopted(h.server, v), msg="the port server's adoption")
            got = _run_episodes(h.address, episodes)
    with j_start(JSeqFormerModel(jax.tree.map(jnp.asarray, new_tree), slots=2, length=16,
                                 int8=int8)) as h:
        want = _run_episodes(h.address, episodes)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("int8", [False, True])
def test_port_publisher_feeds_the_reference_server(int8):
    from blendjax.serve import SeqFormerModel as JSeqFormerModel
    from blendjax.serve import start_server_thread as j_start
    from blendjax.weights.bus import WeightSubscriber as JWeightSubscriber
    from blendjax_torch.models import seqformer as tseq

    params = tseq.init(torch.Generator().manual_seed(3), device="cpu", **SEQ)
    start = JSeqFormerModel(jax.tree.map(jnp.asarray, _jax_tree(0)), slots=2, length=16,
                            int8=int8)
    episodes = _episodes(8, (5, 6))
    with WeightPublisher(quantize="seqformer" if int8 else None).start() as pub:
        with j_start(start, subscriber=JWeightSubscriber(pub.address)) as h:
            v = pub.publish(params_to_jax(params), step=1)
            _wait(_adopted(h.server, v), msg="the reference server's adoption")
            got = _run_episodes(h.address, episodes)
    with start_server_thread(SeqFormerModel(params, slots=2, length=16, int8=int8)) as h:
        want = _run_episodes(h.address, episodes)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("kind", ["seqformer", "policy"])
def test_quantized_wire_equals_the_reference_quantizer(kind):
    """The port's publisher with ``quantize=`` puts on the wire what the
    reference's ``quantize_for_wire`` makes of the same params, bit for bit
    (``w_q`` in the reference's layout)."""
    from blendjax.ops.quant import quantize_for_wire as j_quantize_for_wire
    from blendjax.weights.bus import WeightSubscriber as JWeightSubscriber
    from blendjax.weights.snapshot import flatten_tree as j_flatten_tree

    if kind == "seqformer":
        tree = _jax_tree(5)
    else:
        tree = jax.device_get(jpol.init(jax.random.PRNGKey(5), 6, 3))
    want = j_flatten_tree(jax.device_get(j_quantize_for_wire(tree, kind)))
    with WeightPublisher(quantize=kind).start() as pub:
        sub = JWeightSubscriber(pub.address)
        try:
            pub.publish(tree)
            snap = _poll_snapshot(sub, msg="the quantized snapshot")
        finally:
            sub.close()
    assert set(snap.leaves) == set(want)
    assert any(path.endswith("w_q") for path in want)
    for path, arr in want.items():
        got = snap.leaves[path]
        assert got.dtype == arr.dtype and got.shape == arr.shape, path
        np.testing.assert_array_equal(got, arr, err_msg=path)


# -- the gateway's canary and the controller (the reference's cases) -------------------


def _episode(gw_address, obs_dim=4, steps=3, timeoutms=10000):
    """One fresh episode through the gateway: (replica, weight versions)."""
    c = ServeClient(gw_address, timeoutms=timeoutms)
    try:
        c.reset()
        obs = np.zeros(obs_dim, np.float32)
        vs = [c.step(obs).get("weight_version") for _ in range(steps)]
        c.close_episode()
        return c.replica, vs
    finally:
        c.close()


@time_limit(90)
def test_controller_promotes_after_healthy_window():
    """Both replicas subscribe; a new version opens a canary window, traffic
    accumulates its stats, and the healthy window promotes it."""
    from blendjax_torch.serve.gateway import start_gateway_thread
    from blendjax_torch.weights.controller import WeightBusController

    counters = EventCounters()
    with WeightPublisher(counters=counters).start() as pub:
        servers = [start_server_thread(LinearModel(obs_dim=4, slots=8, seed=0),
                                       counters=EventCounters(),
                                       subscriber=WeightSubscriber(pub.address,
                                                                   counters=counters))
                   for _ in range(2)]
        gw = start_gateway_thread([s.address for s in servers], counters=counters,
                                  scrape_interval_s=0.1)
        ctl = WeightBusController(gw.gateway, pub, fraction=0.5, healthy_window_s=0.4,
                                  min_requests=5)
        try:
            v1 = pub.publish(linear_tree(1, 4))
            _wait(lambda: set(gw.gateway.fleet_versions().values()) == {v1},
                  msg="fleet at v1")
            assert ctl.tick() is None
            assert gw.gateway.stable_version == v1  # bootstrap
            v2 = pub.publish(linear_tree(2, 4))
            _wait(lambda: set(gw.gateway.fleet_versions().values()) == {v2},
                  msg="fleet at v2")
            assert ctl.tick() == "canary"
            assert gw.gateway.canary_version == v2
            promoted = False
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                _episode(gw.address)
                if ctl.tick() == "promote":
                    promoted = True
                    break
            assert promoted, gw.gateway.version_stats()
            assert gw.gateway.stable_version == v2
            assert gw.gateway.canary_version is None
            snap = _weight_counts(counters)
            assert snap["weight_canary_starts"] >= 1
            assert snap["weight_canary_promotions"] == 1
            assert snap.get("weight_canary_rollbacks", 0) == 0
            assert snap.get("weight_canary_routes", 0) >= 1
        finally:
            gw.close()
            for s in servers:
                s.close()


@time_limit(120)
def test_controller_rolls_back_on_p99_regression_and_republishes():
    """The canary's replica is slow (``work_us``), its scraped p99 passes
    the limit, the canary is rolled back, fresh episodes avoid the rejected
    version, and the stable weights are republished under a fresh id."""
    from blendjax_torch.serve.gateway import start_gateway_thread
    from blendjax_torch.weights.controller import WeightBusController

    counters = EventCounters()
    with WeightPublisher(counters=counters, version_base=0).start() as pub_a, \
            WeightPublisher(version_base=10, counters=counters).start() as pub_b:
        s0 = start_server_thread(LinearModel(obs_dim=4, slots=8, seed=0),
                                 counters=EventCounters(),
                                 subscriber=WeightSubscriber(pub_a.address, counters=counters))
        s1 = start_server_thread(LinearModel(obs_dim=4, slots=8, seed=0, work_us=20000),
                                 counters=EventCounters(),
                                 subscriber=WeightSubscriber(pub_b.address, counters=counters))
        gw = start_gateway_thread([s0.address, s1.address], counters=counters,
                                  scrape_interval_s=0.1)
        ctl = WeightBusController(gw.gateway, pub_a, fraction=0.5, healthy_window_s=30.0,
                                  min_requests=5, max_p99_x=3.0)
        try:
            va = pub_a.publish(linear_tree(1, 4))
            vb = pub_b.publish(linear_tree(11, 4))
            _wait(lambda: sorted(v for v in gw.gateway.fleet_versions().values()
                                 if v is not None) == [va, vb], msg="mixed fleet")
            gw.gateway.set_stable(va)
            assert ctl.tick() == "canary"
            assert gw.gateway.canary_version == vb
            rolled = False
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                _episode(gw.address, timeoutms=20000)
                if ctl.tick() == "rollback":
                    rolled = True
                    break
            assert rolled, gw.gateway.version_stats()
            assert gw.gateway.rejected_version == vb
            snap = _weight_counts(counters)
            assert snap["weight_canary_rollbacks"] == 1
            assert snap["weight_rollback_publishes"] == 1
            assert gw.gateway.stable_version == pub_a.version > va
            for _ in range(4):
                rep, vs = _episode(gw.address)
                assert rep == "r0", (rep, vs)
                assert vb not in vs
        finally:
            gw.close()
            s0.close()
            s1.close()


class _GatewayStub:
    """The controller-facing slice of the gateway, deterministic: the test
    writes fleet versions and per-version stats, and the calls are kept."""

    def __init__(self):
        self.stable_version = None
        self.canary_version = None
        self.rejected_version = None
        self.versions = {}
        self.stats = {}
        self.calls = []

    def fleet_versions(self):
        return dict(self.versions)

    def version_stats(self):
        return {v: dict(r) for v, r in self.stats.items()}

    def set_stable(self, version):
        self.calls.append(("set_stable", version))
        self.stable_version = version

    def canary(self, version, fraction):
        self.calls.append(("canary", version, fraction))
        self.canary_version = version

    def promote(self):
        self.calls.append(("promote",))
        self.stable_version = self.canary_version
        self.canary_version = None

    def rollback(self):
        self.calls.append(("rollback",))
        self.rejected_version = self.canary_version
        self.canary_version = None


def test_controller_verdict_timeout_rolls_back_wedged_canary():
    """A canary that never replies is rolled back after the verdict
    timeout, but only if the fleet served enough traffic meanwhile; an idle
    fleet keeps the window open."""
    from blendjax_torch.weights.controller import WeightBusController

    gw = _GatewayStub()
    ctl = WeightBusController(gw, None, fraction=0.5, min_requests=10,
                              healthy_window_s=60.0, verdict_timeout_s=0.05)
    gw.versions = {"r0": 1, "r1": 1}
    gw.stats = {1: {"requests": 0, "errors": 0}}
    assert ctl.tick() is None and gw.stable_version == 1  # bootstrap
    gw.versions = {"r0": 2, "r1": 1}
    assert ctl.tick() == "canary" and gw.canary_version == 2
    _wait(lambda: time.monotonic() - ctl._canary_t0 > 0.05, msg="the verdict timeout")
    assert ctl.tick() is None  # idle fleet: nothing to judge by
    assert gw.canary_version == 2
    gw.stats[1]["requests"] = 100  # the stable side served, the canary never
    assert ctl.tick() == "rollback"
    assert gw.rejected_version == 2
    assert gw.canary_version is None


class _Republisher:
    def __init__(self):
        self.version = 40

    def republish(self, version):
        self.version += 1
        return self.version


def _controller_script(package):
    """One scripted run over a gateway stub: every tick's action and every
    call the controller made."""
    if package == "port":
        from blendjax_torch.weights.controller import WeightBusController
    else:
        from blendjax.weights.controller import WeightBusController

    gw = _GatewayStub()
    ctl = WeightBusController(gw, _Republisher(), fraction=0.25, min_requests=4,
                              healthy_window_s=0.0, max_error_rate=0.1, max_p99_x=2.0,
                              verdict_timeout_s=3600.0)
    actions = []
    steps = [
        ({"r0": None}, {}),                                    # no version yet
        ({"r0": 1, "r1": 1}, {1: (10, 0, 5.0)}),               # bootstrap stable
        ({"r0": 2, "r1": 1}, {1: (10, 0, 5.0)}),               # canary v2
        ({"r0": 2, "r1": 1}, {1: (20, 0, 5.0), 2: (2, 0, 5.0)}),   # too few
        ({"r0": 2, "r1": 1}, {1: (20, 0, 5.0), 2: (8, 0, 6.0)}),   # promote
        ({"r0": 3, "r1": 2}, {2: (8, 0, 6.0)}),                # canary v3
        ({"r0": 3, "r1": 2}, {2: (9, 0, 6.0), 3: (9, 3, 6.0)}),    # errors: rollback
        ({"r0": 41, "r1": 41}, {2: (9, 0, 6.0), 3: (9, 3, 6.0)}),  # republished
        ({"r0": 42, "r1": 41}, {41: (5, 0, 4.0)}),             # canary v42
        ({"r0": 43, "r1": 41}, {41: (5, 0, 4.0)}),             # superseded: v43
        ({"r0": 43, "r1": 41}, {41: (9, 0, 4.0), 43: (9, 0, 20.0)}),  # p99: rollback
    ]
    for versions, stats in steps:
        gw.versions = versions
        gw.stats = {v: {"requests": r, "errors": e, "p50_ms": p / 2, "p99_ms": p}
                    for v, (r, e, p) in stats.items()}
        actions.append(ctl.tick())
    return actions, gw.calls


def test_controller_takes_the_reference_actions_on_scripted_stats():
    """Both packages' ``WeightBusController`` take the same action at every
    tick, and make the same gateway calls, over the same scripted fleet
    versions and per-version stats."""
    port, ref = _controller_script("port"), _controller_script("reference")
    assert port == ref
    assert port[0] == [None, None, "canary", None, "promote", "canary", "rollback",
                       None, "canary", "canary", "rollback"]


@pytest.mark.chaos
@time_limit(150)
def test_respawned_replica_catches_up_before_canary_readmission():
    """Kill one subscribed replica process of two: the watchdog respawns it
    and the gateway re-admits it, but while a canary window is open no
    fresh episode reaches it until a scrape shows it caught up (the bus is
    silenced to hold it behind)."""
    from blendjax_torch.btt.chaos import kill_instance
    from blendjax_torch.btt.watchdog import FleetWatchdog
    from blendjax_torch.serve import ServerFleet
    from blendjax_torch.serve.gateway import start_gateway_thread

    counters = EventCounters()
    pub = WeightPublisher(counters=counters).start()
    with ServerFleet(2, model="linear", obs_dim=4, slots=8, subscribe=pub.address,
                     device="cpu") as fleet:
        gw = start_gateway_thread(fleet.addresses, counters=counters, scrape_interval_s=0.15)
        wd = FleetWatchdog(fleet, interval=0.2, restart=True,
                           on_death=gw.gateway.notify_replica_death,
                           on_respawn=gw.gateway.notify_replica_respawn)
        try:
            with wd:
                v1 = pub.publish(linear_tree(1, 4))
                _wait(lambda: set(gw.gateway.fleet_versions().values()) == {v1},
                      timeout=30, msg="fleet at v1")
                gw.gateway.set_stable(v1)
                v2 = pub.publish(linear_tree(2, 4))
                _wait(lambda: set(gw.gateway.fleet_versions().values()) == {v2},
                      timeout=30, msg="fleet at v2")
                gw.gateway.canary(v2, fraction=0.5)
                pub.stop()
                kill_instance(fleet, 1)
                _wait(lambda: counters.get("gateway_replica_respawns") >= 1, timeout=30,
                      msg="respawn re-admission")
                _wait(lambda: gw.gateway.fleet_versions().get("r1", "missing") is None,
                      timeout=20, msg="respawned replica reports no version")
                for _ in range(6):
                    rep, vs = _episode(gw.address)
                    assert rep == "r0", (rep, vs)
                    assert set(vs) == {v2}
                pub.start()
                _wait(lambda: gw.gateway.fleet_versions().get("r1") == v2, timeout=30,
                      msg="r1 caught up")
                reps = set()
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline and "r1" not in reps:
                    rep, vs = _episode(gw.address)
                    assert set(vs) == {v2}
                    reps.add(rep)
                assert "r1" in reps, "caught-up replica never rejoined"
        finally:
            gw.close()
            pub.close()
