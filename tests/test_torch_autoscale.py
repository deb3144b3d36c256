"""The port's autoscaler (``blendjax_torch.autoscale``) on the CPU, held to
``tests/test_autoscale.py`` and to the reference's controller.

1. **The reference's cases** against the port: the idempotent drain and
   its actionable errors, a drain under load with no client-visible error
   and re-admission, the controller's hysteresis band and counted holds,
   the client's bounded and jittered front-fallback backoff, the 2 -> 4 ->
   2 resize under traffic, SIGKILL of the draining replica, a restarted
   controller adopting an in-flight drain, and the watchdog's respawn
   jitter.  The reference's ``slow`` marks stay as they are.  The replay
   reshard cases are in ``tests/test_torch_replay_service.py``.  Not
   ported: the three bench cases, which run the reference's
   ``benchmarks/`` and ``bench.py``.
2. **Across the packages**: the port's ``AutoscaleController`` and the
   reference's take the same action at every tick over the same scripted
   gateway snapshots (the reference's ``_FakeGateway``), holds, scale-ups
   with their verdicts, drains, adoptions and rollbacks alike, with equal
   counters.

Every replica runs ``device="cpu"``; every live test waits on conditions
and runs under its own time limit.
"""

import threading
import time

import numpy as np
import pytest

from blendjax_torch.utils.timing import EventCounters, StageTimer
from helpers.time_limit import time_limit


class _Traffic:
    """Steady background episode traffic against a gateway, counting
    requests and client-visible errors (the zero-error contract every
    resize is held to)."""

    def __init__(self, address, n_clients=2, episode_len=4):
        self.address = address
        self.n_clients = int(n_clients)
        self.episode_len = int(episode_len)
        self.requests = 0
        self.errors = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = []

    def _run(self, i):
        from blendjax_torch.serve import ServeClient

        obs = np.arange(4, dtype=np.float32)
        c = ServeClient(self.address, timeoutms=10000)
        try:
            while not self._stop.is_set():
                try:
                    c.reset()
                    n = 1
                    for _ in range(self.episode_len):
                        c.step(obs)
                        n += 1
                    c.close_episode()
                    n += 1
                    with self._lock:
                        self.requests += n
                except Exception:  # noqa: BLE001 - the thing we count
                    with self._lock:
                        self.errors += 1
                    time.sleep(0.05)
        finally:
            c.close()

    def counts(self):
        with self._lock:
            return self.requests, self.errors

    def wait_flowing(self, timeout=30.0):
        """Block until every client has finished at least one episode."""
        need = self.n_clients * (self.episode_len + 2)
        deadline = time.monotonic() + timeout
        while self.counts()[0] < need:
            assert time.monotonic() < deadline, "traffic never flowed"
            time.sleep(0.02)

    def __enter__(self):
        for i in range(self.n_clients):
            t = threading.Thread(target=self._run, args=(i,), daemon=True,
                                 name=f"bjx-ast-client{i}")
            t.start()
            self._threads.append(t)
        self.wait_flowing()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=15)
        return False


def _drive(ctl, until, deadline_s=60.0, interval_s=0.05):
    """Tick ``ctl`` until it reports an action in ``until``."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        action = ctl.tick()
        if action in until:
            return action
        time.sleep(interval_s)
    raise TimeoutError(f"controller never reached {until}")


def _down_controller(gw, fleet, counters, *, min_replicas, window_s=0.5,
                     drain_grace_s=20.0):
    """A controller whose thresholds always want down (and never up)."""
    from blendjax_torch.autoscale import AutoscaleController

    return AutoscaleController(
        gw.gateway, fleet, min_replicas=min_replicas, max_replicas=8,
        up_queue_depth=1e9, up_p99_ms=1e9, down_queue_depth=1e9, down_p99_ms=1e9,
        cooldown_up_s=0.0, cooldown_down_s=0.0, healthy_window_s=window_s,
        min_requests=5, drain_grace_s=drain_grace_s, counters=counters,
        timer=StageTimer())


def _wait(cond, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {msg}"
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# drain lifecycle
# ---------------------------------------------------------------------------


@time_limit(60)
def test_drain_idempotent_and_unknown_replica_actionable():
    from blendjax_torch.serve import LinearModel, start_server_thread
    from blendjax_torch.serve.gateway import start_gateway_thread

    handles = [start_server_thread(LinearModel(obs_dim=4, slots=4, seed=s),
                                   counters=EventCounters()) for s in (0, 1)]
    counters = EventCounters()
    try:
        with start_gateway_thread([h.address for h in handles], counters=counters,
                                  scrape_interval_s=0.2) as gw:
            assert gw.gateway.drain("r0") is True
            assert gw.gateway.drain("r0") is False  # idempotent
            assert counters.get("gateway_drains") == 1
            assert gw.gateway.undrain("r0") is True
            assert gw.gateway.undrain("r0") is False
            with pytest.raises(KeyError, match="r0"):
                gw.gateway.drain("r9")
            with pytest.raises(KeyError, match="r9"):
                gw.gateway.undrain("r9")
    finally:
        for h in handles:
            h.close()


@pytest.mark.chaos
@time_limit(120)
def test_drain_under_load_zero_client_errors_and_readmission():
    from blendjax_torch.serve import ServeClient, ServerFleet
    from blendjax_torch.serve.gateway import start_gateway_thread

    counters = EventCounters()
    obs = np.arange(4, dtype=np.float32)
    with ServerFleet(3, model="linear", obs_dim=4, slots=16, device="cpu") as fleet:
        with start_gateway_thread(fleet.addresses, counters=counters,
                                  scrape_interval_s=0.1) as gw:
            with _Traffic(gw.address, n_clients=3) as traffic:
                live = ServeClient(gw.address, timeoutms=10000)
                live.reset()
                live.step(obs)
                victim = live.replica
                assert gw.gateway.drain(victim) is True
                probes = []
                for _ in range(8):
                    p = ServeClient(gw.address, timeoutms=10000)
                    p.reset()
                    assert p.replica != victim
                    probes.append(p)
                for _ in range(3):
                    assert live.step(obs)["replica"] == victim
                live.close_episode()
                _wait(lambda: gw.gateway.lease_count(victim) == 0, msg="victim drained")
                assert gw.gateway.undrain(victim) is True
                back = False
                deadline = time.monotonic() + 20
                while not back and time.monotonic() < deadline:
                    p = ServeClient(gw.address, timeoutms=10000)
                    p.reset()
                    back = p.replica == victim
                    probes.append(p)
                assert back, "undrained replica never routed again"
                for p in probes:
                    p.close_episode()
                    p.close()
                live.close()
            requests, errors = traffic.counts()
            assert errors == 0, f"{errors} client-visible errors"
            assert requests > 0


# ---------------------------------------------------------------------------
# controller decision rules (no processes: a scripted scrape surface)
# ---------------------------------------------------------------------------


class _FakeGateway:
    """The scrape surface the controller reads, and the calls it makes,
    recorded (the reference's stub, plus the actions)."""

    def __init__(self, snaps, counters):
        self.snaps = snaps
        self.counters = counters
        self.calls = []
        self.leases = {}

    def replica_snapshots(self):
        return {k: dict(v) for k, v in self.snaps.items()}

    def add_replica(self, address, rid=None):
        self.calls.append(("add", rid))
        self.snaps[rid] = _snap()
        return rid

    def remove_replica(self, rid):
        self.calls.append(("remove", rid))
        self.snaps.pop(rid, None)

    def drain(self, rid):
        self.calls.append(("drain", rid))
        self.snaps[rid]["draining"] = True
        return True

    def undrain(self, rid):
        self.calls.append(("undrain", rid))
        self.snaps[rid]["draining"] = False
        return True

    def lease_count(self, rid):
        return self.leases.get(rid, 0)


class _FakeFleet:
    def __init__(self, n):
        self.n = n
        self.calls = []

    def grow(self, n=1):
        idx = self.n
        self.n += 1
        self.calls.append(("grow", idx))
        return [(idx, f"tcp://127.0.0.1:{30000 + idx}")]

    def retire(self, idx):
        self.calls.append(("retire", idx))
        return True


def _snap(queued=0.0, p99=1.0, draining=False, healthy=True, live=0):
    return {"healthy": healthy, "draining": draining, "queued": queued,
            "p99_ms": p99, "live_episodes": live}


def test_controller_hysteresis_band_and_bound_holds():
    from blendjax_torch.autoscale import AutoscaleController

    snaps = {"r0": _snap(queued=4.0), "r1": _snap(queued=4.0)}
    counters = EventCounters()
    gw = _FakeGateway(snaps, counters)
    ctl = AutoscaleController(gw, fleet=None, min_replicas=2, max_replicas=2,
                              up_queue_depth=8.0, down_queue_depth=1.0,
                              up_p99_ms=200.0, down_p99_ms=50.0,
                              counters=counters, timer=StageTimer())
    assert ctl.tick() is None  # inside the band
    assert counters.get("autoscale_holds") == 0
    snaps["r0"] = _snap(queued=20.0)
    snaps["r1"] = _snap(queued=20.0)
    assert ctl.tick() == "hold"  # at max_replicas
    snaps["r0"] = _snap(queued=0.0, p99=0.5)
    snaps["r1"] = _snap(queued=0.0, p99=0.5)
    assert ctl.tick() == "hold"  # at min_replicas
    ctl.min_replicas = 1
    ctl._cooldown_until["down"] = time.monotonic() + 60
    assert ctl.tick() == "hold"  # inside the down cooldown
    assert counters.get("autoscale_holds") == 3
    assert counters.get("autoscale_ticks") == 4
    snaps["r1"] = _snap(queued=0.0, draining=True)
    assert ctl._active(gw.replica_snapshots()).keys() == {"r0"}


def test_client_fallback_backoff_is_bounded_and_jittered():
    from blendjax_torch.serve import ServeClient

    c = ServeClient("tcp://127.0.0.1:9", timeoutms=100, fallback_backoff_s=0.1,
                    fallback_backoff_max_s=0.8)
    assert c._fallback_delay() == 0.0  # no failures yet
    for failures, raw in ((1, 0.1), (2, 0.2), (3, 0.4), (4, 0.8), (10, 0.8)):
        c._fallback_failures = failures
        delays = [c._fallback_delay() for _ in range(50)]
        assert all(0.5 * raw <= d <= raw for d in delays), (failures, raw)
    assert len({round(d, 6) for d in delays}) > 1  # jittered
    c._fallback_failures = 0
    assert c._fallback_delay() == 0.0


def _script(package):
    """One scripted run of a controller over a fake gateway and fleet:
    the action at every tick, the calls it made, and its counters."""
    if package == "port":
        from blendjax_torch.autoscale import AutoscaleController
        from blendjax_torch.utils.timing import EventCounters as Counters
    else:
        from blendjax.autoscale import AutoscaleController
        from blendjax.utils.timing import EventCounters as Counters

    counters = Counters()
    snaps = {"r0": _snap(queued=4.0), "r1": _snap(queued=4.0)}
    gw = _FakeGateway(snaps, counters)
    fleet = _FakeFleet(2)
    ctl = AutoscaleController(gw, fleet, min_replicas=1, max_replicas=3,
                              up_queue_depth=8.0, down_queue_depth=1.0,
                              up_p99_ms=200.0, down_p99_ms=50.0,
                              cooldown_up_s=0.0, cooldown_down_s=0.0,
                              healthy_window_s=0.0, min_requests=2,
                              max_error_rate=0.1, max_p99_x=2.0,
                              drain_grace_s=0.0, counters=counters)
    actions = []

    def tick():
        actions.append(ctl.tick())

    tick()                                       # in the band
    for r in ("r0", "r1"):
        snaps[r] = _snap(queued=20.0, p99=10.0)
    tick()                                       # grow r2
    snaps["r2"] = _snap(queued=20.0, p99=10.0)
    tick()                                       # verdict: committed
    tick()                                       # at max: hold
    for r in ("r0", "r1", "r2"):
        snaps[r] = _snap(queued=20.0, p99=10.0)
    ctl.max_replicas = 4
    tick()                                       # grow r3
    snaps["r3"] = _snap(queued=0.0, p99=500.0)
    tick()                                       # newcomer p99 > 2x: rollback
    for r in list(snaps):
        snaps[r] = _snap(queued=0.0, p99=1.0, live=int(r[1:]))
    gw.leases = {"r0": 1}
    tick()                                       # drain the least loaded (r0)
    tick()                                       # its lease outlives the grace: rollback
    gw.leases = {}
    tick()                                       # drain r0 again
    tick()                                       # drained: verify stage
    tick()                                       # verified: retire
    snaps["r1"]["draining"] = True
    ctl2 = type(ctl)(gw, fleet, min_replicas=1, healthy_window_s=0.0,
                     drain_grace_s=5.0, counters=counters)
    actions.append(ctl2.tick())                  # a restarted controller adopts
    actions.append(ctl2.tick())
    actions.append(ctl2.tick())
    keys = ("autoscale_ticks", "autoscale_holds", "autoscale_scale_ups",
            "autoscale_scale_downs", "autoscale_rollbacks", "autoscale_drain_timeouts",
            "autoscale_replica_spawns", "autoscale_replicas_retired",
            "autoscale_adoptions")
    return actions, gw.calls, fleet.calls, {k: counters.get(k) for k in keys}


def test_controller_takes_the_reference_actions_on_scripted_snapshots():
    """Both packages' controllers, over the same scripted snapshots, take
    the same action at every tick, make the same gateway and fleet calls,
    and count the same."""
    port, ref = _script("port"), _script("reference")
    assert port == ref
    actions = port[0]
    assert actions[:6] == [None, "grow", "scale_up", "hold", "grow", "rollback"]
    assert "adopt" in actions and "scale_down" in actions


# ---------------------------------------------------------------------------
# serve-tier acceptance: 2 -> 4 -> 2 under live traffic
# ---------------------------------------------------------------------------


@pytest.mark.chaos
@pytest.mark.slow  # process-heavy, as the reference's
@time_limit(240)
def test_serve_scale_up_down_acceptance_zero_client_errors():
    from blendjax_torch.autoscale import AutoscaleController
    from blendjax_torch.btt.shm_rpc import leaked_objects
    from blendjax_torch.serve import ServerFleet
    from blendjax_torch.serve.gateway import start_gateway_thread

    counters = EventCounters()
    with ServerFleet(2, model="linear", obs_dim=4, slots=16, device="cpu") as fleet:
        with start_gateway_thread(fleet.addresses, counters=counters,
                                  scrape_interval_s=0.1) as gw:
            with _Traffic(gw.address, n_clients=3) as traffic:
                up = AutoscaleController(
                    gw.gateway, fleet, min_replicas=2, max_replicas=4,
                    up_queue_depth=-1.0, cooldown_up_s=0.0, cooldown_down_s=0.0,
                    healthy_window_s=1.0, min_requests=5, max_p99_x=1e9,
                    counters=counters, timer=StageTimer())
                for _ in range(2):
                    assert _drive(up, {"grow"}) == "grow"
                    assert _drive(up, {"scale_up", "rollback"}) == "scale_up"
                assert len(gw.gateway.replica_ids()) == 4
                down = _down_controller(gw, fleet, counters, min_replicas=2, window_s=0.4)
                for _ in range(2):
                    assert _drive(down, {"drain"}) == "drain"
                    assert _drive(down, {"scale_down", "rollback"}) == "scale_down"
                assert down.tick() == "hold"  # the min_replicas floor
            _, errors = traffic.counts()
            assert errors == 0, f"{errors} client-visible errors"
            assert len(gw.gateway.replica_ids()) == 2
            assert counters.get("autoscale_scale_ups") == 2
            assert counters.get("autoscale_scale_downs") == 2
            assert counters.get("autoscale_replica_spawns") == 2
            assert counters.get("autoscale_replicas_retired") == 2
            assert counters.get("autoscale_rollbacks") == 0
            assert counters.get("gateway_drains") == 2
        assert sum(1 for p in fleet._procs if p is None) == 2
        with pytest.raises(RuntimeError, match="retired"):
            fleet.respawn(next(i for i, p in enumerate(fleet._procs) if p is None))
    for p in fleet._procs:
        if p is not None and p.shm_base is not None:
            assert not leaked_objects(p.shm_base)


# ---------------------------------------------------------------------------
# chaos drills: the draining replica, the controller
# ---------------------------------------------------------------------------


@pytest.mark.chaos
@pytest.mark.slow  # process-heavy, as the reference's
@time_limit(240)
def test_kill_replica_mid_drain_scale_down_still_completes():
    from blendjax_torch.btt.chaos import kill_instance
    from blendjax_torch.btt.watchdog import FleetWatchdog
    from blendjax_torch.serve import ServeClient, ServerFleet
    from blendjax_torch.serve.gateway import start_gateway_thread

    counters = EventCounters()
    obs = np.arange(4, dtype=np.float32)
    with ServerFleet(3, model="linear", obs_dim=4, slots=16, device="cpu") as fleet:
        gw = start_gateway_thread(fleet.addresses, counters=counters, scrape_interval_s=0.1)
        wd = FleetWatchdog(fleet, interval=0.15, restart=True,
                           on_death=gw.gateway.notify_replica_death,
                           on_respawn=gw.gateway.notify_replica_respawn, counters=counters)
        try:
            with wd, _Traffic(gw.address, n_clients=2) as traffic:
                # one lease on every replica, so whichever victim the
                # controller picks is mid-drain
                pinned, seen = [], set()
                deadline = time.monotonic() + 20
                while len(seen) < 3 and time.monotonic() < deadline:
                    c = ServeClient(gw.address, timeoutms=10000)
                    c.reset()
                    c.step(obs)
                    pinned.append(c)
                    seen.add(c.replica)
                assert len(seen) == 3
                ctl = _down_controller(gw, fleet, counters, min_replicas=2)
                assert _drive(ctl, {"drain"}) == "drain"
                victim = ctl._transition["rid"]
                assert gw.gateway.lease_count(victim) >= 1
                kill_instance(fleet, int(victim[1:]))

                def readmitted():
                    rec = gw.gateway.replica_snapshots().get(victim)
                    return (counters.get("gateway_replica_respawns") >= 1
                            and rec is not None and rec["healthy"])

                _wait(readmitted, timeout=30, msg="victim respawned and re-admitted")
                assert gw.gateway.replica_snapshots()[victim]["draining"] is True
                assert gw.gateway.lease_count(victim) == 0
                assert _drive(ctl, {"scale_down", "rollback"}) == "scale_down"
                assert victim not in gw.gateway.replica_ids()
                assert fleet._procs[int(victim[1:])] is None
                assert counters.get("gateway_drains") == 1  # no re-issue
                assert counters.get("autoscale_scale_downs") == 1
                assert counters.get("autoscale_replicas_retired") == 1
                assert counters.get("watchdog_backoff_jitter_ms") >= 1
                _, errors = traffic.counts()
                assert errors == 0
                for c in pinned:
                    c.close()
        finally:
            gw.close()


@pytest.mark.chaos
@pytest.mark.slow  # process-heavy, as the reference's
@time_limit(240)
def test_controller_restart_adopts_in_flight_drain_no_double_act():
    from blendjax_torch.serve import ServerFleet
    from blendjax_torch.serve.gateway import start_gateway_thread

    counters = EventCounters()
    with ServerFleet(3, model="linear", obs_dim=4, slots=16, device="cpu") as fleet:
        with start_gateway_thread(fleet.addresses, counters=counters,
                                  scrape_interval_s=0.1) as gw:
            with _Traffic(gw.address, n_clients=2) as traffic:
                first = _down_controller(gw, fleet, counters, min_replicas=2)
                assert _drive(first, {"drain"}) == "drain"
                victim = first._transition["rid"]
                del first  # the controller dies mid-decision
                fresh = _down_controller(gw, fleet, counters, min_replicas=2)
                assert fresh.tick() == "adopt"
                assert fresh._transition["rid"] == victim
                assert counters.get("autoscale_adoptions") == 1
                assert _drive(fresh, {"scale_down", "rollback"}) == "scale_down"
                _, errors = traffic.counts()
            assert errors == 0
            assert counters.get("gateway_drains") == 1, "double-acted"
            assert counters.get("autoscale_scale_downs") == 1
            assert counters.get("autoscale_replicas_retired") == 1
            assert len(gw.gateway.replica_ids()) == 2


@pytest.mark.chaos
@time_limit(90)
def test_watchdog_respawn_backoff_jitter_counted():
    from blendjax_torch.btt.chaos import kill_instance
    from blendjax_torch.btt.watchdog import FleetWatchdog
    from blendjax_torch.serve import ServerFleet

    counters = EventCounters()
    with ServerFleet(1, model="linear", obs_dim=4, slots=4, device="cpu") as fleet:
        with FleetWatchdog(fleet, interval=0.1, restart=True, respawn_backoff_s=0.05,
                           respawn_jitter_s=0.05, counters=counters) as wd:
            kill_instance(fleet, 0)
            _wait(lambda: bool(wd.deaths and wd.deaths[-1][2] and wd.alive == 1),
                  msg="respawn")
        assert counters.get("watchdog_backoff_jitter_ms") >= 50
