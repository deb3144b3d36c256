"""The port's serve gateway (``blendjax_torch.serve.gateway``) on the CPU,
held to ``tests/test_gateway.py`` and to the JAX package over the wire.

1. **The reference's cases** against the port: episode-lease affinity and
   the replica stamp, fresh episodes spread over replicas, the drain
   lifecycle, routing by model id, stale and unknown leases, prefill
   admission through the hop, the gateway as a hub remote, the replica id
   in client errors and spans, exactly-once through wire faults (tcp via
   ``ChaosProxy``, shm via ``ShmChaos``), SIGKILL of one replica of three
   under ``FleetWatchdog``, SIGKILL of one sharded-gateway worker, wire
   faults in front of the sharded front, and the sharded gateway's
   1-worker/2-worker arms.  Not ported: the two bench-schema cases, which
   measure the reference's stack through ``benchmarks/`` and ``bench.py``.
2. **Across the packages**: each package's ``ServeClient`` through the
   other's gateway over the port's replicas (the linear model exact in f32;
   a small SeqFormer whose params cross through ``convert.py`` within 1e-5
   of the reference's serial decode, the serve tests' limit); the same
   scripted traffic through both gateways giving equal ``gateway_*``
   counters and equal lease ids; a worker's lease ids ``≡ worker (mod N)``
   in both packages; and both fronts choosing the same worker for a
   correlation id (``crc32(mid) % N``).

Every replica runs ``device="cpu"``.  Every live test waits on conditions
and runs under its own time limit; the client timeouts leave room for a
loaded host (six test processes at once), so a slow reply is a retry and
never a failed case.
"""

import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blendjax_torch.btt.faults import FaultPolicy
from blendjax_torch.utils.timing import (
    GATEWAY_EVENTS,
    GATEWAY_STAGES,
    EventCounters,
    StageTimer,
)
from helpers.time_limit import time_limit


def _gateway_counts(counters):
    return {k: v for k, v in counters.snapshot().items() if k.startswith("gateway_")}


def _two_replicas(seeds=(0, 7), slots=8, obs_dim=4):
    """Two in-thread linear servers with different seeds: predictions
    witness which replica served an episode."""
    from blendjax_torch.serve import LinearModel, start_server_thread

    return [start_server_thread(LinearModel(obs_dim=obs_dim, slots=slots, seed=s),
                                counters=EventCounters())
            for s in seeds]


def _ref_w(seed, obs_dim=4):
    from blendjax_torch.serve import LinearModel

    return LinearModel(obs_dim=obs_dim, slots=1, seed=seed).w


def _wait(cond, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {msg}"
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# routing: affinity, spread, drain
# ---------------------------------------------------------------------------


@time_limit(60)
def test_gateway_lease_affinity_and_replica_stamp():
    from blendjax_torch.serve import ServeClient
    from blendjax_torch.serve.gateway import start_gateway_thread

    handles = _two_replicas()
    counters = EventCounters()
    obs = np.arange(4, dtype=np.float32)
    ws = {"r0": _ref_w(0), "r1": _ref_w(7)}
    try:
        with start_gateway_thread([h.address for h in handles], counters=counters,
                                  timer=StageTimer(), scrape_interval_s=0.1) as gw:
            clients = [ServeClient(gw.address, timeoutms=10000) for _ in range(4)]
            for c in clients:
                c.reset()
            for k in range(3):
                for c in clients:
                    r = c.step(obs)
                    assert r["replica"] in ws
                    assert c.replica == r["replica"]
                    assert r["pos"] == k
                    np.testing.assert_allclose(r["pred"], obs @ ws[r["replica"]] + np.float32(k))
            snap = _gateway_counts(counters)
            assert snap["gateway_routed"] >= 16  # 4 resets + 12 steps
            assert snap["gateway_affinity_hits"] >= 12
            hello = clients[0].hello()
            assert hello["gateway"] is True
            assert set(hello["replicas"]) == {"r0", "r1"}
            # once a scrape lands, the gateway's hello carries a healthy
            # replica's capability fields
            _wait(lambda: "obs_dim" in clients[0].hello(), msg="capability fields")
            hello = clients[0].hello()
            assert hello["obs_dim"] == 4
            assert hello["max_batch"] > 0
            for c in clients:
                c.close_episode()
                c.close()
    finally:
        for h in handles:
            h.close()


@time_limit(60)
def test_gateway_spreads_fresh_episodes_across_replicas():
    from blendjax_torch.serve import ServeClient
    from blendjax_torch.serve.gateway import start_gateway_thread

    handles = _two_replicas(seeds=(0, 0))
    try:
        with start_gateway_thread([h.address for h in handles], counters=EventCounters(),
                                  scrape_interval_s=0.1) as gw:
            clients = [ServeClient(gw.address, timeoutms=10000) for _ in range(6)]
            for c in clients:
                c.reset()
            # the optimistic pending-live estimate spreads a burst of
            # resets even before any scrape lands
            per_replica = [h.server.counters.get("serve_resets") for h in handles]
            assert all(n > 0 for n in per_replica), per_replica
            for c in clients:
                c.close_episode()
                c.close()
    finally:
        for h in handles:
            h.close()


@time_limit(60)
def test_gateway_drain_lifecycle():
    from blendjax_torch.serve import ServeClient
    from blendjax_torch.serve.gateway import start_gateway_thread

    handles = _two_replicas(seeds=(0, 0))
    counters = EventCounters()
    obs = np.zeros(4, np.float32)
    try:
        with start_gateway_thread([h.address for h in handles], counters=counters,
                                  scrape_interval_s=0.1) as gw:
            live = ServeClient(gw.address, timeoutms=10000)
            live.reset()
            live.step(obs)
            victim = live.replica
            gw.gateway.drain(victim)
            vic_counters = handles[int(victim[1:])].server.counters
            resets_before = vic_counters.get("serve_resets")
            others = [ServeClient(gw.address, timeoutms=10000) for _ in range(4)]
            for c in others:
                c.reset()
            assert vic_counters.get("serve_resets") == resets_before
            # the drained replica still serves its live episode
            assert live.step(obs)["replica"] == victim
            admin = ServeClient(gw.address, timeoutms=10000)
            reply = admin.rpc("undrain", {"replica": victim})
            assert reply["draining"] == []
            assert _gateway_counts(counters)["gateway_drains"] == 1
            # draining every replica makes a fresh reset fail actionably
            for rid in ("r0", "r1"):
                admin.rpc("drain", {"replica": rid})
            denied = ServeClient(gw.address, timeoutms=10000,
                                 fault_policy=FaultPolicy(max_retries=0))
            with pytest.raises(RuntimeError, match="no healthy replica"):
                denied.reset()
            for c in others + [live, admin, denied]:
                c.close()
    finally:
        for h in handles:
            h.close()


#: how late the gateway loop may observe a silence it should act on, on a
#: host running six test processes at once
QUARANTINE_LAG_S = 1.0


@time_limit(60)
def test_silent_replica_quarantined_within_the_horizon():
    """A replica that stops answering, with no watchdog to say so, is
    quarantined by its silence alone: never before ``quarantine_after``
    has passed since its last answer, and within ``quarantine_after`` plus
    one scrape of falling silent.  Until then it stays in the route set:
    that horizon (at least 5 s, where the reference's is at least 1 s) is
    what a dead replica with no watchdog costs."""
    from blendjax_torch.serve.gateway import quarantine_after, start_gateway_thread

    handles = _two_replicas(seeds=(0, 0))
    counters = EventCounters()
    interval = 0.1
    horizon = quarantine_after(interval)
    try:
        with start_gateway_thread([h.address for h in handles], counters=counters,
                                  scrape_interval_s=interval) as gw:
            snaps = gw.gateway.replica_snapshots
            _wait(lambda: all(r["healthy"] and r["pid"] is not None for r in snaps().values()),
                  msg="both replicas answering scrapes")
            handles[1].close()
            t_silent = time.monotonic()
            _wait(lambda: not snaps()["r1"]["healthy"], timeout=horizon + 10,
                  msg="the silent replica's quarantine")
            t_quarantined = time.monotonic()
            last_ok = gw.gateway._replicas["r1"].last_ok
            assert t_quarantined - last_ok >= horizon, (t_quarantined - last_ok, horizon)
            assert t_quarantined - t_silent <= horizon + interval + QUARANTINE_LAG_S, \
                (t_quarantined - t_silent, horizon)
            assert counters.get("gateway_replica_quarantined") == 1
            assert snaps()["r0"]["healthy"]
    finally:
        for h in handles:
            h.close()


# ---------------------------------------------------------------------------
# multi-model routing, lease errors, prefill through the hop
# ---------------------------------------------------------------------------


@time_limit(60)
def test_gateway_routes_by_model_id():
    from blendjax_torch.serve import LinearModel, ServeClient, start_server_thread
    from blendjax_torch.serve.gateway import start_gateway_thread

    obs = np.arange(4, dtype=np.float32)
    ha = start_server_thread({"a": LinearModel(obs_dim=4, slots=4, seed=0)},
                             counters=EventCounters())
    hb = start_server_thread({"b": LinearModel(obs_dim=4, slots=4, seed=7)},
                             counters=EventCounters())
    try:
        with start_gateway_thread([ha.address, hb.address], counters=EventCounters(),
                                  scrape_interval_s=0.05) as gw:
            cb = ServeClient(gw.address, model="b", timeoutms=10000)
            # the model map is learned from the scrape
            _wait(lambda: set(cb.hello()["models"]) == {"a", "b"}, msg="model map")
            cb.reset()
            r = cb.step(obs)
            assert r["replica"] == "r1"
            np.testing.assert_allclose(r["pred"], obs @ _ref_w(7))
            bogus = ServeClient(gw.address, model="zzz", timeoutms=10000,
                                fault_policy=FaultPolicy(max_retries=0))
            with pytest.raises(RuntimeError, match="zzz"):
                bogus.reset()
            cb.close_episode()
            cb.close()
            bogus.close()
    finally:
        ha.close()
        hb.close()


@time_limit(60)
def test_gateway_unknown_lease_errors_and_noop_close():
    from blendjax_torch.serve import ServeClient
    from blendjax_torch.serve.gateway import start_gateway_thread

    handles = _two_replicas()
    counters = EventCounters()
    try:
        with start_gateway_thread([h.address for h in handles], counters=counters) as gw:
            c = ServeClient(gw.address, timeoutms=10000,
                            fault_policy=FaultPolicy(max_retries=0))
            c.slot, c.episode = 0, 424242  # never admitted
            with pytest.raises(RuntimeError, match="reset\\(\\) and resume"):
                c.step(np.zeros(4, np.float32))
            # a stale close is answered, never an error
            c.slot, c.episode = 0, 424242
            assert not c.close_episode()
            assert _gateway_counts(counters)["gateway_stale_lease_redirects"] >= 1
            c.close()
    finally:
        for h in handles:
            h.close()


@time_limit(60)
def test_gateway_prefill_admission_end_to_end():
    from blendjax_torch.serve import ServeClient
    from blendjax_torch.serve.gateway import start_gateway_thread

    handles = _two_replicas(seeds=(3, 3))
    w = _ref_w(3)
    rng = np.random.default_rng(5)
    prefix = rng.standard_normal((6, 4)).astype(np.float32)
    obs = rng.standard_normal(4).astype(np.float32)
    try:
        with start_gateway_thread([h.address for h in handles],
                                  counters=EventCounters()) as gw:
            c = ServeClient(gw.address, timeoutms=10000)
            reply = c.reset(prefix=prefix)
            assert reply["pos"] == 6
            np.testing.assert_allclose(reply["pred"], prefix[-1] @ w + np.float32(5))
            r = c.step(obs)
            assert r["pos"] == 6
            assert r["replica"] == reply["replica"]
            np.testing.assert_allclose(r["pred"], obs @ w + np.float32(6))
            c.close_episode()
            c.close()
    finally:
        for h in handles:
            h.close()


# ---------------------------------------------------------------------------
# telemetry plane + client diagnosability
# ---------------------------------------------------------------------------


@time_limit(60)
def test_gateway_is_a_scrapeable_hub_remote():
    from blendjax_torch.obs.hub import TelemetryHub
    from blendjax_torch.serve import ServeClient
    from blendjax_torch.serve.gateway import start_gateway_thread

    handles = _two_replicas()
    counters, timer = EventCounters(), StageTimer()
    try:
        with start_gateway_thread([h.address for h in handles], counters=counters,
                                  timer=timer) as gw:
            c = ServeClient(gw.address, timeoutms=10000)
            c.reset()
            for _ in range(3):
                c.step(np.zeros(4, np.float32))
            hub = TelemetryHub()
            c.register_with_hub(hub, "gateway")
            snap = hub.scrape()
            assert snap["counters"]["gateway_routed"] >= 4
            assert snap["counters"]["gateway_affinity_hits"] >= 3
            for name in GATEWAY_EVENTS:
                assert name in snap["counters"], name
            for stage in GATEWAY_STAGES:
                assert stage in snap["stages"], stage
            assert snap["stages"]["gw_route"]["count"] >= 4
            assert snap["stages"]["gw_reply"]["p99_ms"] >= 0.0
            c.close()
    finally:
        for h in handles:
            h.close()


@time_limit(60)
def test_client_surfaces_replica_id_in_error_and_spans():
    from blendjax_torch.obs.spans import SpanRecorder
    from blendjax_torch.serve import ServeClient, ServeRPCError
    from blendjax_torch.serve.gateway import start_gateway_thread

    handles = _two_replicas(seeds=(0, 0))
    rec = SpanRecorder()
    gw = start_gateway_thread([h.address for h in handles], counters=EventCounters())
    try:
        c = ServeClient(gw.address, timeoutms=2000, span_recorder=rec,
                        fault_policy=FaultPolicy(max_retries=0, circuit_threshold=0))
        c.reset()
        c.step(np.zeros(4, np.float32))
        assert c.replica in ("r0", "r1")
        served_by = c.replica
        stamped = [s for s in rec.snapshot() if (s.get("args") or {}).get("replica") == served_by]
        assert stamped
        # kill the gateway: the next RPC times out, and the error names
        # the last replica that served this client
        gw.close()
        gw = None
        with pytest.raises(ServeRPCError, match=served_by):
            c.step(np.zeros(4, np.float32))
        c.close()
    finally:
        if gw is not None:
            gw.close()
        for h in handles:
            h.close()


# ---------------------------------------------------------------------------
# exactly-once through the extra hop (chaos)
# ---------------------------------------------------------------------------


def _wire_fault_policy():
    return FaultPolicy(max_retries=6, backoff_base=0.02, backoff_max=0.1,
                       circuit_threshold=0, seed=1)


@pytest.mark.chaos
@pytest.mark.parametrize("transport", ["tcp", "shm"])
@time_limit(90)
def test_exactly_once_through_gateway_with_wire_faults(transport):
    """A dropped reply and a duplicated request between client and gateway
    still apply exactly one step per request: over tcp (``ChaosProxy``, shm
    pinned off) and over the client's shm channel (``ShmChaos``), with the
    gateway-to-replica hop on its own shm channel."""
    from blendjax_torch.btt.chaos import ChaosProxy
    from blendjax_torch.btt.shm_rpc import ShmChaos, enabled
    from blendjax_torch.serve import LinearModel, ServeClient, start_server_thread
    from blendjax_torch.serve.gateway import start_gateway_thread

    if transport == "shm" and not enabled():
        pytest.skip("shm rpc unavailable on this host")
    counters = EventCounters()
    obs = np.arange(4, dtype=np.float32)
    ref = LinearModel(obs_dim=4, slots=2, seed=0)
    ref.reset_rows(np.asarray([0]))
    h = start_server_thread(LinearModel(obs_dim=4, slots=2, seed=0), counters=EventCounters())
    proxy = None
    try:
        with start_gateway_thread([h.address], counters=counters,
                                  scrape_interval_s=0.1) as gw:
            if transport == "tcp":
                proxy = ChaosProxy(gw.address)
                client = ServeClient(proxy.address, fault_policy=_wire_fault_policy(),
                                     counters=counters, timeoutms=1000, shm=False)
                chaos = proxy
            else:
                chaos = ShmChaos()
                client = ServeClient(gw.address, fault_policy=_wire_fault_policy(),
                                     counters=counters, timeoutms=1000, shm_chaos=chaos)
            client.reset()
            preds = []
            for t in range(16):
                if t == 4:
                    if transport == "shm":
                        assert client.transport == "shm", "client never upgraded"
                    chaos.drop_next("down")  # lose a reply: a retry
                if t == 9:
                    chaos.dup_next("up")  # duplicate a request
                preds.append(client.step(obs)["pred"])
            want = [ref.step_rows(np.asarray([0]), obs[None])[0] for _ in range(16)]
            np.testing.assert_array_equal(np.stack(preds), np.stack(want))
            snap = counters.snapshot()
            assert snap.get("retries", 0) >= 1
            # the retry was healed on the gateway's side: a cache hit or an
            # in-flight re-forward
            assert (snap.get("gateway_cache_hits", 0)
                    + snap.get("gateway_dup_inflight", 0)) >= 1, snap
            if transport == "shm":
                _wait(lambda: any(r.shm is not None for r in gw.gateway._replicas.values()),
                      msg="the gateway-to-replica hop on shm")
            client.close()
    finally:
        if proxy is not None:
            proxy.close()
        h.close()


def _acked_episode_loop(clients, acked, acked_step, survivors=None, deadline_s=60):
    """Drive each client to three acknowledged steps through an outage:
    timeouts retry, the actionable stale-lease error resets the episode.
    Returns (stale errors, errors seen by ``survivors``)."""
    stale, survivor_errors = 0, 0
    for i, c in enumerate(clients):
        deadline = time.monotonic() + deadline_s
        done = 0
        while time.monotonic() < deadline and done < 3:
            try:
                acked_step(i)
                done += 1
            except TimeoutError:
                if survivors is not None and i in survivors:
                    survivor_errors += 1
                continue
            except RuntimeError as exc:
                assert "reset() and resume" in str(exc), exc
                if survivors is not None and i in survivors:
                    survivor_errors += 1
                stale += 1
                while time.monotonic() < deadline:
                    try:
                        c.reset(timeout_ms=2000)
                        acked[i] = 0
                        break
                    except (TimeoutError, RuntimeError):
                        time.sleep(0.1)
        assert done == 3, f"client {i} never recovered"
    return stale, survivor_errors


@pytest.mark.chaos
@time_limit(150)
def test_kill_one_replica_of_three_respawn_exactly_once():
    """SIGKILL one of three replica processes mid-traffic; the watchdog
    respawns it.  Clients see timeouts and at most one actionable
    stale-lease error each, resume after ``reset()``, and every acked step
    was applied exactly once (each acked prediction is ``obs @ W + k``, k
    the acks since the episode's reset)."""
    from blendjax_torch.btt.chaos import kill_instance
    from blendjax_torch.btt.shm_rpc import leaked_objects
    from blendjax_torch.btt.watchdog import FleetWatchdog
    from blendjax_torch.serve import ServeClient, ServerFleet
    from blendjax_torch.serve.gateway import start_gateway_thread

    gw_counters = EventCounters()
    obs = np.arange(4, dtype=np.float32)
    w = _ref_w(0)
    with ServerFleet(3, model="linear", obs_dim=4, slots=8, device="cpu") as fleet:
        gw = start_gateway_thread(fleet.addresses, counters=gw_counters,
                                  scrape_interval_s=0.15)
        wd = FleetWatchdog(fleet, interval=0.2, restart=True,
                           on_death=gw.gateway.notify_replica_death,
                           on_respawn=gw.gateway.notify_replica_respawn)
        try:
            with wd:
                clients = []
                for i in range(4):
                    c = ServeClient(gw.address, timeoutms=1500, counters=EventCounters(),
                                    fault_policy=FaultPolicy(max_retries=1, backoff_base=0.05,
                                                             backoff_max=0.2,
                                                             circuit_threshold=0, seed=i))
                    c.reset()
                    clients.append(c)
                acked = [0] * len(clients)

                def acked_step(i):
                    r = clients[i].step(obs)
                    np.testing.assert_array_equal(r["pred"], obs @ w + np.float32(acked[i]))
                    acked[i] += 1

                for i in range(len(clients)):
                    acked_step(i)
                # kill the replica that owns clients[1]'s episode, so a client
                # crosses the stale-lease path for sure
                kill_instance(fleet, int(clients[1].replica[1:]))
                stale, _ = _acked_episode_loop(clients, acked, acked_step)
                assert stale >= 1
                _wait(lambda: gw_counters.get("gateway_replica_respawns") >= 1, timeout=30,
                      msg="respawn re-admission")
                snap = _gateway_counts(gw_counters)
                assert snap.get("gateway_replica_quarantined", 0) >= 1
                assert snap.get("gateway_stale_lease_redirects", 0) >= 1
                assert wd.deaths and wd.deaths[-1][2]  # restarted
                assert wd.alive == 3
                for c in clients:
                    c.close()
        finally:
            gw.close()
    # the SIGKILLed replica ran no cleanup; the respawn and the close swept
    for p in fleet._procs:
        if p is not None and p.shm_base is not None:
            assert not leaked_objects(p.shm_base), leaked_objects(p.shm_base)


# ---------------------------------------------------------------------------
# the sharded data plane
# ---------------------------------------------------------------------------


@pytest.mark.chaos
@time_limit(150)
def test_kill_one_gateway_worker_exactly_once():
    """SIGKILL one of three gateway worker processes.  Clients on the
    survivors keep stepping with no error; the victim's clients see
    timeouts, fall back to the front, get one actionable stale-lease error,
    and resume after ``reset()``, every acked step applied exactly once.
    The watchdog respawns the worker under its pinned address and shm base,
    and no ``/dev/shm`` object outlives the close."""
    from blendjax_torch.btt.chaos import kill_instance
    from blendjax_torch.btt.shm_rpc import leaked_objects
    from blendjax_torch.serve import ServeClient, ServerFleet
    from blendjax_torch.serve.gateway import start_sharded_gateway_thread

    gw_counters = EventCounters()
    obs = np.arange(4, dtype=np.float32)
    w = _ref_w(0)
    with ServerFleet(2, model="linear", obs_dim=4, slots=16, device="cpu") as fleet:
        gw = start_sharded_gateway_thread(fleet.addresses, workers=3, counters=gw_counters,
                                          scrape_interval_s=0.15)
        bases = list(gw.gateway._wbases)
        try:
            clients, acked = [], []

            def admit():
                c = ServeClient(gw.address, timeoutms=1500, counters=EventCounters(),
                                fault_policy=FaultPolicy(max_retries=1, backoff_base=0.05,
                                                         backoff_max=0.2, circuit_threshold=0,
                                                         seed=len(clients)))
                c.reset()
                clients.append(c)
                acked.append(0)

            for _ in range(6):
                admit()
            # fresh traffic hashes by correlation id: admit more until the
            # victim's partition and a survivor both exist
            while len({c.gw_worker for c in clients}) < 2 and len(clients) < 24:
                admit()
            assert len({c.gw_worker for c in clients}) >= 2

            def acked_step(i):
                r = clients[i].step(obs)
                np.testing.assert_array_equal(r["pred"], obs @ w + np.float32(acked[i]))
                acked[i] += 1

            for i in range(len(clients)):
                acked_step(i)
                acked_step(i)
            victim_tag = clients[0].gw_worker
            survivors = {i for i, c in enumerate(clients) if c.gw_worker != victim_tag}
            assert len(survivors) < len(clients)
            kill_instance(gw.gateway, int(victim_tag[2:]))
            stale, survivor_errors = _acked_episode_loop(clients, acked, acked_step,
                                                         survivors=survivors)
            assert survivor_errors == 0
            assert stale >= 1
            _wait(lambda: (gw.gateway.gateway_counters().get("gateway_worker_respawns", 0) >= 1
                           and all(x.alive for x in gw.gateway._workers)),
                  timeout=30, msg="worker respawn re-admitted")
            assert gw.gateway.gateway_counters().get("gateway_worker_deaths", 0) >= 1
            # the actionable error came off the stale partition (the front's
            # dead-worker answer or the respawned worker's unknown lease);
            # a worker's count reaches the front on its next scrape
            _wait(lambda: gw.gateway.gateway_counters().get(
                "gateway_stale_lease_redirects", 0) >= 1, msg="stale-lease count merged")
            for c in clients:
                c.close()
        finally:
            gw.close()
    for base in bases:
        if base is not None:
            assert not leaked_objects(base), leaked_objects(base)


@pytest.mark.chaos
@time_limit(90)
def test_exactly_once_through_sharded_front_with_wire_faults():
    """A dropped reply and a duplicated request in front of the sharded
    front still apply exactly one step per request.  The client is pinned
    to the front (``follow_redirects=False``): the front re-relays a
    same-mid retry to the same worker, whose reply cache answers it."""
    from blendjax_torch.btt.chaos import ChaosProxy
    from blendjax_torch.serve import LinearModel, ServeClient, start_server_thread
    from blendjax_torch.serve.gateway import start_sharded_gateway_thread

    counters = EventCounters()
    obs = np.arange(4, dtype=np.float32)
    ref = LinearModel(obs_dim=4, slots=2, seed=0)
    ref.reset_rows(np.asarray([0]))
    h = start_server_thread(LinearModel(obs_dim=4, slots=2, seed=0), counters=EventCounters())
    proxy = None
    try:
        with start_sharded_gateway_thread([h.address], workers=2, counters=counters,
                                          scrape_interval_s=0.1, supervise=False) as gw:
            proxy = ChaosProxy(gw.address)
            client = ServeClient(proxy.address, fault_policy=_wire_fault_policy(),
                                 counters=counters, timeoutms=1500, shm=False,
                                 follow_redirects=False)
            client.reset()
            preds = []
            for t in range(16):
                if t == 4:
                    proxy.drop_next("down")
                if t == 9:
                    proxy.dup_next("up")
                preds.append(client.step(obs)["pred"])
            want = [ref.step_rows(np.asarray([0]), obs[None])[0] for _ in range(16)]
            np.testing.assert_array_equal(np.stack(preds), np.stack(want))
            snap = counters.snapshot()
            assert snap.get("retries", 0) >= 1
            assert snap.get("gateway_front_relays", 0) >= 16
            # the worker's dedupe or reply cache fired; its counters reach
            # the front on the scrape cycle
            _wait(lambda: (gw.gateway.gateway_counters().get("gateway_cache_hits", 0)
                           + gw.gateway.gateway_counters().get("gateway_dup_inflight", 0)) >= 1,
                  msg="worker-side healing counted")
            client.close()
    finally:
        if proxy is not None:
            proxy.close()
        h.close()


def _steps_in(address, n_clients, seconds, obs_dim=4):
    """Steps answered to ``n_clients`` fresh episodes in ``seconds``, and
    the addresses the clients ended on."""
    from blendjax_torch.serve import ServeClient

    clients = [ServeClient(address, timeoutms=10000) for _ in range(n_clients)]
    for c in clients:
        c.reset()
    obs = np.zeros(obs_dim, np.float32)
    steps = 0
    t_end = time.monotonic() + seconds
    while time.monotonic() < t_end:
        for c in clients:
            c.step(obs)
            steps += 1
    ended_on = [c.address for c in clients]
    for c in clients:
        c.close_episode()
        c.close()
    return steps, ended_on


@pytest.mark.chaos
@time_limit(90)
def test_sharded_gateway_one_and_two_worker_arms():
    """The sharded gateway's two arms over one fleet and one set of worker
    processes: with one active worker every message rides the front (the
    direct-dial map is withheld); with two, clients are handed to their
    owning worker.  Both arms serve, and the front's relays are counted."""
    from blendjax_torch.serve import ServerFleet
    from blendjax_torch.serve.gateway import start_sharded_gateway_thread

    counters = EventCounters()
    with ServerFleet(2, model="linear", obs_dim=16, slots=16, work_us=50,
                     device="cpu") as fleet:
        with start_sharded_gateway_thread(fleet.addresses, workers=2, counters=counters,
                                          scrape_interval_s=0.1) as gw:
            gw.set_active_workers(1)
            steps1, on1 = _steps_in(gw.address, 4, 0.8, obs_dim=16)
            gw.set_active_workers(2)
            steps2, on2 = _steps_in(gw.address, 4, 0.8, obs_dim=16)
            assert steps1 > 0 and steps2 > 0
            assert set(on1) == {gw.address}
            assert gw.address not in on2
            assert gw.gateway.gateway_counters().get("gateway_front_relays", 0) >= steps1


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _seq_tree():
    from blendjax.models import seqformer as jseq

    return jax.device_get(jseq.init(jax.random.PRNGKey(0), obs_dim=5, d_model=32,
                                    n_heads=4, n_layers=2, max_len=32))


def _jax_serial(tree, episode, length=32):
    """The reference's serial decode of one episode."""
    from blendjax.models import seqformer as jseq

    cache = jseq.init_cache(tree, 1, dtype=jnp.float32, length=length)
    preds = []
    for o in episode:
        pred, cache = jseq.decode_step(tree, cache, jnp.asarray(o[None]),
                                       compute_dtype=jnp.float32)  # (params, cache, obs)
        preds.append(np.asarray(pred[0]))
    return np.stack(preds)


def _port_replicas(model, n=2):
    from blendjax_torch.models.convert import params_from_jax
    from blendjax_torch.serve import LinearModel, SeqFormerModel, start_server_thread

    if model == "linear":
        return [start_server_thread(LinearModel(obs_dim=4, slots=4, seed=3),
                                    counters=EventCounters()) for _ in range(n)]
    params = params_from_jax(_seq_tree(), device="cpu")
    return [start_server_thread(SeqFormerModel(params, slots=4, length=32),
                                counters=EventCounters()) for _ in range(n)]


@pytest.mark.parametrize("model", ["linear", "seqformer"])
@pytest.mark.parametrize("gateway", ["port", "reference"])
@time_limit(90)
def test_client_through_the_other_packages_gateway(gateway, model):
    """The reference's client through the port's gateway, and the port's
    client through the reference's, over the port's replicas: the linear
    model's predictions are exact, the SeqFormer's within 1e-5 of the
    reference's serial decode of the same params."""
    from blendjax.serve import ServeClient as JaxClient
    from blendjax.serve.gateway import start_gateway_thread as j_start_gateway_thread
    from blendjax_torch.serve import ServeClient
    from blendjax_torch.serve.gateway import start_gateway_thread

    start = start_gateway_thread if gateway == "port" else j_start_gateway_thread
    client_cls = JaxClient if gateway == "port" else ServeClient
    dim = 4 if model == "linear" else 5
    episodes = np.random.default_rng(11).standard_normal((3, 6, dim)).astype(np.float32)
    handles = _port_replicas(model)
    try:
        with start([h.address for h in handles], scrape_interval_s=0.1) as gw:
            clients = [client_cls(gw.address, timeoutms=20000) for _ in episodes]
            for c in clients:
                c.reset()
            got = [[] for _ in episodes]
            for t in range(episodes.shape[1]):
                for i, c in enumerate(clients):
                    r = c.step(episodes[i, t])
                    assert r["replica"] in ("r0", "r1")
                    got[i].append(np.asarray(r["pred"]))
            for c in clients:
                c.close_episode()
                c.close()
    finally:
        for h in handles:
            h.close()
    for i, ep in enumerate(episodes):
        if model == "linear":
            w = _ref_w(3)
            want = np.stack([o @ w + np.float32(k) for k, o in enumerate(ep)])
            np.testing.assert_array_equal(np.stack(got[i]), want)
        else:
            np.testing.assert_allclose(np.stack(got[i]), _jax_serial(_seq_tree(), ep),
                                       atol=1e-5, rtol=1e-5)


def _scripted(client_cls, address):
    """A fixed script: resets, steps, a stale step, a no-op close, an
    unknown command and closes; returns the lease ids handed out."""
    obs = np.ones(4, np.float32)
    clients = [client_cls(address, timeoutms=20000, shm=False) for _ in range(3)]
    for c in clients:
        c.reset()
    leases = [c.episode for c in clients]
    for _ in range(2):
        for c in clients:
            c.step(obs)
    stale = client_cls(address, timeoutms=20000, shm=False)
    stale.slot, stale.episode = 0, 987654
    with pytest.raises(RuntimeError, match="reset\\(\\) and resume"):
        stale.step(obs)
    stale.slot, stale.episode = 0, 987654
    assert not stale.close_episode()
    with pytest.raises(RuntimeError, match="unknown serve command"):
        stale.rpc("frobnicate")
    for c in clients:
        assert c.close_episode()
    for c in clients + [stale]:
        c.close()
    return leases


@time_limit(90)
def test_scripted_traffic_same_counters_and_leases_in_both_gateways():
    """The same scripted traffic through the port's gateway and the
    reference's, each over its own pair of port replicas, once both have
    scraped their fleet: equal ``gateway_*`` counters and equal lease ids."""
    from blendjax.serve import ServeClient as JaxClient
    from blendjax.serve.gateway import start_gateway_thread as j_start_gateway_thread
    from blendjax_torch.serve import ServeClient
    from blendjax_torch.serve.gateway import start_gateway_thread

    out = {}
    for name, start, client_cls in (("port", start_gateway_thread, ServeClient),
                                    ("reference", j_start_gateway_thread, JaxClient)):
        counters = EventCounters()
        handles = _port_replicas("linear")
        try:
            # one scrape, then none during the script: routing depends only
            # on the script
            with start([h.address for h in handles], counters=counters,
                       scrape_interval_s=600.0) as gw:
                _wait(lambda: all(s["pid"] is not None
                                  for s in gw.gateway.replica_snapshots().values()),
                      msg="first scrape")
                before = _gateway_counts(counters)
                leases = _scripted(client_cls, gw.address)
                # a reply is counted just after it is sent: wait until every
                # request of the script (one reply each) has been counted
                _wait(lambda: counters.get("gateway_replies") - before.get("gateway_replies", 0)
                      == counters.get("gateway_requests") - before.get("gateway_requests", 0),
                      msg="every reply counted")
                after = _gateway_counts(counters)
        finally:
            for h in handles:
                h.close()
        out[name] = ({k: v - before.get(k, 0) for k, v in after.items()}, leases)
    assert out["port"][0] == out["reference"][0]
    assert out["port"][1] == out["reference"][1]
    assert out["port"][0]["gateway_stale_lease_redirects"] == 2


@time_limit(60)
def test_worker_lease_partition_and_front_worker_choice_match():
    """A gateway worker's lease ids are ``≡ worker (mod N)`` in both
    packages and equal for the same resets; both sharded fronts pick the
    worker ``crc32(mid) % N`` for fresh traffic."""
    from blendjax.serve import ServeClient as JaxClient
    from blendjax.serve.gateway import ShardedGateway as JShardedGateway
    from blendjax.serve.gateway_worker import GatewayWorker as JGatewayWorker
    from blendjax_torch.serve import ServeClient
    from blendjax_torch.serve.gateway import ShardedGateway
    from blendjax_torch.serve.gateway_worker import GatewayWorker

    import threading

    handles = _port_replicas("linear")
    addrs = [h.address for h in handles]
    try:
        leases = {}
        for name, cls, client_cls in (("port", GatewayWorker, ServeClient),
                                      ("reference", JGatewayWorker, JaxClient)):
            worker = cls("tcp://127.0.0.1:*", addrs, worker_index=1, n_workers=3,
                         counters=EventCounters())
            stop = threading.Event()
            t = threading.Thread(target=worker.serve_forever, kwargs={"stop_event": stop},
                                 daemon=True)
            t.start()
            try:
                clients = [client_cls(worker.address, timeoutms=20000, shm=False)
                           for _ in range(4)]
                for c in clients:
                    c.reset()
                leases[name] = [c.episode for c in clients]
                for c in clients:
                    c.close_episode()
                    c.close()
            finally:
                stop.set()
                t.join(timeout=5)
                worker.close()
        assert leases["port"] == leases["reference"]
        assert all(ep % 3 == 1 for ep in leases["port"]), leases
        fronts = [ShardedGateway("tcp://127.0.0.1:*", addrs, workers=3),
                  JShardedGateway("tcp://127.0.0.1:*", addrs, workers=3)]
        try:
            from blendjax_torch import wire

            mids = [wire.new_message_id() for _ in range(64)]
            picks = [[f._pick_worker_for_mid(m).idx for m in mids] for f in fronts]
            assert picks[0] == picks[1]
            assert picks[0] == [zlib.crc32(m.encode()) % 3 for m in mids]
        finally:
            for f in fronts:
                f.close()
    finally:
        for h in handles:
            h.close()
