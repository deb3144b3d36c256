"""The port's fleet supervisor (``blendjax_torch.btt.supervise``) and fault
injection (``btt/chaos.py``), on the CPU.

1. The reference's ``tests/test_obs.py`` supervisor cases: a supervised
   death dumps a postmortem naming its target, with the health snapshot,
   and reaches the hub; ``aggregate_health`` merges stage histograms as the
   union's quantile.
2. The reference's ``tests/test_chaos.py`` acceptance drills on the port's
   stack under the fake Blender: SIGKILL 1 of 3 echo producers
   (``tests/blender/torch_env.blend.py``) mid-training, the pool rides
   through the death and the supervisor's respawn re-admits the env within
   the policy's budget; and SIGKILL an ``shm://`` frame producer, whose
   stream heals through the ring's generation reopen with the health check
   green.  Every wait is bounded.
3. The port's ``ChaosProxy`` relays, stalls and cuts a TCP stream, as the
   reference's does.
"""

import json
import socket
import threading
import types

import numpy as np
import pytest

from blendjax_torch import datagen
from blendjax_torch.btt.chaos import ChaosProxy, kill_instance, wait_env_ready
from blendjax_torch.btt.envpool import EnvPool
from blendjax_torch.btt.launcher import BlenderLauncher
from blendjax_torch.btt.supervise import FleetSupervisor, aggregate_health
from blendjax_torch.obs.hub import TelemetryHub
from blendjax_torch.utils.timing import EventCounters, StageTimer
from helpers import BLEND_SCRIPTS, FAKE_BLENDER
from test_torch_env import _free_block, _policy

ENV_SCRIPT = f"{BLEND_SCRIPTS}/torch_env.blend.py"
SMALL = ["--height", "16", "--width", "24", "--keypoints", "2"]


@pytest.fixture
def fake_blender(monkeypatch):
    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)
    monkeypatch.setenv("BLENDJAX_FAKE_BPY", "1")


def test_supervisor_death_dumps_postmortem(tmp_path):
    launcher = types.SimpleNamespace(launch_info=None)
    counters = EventCounters()
    timer = StageTimer()
    timer.add("recv", 0.001)
    hub = TelemetryHub()
    sup = FleetSupervisor(launcher, pool=None, counters=counters, timer=timer, hub=hub,
                          postmortem_dir=str(tmp_path))
    sup._on_death(1, -9)
    assert counters.get("deaths") == 1
    assert sup.last_postmortem is not None
    doc = json.loads(open(sup.last_postmortem).read())
    assert doc["extra"]["target"] == "instance1"
    assert doc["extra"]["exit_code"] == -9
    assert doc["extra"]["health"]["deaths"] == 1
    assert any(e["event"] == "producer_death" and e["target"] == "instance1"
               for e in doc["events"])
    snap = hub.scrape()
    assert snap["counters"]["deaths"] == 1
    assert snap["components"]["fleet0"]["probe"]["deaths"] == 1
    assert sup.health()["stages"]["recv"]["p50_ms"] > 0


def test_aggregate_health_merges_stage_histograms():
    sups = []
    for fid, lat in ((0, 1e-4), (1, 1e-1)):
        timer = StageTimer()
        for _ in range(100):
            timer.add("recv", lat)
        sups.append(FleetSupervisor(types.SimpleNamespace(launch_info=None), pool=None,
                                    counters=EventCounters(), timer=timer, fleet_id=fid,
                                    postmortem_dir=None))
    agg = aggregate_health(sups)
    rec = agg["stages"]["recv"]
    assert rec["count"] == 200
    assert rec["p99_ms"] > 50.0  # the union's quantile, not a mean
    assert rec["p50_ms"] < 110.0
    assert agg["fleets"][0]["stages"]["recv"]["count"] == 100


class _EchoServer:
    """Plain-TCP echo upstream."""

    def __init__(self):
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(4)
        self.port = self._sock.getsockname()[1]
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn):
        with conn:
            while True:
                data = conn.recv(4096)
                if not data:
                    return
                conn.sendall(data)

    def close(self):
        self._sock.close()


def test_chaos_proxy_relays_stalls_and_cuts():
    echo = _EchoServer()
    try:
        with ChaosProxy(echo.port) as proxy:
            host, port = proxy.address[len("tcp://"):].rsplit(":", 1)
            c = socket.create_connection((host, int(port)), timeout=5)
            c.sendall(b"hello")
            assert c.recv(64) == b"hello"
            proxy.stall()
            c.sendall(b"held")
            c.settimeout(0.3)
            with pytest.raises(socket.timeout):
                c.recv(64)
            proxy.resume()
            c.settimeout(5)
            assert c.recv(64) == b"held"
            proxy.cut()
            c.settimeout(5)
            assert c.recv(64) == b""  # the relay closed the connection
            c.close()
    finally:
        echo.close()


def test_supervisor_kill_one_of_three_heals_within_deadline(fake_blender):
    """Kill 1 of 3 producers mid-training: ``EnvPool.step`` keeps going on
    the other two, the supervisor respawns the producer and re-admits its
    env within the policy's budget, and ``health()`` counts it all."""
    with BlenderLauncher(scene="", script=ENV_SCRIPT, num_instances=3, named_sockets=["GYM"],
                         start_port=_free_block(3), background=True,
                         instance_args=[["--horizon", "100000"]] * 3) as bl:
        addrs = bl.launch_info.addresses["GYM"]
        wait_env_ready(addrs)
        counters = EventCounters()
        pool = EnvPool(addrs, timeoutms=10000, fault_policy=_policy(), counters=counters)
        # the watchdog's interval is longer than the RPC deadline: the
        # quarantine comes from the fault policy, the respawn from the watchdog
        with FleetSupervisor(bl, pool=pool, interval=3.0, heal_interval=0.05,
                             counters=counters) as sup:
            try:
                obs, infos = pool.reset()
                assert len(infos) == 3 and pool.healthy.all()
                for _ in range(3):
                    pool.step([1.0, 2.0, 3.0])
                h = sup.health()
                assert h["retries"] == 0 and h["quarantines"] == 0
                assert h["deaths"] == 0 and h["restarts"] == 0
                assert h["healthy_envs"] == 3

                kill_instance(bl, 1)
                obs, rew, done, infos = pool.step([4.0, 4.0, 4.0])
                assert list(pool.healthy) == [True, False, True]
                assert infos[1]["quarantined"] and not infos[1]["healthy"]
                assert rew[1] == 0.0 and done[1]
                assert obs[0] == 4.0 and obs[2] == 4.0
                obs, rew, done, infos = pool.step([5.0, 5.0, 5.0])
                assert not done[1]
                assert obs[0] == 5.0 and obs[2] == 5.0

                assert sup.await_deaths(1, timeout=20)
                budget = (sup.watchdog.interval + 20.0 + 2 * pool.policy.deadline_s
                          + pool.policy.backoff_max)
                assert sup.await_healthy(timeout=budget), sup.health()
                obs, rew, done, infos = pool.step([6.0, 6.0, 6.0])
                assert infos[1]["healthy"] and infos[1].get("readmitted")
                assert rew[1] == 0.0 and not done[1] and obs[1] == 0.0
                obs, rew, done, infos = pool.step([7.0, 8.0, 9.0])
                np.testing.assert_allclose(obs, [7.0, 8.0, 9.0])
                h = sup.health()
                assert h["deaths"] == 1 and h["restarts"] == 1
                assert h["quarantines"] == 1 and h["readmissions"] == 1
                assert h["retries"] >= 1 and h["timeouts"] >= 2
                assert h["healthy_envs"] == 3 and h["num_envs"] == 3 and h["alive"] == 3
            finally:
                pool.close()


def test_supervisor_shm_stream_heals_after_kill(fake_blender):
    """Kill an ``shm://`` frame producer under supervision: the respawn
    recreates its ring under the same name and the stream heals through
    the reader's generation reopen, with no timeout in between."""
    from blendjax_torch.btt.dataset import RemoteIterableDataset

    with BlenderLauncher(scene="", script=str(datagen.FRAMES_SCRIPT), num_instances=1,
                         named_sockets=["DATA"], start_port=_free_block(1), seed=0,
                         proto="shm", background=True, instance_args=[SMALL]) as bl:
        counters = EventCounters()
        with FleetSupervisor(bl, pool=None, interval=0.2, counters=counters) as sup:
            healed = threading.Event()
            sup.add_health_check("stream", healed.is_set)
            ds = RemoteIterableDataset(bl.launch_info.addresses["DATA"], max_items=10**9,
                                       timeoutms=30000)
            it = ds.stream()
            try:
                first = [next(it) for _ in range(5)]
                assert [int(m["frameid"]) for m in first] == [0, 1, 2, 3, 4]
                kill_instance(bl, 0)
                assert sup.await_deaths(1, timeout=20)
                for _ in range(5000):
                    if int(next(it)["frameid"]) == 0:
                        healed.set()
                        break
                assert healed.is_set(), "the stream never reopened the new ring"
                assert int(next(it)["frameid"]) == 1
                h = sup.health()
                assert h["deaths"] == 1 and h["restarts"] == 1
                assert h["checks"] == {"stream": True}
            finally:
                it.close()


def test_supervisor_health_reports_replay():
    """``tests/test_replay.py::test_supervisor_health_reports_replay`` on
    the port, with its attach-after-construction path
    (``attach_replay``)."""
    from blendjax_torch.replay import ReplayBuffer
    from blendjax_torch.utils.timing import REPLAY_EVENTS

    launcher = types.SimpleNamespace(launch_info=None)
    counters = EventCounters()
    buf = ReplayBuffer(8, seed=0, counters=counters)
    sup = FleetSupervisor(launcher, pool=None, counters=counters, replay=buf)
    h = sup.health()
    for name in REPLAY_EVENTS:
        assert h[name] == 0  # zero-filled before any event
    for i in range(4):
        buf.append({"obs": np.full(3, i, np.float32), "reward": np.float32(i)})
    h = sup.health()
    assert h["replay_appends"] == 4
    assert h["replay"]["size"] == 4 and h["replay"]["capacity"] == 8
    sup2 = FleetSupervisor(launcher, pool=None, counters=counters)
    assert "replay" not in sup2.health()
    sup2.attach_replay(buf)
    assert sup2.replay is buf and sup2.health()["replay"]["size"] == 4
