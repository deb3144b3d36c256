"""The port's env layer (``blendjax_torch.btb.env``, ``btt.env``,
``btt.envpool``, ``btt.faults``, ``btt.vector_env``) on the cases of the
reference's ``tests/test_env.py``, ``tests/test_envpool_async.py`` and
``tests/test_faults.py``, re-run against the port: the RPC loop, the
batched pool, the scripted-agent ordering, the real-time agent, the
pipelined ready-first loop, quarantine and re-admission, the producer's
reply cache, and the fault policy's retries, backoff and circuit.

Producers run under ``tests/helpers/fake_blender.py`` with
``BLENDJAX_FAKE_BPY=1``: the echo fixture ``tests/blender/torch_env.blend.py``
(the reference fixture's env on the port's producer stack) and the port's
cartpole, ``blendjax_torch/btb/cartpole.blend.py``, whose transitions are
held to :class:`blendjax_torch.btb.cartpole.Cartpole` stepped in this
process with the same seed and actions.  Two cases show the wire protocol
is shared: the port's pool steps the reference's ``env.blend.py``, and the
reference's pool steps the port's cartpole.  The fleet supervisor is not
ported (ROADMAP Queue 1, item 9): re-admission is driven by relaunching
the killed producer on its address, which the pool's probes find.
"""

import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import zmq

from blendjax.btt.chaos import ChaosProxy, kill_instance, wait_env_ready
from blendjax_torch import wire
from blendjax_torch.btb import cartpole
from blendjax_torch.btb.env import BaseEnv, RemoteControlledAgent
from blendjax_torch.btt.env import RemoteEnv, adapt_step_result, kwargs_to_cli, launch_env
from blendjax_torch.btt.envpool import EnvPool, launch_env_pool
from blendjax_torch.btt.faults import CircuitOpenError, FaultPolicy
from blendjax_torch.btt.launcher import BlenderLauncher
from blendjax_torch.utils.timing import EventCounters
from helpers import BLEND_SCRIPTS, FAKE_BLENDER, REPO_ROOT, fake_bpy

ENV_SCRIPT = f"{BLEND_SCRIPTS}/torch_env.blend.py"
REF_ENV_SCRIPT = f"{BLEND_SCRIPTS}/env.blend.py"
CARTPOLE = str(cartpole.__file__).replace("cartpole.py", "cartpole.blend.py")


@pytest.fixture
def fake_blender(monkeypatch):
    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)
    monkeypatch.setenv("BLENDJAX_FAKE_BPY", "1")


def _free_block(n):
    """First port of ``n`` consecutive free ports."""
    for _ in range(100):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        socks = []
        try:
            for k in range(n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + k))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} consecutive free ports")


def _addr():
    return f"tcp://127.0.0.1:{_free_block(1)}"


# -- test_env.py ------------------------------------------------------------------


def test_kwargs_to_cli():
    assert kwargs_to_cli({"render_every": 3, "real_time": True, "debug": False}) == [
        "--render-every", "3", "--real-time", "--no-debug",
    ]


def test_base_env_scripted_agent_ordering():
    bpy = fake_bpy.install()
    calls = []

    class Env(BaseEnv):
        def __init__(self, agent):
            super().__init__(agent)
            self.value = 0.0

        def _env_reset(self):
            calls.append("reset")
            self.value = 0.0

        def _env_prepare_step(self, action):
            calls.append(f"prepare_{action}")
            self.value = action

        def _env_post_step(self):
            calls.append(f"post_{self.value}")
            return {"obs": self.value, "reward": self.value}

    actions = iter([10, 20, 30])
    seen = []

    def agent(env, **ctx):
        seen.append((ctx["time"], ctx["obs"], ctx["done"]))
        return BaseEnv.CMD_STEP, next(actions)

    env = Env(agent)
    env.run(frame_range=(1, 4), use_animation=True)
    bpy.pump_draw()  # post of frame 1
    for _ in range(3):
        bpy.pump_frame()
    env.events.stop()

    # reset once; agent first consulted at frame 2 with frame-1 obs; each
    # action applied before that frame's post step
    assert calls == [
        "reset", "post_0.0",
        "prepare_10", "post_10",
        "prepare_20", "post_20",
        "prepare_30", "post_30",
    ]
    assert seen[0] == (2, 0.0, False)
    assert seen[1] == (3, 10, False)
    # at frame 4 the done horizon (frame_range[1]=4) is already reached
    assert seen[2] == (4, 20, True)


def test_default_renderer_names_its_roadmap_item():
    """The default renderer is ported (ROADMAP Queue 1, item 8's camera and
    offscreen modules): the scene camera, rgb, color-managed, every nth
    frame.  ``tests/test_torch_camera.py`` holds what it renders."""
    from blendjax_torch.btb.offscreen import OffScreenRenderer

    bpy = fake_bpy.install()
    env = BaseEnv(lambda env, **ctx: (BaseEnv.CMD_STEP, None))
    env.attach_default_renderer(every_nth=3)
    assert isinstance(env.renderer, OffScreenRenderer) and env.render_every == 3
    assert env.renderer.mode == "rgb" and env.renderer.gamma is True
    assert env.renderer.camera.bpy_camera is bpy.context.scene.camera


def test_remote_env_rpc_loop(fake_blender):
    with launch_env(scene="", script=ENV_SCRIPT, background=True, horizon=5,
                    timeoutms=30000, start_port=_free_block(1)) as env:
        obs, info = env.reset()
        assert obs == 0.0
        assert info["time"] == 2  # reset reply carries frame-2 context

        obs, reward, done, info = env.step(4.0)
        assert obs == 4.0 and reward == pytest.approx(0.4) and not done
        t0 = info["time"]
        obs, reward, done, info = env.step(8.0)
        assert obs == 8.0 and reward == pytest.approx(0.8)
        assert info["time"] == t0 + 1  # one step == one frame

        # run to the horizon -> done
        while not done:
            obs, reward, done, info = env.step(1.0)
        assert info["time"] >= 5

        # reset after done restarts the episode
        obs, info = env.reset()
        assert obs == 0.0
        obs, reward, done, _ = env.step(2.0)
        assert obs == 2.0 and not done
        assert env.render(mode="rgb_array") is None


def test_env_pool_batched(fake_blender):
    with launch_env_pool(scene="", script=ENV_SCRIPT, num_instances=2, background=True,
                         horizon=6, timeoutms=30000, start_port=_free_block(2)) as pool:
        obs, infos = pool.reset()
        np.testing.assert_allclose(obs, [0.0, 0.0])
        assert len(infos) == 2

        obs, rewards, dones, infos = pool.step([1.0, 3.0])
        np.testing.assert_allclose(obs, [1.0, 3.0])
        np.testing.assert_allclose(rewards, [0.1, 0.3])
        assert not dones.any()

        # drive both to done
        for _ in range(8):
            obs, rewards, dones, infos = pool.step([1.0, 1.0])
            if dones.any():
                break
        assert dones.all()  # same horizon -> finish together

        # autoreset: next step resets them, fresh obs, zero reward
        obs, rewards, dones, infos = pool.step([9.0, 9.0])
        np.testing.assert_allclose(obs, [0.0, 0.0])
        np.testing.assert_allclose(rewards, [0.0, 0.0])
        assert not dones.any()
        # and stepping continues normally
        obs, rewards, dones, infos = pool.step([5.0, 6.0])
        np.testing.assert_allclose(obs, [5.0, 6.0])


def test_pool_action_count_mismatch():
    pool = EnvPool.__new__(EnvPool)
    pool.num_envs = 2
    pool.autoreset = False
    pool._needs_reset = np.zeros(2, bool)
    with pytest.raises(ValueError, match="expected 2 actions"):
        pool.step([1.0])


def test_pool_depth_beyond_the_reply_cache_is_refused():
    with pytest.raises(ValueError, match="reply-cache window"):
        EnvPool([_addr()], pipeline_depth=wire.REPLY_CACHE_DEPTH + 1)
    with pytest.raises(ValueError, match=">= 1"):
        EnvPool([_addr()], pipeline_depth=0)


def test_remote_controlled_agent_real_time_nonblocking():
    """real_time=True: with no pending request the agent must not block the
    frame loop (returns CMD_STEP, None); requests are served when present."""
    addr = _addr()
    agent = RemoteControlledAgent(addr, real_time=True, timeoutms=2000)
    req = zmq.Context.instance().socket(zmq.REQ)
    req.setsockopt(zmq.LINGER, 0)
    req.setsockopt(zmq.RCVTIMEO, 5000)
    req.connect(addr)
    env = types.SimpleNamespace(state=BaseEnv.STATE_RUN)
    try:
        # no request pending -> simulation continues without action
        assert agent(env, obs=0.0, done=False) == (BaseEnv.CMD_STEP, None)
        assert agent(env, obs=0.0, done=False) == (BaseEnv.CMD_STEP, None)

        # a pending step request is consumed
        wire.send_message(req, {"cmd": "step", "action": 3.5})
        time.sleep(0.2)  # let the request arrive
        cmd, action = agent(env, obs=0.0, done=False)
        assert cmd == BaseEnv.CMD_STEP and action == 3.5

        # next frame: the reply (previous ctx) goes out even in real time
        cmd, action = agent(env, obs=3.5, reward=1.0, done=False, time=7)
        assert (cmd, action) == (BaseEnv.CMD_STEP, None)
        reply = wire.recv_message(req)
        assert reply["obs"] == 3.5 and reply["time"] == 7

        # reset request while running -> CMD_RESTART
        wire.send_message(req, {"cmd": "reset"})
        time.sleep(0.2)
        cmd, action = agent(env, obs=3.5, done=False)
        assert cmd == BaseEnv.CMD_RESTART and action is None
    finally:
        agent.close()
        req.close(0)


def test_adapt_step_result_both_apis():
    # gymnasium: 5-tuple with terminated/truncated split
    out = adapt_step_result(1.0, 0.5, 1, {"k": 2}, gymnasium_api=True)
    assert out == (1.0, 0.5, True, False, {"k": 2})
    assert isinstance(out[2], bool)
    # classic gym: legacy 4-tuple, done passed through
    assert adapt_step_result(1.0, 0.5, True, {}, gymnasium_api=False) == (1.0, 0.5, True, {})


def test_openai_remote_env_stub_without_gym():
    """Without gym and gymnasium the package imports and the adapter is a
    stub that raises on use (the card's machine has neither)."""
    code = (
        "import sys\n"
        "sys.modules['gymnasium'] = None\n"
        "sys.modules['gym'] = None\n"
        "from blendjax_torch.btt import env, vector_env\n"
        "import blendjax_torch.btt.envpool\n"
        "assert not env.USING_GYMNASIUM\n"
        "for make in (env.OpenAIRemoteEnv, lambda: vector_env.BlenderVectorEnv(None, None, None)):\n"
        "    try:\n"
        "        make()\n"
        "    except ImportError as e:\n"
        "        print('stub:', e)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("stub:") == 2 and "gymnasium" in out.stdout


def test_gymnasium_adapter_api(fake_blender):
    """Under gymnasium the adapter satisfies the gymnasium.Env contract:
    reset() -> (obs, info), step() -> 5-tuple."""
    gymnasium = pytest.importorskip("gymnasium")
    from blendjax_torch.btt.env import USING_GYMNASIUM, OpenAIRemoteEnv

    assert USING_GYMNASIUM
    port = _free_block(1)

    class _TestEnv(OpenAIRemoteEnv):
        def __init__(self):
            super().__init__()
            self.launch(scene="", script=ENV_SCRIPT, background=True, horizon=5,
                        start_port=port)
            self.action_space = gymnasium.spaces.Box(-100.0, 100.0, shape=(),
                                                     dtype=np.float32)
            self.observation_space = gymnasium.spaces.Box(-100.0, 100.0, shape=(),
                                                          dtype=np.float32)

    env_id = "blendjax-torch-testenv-v0"
    if env_id in gymnasium.registry:
        del gymnasium.registry[env_id]
    gymnasium.register(id=env_id, entry_point=_TestEnv)
    env = gymnasium.make(env_id, disable_env_checker=False)
    try:
        result = env.reset(seed=123)
        assert isinstance(result, tuple) and len(result) == 2
        obs, info = result
        assert isinstance(info, dict)

        result = env.step(4.0)
        assert len(result) == 5
        obs, reward, terminated, truncated, info = result
        assert obs == 4.0 and reward == pytest.approx(0.4)
        assert terminated is False and truncated is False

        terminated = False
        while not terminated:
            obs, reward, terminated, truncated, info = env.step(1.0)
        # reset after termination works and returns the 2-tuple again
        obs, info = env.reset()
        assert isinstance(info, dict)
    finally:
        env.close()


def _vector_env(num_instances, horizon, **kwargs):
    gymnasium = pytest.importorskip("gymnasium")
    from blendjax_torch.btt.vector_env import launch_vector_env

    obs_space = gymnasium.spaces.Box(-np.inf, np.inf, shape=(), dtype=np.float64)
    act_space = gymnasium.spaces.Box(-10.0, 10.0, shape=(), dtype=np.float64)
    return launch_vector_env(
        scene="", script=ENV_SCRIPT, num_instances=num_instances,
        single_observation_space=obs_space, single_action_space=act_space,
        background=True, horizon=horizon, timeoutms=30000,
        start_port=_free_block(num_instances), **kwargs)


def test_vector_env_gymnasium_contract(fake_blender):
    """BlenderVectorEnv follows the gymnasium VectorEnv API over a fleet:
    batched spaces, 5-tuple step, NEXT_STEP autoreset."""
    with _vector_env(2, horizon=4) as env:
        assert env.num_envs == 2
        assert env.observation_space.shape == (2,)
        assert env.action_space.shape == (2,)

        obs, info = env.reset()
        assert obs.shape == (2,)
        np.testing.assert_allclose(obs, [0.0, 0.0])
        assert "env_infos" in info

        obs, rew, term, trunc, info = env.step(np.array([1.0, 3.0]))
        np.testing.assert_allclose(obs, [1.0, 3.0])
        np.testing.assert_allclose(rew, [0.1, 0.3])
        assert term.dtype == bool and trunc.dtype == bool
        assert not term.any() and not trunc.any()

        for _ in range(6):
            obs, rew, term, trunc, info = env.step(np.array([2.0, 2.0]))
            if term.any():
                break
        assert term.all()
        obs, rew, term, trunc, info = env.step(np.array([7.0, 7.0]))
        np.testing.assert_allclose(obs, [0.0, 0.0])
        np.testing.assert_allclose(rew, [0.0, 0.0])
        assert not term.any()


def test_vector_env_async_pair(fake_blender):
    """The gymnasium step_async/step_wait pair: the same 5-tuple contract
    as step(), with the NEXT_STEP autoreset boundary crossing the async
    path."""
    with _vector_env(2, horizon=4, pipeline_depth=2) as env:
        env.reset()
        env.step_async(np.array([1.0, 3.0]))
        obs, rew, term, trunc, info = env.step_wait()
        np.testing.assert_allclose(obs, [1.0, 3.0])
        np.testing.assert_allclose(rew, [0.1, 0.3])
        assert not term.any() and not trunc.any()
        for _ in range(6):
            env.step_async(np.array([2.0, 2.0]))
            obs, rew, term, trunc, info = env.step_wait()
            if term.any():
                break
        assert term.all()
        env.step_async(np.array([7.0, 7.0]))
        obs, rew, term, trunc, info = env.step_wait()
        np.testing.assert_allclose(obs, [0.0, 0.0])
        np.testing.assert_allclose(rew, [0.0, 0.0])
        assert not term.any()


# -- test_envpool_async.py ------------------------------------------------------


def _drive(pool, action_rounds, pipelined):
    out = []
    for actions in action_rounds:
        if pipelined:
            pool.step_async(list(actions))
            obs, rew, done, infos = pool.step_wait_full()
        else:
            obs, rew, done, infos = pool.step(list(actions))
        out.append((np.asarray(obs).copy(), np.asarray(rew).copy(), np.asarray(done).copy(),
                    [(i.get("time"), i.get("frame")) for i in infos]))
    return out


def test_async_lockstep_bit_identical(fake_blender):
    """Over the same deterministic fleet, the async path's full-batch mode
    gives byte for byte the transitions of lock-step ``step()``, an
    autoreset boundary included."""
    rounds = [[1.0, 2.0], [2.0, 3.0], [3.0, 1.0], [1.5, 2.5],  # crosses done@6
              [4.0, 5.0], [0.5, 0.25], [6.0, 7.0]]
    with launch_env_pool(scene="", script=ENV_SCRIPT, num_instances=2, background=True,
                         horizon=6, timeoutms=30000, start_port=_free_block(2),
                         pipeline_depth=2) as pool:
        pool.reset()
        lockstep = _drive(pool, rounds, pipelined=False)
        pool.reset()  # restart the episode: the fixture is deterministic
        asynced = _drive(pool, rounds, pipelined=True)
    for (lo, lr, ld, li), (ao, ar, ad, ai) in zip(lockstep, asynced):
        np.testing.assert_array_equal(lo, ao)
        assert lo.dtype == ao.dtype
        np.testing.assert_array_equal(lr, ar)
        assert lr.dtype == ar.dtype
        np.testing.assert_array_equal(ld, ad)
        assert li == ai  # per-env clocks advanced identically


def test_pipelined_depth2_ready_first_and_monotonic(fake_blender):
    """Depth-2 pipelining: ready-first collection with indices, per-env
    FIFO ordering, monotonic per-env clocks, and depth accounting."""
    with launch_env_pool(scene="", script=ENV_SCRIPT, num_instances=2, background=True,
                         horizon=1_000_000, timeoutms=30000, start_port=_free_block(2),
                         pipeline_depth=2) as pool:
        pool.reset()
        pool.step_async([1.0, 2.0])
        pool.step_async([3.0, 4.0])
        assert pool.inflight == [2, 2]
        with pytest.raises(RuntimeError, match="in flight"):
            pool.step_async([9.0, 9.0])
        times = {0: [], 1: []}
        seen = {0: [], 1: []}
        collected = 0
        while collected < 4:
            idx, obs, rew, done, infos = pool.step_wait(min_ready=1)
            assert len(idx) >= 1
            for j, i in enumerate(idx):
                i = int(i)
                times[i].append(infos[j]["time"])
                seen[i].append(float(np.asarray(obs).reshape(-1)[j]))
                assert infos[j]["healthy"]
            collected += len(idx)
        assert pool.inflight == [0, 0]
        assert seen[0] == [1.0, 3.0]
        assert seen[1] == [2.0, 4.0]
        for ts in times.values():
            assert ts == sorted(ts) and len(set(ts)) == len(ts)
        # lock-step step() refuses to interleave with a live pipeline
        pool.step_async([5.0, 5.0])
        with pytest.raises(RuntimeError, match="in flight"):
            pool.step([6.0, 6.0])
        pool.step_wait()
        with pytest.raises(ValueError, match="expected 2 actions"):
            pool.step_async([1.0])
        with pytest.raises(ValueError, match="indices"):
            pool.step_async([1.0, 2.0], indices=[0])


def test_out_of_order_replies_route_by_correlation(fake_blender):
    """ChaosProxy stalls reorder completion across envs: replies land at
    the right env index regardless of arrival order, with ``env_times``
    monotonic per env."""
    policy = FaultPolicy(max_retries=1, deadline_s=5.0, jitter=0.0, circuit_threshold=0,
                         seed=3)
    with BlenderLauncher(scene="", script=ENV_SCRIPT, num_instances=3, named_sockets=["GYM"],
                         start_port=_free_block(3), background=True,
                         instance_args=[["--horizon", "100000"]] * 3) as bl:
        addrs = bl.launch_info.addresses["GYM"]
        wait_env_ready(addrs)
        with ChaosProxy(addrs[0], seed=5) as proxy:
            counters = EventCounters()
            pool = EnvPool([proxy.address, addrs[1], addrs[2]], timeoutms=10000,
                           fault_policy=policy, counters=counters, pipeline_depth=2)
            try:
                pool.reset()
                times = {i: [] for i in range(3)}
                for round_no in range(4):
                    actions = [10.0 * (round_no + 1) + i for i in range(3)]
                    proxy.stall()  # env 0's replies held back
                    pool.step_async(actions)
                    idx, obs, rew, done, infos = pool.step_wait(min_ready=2)
                    got = {int(i) for i in idx}
                    assert 0 not in got and got <= {1, 2}
                    for j, i in enumerate(idx):
                        i = int(i)
                        assert float(np.asarray(obs)[j]) == actions[i]
                        times[i].append(infos[j]["time"])
                    proxy.resume()
                    while len(times[0]) <= round_no:
                        idx, obs, rew, done, infos = pool.step_wait(min_ready=1)
                        for j, i in enumerate(idx):
                            i = int(i)
                            assert float(np.asarray(obs)[j]) == actions[i]
                            times[i].append(infos[j]["time"])
                assert counters.get("quarantines") == 0
                for i, ts in times.items():
                    assert len(ts) == 4
                    assert ts == sorted(ts) and len(set(ts)) == len(ts), (i, ts)
                assert pool.healthy.all()
            finally:
                pool.close()


def _policy(**kw):
    base = dict(max_retries=1, deadline_s=0.6, backoff_base=0.05, backoff_factor=2.0,
                backoff_max=0.2, jitter=0.25, circuit_threshold=0, seed=7)
    base.update(kw)
    return FaultPolicy(**base)


def test_kill_mid_flight_quarantine_and_full_depth_readmission(fake_blender):
    """Kill 1 of 3 producers with requests in flight at depth 2: its
    pipeline drains into synthetic transitions (exactly one ``done=True``),
    survivors keep completing, and once a producer is relaunched on its
    address the pool's probes re-admit it at full pipeline depth, serving
    real transitions."""
    base = _free_block(3)
    with BlenderLauncher(scene="", script=ENV_SCRIPT, num_instances=3, named_sockets=["GYM"],
                         start_port=base, background=True,
                         instance_args=[["--horizon", "100000"]] * 3) as bl:
        addrs = bl.launch_info.addresses["GYM"]
        wait_env_ready(addrs)
        counters = EventCounters()
        # the victim sits behind a chaos proxy so the kill provably lands
        # while its two requests are in flight (stall first, then kill)
        with ChaosProxy(addrs[1], seed=11) as proxy:
            pool = EnvPool([addrs[0], proxy.address, addrs[2]], timeoutms=10000,
                           fault_policy=_policy(), counters=counters, pipeline_depth=2)
            try:
                pool.reset()
                pool.step_async([1.0, 1.0, 1.0])
                pool.step_async([2.0, 2.0, 2.0])
                idx, *_ = pool.step_wait()
                assert len(idx) == 6
                proxy.stall()
                pool.step_async([3.0, 3.0, 3.0])
                pool.step_async([4.0, 4.0, 4.0])
                assert pool.inflight == [2, 2, 2]
                kill_instance(bl, 1)
                bl.launch_info.processes[1].wait(timeout=10)
                proxy.resume()

                env1_dones = env1_synthetic = 0
                relaunched = None
                readmitted = False
                deadline = time.monotonic() + 60
                try:
                    while not readmitted and time.monotonic() < deadline:
                        idx, obs, rew, done, infos = pool.step_wait(min_ready=3)
                        for j, i in enumerate(idx):
                            i = int(i)
                            if i != 1:
                                assert infos[j]["healthy"]  # survivors never poisoned
                                continue
                            env1_dones += bool(done[j])
                            if not infos[j].get("healthy", True):
                                env1_synthetic += 1
                                assert rew[j] == 0.0
                            if infos[j].get("readmitted"):
                                readmitted = True
                        if relaunched is None and pool.quarantined[1]:
                            # the watchdog's respawn: a fresh producer on the address
                            relaunched = BlenderLauncher(
                                scene="", script=ENV_SCRIPT, num_instances=1,
                                named_sockets=["GYM"], start_port=base + 1, background=True,
                                instance_args=[["--horizon", "100000"]]).__enter__()
                            pool.notify_respawn(1)
                        pool.step_async([5.0] * len(idx), indices=list(idx))
                    assert readmitted, "no re-admission"
                    assert env1_dones == 1  # the interrupted episode closed once
                    assert env1_synthetic >= 1

                    pool.step_wait()
                    pool.step_async([7.0, 8.0, 9.0])
                    pool.step_async([7.5, 8.5, 9.5])
                    assert pool.inflight == [2, 2, 2]
                    got = {0: [], 1: [], 2: []}
                    while any(len(v) < 2 for v in got.values()):
                        idx, obs, rew, done, infos = pool.step_wait(min_ready=1)
                        for j, i in enumerate(idx):
                            got[int(i)].append(float(np.asarray(obs)[j]))
                            assert infos[j]["healthy"]
                    assert got[1] == [8.0, 8.5]  # real transitions again
                    assert counters.get("quarantines") == 1
                    assert counters.get("readmissions") == 1
                    assert counters.get("inflight_discards") >= 2
                    assert pool.inflight == [0, 0, 0]
                finally:
                    if relaunched is not None:
                        relaunched.__exit__(None, None, None)
            finally:
                pool.close()


def test_kill_mid_flight_strict_mode_raises_naming_env(fake_blender):
    """quarantine=False: a producer dying with pipeline requests in flight
    fails the wait with a ``TimeoutError`` naming the env, and completed
    transitions survive for a later collection."""
    with BlenderLauncher(scene="", script=ENV_SCRIPT, num_instances=2, named_sockets=["GYM"],
                         start_port=_free_block(2), background=True,
                         instance_args=[["--horizon", "100000"]] * 2) as bl:
        addrs = bl.launch_info.addresses["GYM"]
        wait_env_ready(addrs)
        with ChaosProxy(addrs[0], seed=13) as proxy:
            pool = EnvPool([proxy.address, addrs[1]], timeoutms=10000,
                           fault_policy=_policy(max_retries=0), quarantine=False,
                           counters=EventCounters(), pipeline_depth=2)
            try:
                pool.reset()
                proxy.stall()
                pool.step_async([1.0, 2.0])
                pool.step_async([3.0, 4.0])
                assert pool.inflight == [2, 2]
                kill_instance(bl, 0)
                with pytest.raises(TimeoutError, match="environment 0"):
                    deadline = time.monotonic() + 60
                    while time.monotonic() < deadline:
                        pool.step_wait(min_ready=4, timeout_ms=5000)
                idx, obs, rew, done, infos = pool.step_wait(min_ready=1, timeout_ms=5000)
                assert {int(i) for i in idx} == {1}
                assert [float(v) for v in np.asarray(obs)] == [2.0, 4.0]
            finally:
                pool.close()


def test_agent_dedupes_resent_correlated_step():
    """A re-sent ``step`` carrying the same correlation id is answered from
    the reply cache instead of simulating the frame twice; the id is echoed
    in every reply."""
    addr = _addr()
    agent = RemoteControlledAgent(addr, timeoutms=1000)
    dealer = zmq.Context.instance().socket(zmq.DEALER)
    dealer.setsockopt(zmq.LINGER, 0)
    dealer.setsockopt(zmq.RCVTIMEO, 5000)
    dealer.connect(addr)
    env = types.SimpleNamespace(state=BaseEnv.STATE_RUN)
    try:
        req_a = {"cmd": "step", "action": 3.5}
        mid_a = wire.stamp_message_id(req_a)
        wire.send_message_dealer(dealer, req_a)
        cmd, action = agent(env, obs=0.0, done=False)
        assert (cmd, action) == (BaseEnv.CMD_STEP, 3.5)

        wire.send_message_dealer(dealer, dict(req_a))
        req_b = {"cmd": "step", "action": 7.0}
        wire.stamp_message_id(req_b)
        wire.send_message_dealer(dealer, req_b)
        time.sleep(0.2)

        # the reply for A goes out, the duplicate is served from the cache
        # (no second simulation), and B is the action applied
        cmd, action = agent(env, obs=3.5, reward=0.35, done=False, time=9)
        assert (cmd, action) == (BaseEnv.CMD_STEP, 7.0)
        first = wire.recv_message_dealer(dealer)
        dup = wire.recv_message_dealer(dealer)
        assert first["obs"] == 3.5 and first["time"] == 9
        assert first[wire.BTMID_KEY] == mid_a
        assert dup == first

        cmd, action = agent(env, obs=7.0, reward=0.7, done=False, time=10)
        assert (cmd, action) == (BaseEnv.CMD_STEP, None)
        reply_b = wire.recv_message_dealer(dealer)
        assert reply_b["obs"] == 7.0 and reply_b["time"] == 10
        assert reply_b[wire.BTMID_KEY] == req_b[wire.BTMID_KEY]
    finally:
        agent.close()
        dealer.close(0)


def test_lost_reply_recovered_in_order_without_resimulation(fake_blender, monkeypatch):
    """A reply lost ahead of an out-of-order match is recovered: the newer
    reply waits, the older request is re-sent under its id, the producer's
    reply cache answers it, and every submission yields one transition in
    submission order."""
    counters = EventCounters()
    policy = FaultPolicy(max_retries=2, deadline_s=8.0, backoff_base=0.05, jitter=0.0,
                         circuit_threshold=0, seed=5)
    with launch_env_pool(scene="", script=ENV_SCRIPT, num_instances=1, background=True,
                         horizon=1_000_000, timeoutms=8000, start_port=_free_block(1),
                         pipeline_depth=3, fault_policy=policy, counters=counters) as pool:
        pool.reset()
        pool.step_async([1.0, 2.0, 3.0], indices=[0, 0, 0])
        real_recv = wire.recv_message_dealer
        state = {"swallowed": False}

        def lossy(sock, flags=0):
            d = real_recv(sock, flags=flags)
            if not state["swallowed"]:
                state["swallowed"] = True  # reply 1.0 evaporates in transit
                raise zmq.Again()
            return d

        monkeypatch.setattr("blendjax_torch.wire.recv_message_dealer", lossy)
        idx, obs, rew, done, infos = pool.step_wait(min_ready=3)
        assert state["swallowed"]
        assert list(idx) == [0, 0, 0]
        assert [float(v) for v in np.asarray(obs)] == [1.0, 2.0, 3.0]
        times = [i["time"] for i in infos]
        assert times == sorted(times) and len(set(times)) == 3
        assert all(i["healthy"] for i in infos)
        assert counters.get("retries") >= 1
        assert counters.get("inflight_discards") == 0
        assert pool.inflight == [0]
        pool.step_async([4.0], indices=[0])
        idx, obs, *_ = pool.step_wait(min_ready=1)
        assert float(np.asarray(obs)[0]) == 4.0


def test_remote_env_policy_retry_is_exactly_once():
    """A ``RemoteEnv`` under a ``FaultPolicy`` stamps each logical call
    once, so its timeout-driven re-send carries the same correlation id
    and the agent never simulates the retried ``step`` twice."""
    addr = _addr()
    agent = RemoteControlledAgent(addr, timeoutms=1000)
    policy = FaultPolicy(max_retries=2, backoff_base=0.01, jitter=0.0, circuit_threshold=0,
                         seed=1)
    counters = EventCounters()
    env_ns = types.SimpleNamespace(state=BaseEnv.STATE_RUN)
    result = {}

    def client():
        renv = RemoteEnv(addr, timeoutms=300, fault_policy=policy, counters=counters)
        try:
            result["step"] = renv.step(3.5)
        except BaseException as exc:
            result["error"] = exc
        finally:
            renv.close()

    t = threading.Thread(target=client, daemon=True)
    try:
        t.start()
        time.sleep(0.45)  # both copies of the request are queued now
        cmd, action = agent(env_ns, obs=0.0, done=False)
        assert (cmd, action) == (BaseEnv.CMD_STEP, 3.5)
        cmd, action = agent(env_ns, obs=3.5, reward=0.35, done=False, time=9)
        assert (cmd, action) == (BaseEnv.CMD_STEP, None)
        t.join(timeout=10)
        assert not t.is_alive()
        assert "error" not in result, result.get("error")
        obs, reward, done, info = result["step"]
        assert (obs, reward, done) == (3.5, 0.35, False)
        assert info["time"] == 9
        assert counters.get("retries") >= 1
    finally:
        agent.close()


def _legacy_server(addr, stop, stall=None, delay_s=0.0):
    """A REP producer that echoes no correlation id; with ``stall`` set it
    swallows the next request and answers nothing more."""
    rep = zmq.Context.instance().socket(zmq.REP)
    rep.setsockopt(zmq.LINGER, 0)
    rep.setsockopt(zmq.RCVTIMEO, 100)
    rep.bind(addr)
    t = 0
    try:
        while not stop.is_set():
            try:
                req = wire.recv_message(rep)
            except zmq.Again:
                continue
            if stall is not None and stall.is_set():
                stop.wait()
                break
            time.sleep(delay_s)
            t += 1
            obs = 0.0 if req["cmd"] == "reset" else req["action"]
            wire.send_message(rep, {"obs": obs, "reward": 0.0, "done": False, "time": t})
    finally:
        rep.close(0)


def test_legacy_producer_timeout_escalates_without_retry():
    """Once the pool has seen a reply without a correlation id from an env,
    an in-flight timeout escalates straight to quarantine instead of
    re-sending (a retry's duplicate reply would shift FIFO matching)."""
    addr, stall, stop = _addr(), threading.Event(), threading.Event()
    thread = threading.Thread(target=_legacy_server, args=(addr, stop, stall), daemon=True)
    thread.start()
    counters = EventCounters()
    policy = FaultPolicy(max_retries=3, deadline_s=0.5, backoff_base=0.05, jitter=0.0,
                         circuit_threshold=0, seed=7)
    pool = EnvPool([addr], timeoutms=2000, fault_policy=policy, counters=counters,
                   pipeline_depth=2)
    try:
        pool.step_async([1.0])
        idx, obs, rew, done, infos = pool.step_wait(min_ready=1)
        assert list(idx) == [0] and infos[0]["healthy"]
        assert float(np.asarray(obs)[0]) == 0.0  # the autoreset "reset"

        stall.set()
        pool.step_async([2.0])
        idx, obs, rew, done, infos = pool.step_wait(min_ready=1)
        assert counters.get("retries") == 0
        assert counters.get("quarantines") == 1
        assert list(idx) == [0]
        assert bool(np.asarray(done)[0]) and not infos[0]["healthy"]
        assert bool(pool.quarantined[0])
    finally:
        stop.set()
        pool.close()
        thread.join(timeout=3)


def test_legacy_producer_retried_before_first_reply_fails_cleanly():
    """A retry that fires before a legacy env's first reply leaves its
    attribution unrecoverable: the env fails cleanly (quarantine and
    synthetic transitions) instead of serving shifted transitions."""
    addr, stop = _addr(), threading.Event()
    thread = threading.Thread(target=_legacy_server, args=(addr, stop),
                              kwargs={"delay_s": 1.0}, daemon=True)
    thread.start()
    counters = EventCounters()
    policy = FaultPolicy(max_retries=3, deadline_s=0.4, backoff_base=0.05, jitter=0.0,
                         circuit_threshold=0, seed=7)
    pool = EnvPool([addr], timeoutms=2000, fault_policy=policy, counters=counters,
                   pipeline_depth=2)
    try:
        pool.step_async([1.0])
        pool.step_async([2.0])
        idx, obs, rew, done, infos = pool.step_wait(min_ready=2)
        assert counters.get("retries") >= 1
        assert counters.get("quarantines") == 1
        assert list(idx) == [0, 0]
        assert list(np.asarray(done)) == [True, False]  # exactly one quarantine done
        assert not infos[0]["healthy"] and not infos[1]["healthy"]
        assert bool(pool.quarantined[0])
    finally:
        stop.set()
        pool.close()
        thread.join(timeout=3)


def test_traced_pool_merges_producer_spans(fake_blender):
    """``trace=True``: every RPC records a client span tagged with its
    correlation id, and the producer's ``producer_step`` span rides back
    on the reply under the same id, inside the client's span."""
    from blendjax_torch.obs.spans import span_trace

    with launch_env_pool(scene="", script=ENV_SCRIPT, num_instances=2, background=True,
                         horizon=100, timeoutms=30000, start_port=_free_block(2),
                         pipeline_depth=2, trace=True) as pool:
        pool.reset()
        obs, *_ = pool.step([1.0, 2.0])
        pool.step_async([3.0, 4.0])
        pool.step_wait()
        spans = pool.spans.snapshot()
    np.testing.assert_array_equal(obs, [1.0, 2.0])  # the spans stay off the data
    client = {span_trace(s): s for s in spans if s["cat"] == "envpool"}
    producer = [s for s in spans if s["cat"] == "producer"]
    assert len(client) == 6 and len(producer) == 6
    assert {s["name"] for s in client.values()} == {"env_rpc", "env_step"}
    for s in producer:
        outer = client[span_trace(s)]
        assert s["pid"] != outer["pid"]
        assert outer["ts"] <= s["ts"] and s["ts"] + s["dur"] <= outer["ts"] + outer["dur"]


# -- test_faults.py ------------------------------------------------------------------


def test_backoff_deterministic_and_capped():
    policy = FaultPolicy(backoff_base=0.1, backoff_factor=2.0, backoff_max=0.5, jitter=0.25,
                         seed=42)
    a, b = policy.new_state(key=3), policy.new_state(key=3)
    seq_a = [a.backoff(n) for n in range(1, 8)]
    assert seq_a == [b.backoff(n) for n in range(1, 8)]
    other = policy.new_state(key=4)
    assert [other.backoff(n) for n in range(1, 8)] != seq_a
    for n, d in enumerate(seq_a, start=1):
        base = min(0.5, 0.1 * 2.0 ** (n - 1))
        assert base * 0.75 <= d <= base * 1.25


def test_no_jitter_is_exact():
    policy = FaultPolicy(backoff_base=0.1, backoff_factor=2.0, backoff_max=1.0, jitter=0.0)
    st = policy.new_state()
    assert [st.backoff(n) for n in (1, 2, 3, 4, 5)] == pytest.approx(
        [0.1, 0.2, 0.4, 0.8, 1.0])


def test_run_retries_then_succeeds():
    counters = EventCounters()
    policy = FaultPolicy(max_retries=3, backoff_base=0.01, jitter=0.0)
    calls, slept = [], []

    def fn(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise TimeoutError("transient")
        return "ok"

    assert policy.run(fn, counters=counters, sleep=slept.append) == "ok"
    assert calls == [0, 1, 2]
    assert counters.get("retries") == 2
    assert counters.get("timeouts") == 2
    assert counters.get("failures") == 0
    assert slept == pytest.approx([0.01, 0.02])


def test_run_exhausts_and_raises():
    counters = EventCounters()
    policy = FaultPolicy(max_retries=2, backoff_base=0.001, jitter=0.0)

    def fn(attempt):
        raise TimeoutError("down")

    with pytest.raises(TimeoutError, match="down"):
        policy.run(fn, counters=counters, sleep=lambda s: None)
    assert counters.get("retries") == 2
    assert counters.get("failures") == 1
    assert counters.get("timeouts") == 3


def test_run_non_retryable_propagates_immediately():
    policy = FaultPolicy(max_retries=5)
    calls = []

    def fn(attempt):
        calls.append(attempt)
        raise ValueError("logic bug, not a fault")

    with pytest.raises(ValueError):
        policy.run(fn, sleep=lambda s: None, counters=EventCounters())
    assert calls == [0]


def test_deadline_stops_retrying():
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    counters = EventCounters()
    policy = FaultPolicy(max_retries=10, deadline_s=1.0, backoff_base=0.01, jitter=0.0,
                         _clock=clock)
    calls = []

    def fn(attempt):
        calls.append(attempt)
        raise TimeoutError("slow")

    with pytest.raises(TimeoutError):
        policy.run(fn, counters=counters, sleep=lambda s: None)
    assert len(calls) == 1
    assert counters.get("failures") == 1


def test_circuit_opens_and_cools_down():
    t = [0.0]
    policy = FaultPolicy(max_retries=0, circuit_threshold=3, circuit_cooldown_s=10.0,
                         backoff_base=0.0, jitter=0.0, _clock=lambda: t[0])
    counters = EventCounters()
    state = policy.new_state()

    def fn(attempt):
        raise TimeoutError("dead")

    for _ in range(3):
        with pytest.raises(TimeoutError):
            policy.run(fn, state=state, counters=counters, sleep=lambda s: None)
    assert counters.get("circuit_opens") == 1
    assert state.circuit_open()

    calls = []
    with pytest.raises(CircuitOpenError):
        policy.run(lambda a: calls.append(a), state=state, counters=counters)
    assert calls == []
    assert counters.get("circuit_rejections") == 1

    t[0] = 11.0
    assert policy.run(lambda a: "back", state=state, counters=counters) == "back"
    assert not state.circuit_open()
    assert state.consecutive_failures == 0


def test_event_counters_thread_safe_and_snapshot():
    c = EventCounters()
    threads = [threading.Thread(target=lambda: [c.incr("x") for _ in range(1000)])
               for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert c.get("x") == 8000
    c.incr("y", 5)
    snap = c.snapshot()
    assert snap == {"x": 8000, "y": 5}
    snap["x"] = 0  # snapshot is a copy
    assert c.get("x") == 8000
    c.reset()
    assert c.snapshot() == {}
    assert c.get("missing") == 0


def test_fault_path_notes_the_flight_recorder():
    from blendjax_torch.obs import flight_recorder

    policy = FaultPolicy(max_retries=1, backoff_base=0.0, jitter=0.0)
    before = len(flight_recorder.snapshot())

    def fn(attempt):
        raise TimeoutError("down")

    with pytest.raises(TimeoutError):
        policy.run(fn, counters=EventCounters(), name="probe", sleep=lambda s: None)
    events = [e["event"] for e in flight_recorder.snapshot()[before:]]
    assert events == ["retry", "rpc_failure"]


# -- the port's cartpole producer ------------------------------------------------------


class _PoolTwin:
    """What a pool of cartpole producers seeded ``seed + i`` must return,
    stepped in this process under the pool's autoreset contract."""

    def __init__(self, n, seed):
        self.poles = [cartpole.Cartpole(seed + i) for i in range(n)]
        self.obs = [p.reset() for p in self.poles]  # each producer's first reset
        self.needs_reset = [False] * n

    def step(self, forces):
        out = []
        for i, (pole, f) in enumerate(zip(self.poles, forces)):
            if self.needs_reset[i]:
                obs, reward, done = pole.reset(), 0.0, False
            else:
                obs, reward, done = pole.step(f)
            self.needs_reset[i] = done
            out.append((obs, reward, done))
        obs, rew, done = zip(*out)
        return np.stack(obs), np.asarray(rew, np.float32), np.asarray(done)


def _forces(rounds, n, seed=0):
    """Bang-bang forces that drop the pole within a few dozen steps."""
    rng = np.random.default_rng(seed)
    return [list(np.where(rng.random(n) < 0.8, 20.0, -20.0)) for _ in range(rounds)]


def _hold_to_twin(pool, seed, n, rounds, pipelined=False):
    twin = _PoolTwin(n, seed)
    obs, _ = pool.reset()
    np.testing.assert_array_equal(obs, np.stack(twin.obs))
    assert obs.dtype == np.float32 and obs.shape == (n, cartpole.OBS_DIM)
    dones_seen = 0
    for forces in _forces(rounds, n):
        if pipelined:
            pool.step_async(forces)
            obs, rew, done, infos = pool.step_wait_full()
        else:
            obs, rew, done, infos = pool.step(forces)
        want_obs, want_rew, want_done = twin.step(forces)
        np.testing.assert_array_equal(obs, want_obs)
        np.testing.assert_array_equal(rew, want_rew)
        np.testing.assert_array_equal(done, want_done)
        assert all(i["healthy"] for i in infos)
        dones_seen += int(done.sum())
    assert dones_seen >= n  # every lane crossed an episode boundary


@pytest.mark.parametrize("pipelined", [False, True])
def test_cartpole_pool_matches_dynamics_in_process(fake_blender, pipelined):
    seed, n = 5, 2
    with launch_env_pool(scene="", script=CARTPOLE, num_instances=n, background=True,
                         timeoutms=30000, start_port=_free_block(n), seed=seed,
                         pipeline_depth=2) as pool:
        _hold_to_twin(pool, seed, n, rounds=80, pipelined=pipelined)


def test_cartpole_remote_env_episode(fake_blender):
    """One producer through ``RemoteEnv``: reset, steps to the end of an
    episode, reset (a fresh draw), all equal to the dynamics in process."""
    pole = cartpole.Cartpole(11)
    with launch_env(scene="", script=CARTPOLE, background=True, timeoutms=30000,
                    start_port=_free_block(1), seed=11) as env:
        obs, info = env.reset()
        np.testing.assert_array_equal(obs, pole.reset())
        for _ in range(2):
            done = False
            while not done:
                obs, reward, done, info = env.step(20.0)
                want = pole.step(20.0)
                np.testing.assert_array_equal(obs, want[0])
                assert (reward, done) == want[1:]
            obs, _ = env.reset()
            np.testing.assert_array_equal(obs, pole.reset())


def test_cartpole_dynamics_vectorize():
    """The dynamics of one pole equal the batched form the numpy pool uses."""
    rng = np.random.default_rng(0)
    states = rng.uniform(-0.05, 0.05, (4, 4))
    forces = np.array([20.0, -20.0, 3.0, 0.0])
    batched = cartpole.step_state(states, forces)
    for s, f, b in zip(states, forces, batched):
        np.testing.assert_array_equal(cartpole.step_state(s, f), b)
    assert cartpole.observe(batched).shape == (4, 3)
    assert not cartpole.finished(batched, 0).any()
    assert cartpole.finished(batched, cartpole.MAX_STEPS).all()


# -- the wire protocol is shared -------------------------------------------------------


def test_port_pool_steps_the_reference_producer(monkeypatch):
    """The port's pool over the reference's ``env.blend.py`` (the JAX
    package's BaseEnv, agent and animation loop) gives the transitions
    the fixture defines."""
    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)
    with launch_env_pool(scene="", script=REF_ENV_SCRIPT, num_instances=2, background=True,
                         horizon=6, timeoutms=30000, start_port=_free_block(2),
                         pipeline_depth=2) as pool:
        obs, _ = pool.reset()
        np.testing.assert_array_equal(obs, [0.0, 0.0])
        obs, rew, done, infos = pool.step([1.0, 3.0])
        np.testing.assert_array_equal(obs, [1.0, 3.0])
        np.testing.assert_allclose(rew, [0.1, 0.3])
        frames = [i["frame"] for i in infos]
        pool.step_async([2.0, 4.0])
        idx, obs, rew, done, infos = pool.step_wait(min_ready=2)
        assert sorted(int(i) for i in idx) == [0, 1]
        assert {int(i): float(o) for i, o in zip(idx, obs)} == {0: 2.0, 1: 4.0}
        assert [i["frame"] for _, i in sorted(zip(idx, infos), key=lambda p: p[0])] == [
            f + 1 for f in frames]


def test_reference_pool_steps_the_port_cartpole(fake_blender):
    """The reference's ``EnvPool`` over the port's cartpole producers:
    the transitions equal the dynamics stepped in this process."""
    from blendjax.btt.envpool import EnvPool as JEnvPool

    seed, n = 21, 2
    with BlenderLauncher(scene="", script=CARTPOLE, num_instances=n, named_sockets=["GYM"],
                         start_port=_free_block(n), background=True, seed=seed) as bl:
        with JEnvPool(bl.launch_info.addresses["GYM"], timeoutms=30000,
                      pipeline_depth=2) as pool:
            _hold_to_twin(pool, seed, n, rounds=60)

