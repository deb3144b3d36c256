"""Consumer-side remote environment, a copy of ``blendjax.btt.env``.

``RemoteEnv`` gives the familiar blocking ``step()/reset()`` over a REQ
socket whose peer is a :class:`blendjax_torch.btb.env.RemoteControlledAgent`
inside Blender (or the JAX package's: the wire protocol is shared).  One
``step()`` == one simulated frame.  Observations come back as numpy
pytrees; for batched policy training over many instances use
:class:`blendjax_torch.btt.envpool.EnvPool`.

``REQ_RELAXED`` + ``REQ_CORRELATE`` keep the REQ socket usable after a
timeout (no strict alternation lockup).

``OpenAIRemoteEnv`` is the gym/gymnasium adapter; neither package is
needed to import this module (without them the adapter is a stub that
raises on use).  The remote ``render()`` viewer is not ported (ROADMAP
Queue 1, item 8): ``render`` returns the last frame the producer sent.
"""

from __future__ import annotations

from contextlib import ExitStack, contextmanager

import zmq

from blendjax_torch import wire
from blendjax_torch.btt.constants import DEFAULT_TIMEOUTMS


class RemoteEnv:
    """Blocking client for one remote Blender environment.

    ``fault_policy`` (a :class:`blendjax_torch.btt.faults.FaultPolicy`)
    makes every RPC retry with backoff inside the policy's deadline and
    trips a circuit breaker after consecutive failures; without one, a
    single timeout raises.  Retries re-send the request under the same
    correlation id, which the producers dedupe (the frame is never
    simulated twice); see :mod:`blendjax_torch.btt.faults` for the caveat
    with producers that ignore the id.
    """

    def __init__(self, address, timeoutms=DEFAULT_TIMEOUTMS, fault_policy=None,
                 counters=None):
        self._ctx = zmq.Context.instance()
        self.socket = self._ctx.socket(zmq.REQ)
        self.socket.setsockopt(zmq.LINGER, 0)
        self.socket.setsockopt(zmq.SNDTIMEO, timeoutms * 10)
        self.socket.setsockopt(zmq.RCVTIMEO, timeoutms)
        self.socket.setsockopt(zmq.REQ_RELAXED, 1)
        self.socket.setsockopt(zmq.REQ_CORRELATE, 1)
        self.socket.connect(address)
        self.env_time = None
        self.rgb_array = None
        self.viewer = None
        self.fault_policy = fault_policy
        self._fault_state = (
            fault_policy.new_state() if fault_policy is not None else None
        )
        self._counters = counters

    def reset(self):
        """Reset; returns ``(obs, info)``."""
        ddict = self._reqrep(cmd="reset")
        self.rgb_array = ddict.pop("rgb_array", None)
        return ddict.pop("obs"), ddict

    def step(self, action):
        """Apply ``action``; returns ``(obs, reward, done, info)``.

        ``action`` must be wire-serializable (numbers, numpy arrays,
        nested containers thereof).
        """
        ddict = self._reqrep(cmd="step", action=action)
        obs = ddict.pop("obs")
        reward = ddict.pop("reward")
        done = ddict.pop("done")
        self.rgb_array = ddict.pop("rgb_array", None)
        return obs, reward, done, ddict

    def render(self, mode="human", backend=None):
        """Show (``mode="human"``, in a viewer from
        :mod:`blendjax_torch.btt.env_rendering`) or return
        (``mode="rgb_array"``) the last frame the remote env's renderer
        sent; None when it sent none."""
        if mode == "rgb_array" or self.rgb_array is None:
            return self.rgb_array
        if self.viewer is None:
            from blendjax_torch.btt.env_rendering import create_renderer

            self.viewer = create_renderer(backend)
        self.viewer.imshow(self.rgb_array)
        return None

    def _reqrep(self, **send_kwargs):
        if self.fault_policy is None:
            return self._attempt(send_kwargs)
        # one correlation id for every re-send of this logical call: the
        # producer-side agent dedupes a retried non-idempotent ``step``
        # (serving its cached reply instead of simulating the frame twice)
        wire.stamp_message_id(send_kwargs)
        return self.fault_policy.run(
            lambda attempt: self._attempt(send_kwargs),
            state=self._fault_state,
            counters=self._counters,
            name=f"RemoteEnv {send_kwargs.get('cmd', 'rpc')}",
        )

    def _attempt(self, send_kwargs):
        """One send+recv cycle (REQ_RELAXED keeps the socket usable for a
        policy-driven re-send after a timeout)."""
        try:
            wire.send_message(self.socket, {**send_kwargs, "time": self.env_time})
        except zmq.Again:
            raise TimeoutError("Failed to send to remote environment") from None
        try:
            ddict = wire.recv_message(self.socket)
        except zmq.Again:
            raise TimeoutError("No response from remote environment") from None
        ddict.pop(wire.BTMID_KEY, None)  # echoed correlation id, not info
        self.env_time = ddict["time"]
        return ddict

    def close(self):
        if self.viewer is not None:
            self.viewer.close()
            self.viewer = None
        if self.socket is not None:
            self.socket.close(0)
            self.socket = None


def kwargs_to_cli(kwargs):
    """Python kwargs -> CLI flags for the remote env script: ``k=v`` becomes
    ``--k v``; booleans become ``--k`` / ``--no-k``; underscores become
    dashes."""
    args = []
    for key, value in kwargs.items():
        key = key.replace("_", "-")
        if isinstance(value, bool):
            args.append(f"--{key}" if value else f"--no-{key}")
        else:
            args.extend([f"--{key}", str(value)])
    return args


@contextmanager
def launch_env(scene, script, background=False, timeoutms=DEFAULT_TIMEOUTMS,
               fault_policy=None, start_port=11000, seed=None, **kwargs):
    """Launch one Blender env instance and yield a connected RemoteEnv.
    Extra kwargs become CLI flags for the env script (see
    :func:`kwargs_to_cli`).  ``start_port`` is the instance's port and
    ``seed`` its ``-btseed`` (random when None)."""
    from blendjax_torch.btt.launcher import BlenderLauncher

    env = None
    try:
        with BlenderLauncher(
            scene=scene,
            script=script,
            num_instances=1,
            named_sockets=["GYM"],
            instance_args=[kwargs_to_cli(kwargs)],
            background=background,
            start_port=start_port,
            seed=seed,
        ) as bl:
            env = RemoteEnv(bl.launch_info.addresses["GYM"][0],
                            timeoutms=timeoutms, fault_policy=fault_policy)
            yield env
    finally:
        if env is not None:
            env.close()


def _gym_module():
    try:
        import gymnasium

        return gymnasium
    except ImportError:
        pass
    try:
        import gym

        return gym
    except ImportError:
        return None


_gym = _gym_module()

#: True when the adapter's backing module is gymnasium, whose API differs
#: from classic gym: ``step`` returns a 5-tuple with separate
#: ``terminated``/``truncated`` flags and ``reset`` returns ``(obs, info)``.
USING_GYMNASIUM = _gym is not None and _gym.__name__ == "gymnasium"


def adapt_step_result(obs, reward, done, info, gymnasium_api):
    """Convert the wire-level ``(obs, reward, done, info)`` to the backing
    module's ``step`` contract.

    Under gymnasium: ``(obs, reward, terminated, truncated, info)``.  The
    producer's ``done`` means task termination (e.g. the pole fell); the
    remote protocol has no separate time-limit signal, so ``truncated`` is
    always False — wrap with ``gymnasium.wrappers.TimeLimit`` for episode
    caps.  Under classic gym: the legacy 4-tuple, unchanged."""
    if gymnasium_api:
        return obs, reward, bool(done), False, info
    return obs, reward, done, info


if _gym is not None:

    class OpenAIRemoteEnv(_gym.Env):
        """gym/gymnasium adapter over :func:`launch_env`.  Subclass, call
        :meth:`launch` with your scene/script, and register with gym.

        The adapter follows whichever module backs it: under gymnasium,
        ``step`` returns the 5-tuple ``(obs, reward, terminated,
        truncated, info)`` and ``reset`` returns ``(obs, info)``; under
        classic gym, the legacy 4-tuple and bare-obs reset."""

        metadata = {
            "render.modes": ["rgb_array", "human"],  # classic gym key
            "render_modes": ["rgb_array", "human"],
        }

        def __init__(self, version="0.0.1"):
            self.__version__ = version
            self._es = ExitStack()
            self._env = None

        def launch(self, scene, script, background=False, **kwargs):
            if self._env is not None:
                raise RuntimeError("Environment already running.")
            self._env = self._es.enter_context(
                launch_env(scene=scene, script=script, background=background, **kwargs)
            )

        def step(self, action):
            obs, reward, done, info = self._env.step(action)
            return adapt_step_result(obs, reward, done, info, USING_GYMNASIUM)

        def reset(self, *, seed=None, options=None):
            if USING_GYMNASIUM:
                # seeds the np_random generator per the gymnasium contract;
                # the remote scene's randomization is seeded at launch
                # (-btseed), so a mid-run seed only affects local sampling
                super().reset(seed=seed)
                obs, info = self._env.reset()
                return obs, info
            obs, _ = self._env.reset()
            return obs

        def render(self, mode="human"):
            return self._env.render(mode=mode)

        @property
        def env_time(self):
            return self._env.env_time

        def close(self):
            if self._es is not None:
                self._es.close()
                self._es = None
                self._env = None

        def __del__(self):
            self.close()

else:  # neither gym nor gymnasium installed

    class OpenAIRemoteEnv:  # noqa: D401 - stub
        """Placeholder raising on use: neither gym nor gymnasium installed."""

        def __init__(self, *a, **k):
            raise ImportError(
                "OpenAIRemoteEnv requires gym or gymnasium; "
                "use RemoteEnv / EnvPool directly."
            )
