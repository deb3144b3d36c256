"""gymnasium ``VectorEnv`` adapter over
:class:`blendjax_torch.btt.envpool.EnvPool`, a copy of
``blendjax.btt.vector_env``.

It makes a Blender fleet a drop-in ``gymnasium.vector.VectorEnv``, so
vectorized agent libraries drive Blender fleets unchanged.  gymnasium
stays optional: without it the module imports and the adapter raises on
use.

Autoreset follows gymnasium's NEXT_STEP mode, which is exactly
``EnvPool``'s native behavior: a terminated instance returns its terminal
observation with ``terminations[i] = True``; the reset happens on the
*next* ``step`` call, which returns the fresh observation with zero
reward.  The gymnasium ``step_async``/``step_wait`` pair runs over the
pool's pipelined DEALER path; ``step`` remains the lock-step REQ/REP path.
"""

from __future__ import annotations

import numpy as np

try:
    import gymnasium as _gym
    from gymnasium.vector.utils import batch_space as _batch_space
except ImportError:  # gymnasium is optional
    _gym = None


def _require_gymnasium():
    if _gym is None:
        raise ImportError(
            "gymnasium is required for BlenderVectorEnv; pip install gymnasium"
        )


if _gym is not None:

    class BlenderVectorEnv(_gym.vector.VectorEnv):
        """A fleet of remote Blender environments as one vector env.

        Params
        ------
        pool: EnvPool
            Connected pool (see
            :func:`blendjax_torch.btt.envpool.launch_env_pool`).
            The adapter owns it: ``close()`` closes the pool.
        single_observation_space / single_action_space: gymnasium.Space
            Per-instance spaces (the wire protocol is schema-free, so the
            caller declares them, as ``OpenAIRemoteEnv`` subclasses
            do).
        """

        metadata = {"autoreset_mode": (
            _gym.vector.AutoresetMode.NEXT_STEP
            if hasattr(_gym.vector, "AutoresetMode") else "next_step"
        )}

        def __init__(self, pool, single_observation_space,
                     single_action_space):
            if not getattr(pool, "autoreset", False):
                raise ValueError(
                    "BlenderVectorEnv advertises NEXT_STEP autoreset and "
                    "requires an EnvPool built with autoreset=True"
                )
            self._pool = pool
            self.num_envs = pool.num_envs
            self.single_observation_space = single_observation_space
            self.single_action_space = single_action_space
            self.observation_space = _batch_space(
                single_observation_space, pool.num_envs
            )
            self.action_space = _batch_space(
                single_action_space, pool.num_envs
            )

        @staticmethod
        def _as_batched(obs):
            # collate() returns a dict/tuple pytree for structured
            # observations (Dict/Tuple spaces): leave those alone —
            # np.asarray would collapse them to a 0-d object array
            if isinstance(obs, (dict, tuple, list)):
                return obs
            return np.asarray(obs)

        def reset(self, *, seed=None, options=None):
            # remote scenes seed at launch (-btseed); a per-reset seed has
            # no remote hook, as in OpenAIRemoteEnv
            obs, infos = self._pool.reset()
            return self._as_batched(obs), {"env_infos": infos}

        @staticmethod
        def _route_dones(obs, rewards, dones, infos):
            dones = np.asarray(dones, dtype=bool)
            # a quarantine done is an episode cut short (producer died /
            # hung), not a task-terminal state: gymnasium-conformant
            # trainers must keep bootstrapping V(s') there, so it routes
            # to truncations, never terminations
            truncations = np.array(
                [bool(info.get("quarantined")) for info in infos], dtype=bool
            ) & dones
            terminations = dones & ~truncations
            return (
                BlenderVectorEnv._as_batched(obs),
                rewards,
                terminations,
                truncations,
                {"env_infos": infos},
            )

        def step(self, actions):
            return self._route_dones(*self._pool.step(list(actions)))

        def step_async(self, actions):
            """Submit the batch without waiting (gymnasium vector pair).

            The fleet simulates while the caller computes; collect with
            :meth:`step_wait`.  Backed by ``EnvPool.step_async`` — the
            producers integrate physics for frame t+1 concurrently with
            whatever runs between the two calls.
            """
            self._pool.step_async(list(actions))

        def step_wait(self):
            """Collect the batch submitted by :meth:`step_async`; same
            5-tuple (and autoreset/truncation routing) as :meth:`step`."""
            return self._route_dones(*self._pool.step_wait_full())

        def close_extras(self, **kwargs):
            self._pool.close()

else:

    class BlenderVectorEnv:  # noqa: D401 - stub keeps imports harmless
        """Unavailable: gymnasium is not installed."""

        def __init__(self, *a, **k):
            _require_gymnasium()


def launch_vector_env(scene, script, num_instances, single_observation_space,
                      single_action_space, **kwargs):
    """Launch a Blender fleet and wrap it as a gymnasium ``VectorEnv``.

    Context manager; extra kwargs flow to
    :func:`blendjax_torch.btt.envpool.launch_env_pool` (and on to each
    instance's CLI).
    """
    _require_gymnasium()
    from contextlib import contextmanager

    from blendjax_torch.btt.envpool import launch_env_pool

    @contextmanager
    def _cm():
        with launch_env_pool(
            scene=scene, script=script, num_instances=num_instances, **kwargs
        ) as pool:
            env = BlenderVectorEnv(
                pool, single_observation_space, single_action_space
            )
            try:
                yield env
            finally:
                env.close()

    return _cm()
