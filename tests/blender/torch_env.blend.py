"""Env fixture for the port: the deterministic echo environment of
``env.blend.py`` (obs == the last applied action, reward == action / 10,
episode horizon set by the frame range) on the port's producer stack,
``blendjax_torch.btb`` (BaseEnv + RemoteControlledAgent +
AnimationController).  Runs under ``tests/helpers/fake_blender.py`` with
``BLENDJAX_FAKE_BPY=1``, which installs the fake ``bpy``."""

import argparse
import time

from blendjax_torch.btb.arguments import parse_blendtorch_args
from blendjax_torch.btb.env import BaseEnv, RemoteControlledAgent


class EchoEnv(BaseEnv):
    """obs == last applied action; reward == action / 10.  ``physics_us >
    0`` sleeps that long per applied step, standing in for a physics
    solver's per-frame cost.

    Scenario plane (docs/scenarios.md): ``--scenario`` labels the env from
    launch, and ``_env_apply_params`` applies the pushes that arrive on the
    CTRL duplex channel (a ``scenario`` relabel and a ``physics_us``
    retiming take effect on the next frame).  The applied scenario and
    physics rate ride every post-step dict, so transitions, replay rows
    and telemetry attribute to scenarios in-band."""

    def __init__(self, agent, physics_us=0, scenario=None):
        super().__init__(agent)
        self.applied = 0.0
        self.physics_us = physics_us
        self.scenario = scenario
        self.params_applied = 0

    def _env_reset(self):
        self.applied = 0.0

    def _env_prepare_step(self, action):
        self.applied = float(action)
        if self.physics_us > 0:
            time.sleep(self.physics_us / 1e6)

    def _env_apply_params(self, msg):
        if msg.get("cmd") != "scenario":
            return
        params = msg.get("params") or {}
        if "physics_us" in params:
            self.physics_us = int(params["physics_us"])
        name = msg.get("scenario") or params.get("scenario")
        if name:
            self.scenario = str(name)
        self.params_applied += 1

    def _env_post_step(self):
        out = {"obs": self.applied, "reward": self.applied / 10.0,
               "frame": self.events.frameid}
        if self.scenario is not None:
            out["scenario"] = self.scenario
            out["physics_us_now"] = self.physics_us
        return out


def main():
    btargs, remainder = parse_blendtorch_args()
    parser = argparse.ArgumentParser()
    parser.add_argument("--horizon", type=int, default=10)
    parser.add_argument("--physics-us", type=int, default=0)
    parser.add_argument("--scenario", type=str, default=None)
    args = parser.parse_args(remainder)

    agent = RemoteControlledAgent(btargs.btsockets["GYM"], timeoutms=30000)
    env = EchoEnv(agent, physics_us=args.physics_us, scenario=args.scenario)
    if "CTRL" in btargs.btsockets:
        # the scenario control plane: a bound PAIR socket polled every
        # frame, applying pushes mid-training
        from blendjax_torch.btb.duplex import DuplexChannel

        env.attach_param_channel(DuplexChannel(btargs.btsockets["CTRL"], btid=btargs.btid))
    env.run(frame_range=(1, args.horizon), use_animation=False)


main()
