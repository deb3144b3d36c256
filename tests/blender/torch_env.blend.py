"""Env fixture for the port: the deterministic echo environment of
``env.blend.py`` (obs == the last applied action, reward == action / 10,
episode horizon set by the frame range) on the port's producer stack,
``blendjax_torch.btb`` (BaseEnv + RemoteControlledAgent +
AnimationController).  Runs under ``tests/helpers/fake_blender.py`` with
``BLENDJAX_FAKE_BPY=1``, which installs the fake ``bpy``."""

import argparse

from blendjax_torch.btb.arguments import parse_blendtorch_args
from blendjax_torch.btb.env import BaseEnv, RemoteControlledAgent


class EchoEnv(BaseEnv):
    """obs == last applied action; reward == action / 10."""

    def __init__(self, agent):
        super().__init__(agent)
        self.applied = 0.0

    def _env_reset(self):
        self.applied = 0.0

    def _env_prepare_step(self, action):
        self.applied = float(action)

    def _env_post_step(self):
        return {"obs": self.applied, "reward": self.applied / 10.0,
                "frame": self.events.frameid}


def main():
    btargs, remainder = parse_blendtorch_args()
    parser = argparse.ArgumentParser()
    parser.add_argument("--horizon", type=int, default=10)
    args = parser.parse_args(remainder)

    agent = RemoteControlledAgent(btargs.btsockets["GYM"], timeoutms=30000)
    env = EchoEnv(agent)
    env.run(frame_range=(1, args.horizon), use_animation=False)


main()
