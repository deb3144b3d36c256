"""Producer script: the cartpole env, driven over RPC.

Runs :class:`blendjax_torch.btb.cartpole.CartpoleEnv` (the classic
cart-pole dynamics in numpy, initial states from a generator seeded
``-btseed``) behind a :class:`~blendjax_torch.btb.env.RemoteControlledAgent`
bound to the ``GYM`` socket, so :class:`blendjax_torch.btt.env.RemoteEnv`
and :class:`blendjax_torch.btt.envpool.EnvPool` step it one frame per
request.  It needs ``bpy`` for the animation loop: Blender's own, or the
fake one of ``tests/helpers/fake_blender.py`` with ``BLENDJAX_FAKE_BPY=1``.
Under ``--background`` the loop blocks (as fast as requests come); with a
UI it runs on Blender's player.

    blender --background --python cartpole.blend.py -- -btid 0 -btseed 0 \\
        -btsockets GYM=tcp://127.0.0.1:11000 [--real-time]
"""

import argparse


def main():
    import bpy

    from blendjax_torch.btb.arguments import parse_blendtorch_args
    from blendjax_torch.btb.cartpole import CartpoleEnv
    from blendjax_torch.btb.env import RemoteControlledAgent

    btargs, remainder = parse_blendtorch_args()
    parser = argparse.ArgumentParser()
    parser.add_argument("--real-time", action="store_true")
    parser.add_argument("--no-real-time", dest="real_time", action="store_false")
    args = parser.parse_args(remainder)

    agent = RemoteControlledAgent(btargs.btsockets["GYM"], real_time=args.real_time)
    env = CartpoleEnv(agent, seed=btargs.btseed)
    env.run(frame_range=(1, 10000), use_animation=not bpy.app.background)


if __name__ == "__main__":
    main()
