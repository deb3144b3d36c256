"""Producer script: seeded pendulum episodes in the world-model message
schema.

Publishes ``{"obs_seq": (seq_len, obs_dim) float32, "episode": int}`` —
the schema of ``examples/worldmodel/pendulum.blend.py`` — one message per
episode, each a damped driven pendulum integrated by
:func:`blendjax_torch.btb.pendulum.simulate_episode` from a generator
seeded ``btseed``.  Channels from 8 up are zero.  Needs neither ``bpy``
nor torch: it stands in for the Blender scene wherever the feed and the
trainer are what is being driven.

Runs under Blender's CLI protocol (normally via ``BlenderLauncher``)::

    blender --python episodes.blend.py -- -btid 0 -btseed 0 -btsockets DATA=tcp://... \\
        --seq-len 65 --obs-dim 8
"""

import argparse

import numpy as np


def main():
    from blendjax_torch.btb.arguments import parse_blendtorch_args
    from blendjax_torch.btb.pendulum import simulate_episode
    from blendjax_torch.btb.publisher import DataPublisher

    args, remainder = parse_blendtorch_args()
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq-len", type=int, default=65,
                    help="observations per episode (the trainer sees T = seq_len - 1)")
    ap.add_argument("--obs-dim", type=int, default=8)
    opts = ap.parse_args(remainder)

    rng = np.random.default_rng(args.btseed)
    # bounded publish: under backpressure the loop retries instead of
    # blocking forever, so SIGTERM from the launcher is never held up
    pub = DataPublisher(
        args.btsockets["DATA"], btid=args.btid, raw_buffers=True, sndtimeoms=500
    )
    episode = 0
    while True:
        obs_seq = simulate_episode(rng, 1, opts.seq_len - 1, opts.obs_dim)[0]
        while not pub.publish(obs_seq=obs_seq, episode=episode):
            pass
        episode += 1


if __name__ == "__main__":
    main()
