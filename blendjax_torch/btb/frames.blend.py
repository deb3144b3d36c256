"""Producer script: seeded synthetic frames in the datagen message schema.

Publishes ``{image, xy, frameid}`` — the schema of
``examples/datagen/cube.blend.py`` — with a uint8 ``image`` of
``--height x --width x 3`` and ``xy`` of ``--keypoints x 2`` float32 pixel
coordinates.  Every frame is a pure function of ``(btseed, frameid)``
(:func:`make_frame`), so a consumer can check what arrived against what was
sent.  Needs neither ``bpy`` nor torch: it stands in for the Blender
renderer wherever the feed and the trainer are what is being driven.

Runs under Blender's CLI protocol (normally via ``BlenderLauncher``)::

    blender --python frames.blend.py -- -btid 0 -btseed 0 -btsockets DATA=tcp://...
"""

import argparse

import numpy as np

#: Distinct frames pre-generated per producer and published round-robin,
#: so the publish loop measures the feed and not numpy's generator.
POOL = 8


def make_frame(seed, frameid, height, width, keypoints):
    """The ``(image, xy)`` pair a producer seeded ``seed`` publishes as
    frame ``frameid``."""
    rng = np.random.default_rng([seed, frameid % POOL])
    image = rng.integers(0, 256, size=(height, width, 3), dtype=np.uint8)
    xy = (rng.random((keypoints, 2)) * np.array([width, height])).astype(np.float32)
    return image, xy


def main():
    from blendjax_torch.btb.arguments import parse_blendtorch_args
    from blendjax_torch.btb.publisher import DataPublisher

    args, remainder = parse_blendtorch_args()
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--keypoints", type=int, default=8)
    opts = ap.parse_args(remainder)

    pool = [
        make_frame(args.btseed, i, opts.height, opts.width, opts.keypoints)
        for i in range(POOL)
    ]
    # bounded publish: under backpressure the loop retries instead of
    # blocking forever, so SIGTERM from the launcher is never held up
    pub = DataPublisher(
        args.btsockets["DATA"], btid=args.btid, raw_buffers=True, sndtimeoms=500
    )
    frameid = 0
    while True:
        image, xy = pool[frameid % POOL]
        if pub.publish(image=image, xy=xy, frameid=frameid):
            frameid += 1


if __name__ == "__main__":
    main()
