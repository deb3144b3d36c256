"""Producer script: the datagen renderer, a randomly rotated cube with its
corners as keypoints.

Publishes ``{image, xy, frameid}`` (the schema of the JAX package's
``examples/datagen/cube.blend.py``): a 480x640x3 uint8 offscreen render of
the scene camera and the 8 cube corners projected to pixels (float32,
upper-left origin).  The scene is built procedurally: a 2-unit cube at the
origin, a camera at (0, -8, 2) aimed at it, and a sun; each ``pre_frame``
draws the cube's rotation from a generator seeded ``-btseed``.  It needs
``bpy``: Blender's own, or the fake one of ``tests/helpers/fake_blender.py``
with ``BLENDJAX_FAKE_BPY=1``.  Under ``--background`` the frame loop
blocks; with a UI it runs on Blender's player.

    blender --background --python cube.blend.py -- -btid 0 -btseed 0 \\
        -btsockets DATA=tcp://127.0.0.1:11000
"""

import numpy as np

RESOLUTION = (480, 640)


def build_scene():
    """Cube, camera and sun on an empty scene; returns ``(cube, camera)``."""
    import bpy

    for obj in list(bpy.data.objects):
        bpy.data.objects.remove(obj, do_unlink=True)
    bpy.ops.mesh.primitive_cube_add(size=2.0, location=(0, 0, 0))
    cube = bpy.context.active_object
    bpy.ops.object.camera_add(location=(0, -8, 2))
    cam = bpy.context.active_object
    bpy.context.scene.camera = cam
    bpy.ops.object.light_add(type="SUN", location=(3, -4, 6))
    bpy.context.scene.render.resolution_x = RESOLUTION[1]
    bpy.context.scene.render.resolution_y = RESOLUTION[0]
    bpy.context.scene.render.resolution_percentage = 100
    return cube, cam


def main():
    import bpy

    from blendjax_torch.btb.animation import AnimationController
    from blendjax_torch.btb.arguments import parse_blendtorch_args
    from blendjax_torch.btb.camera import Camera
    from blendjax_torch.btb.offscreen import OffScreenRenderer
    from blendjax_torch.btb.publisher import DataPublisher

    args, _ = parse_blendtorch_args()
    rng = np.random.default_rng(args.btseed)

    cube, _ = build_scene()
    cam = Camera()
    # a camera added procedurally looks down -Z: aim it at the origin
    cam.look_at(look_at=(0.0, 0.0, 0.0), look_from=(0.0, -8.0, 2.0))
    off = OffScreenRenderer(camera=cam, mode="rgb")
    off.set_render_style(shading="RENDERED", overlays=False)
    pub = DataPublisher(args.btsockets["DATA"], btid=args.btid)

    anim = AnimationController()

    def randomize():
        cube.rotation_euler = rng.uniform(0, np.pi, size=3)

    def publish(anim):
        img = off.render()
        xy = cam.object_to_pixel(cube)
        pub.publish(image=img, xy=xy.astype(np.float32), frameid=anim.frameid)

    anim.pre_frame.add(randomize)
    anim.post_frame.add(publish, anim)
    anim.play(frame_range=(0, 100), num_episodes=-1,
              use_animation=not getattr(bpy.app, "background", False))


if __name__ == "__main__":
    main()
