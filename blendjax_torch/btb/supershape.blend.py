"""Producer script: the densityopt renderer, a supershape driven over the
duplex channel.

Each ``pre_frame`` polls the ``CTRL`` duplex channel without blocking and
applies at most one message: ``{shape_params: (m1, m2), shape_id}``
rebuilds the mesh (the Gielis superformula, :func:`supershape_vertices`).
Each ``post_frame`` renders the scene camera offscreen and publishes
``{image, shape_id}`` on ``DATA`` once a shape id is set, so a producer
keeps publishing its last shape every frame and the consumer skips the
stale frames (:func:`blendjax_torch.densityopt.make_blender_renderer`).
The scene is 128x128, a camera 6 units down -Y aimed at the origin and a
sun.  It needs ``bpy``: Blender's own, or the fake one of
``tests/helpers/fake_blender.py`` with ``BLENDJAX_FAKE_BPY=1``.  Under
``--background`` the frame loop blocks; with a UI it runs on Blender's
player.

    blender --background --python supershape.blend.py -- -btid 0 -btseed 0 \\
        -btsockets DATA=tcp://127.0.0.1:11000 CTRL=tcp://127.0.0.1:11001
"""

import numpy as np

RESOLUTION = (128, 128)


def superformula(theta, m, n1=2.0, n2=4.0, n3=4.0, a=1.0, b=1.0):
    """Gielis superformula radius for angle array ``theta``."""
    t = m * theta / 4.0
    raw = np.abs(np.cos(t) / a) ** n2 + np.abs(np.sin(t) / b) ** n3
    return raw ** (-1.0 / n1)


def supershape_vertices(m1, m2, res=48):
    """``((res*res, 3) vertex grid of a 3-D supershape, res)``."""
    theta = np.linspace(-np.pi, np.pi, res)
    phi = np.linspace(-np.pi / 2, np.pi / 2, res)
    r1 = superformula(theta, m1)
    r2 = superformula(phi, m2)
    T, P = np.meshgrid(theta, phi, indexing="ij")
    R1, R2 = np.meshgrid(r1, r2, indexing="ij")
    x = R1 * np.cos(T) * R2 * np.cos(P)
    y = R1 * np.sin(T) * R2 * np.cos(P)
    z = R2 * np.sin(P)
    return np.stack([x, y, z], axis=-1).reshape(-1, 3), res


def supershape_faces(n):
    """Quad faces of an ``n`` x ``n`` vertex grid."""
    return [(i * n + j, i * n + j + 1, i * n + j + n + 1, i * n + j + n)
            for i in range(n - 1) for j in range(n - 1)]


def make_mesh(m1, m2, obj=None, res=48):
    """Create the supershape object for ``(m1, m2)``, or swap ``obj``'s mesh
    for a new one (the old mesh is removed)."""
    import bpy

    verts, n = supershape_vertices(m1, m2, res)
    mesh = bpy.data.meshes.new("supershape")
    mesh.from_pydata(verts.tolist(), [], supershape_faces(n))
    mesh.update()
    if obj is None:
        obj = bpy.data.objects.new("supershape", mesh)
        bpy.context.collection.objects.link(obj)
    else:
        old = obj.data
        obj.data = mesh
        bpy.data.meshes.remove(old)
    return obj


def build_scene():
    """An empty scene with a camera 6 units down -Y and a sun, at
    :data:`RESOLUTION`."""
    import bpy

    for o in list(bpy.data.objects):
        bpy.data.objects.remove(o, do_unlink=True)
    bpy.ops.object.camera_add(location=(0, -6, 0))
    bpy.context.scene.camera = bpy.context.active_object
    bpy.ops.object.light_add(type="SUN", location=(2, -4, 4))
    bpy.context.scene.render.resolution_x = RESOLUTION[1]
    bpy.context.scene.render.resolution_y = RESOLUTION[0]


def main():
    import bpy

    from blendjax_torch.btb.animation import AnimationController
    from blendjax_torch.btb.arguments import parse_blendtorch_args
    from blendjax_torch.btb.camera import Camera
    from blendjax_torch.btb.duplex import DuplexChannel
    from blendjax_torch.btb.offscreen import OffScreenRenderer
    from blendjax_torch.btb.publisher import DataPublisher

    args, _ = parse_blendtorch_args()

    build_scene()
    obj = make_mesh(3.0, 3.0)
    cam = Camera()
    # a camera added procedurally looks down -Z: aim it at the origin
    cam.look_at(look_at=(0.0, 0.0, 0.0), look_from=(0.0, -6.0, 0.0))
    off = OffScreenRenderer(camera=cam, mode="rgb")
    pub = DataPublisher(args.btsockets["DATA"], btid=args.btid)
    duplex = DuplexChannel(args.btsockets["CTRL"], btid=args.btid)

    state = {"obj": obj, "shape_id": -1}
    anim = AnimationController()

    def apply_params():
        msg = duplex.recv(timeoutms=0)  # one message a frame, at most
        if msg is not None:
            m1, m2 = msg["shape_params"]
            state["obj"] = make_mesh(float(m1), float(m2), state["obj"])
            state["shape_id"] = msg["shape_id"]

    def publish():
        if state["shape_id"] >= 0:
            pub.publish(image=off.render(), shape_id=state["shape_id"])

    anim.pre_frame.add(apply_params)
    anim.post_frame.add(publish)
    anim.play(frame_range=(0, 10000), num_episodes=-1,
              use_animation=not getattr(bpy.app, "background", False))


if __name__ == "__main__":
    main()
