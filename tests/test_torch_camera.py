"""The port's camera, scene helpers and offscreen renderer
(``blendjax_torch.btb.camera_math``, ``camera``, ``utils``, ``offscreen``)
against the JAX package's, on the cases of ``tests/test_camera_math.py``,
``tests/test_offscreen_camera.py`` and ``tests/test_golden_camera.py``.

Both sides are numpy: projections, view and projection matrices and
rendered arrays must equal the JAX package's on the same inputs within
atol 1e-12 (rendered uint8 arrays exactly).  The bpy paths run under the
fake ``bpy`` of ``tests/helpers/fake_bpy.py``.  Then the producers: the
golden-camera fixture and the datagen cube producer through the port's
launcher, and ``BaseEnv.attach_default_renderer`` filling
``ctx['rgb_array']``."""

import importlib.util
import os

import numpy as np
import pytest
import zmq

from blendjax.btb import camera_math as jcm
from blendjax_torch import btb as tbtb
from blendjax_torch.btb import camera_math as cm
from helpers import BLEND_SCRIPTS, FAKE_BLENDER, REPO_ROOT, fake_bpy
from helpers.producers import free_port

ATOL = 1e-12

# Camera 5 units along -Y, looking at the origin, +Z up.
EYE = (0.0, -5.0, 0.0)
VIEW = cm.look_at_matrix(EYE, (0, 0, 0))
SHAPE = (64, 64)  # H, W


# -- camera_math: the reference's goldens on the port ---------------------


def test_look_at_frame():
    cam = cm.hom(np.array([[0.0, 0.0, 0.0]])) @ VIEW.T
    np.testing.assert_allclose(cam[0, :3], [0, 0, -5], atol=1e-12)
    up = cm.hom(np.array([[0.0, 0.0, 1.0]])) @ VIEW.T
    assert up[0, 1] > 0


def test_perspective_projection_golden():
    proj = cm.perspective_projection(np.pi / 2, 1.0, 0.1, 100.0)
    px = cm.project_points([[0, 0, 0]], VIEW, proj, SHAPE)
    np.testing.assert_allclose(px, [[32, 32]], atol=1e-9)
    px, z = cm.project_points([[1, 0, 0]], VIEW, proj, SHAPE, return_depth=True)
    np.testing.assert_allclose(px, [[38.4, 32.0]], atol=1e-9)
    np.testing.assert_allclose(z, [5.0], atol=1e-12)
    px_up = cm.project_points([[0, 0, 1]], VIEW, proj, SHAPE)
    assert px_up[0, 1] < 32
    px_up_gl = cm.project_points([[0, 0, 1]], VIEW, proj, SHAPE, origin="lower-left")
    assert px_up_gl[0, 1] > 32
    np.testing.assert_allclose(px_up[0, 1] + px_up_gl[0, 1], 64.0, atol=1e-9)


def test_orthographic_projection_golden():
    proj = cm.orthographic_projection(4.0, 1.0, 0.1, 100.0)
    px = cm.project_points([[1, 0, 0]], VIEW, proj, SHAPE)
    np.testing.assert_allclose(px, [[48.0, 32.0]], atol=1e-9)
    _, z = cm.world_to_ndc([[1.5, 0, 0]], VIEW, proj, return_depth=True)
    np.testing.assert_allclose(z, [5.0], atol=1e-12)


def test_hom_dehom_roundtrip():
    pts = np.array([[1.0, 2.0, 3.0], [-4.0, 0.5, 2.0]])
    h = cm.hom(pts)
    assert h.shape == (2, 4)
    np.testing.assert_allclose(cm.dehom(h), pts)
    np.testing.assert_allclose(cm.dehom(cm.hom(pts, 2.0)), pts / 2.0)


def test_ndc_to_pixel_origins():
    ndc = np.array([[0.0, 0.5, 0.0]])
    np.testing.assert_allclose(cm.ndc_to_pixel(ndc, SHAPE, "upper-left"), [[32.0, 16.0]])
    np.testing.assert_allclose(cm.ndc_to_pixel(ndc, SHAPE, "lower-left"), [[32.0, 48.0]])
    with pytest.raises(ValueError):
        cm.ndc_to_pixel(ndc, SHAPE, "center")


def test_bbox_corners():
    corners = cm.bbox_corners([0, 0, 0], [1, 2, 3])
    assert corners.shape == (8, 3)
    np.testing.assert_allclose(corners.min(0), [0, 0, 0])
    np.testing.assert_allclose(corners.max(0), [1, 2, 3])


def test_random_spherical_loc():
    rng = np.random.default_rng(0)
    pts = np.stack([cm.random_spherical_loc(radius_range=(2, 3), rng=rng) for _ in range(64)])
    radii = np.linalg.norm(pts, axis=1)
    assert (radii >= 2 - 1e-9).all() and (radii <= 3 + 1e-9).all()
    np.testing.assert_allclose(cm.random_spherical_loc(rng=np.random.default_rng(7)),
                               cm.random_spherical_loc(rng=np.random.default_rng(7)))


def test_degenerate_look_at_along_up():
    view = cm.look_at_matrix((0, 0, 5), (0, 0, 0))
    cam = cm.hom(np.array([[0.0, 0.0, 0.0]])) @ view.T
    np.testing.assert_allclose(cam[0, :3], [0, 0, -5], atol=1e-12)


# -- camera_math: equal to the JAX package's on the same inputs -----------


def _math_inputs(seed):
    rng = np.random.default_rng(seed)
    eye = rng.uniform(-8, 8, 3)
    target = rng.uniform(-1, 1, 3)
    pts = rng.uniform(-2, 2, (16, 3))
    return eye, target, pts


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("origin", ["upper-left", "lower-left"])
@pytest.mark.parametrize("kind", ["persp", "ortho"])
def test_camera_math_equals_the_jax_package(seed, origin, kind):
    eye, target, pts = _math_inputs(seed)
    shape = (48 + seed, 64 + 3 * seed)
    aspect = shape[1] / shape[0]
    if kind == "persp":
        proj, jproj = (m.perspective_projection(0.3 + 0.2 * seed, aspect, 0.1, 50.0)
                       for m in (cm, jcm))
    else:
        proj, jproj = (m.orthographic_projection(3.0 + seed, aspect, 0.1, 50.0)
                       for m in (cm, jcm))
    view, jview = cm.look_at_matrix(eye, target), jcm.look_at_matrix(eye, target)
    np.testing.assert_allclose(view, jview, rtol=0, atol=ATOL)
    np.testing.assert_allclose(proj, jproj, rtol=0, atol=ATOL)
    ndc, z = cm.world_to_ndc(pts, view, proj, return_depth=True)
    jndc, jz = jcm.world_to_ndc(pts, jview, jproj, return_depth=True)
    np.testing.assert_allclose(ndc, jndc, rtol=0, atol=ATOL)
    np.testing.assert_allclose(z, jz, rtol=0, atol=ATOL)
    pix, depth = cm.project_points(pts, view, proj, shape, origin=origin, return_depth=True)
    jpix, jdepth = jcm.project_points(pts, jview, jproj, shape, origin=origin,
                                      return_depth=True)
    np.testing.assert_allclose(pix, jpix, rtol=0, atol=ATOL)
    np.testing.assert_allclose(depth, jdepth, rtol=0, atol=ATOL)
    np.testing.assert_allclose(cm.bbox_corners(pts.min(0), pts.max(0)),
                               jcm.bbox_corners(pts.min(0), pts.max(0)), rtol=0, atol=ATOL)
    np.testing.assert_allclose(cm.dehom(cm.hom(pts, 2.0)), jcm.dehom(jcm.hom(pts, 2.0)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        cm.random_spherical_loc((1, 2), (0, 1), (0, 3), rng=np.random.default_rng(seed)),
        jcm.random_spherical_loc((1, 2), (0, 1), (0, 3), rng=np.random.default_rng(seed)),
        rtol=0, atol=ATOL)


# -- the bpy adapter and the offscreen renderer under the fake bpy --------


@pytest.fixture
def bpy():
    return fake_bpy.install()


def _port():
    from blendjax_torch.btb.camera import Camera
    from blendjax_torch.btb.offscreen import OffScreenRenderer

    return Camera, OffScreenRenderer


def _jax():
    """The JAX package's adapter and renderer, bound to the fake installed
    last (``fake_bpy.install`` drops their modules)."""
    from blendjax.btb.camera import Camera
    from blendjax.btb.offscreen import OffScreenRenderer

    return Camera, OffScreenRenderer


def test_lazy_exports(bpy):
    Camera, OffScreenRenderer = _port()
    assert tbtb.Camera is Camera and tbtb.OffScreenRenderer is OffScreenRenderer
    assert tbtb.camera_math is cm and tbtb.utils.hom is cm.hom


def test_offscreen_render_shape_and_flip(bpy):
    _, OffScreenRenderer = _port()
    img = OffScreenRenderer(mode="rgb", origin="upper-left").render()
    assert img.shape == (240, 320, 3) and img.dtype == np.uint8
    assert img[0, 0, 0] == 255 and img[-1, 0, 0] == 0
    assert img[0, 0, 1] == 0 and img[0, -1, 1] == 255
    img2 = OffScreenRenderer(mode="rgb", origin="lower-left").render()
    assert img2[0, 0, 0] == 0 and img2[-1, 0, 0] == 255


def test_offscreen_rgba_and_free(bpy):
    _, OffScreenRenderer = _port()
    off = OffScreenRenderer(mode="rgba")
    img = off.render()
    assert img.shape == (240, 320, 4)
    assert (img[..., 3] == 255).all()
    off.free()
    assert off.offscreen.freed
    with pytest.raises(ValueError, match="unknown mode"):
        OffScreenRenderer(mode="bgr")


def test_offscreen_gamma_roundtrip(bpy):
    _, OffScreenRenderer = _port()
    lin = OffScreenRenderer(mode="rgb", gamma=False)
    img_lin = lin.render()
    assert lin.offscreen.draw_calls[-1]["do_color_management"] is False
    gam = OffScreenRenderer(mode="rgb", gamma=True)
    img_gam = gam.render()
    assert gam.offscreen.draw_calls[-1]["do_color_management"] is True
    mid = img_lin.shape[0] // 2
    assert img_gam[mid, 0, 0] > img_lin[mid, 0, 0]
    np.testing.assert_allclose(img_gam[mid, 0, 0] / 255.0,
                               (img_lin[mid, 0, 0] / 255.0) ** (1 / 2.2), atol=0.02)


def test_offscreen_draws_with_camera_matrices(bpy):
    Camera, OffScreenRenderer = _port()
    cam = Camera()
    off = OffScreenRenderer(camera=cam)
    off.render()
    call = off.offscreen.draw_calls[-1]
    np.testing.assert_allclose(call["view_matrix"], cam.view_matrix)
    np.testing.assert_allclose(call["proj_matrix"], cam.proj_matrix)
    assert call["scene"] is bpy.context.scene


def test_set_render_style(bpy):
    _, OffScreenRenderer = _port()
    OffScreenRenderer().set_render_style(shading="RENDERED", overlays=False)
    assert bpy.context.space_data.shading.type == "RENDERED"
    assert bpy.context.space_data.overlay.show_overlays is False


@pytest.mark.parametrize("mode", ["rgb", "rgba"])
@pytest.mark.parametrize("origin", ["upper-left", "lower-left"])
@pytest.mark.parametrize("gamma", [False, True])
def test_offscreen_render_equals_the_jax_package(bpy, mode, origin, gamma):
    bpy.context.scene.render.resolution_x, bpy.context.scene.render.resolution_y = 96, 72
    Camera, OffScreenRenderer = _port()
    JCamera, JOffScreenRenderer = _jax()
    cam, jcam = Camera(), JCamera()
    cam.look_at(look_at=(0.5, 0.0, 0.0), look_from=(3.0, -4.0, 2.0))
    jcam.look_at(look_at=(0.5, 0.0, 0.0), look_from=(3.0, -4.0, 2.0))
    off = OffScreenRenderer(camera=cam, mode=mode, origin=origin, gamma=gamma)
    joff = JOffScreenRenderer(camera=jcam, mode=mode, origin=origin, gamma=gamma)
    img, jimg = off.render(), joff.render()
    assert img.dtype == jimg.dtype == np.uint8 and img.shape == jimg.shape
    np.testing.assert_array_equal(img, jimg)
    for key in ("view_matrix", "proj_matrix"):
        np.testing.assert_allclose(off.offscreen.draw_calls[-1][key],
                                   joff.offscreen.draw_calls[-1][key], rtol=0, atol=ATOL)


def _expected_pixels_persp(verts_world, cam_z, px, py, w, h):
    """Analytic perspective projection: camera at (0, 0, cam_z) looking down
    -Z, upper-left pixel origin."""
    out, depths = [], []
    for x, y, z in verts_world:
        wclip = cam_z - z
        out.append(((px * x / wclip + 1) / 2 * w, (1 - (py * y / wclip + 1) / 2) * h))
        depths.append(wclip)
    return np.array(out), np.array(depths)


def test_camera_adapter_perspective_golden(bpy):
    Camera, _ = _port()
    cam = Camera()
    assert cam.shape == (240, 320) and cam.type == "PERSP"
    assert cam.clip_range == (0.1, 100.0)
    cube = fake_bpy.cube_mesh(half=1.0)
    pix, depth = cam.object_to_pixel(cube, return_depth=True)
    px = 2 * 50.0 / 36.0
    py = px * (320 / 240)
    exp_pix, exp_depth = _expected_pixels_persp([tuple(v.co) for v in cube.data.vertices],
                                                5.0, px, py, 320, 240)
    np.testing.assert_allclose(pix, exp_pix, atol=1e-6)
    np.testing.assert_allclose(depth, exp_depth, atol=1e-6)


def test_camera_adapter_ortho_golden(bpy):
    Camera, _ = _port()
    bpy.context.scene.camera.data.type = "ORTHO"
    cam = Camera()
    cube = fake_bpy.cube_mesh(half=1.0)
    sx, sy = 2 / 6.0, (2 / 6.0) * (320 / 240)
    exp = np.array([((x * sx + 1) / 2 * 320, (1 - (y * sy + 1) / 2) * 240)
                    for x, y, z in (tuple(v.co) for v in cube.data.vertices)])
    np.testing.assert_allclose(cam.object_to_pixel(cube), exp, atol=1e-6)


def test_camera_adapter_bbox_projection(bpy):
    Camera, _ = _port()
    cam = Camera()
    cube = fake_bpy.cube_mesh(half=0.5)
    pix = cam.bbox_object_to_pixel(cube)
    assert pix.shape == (8, 2)
    ref = cam.object_to_pixel(cube)
    assert {tuple(np.round(p, 4)) for p in pix} == {tuple(np.round(p, 4)) for p in ref}


def test_camera_look_at_centers_target(bpy):
    Camera, _ = _port()
    cam = Camera()
    cam.look_at(look_at=(0.0, 0.0, 0.0), look_from=(4.0, -3.0, 5.0))
    pix, depth = cam.world_to_ndc(np.array([[0.0, 0.0, 0.0]]), return_depth=True)
    np.testing.assert_allclose(pix[0][:2], [0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(depth[0], np.sqrt(16 + 9 + 25), atol=1e-6)
    np.testing.assert_allclose(cam.ndc_to_pixel(pix)[0], [160.0, 120.0], atol=1e-6)


def test_camera_shape_respects_resolution_percentage(bpy):
    Camera, _ = _port()
    bpy.context.scene.render.resolution_percentage = 50
    assert Camera().shape == (120, 160)


@pytest.mark.parametrize("cam_type", ["PERSP", "ORTHO"])
@pytest.mark.parametrize("origin", ["upper-left", "lower-left"])
def test_camera_adapter_equals_the_jax_package(bpy, cam_type, origin):
    """View and projection matrices, vertex and bbox projections with depth,
    after the same look_at, on the same fake scene."""
    bpy.context.scene.camera.data.type = cam_type
    Camera, _ = _port()
    JCamera, _ = _jax()
    cam, jcam = Camera(), JCamera()
    for c in (cam, jcam):
        c.look_at(look_at=(0.2, -0.1, 0.3), look_from=(5.0, -3.0, 4.0))
    cube = fake_bpy.cube_mesh(half=0.7, location=(0.3, 0.1, -0.2))
    np.testing.assert_allclose(cam.view_matrix, jcam.view_matrix, rtol=0, atol=ATOL)
    np.testing.assert_allclose(cam.proj_matrix, jcam.proj_matrix, rtol=0, atol=ATOL)
    for name in ("object_to_pixel", "bbox_object_to_pixel"):
        pix, depth = getattr(cam, name)(cube, return_depth=True, origin=origin)
        jpix, jdepth = getattr(jcam, name)(cube, return_depth=True, origin=origin)
        np.testing.assert_allclose(pix, jpix, rtol=0, atol=ATOL)
        np.testing.assert_allclose(depth, jdepth, rtol=0, atol=ATOL)


def test_world_and_object_coordinates(bpy):
    from blendjax.btb import utils as jutils
    from blendjax_torch.btb import utils

    cube = fake_bpy.cube_mesh(half=1.0, location=(2.0, 0.0, 0.0))
    obj = utils.object_coordinates(cube)
    world = utils.world_coordinates(cube)
    assert obj.shape == (8, 3) and world.shape == (8, 3)
    np.testing.assert_allclose(world, obj + np.array([2.0, 0.0, 0.0]))
    bbox = utils.bbox_world_coordinates(cube)
    assert bbox.shape == (8, 3)
    np.testing.assert_allclose(sorted(map(tuple, bbox)), sorted(map(tuple, world)))
    for name in ("object_coordinates", "world_coordinates", "bbox_world_coordinates"):
        np.testing.assert_allclose(getattr(utils, name)(cube), getattr(jutils, name)(cube),
                                   rtol=0, atol=ATOL)
    area, space, region = utils.find_first_view3d()
    assert (area, space, region) == jutils.find_first_view3d()


def test_compute_object_visibility(bpy):
    from blendjax_torch.btb import utils

    Camera, _ = _port()
    cube = fake_bpy.cube_mesh(half=1.0)
    cam = Camera()
    bpy.context.scene.ray_cast_target = cube
    assert utils.compute_object_visibility(cube, cam, N=8, rng=np.random.default_rng(0)) == 1.0
    bpy.context.scene.ray_cast_target = None
    assert utils.compute_object_visibility(cube, cam, N=8, rng=np.random.default_rng(0)) == 0.0


def test_scene_stats_counts_orphans(bpy):
    from blendjax_torch.btb import utils

    bpy.data.objects.extend([fake_bpy.cube_mesh(half=1.0),
                             fake_bpy.cube_mesh(half=1.0, users=0)])
    assert utils.scene_stats()["objects"] == (1, 1)


# -- BaseEnv.attach_default_renderer ----------------------------------------


def _run_env(BaseEnv, bpy, every_nth, frames=5):
    """A BaseEnv whose agent records ``ctx['rgb_array']`` each frame it is
    consulted, driven for ``frames`` frames of the fake player."""
    seen = []

    class Env(BaseEnv):
        def _env_reset(self):
            pass

        def _env_prepare_step(self, action):
            pass

        def _env_post_step(self):
            return {"obs": 0.0, "reward": 0.0}

    def agent(env, **ctx):
        seen.append((ctx["time"], ctx.get("rgb_array")))
        return BaseEnv.CMD_STEP, None

    env = Env(agent)
    env.attach_default_renderer(every_nth=every_nth)
    env.run(frame_range=(1, 100), use_animation=True)
    bpy.pump_draw()
    for _ in range(frames):
        bpy.pump_frame()
    env.events.stop()
    return seen, len(env.renderer.offscreen.draw_calls)


@pytest.mark.parametrize("every_nth", [1, 2])
def test_attach_default_renderer_fills_rgb_array(bpy, every_nth):
    """Every nth frame renders the scene camera, color-managed, into the
    ctx the agent sees (6 frames: offsets 0-5 from the range's start); the
    JAX package's BaseEnv on the same fake scene renders as often and the
    agent sees the same arrays."""
    from blendjax_torch.btb.env import BaseEnv

    seen, renders = _run_env(BaseEnv, bpy, every_nth)
    jbpy = fake_bpy.install()
    from blendjax.btb.env import BaseEnv as JBaseEnv

    jseen, jrenders = _run_env(JBaseEnv, jbpy, every_nth)
    assert renders == jrenders == -(-6 // every_nth)
    assert [t for t, _ in seen] == [t for t, _ in jseen] == [2, 3, 4, 5, 6]
    for (_, img), (_, jimg) in zip(seen, jseen):
        assert img.shape == (240, 320, 3) and img.dtype == np.uint8
        np.testing.assert_array_equal(img, jimg)


# -- producers through the port's launcher ----------------------------------


def _load_spec():
    path = os.path.join(BLEND_SCRIPTS, "golden_camera_spec.py")
    mod_spec = importlib.util.spec_from_file_location("golden_camera_spec", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def _one_payload(launcher_cls, script):
    with launcher_cls(scene="", script=script, num_instances=1, named_sockets=["DATA"],
                      start_port=free_port(), background=True) as bl:
        ctx = zmq.Context()
        try:
            sock = ctx.socket(zmq.PULL)
            sock.connect(bl.launch_info.addresses["DATA"][0])
            assert sock.poll(30000), "no golden-camera payload"
            from blendjax_torch import wire

            return wire.recv_message(sock)
        finally:
            ctx.destroy(linger=0)


def test_golden_camera_producer_matches_analytic(monkeypatch):
    """The port's golden-camera producer through the port's launcher meets
    the spec's analytic bar, and publishes the JAX producer's projections
    (atol 1e-12) on the same fake scene."""
    from blendjax.btt.launcher import BlenderLauncher as JaxLauncher
    from blendjax_torch.btt.launcher import BlenderLauncher

    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)
    monkeypatch.setenv("BLENDJAX_FAKE_BPY", "1")
    spec = _load_spec()
    msg = _one_payload(BlenderLauncher, f"{BLEND_SCRIPTS}/torch_golden_camera.blend.py")
    spec.check_payload(msg)
    jmsg = _one_payload(JaxLauncher, f"{BLEND_SCRIPTS}/golden_camera.blend.py")
    for name in ("persp", "ortho"):
        for key in ("pix", "depth"):
            np.testing.assert_allclose(msg[f"{name}_{key}"], jmsg[f"{name}_{key}"],
                                       rtol=0, atol=ATOL)
        view = jcm.look_at_matrix(spec.EYE, spec.TARGET)
        np.testing.assert_allclose(msg[f"{name}_view"], view, rtol=0, atol=1e-9)


def _cube_items(launcher_cls, dataset_cls, script, n=3):
    with launcher_cls(scene="", script=script, num_instances=1, named_sockets=["DATA"],
                      start_port=free_port(), background=True, seed=0) as bl:
        return list(dataset_cls(bl.launch_info.addresses["DATA"], max_items=n,
                                timeoutms=30000))


def test_datagen_cube_producer_streams_annotated_frames(monkeypatch):
    """The port's cube producer (``btb/cube.blend.py``, the datagen
    example's producer) through the port's launcher and dataset: aimed
    camera, 8 projected corners inside the frame, and the JAX producer's
    images and keypoints for the same seed, frame by frame."""
    from blendjax.btt.dataset import RemoteIterableDataset as JaxDataset
    from blendjax.btt.launcher import BlenderLauncher as JaxLauncher
    from blendjax_torch import datagen
    from blendjax_torch.btt.dataset import RemoteIterableDataset
    from blendjax_torch.btt.launcher import BlenderLauncher

    monkeypatch.setenv("BLENDJAX_BLENDER", FAKE_BLENDER)
    monkeypatch.setenv("BLENDJAX_FAKE_BPY", "1")
    assert datagen.SCRIPT.name == "cube.blend.py"
    items = _cube_items(BlenderLauncher, RemoteIterableDataset, str(datagen.SCRIPT))
    jitems = _cube_items(JaxLauncher, JaxDataset,
                         os.path.join(REPO_ROOT, "examples", "datagen", "cube.blend.py"))
    assert len(items) == len(jitems) == 3
    for item, jitem in zip(items, jitems):
        assert item["image"].shape == (480, 640, 3) and item["image"].dtype == np.uint8
        assert item["xy"].shape == (8, 2) and item["xy"].dtype == np.float32
        assert (item["xy"][:, 0] >= 0).all() and (item["xy"][:, 0] <= 640).all()
        assert (item["xy"][:, 1] >= 0).all() and (item["xy"][:, 1] <= 480).all()
        assert item["frameid"] == jitem["frameid"]
        np.testing.assert_array_equal(item["image"], jitem["image"])
        np.testing.assert_array_equal(item["xy"], jitem["xy"])
