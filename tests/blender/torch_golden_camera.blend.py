"""Golden-camera producer on the port's ``btb`` (the port's copy of
``tests/blender/golden_camera.blend.py``): builds the scene of
``golden_camera_spec.py`` procedurally, projects the spec's world points
through the port's bpy ``Camera`` for a perspective and an orthographic
camera, and publishes the pixel coordinates and depths once."""

import importlib.util
import os
import sys

import numpy as np

_SPEC_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_camera_spec.py")
_spec_mod = importlib.util.spec_from_file_location("golden_camera_spec", _SPEC_PATH)
spec = importlib.util.module_from_spec(_spec_mod)
_spec_mod.loader.exec_module(spec)


def _add_camera(bpy, name, cam_type):
    data = bpy.data.cameras.new(name)
    data.type = cam_type
    data.clip_start = spec.NEAR
    data.clip_end = spec.FAR
    if cam_type == "ORTHO":
        data.ortho_scale = spec.ORTHO_SCALE
    else:
        data.sensor_fit = "AUTO"
        data.angle = spec.FOV_X  # horizontal FOV at AUTO fit, w >= h
    obj = bpy.data.objects.new(name, data)
    bpy.context.scene.collection.objects.link(obj)
    return obj


def main():
    import bpy

    from blendjax_torch.btb.arguments import parse_blendtorch_args
    from blendjax_torch.btb.camera import Camera
    from blendjax_torch.btb.publisher import DataPublisher

    args, _ = parse_blendtorch_args(sys.argv)
    bpy.ops.object.select_all(action="SELECT")
    bpy.ops.object.delete(use_global=False)
    scene = bpy.context.scene
    scene.render.resolution_x = spec.WIDTH
    scene.render.resolution_y = spec.HEIGHT
    scene.render.resolution_percentage = 100

    payload = {}
    for name, cam_type in (("persp", "PERSP"), ("ortho", "ORTHO")):
        obj = _add_camera(bpy, name, cam_type)
        scene.camera = obj
        cam = Camera(obj)
        cam.look_at(look_at=spec.TARGET, look_from=spec.EYE)
        bpy.context.view_layer.update()
        cam.update_view_matrix()
        cam.update_proj_matrix()
        ndc, depth = cam.world_to_ndc(spec.POINTS, return_depth=True)
        pix = cam.ndc_to_pixel(ndc, origin="upper-left")
        payload[f"{name}_pix"] = np.asarray(pix, np.float64)
        payload[f"{name}_depth"] = np.asarray(depth, np.float64)
        payload[f"{name}_view"] = np.asarray(cam.view_matrix, np.float64)
        payload[f"{name}_proj"] = np.asarray(cam.proj_matrix, np.float64)
        payload[f"{name}_type"] = cam.type

    DataPublisher(args.btsockets["DATA"], args.btid).publish(**payload)


main()
