"""bpy camera adapter: intrinsics, extrinsics and pixel-space annotations;
a copy of ``blendjax.btb.camera``.

A thin wrapper around a Blender camera object that leaves all the math to
the pure :mod:`blendjax_torch.btb.camera_math`.  It produces the ``xy``
keypoint and bounding-box labels streamed beside rendered frames.  ``bpy``
and ``mathutils`` are imported where they are used, so the module imports
outside Blender.
"""

from __future__ import annotations

import numpy as np

from blendjax_torch.btb import camera_math as cm


def _bpy():
    import bpy

    return bpy


class Camera:
    """Camera settings, matrices, and projection helpers.

    Params
    ------
    bpy_camera: bpy.types.Object | None
        Camera object; defaults to the scene camera.
    shape: (H, W) | None
        Target image shape; defaults to render settings.
    """

    def __init__(self, bpy_camera=None, shape=None):
        self.bpy_camera = bpy_camera or _bpy().context.scene.camera
        self.shape = shape or Camera.shape_from_bpy()
        self.update_view_matrix()
        self.update_proj_matrix()

    def update_view_matrix(self):
        """Refresh the cached 4x4 view matrix (world -> camera)."""
        self.view_matrix = Camera.view_from_bpy(self.bpy_camera)

    def update_proj_matrix(self):
        """Refresh the cached 4x4 projection matrix (camera -> clip)."""
        self.proj_matrix = Camera.proj_from_bpy(self.bpy_camera, self.shape)

    @property
    def type(self):
        return self.bpy_camera.data.type

    @property
    def clip_range(self):
        return (self.bpy_camera.data.clip_start, self.bpy_camera.data.clip_end)

    @staticmethod
    def shape_from_bpy(bpy_render=None):
        """(H, W) from the render settings, resolution percentage included."""
        render = bpy_render or _bpy().context.scene.render
        scale = render.resolution_percentage / 100.0
        return (int(render.resolution_y * scale), int(render.resolution_x * scale))

    @staticmethod
    def view_from_bpy(bpy_camera):
        """View matrix: the normalized world matrix, inverted."""
        camera = bpy_camera or _bpy().context.scene.camera
        return np.asarray(camera.matrix_world.normalized().inverted())

    @staticmethod
    def proj_from_bpy(bpy_camera, shape):
        """Projection via ``calc_matrix_camera`` on the evaluated depsgraph."""
        bpy = _bpy()
        camera = bpy_camera or bpy.context.scene.camera
        shape = shape or Camera.shape_from_bpy()
        return np.asarray(
            camera.calc_matrix_camera(bpy.context.evaluated_depsgraph_get(),
                                      x=shape[1], y=shape[0])
        )

    # -- projections (pure math, see camera_math) ---------------------------

    def world_to_ndc(self, xyz_world, return_depth=False):
        return cm.world_to_ndc(xyz_world, self.view_matrix, self.proj_matrix,
                               return_depth=return_depth)

    def ndc_to_pixel(self, ndc, origin="upper-left"):
        return cm.ndc_to_pixel(ndc, self.shape, origin=origin)

    def object_to_pixel(self, *objs, return_depth=False, origin="upper-left"):
        """Pixel coordinates of all vertices of the given objects."""
        from blendjax_torch.btb.utils import world_coordinates

        return cm.project_points(world_coordinates(*objs), self.view_matrix,
                                 self.proj_matrix, self.shape, origin=origin,
                                 return_depth=return_depth)

    def bbox_object_to_pixel(self, *objs, return_depth=False, origin="upper-left"):
        """Pixel coordinates of the bounding-box corners of the given objects."""
        from blendjax_torch.btb.utils import bbox_world_coordinates

        return cm.project_points(bbox_world_coordinates(*objs), self.view_matrix,
                                 self.proj_matrix, self.shape, origin=origin,
                                 return_depth=return_depth)

    def look_at(self, look_at=None, look_from=None):
        """Aim the camera: -Z at the target, Y up."""
        from mathutils import Vector

        if look_from is None:
            look_from = self.bpy_camera.location
        if look_at is None:
            look_at = Vector((0.0, 0.0, 0.0))
        direction = Vector(look_at) - Vector(look_from)
        rot_quat = direction.to_track_quat("-Z", "Y")
        self.bpy_camera.rotation_euler = rot_quat.to_euler()
        self.bpy_camera.location = look_from
        self.update_view_matrix()
