"""Offscreen renderer of the first 3D viewport: a copy of
``blendjax.btb.offscreen``.

Renders into a ``gpu.types.GPUOffScreen`` and reads the color texture back
as a numpy uint8 HxWxC array.  Must be called where the GL context is
valid, i.e. inside the POST_PIXEL draw callback that
``AnimationController(use_offline_render=True)`` provides (or the blocking
``--background`` loop under a GL-capable stack).

Readback, newest first: ``GPUTexture.read()`` (Blender >= 3.0, a buffer
``np.asarray`` views without a copy), then PyOpenGL's ``glGetTexImage``
for Blender 2.8x.  Blender renders linear color; ``gamma=True`` asks
``draw_view3d`` for color management (sRGB-encoded frames), else frames
ship linear and the consumer may encode them on the card
(:func:`blendjax_torch.ops.image.linear_to_srgb`).  ``bpy``, ``gpu`` and
``mathutils`` are imported where they are used.
"""

from __future__ import annotations

import numpy as np


class OffScreenRenderer:
    """Offscreen render of the first 3D viewport.

    Params
    ------
    camera: blendjax_torch.btb.Camera | None
        Camera providing view/projection matrices; defaults to scene camera.
    mode: 'rgb' | 'rgba'
        Channels of the returned array.
    origin: 'upper-left' | 'lower-left'
        Row order of the returned image.
    gamma: bool
        Color-managed (sRGB-encoded) output instead of linear.
    """

    def __init__(self, camera=None, mode="rgb", origin="upper-left", gamma=False):
        import gpu

        from blendjax_torch.btb.camera import Camera
        from blendjax_torch.btb.utils import find_first_view3d

        if mode not in ("rgb", "rgba"):
            raise ValueError(f"unknown mode {mode!r}")
        self.camera = camera or Camera()
        self.mode = mode
        self.origin = origin
        self.gamma = gamma
        h, w = self.camera.shape
        self.offscreen = gpu.types.GPUOffScreen(w, h)
        self.area, self.space, self.region = find_first_view3d()

    def set_render_style(self, shading="RENDERED", overlays=False):
        """Viewport shading for subsequent renders."""
        self.space.shading.type = shading
        self.space.overlay.show_overlays = overlays

    def render(self):
        """Render and return HxWx{3,4} uint8."""
        import bpy

        h, w = self.camera.shape
        self.offscreen.draw_view3d(
            bpy.context.scene,
            bpy.context.view_layer,
            self.space,
            self.region,
            _as_matrix(self.camera.view_matrix),
            _as_matrix(self.camera.proj_matrix),
            do_color_management=self.gamma,
        )
        rgba = self._read_texture(w, h)
        img = rgba[..., :3] if self.mode == "rgb" else rgba
        if self.origin == "upper-left":
            img = np.flipud(img)
        return np.ascontiguousarray(img)

    def _read_texture(self, w, h):
        tex = getattr(self.offscreen, "texture_color", None)
        if tex is not None and hasattr(tex, "read"):
            buf = tex.read()  # gpu.types.Buffer, float32 RGBA in Blender 3.x+
            arr = np.asarray(buf, dtype=np.float32).reshape(h, w, 4)
            return (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        return self._read_texture_gl(w, h)

    def _read_texture_gl(self, w, h):  # pragma: no cover - Blender 2.8x only
        """PyOpenGL readback for Blender 2.8x."""
        import bgl
        from OpenGL.GL import GL_RGBA, GL_TEXTURE_2D, GL_UNSIGNED_BYTE, glGetTexImage

        buffer = np.zeros((h, w, 4), dtype=np.uint8)
        bgl.glActiveTexture(bgl.GL_TEXTURE0)
        bgl.glBindTexture(bgl.GL_TEXTURE_2D, self.offscreen.color_texture)
        glGetTexImage(GL_TEXTURE_2D, 0, GL_RGBA, GL_UNSIGNED_BYTE, buffer)
        return buffer

    def free(self):
        self.offscreen.free()


def _as_matrix(m):
    """numpy 4x4 -> mathutils.Matrix for the gpu API."""
    from mathutils import Matrix

    return Matrix([list(row) for row in np.asarray(m)])
