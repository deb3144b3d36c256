"""Pure-numpy camera projection math: a copy of ``blendjax.btb.camera_math``.

The projection math of the bpy :class:`~blendjax_torch.btb.camera.Camera`
adapter, kept free of bpy so it runs under golden-value tests anywhere and
serves the consumer side too (re-projecting keypoints in a training loop).

Conventions match Blender/OpenGL: camera looks down -Z, NDC in [-1, 1]^3,
view = inverse of the camera's world matrix.
"""

from __future__ import annotations

import numpy as np


def hom(x, v=1.0):
    """Append a homogeneous coordinate ``v`` along the last axis
    (blendtorch ``utils.py:112-117``)."""
    x = np.atleast_2d(x)
    pad = np.full((*x.shape[:-1], 1), v, dtype=x.dtype)
    return np.concatenate((x, pad), axis=-1)


def dehom(x):
    """Perspective division by the last coordinate (blendtorch
    ``utils.py:119-121``)."""
    return x[..., :-1] / x[..., -1:]


def world_to_ndc(xyz_world, view_matrix, proj_matrix, return_depth=False):
    """Project Nx3 world points to normalized device coordinates.

    With ``return_depth`` also returns linear depth along the camera's
    viewing direction (positive in front of the camera) — the annotation
    signal used for keypoint depth labels (blendtorch ``camera.py:84-112``).
    """
    view = np.asarray(view_matrix, dtype=np.float64)
    proj = np.asarray(proj_matrix, dtype=np.float64)
    xyzw = hom(np.atleast_2d(np.asarray(xyz_world, dtype=np.float64)))
    cam = xyzw @ view.T
    ndc = dehom(cam @ proj.T)
    if return_depth:
        return ndc, -cam[:, 2].copy()  # camera looks down -Z
    return ndc


def ndc_to_pixel(ndc, shape, origin="upper-left"):
    """Map NDC xy to pixel coordinates for an (H, W) image.

    ``origin='upper-left'`` yields OpenCV convention, ``'lower-left'``
    OpenGL (blendtorch ``camera.py:115-136``).
    """
    if origin not in ("upper-left", "lower-left"):
        raise ValueError(f"unknown origin {origin!r}")
    h, w = shape
    xy = (np.atleast_2d(ndc)[:, :2] + 1.0) * 0.5
    if origin == "upper-left":
        xy = np.stack([xy[:, 0], 1.0 - xy[:, 1]], axis=-1)
    return xy * np.array([[w, h]], dtype=xy.dtype)


def project_points(
    xyz_world, view_matrix, proj_matrix, shape, origin="upper-left", return_depth=False
):
    """world -> pixel composition (blendtorch ``camera.py:138-162``)."""
    if return_depth:
        ndc, z = world_to_ndc(xyz_world, view_matrix, proj_matrix, return_depth=True)
        return ndc_to_pixel(ndc, shape, origin), z
    return ndc_to_pixel(
        world_to_ndc(xyz_world, view_matrix, proj_matrix), shape, origin
    )


def look_at_matrix(eye, target, up=(0.0, 0.0, 1.0)):
    """4x4 view matrix for a camera at ``eye`` looking at ``target``.

    Equivalent to Blender's ``to_track_quat('-Z', 'Y')`` placement followed
    by world-matrix inversion (blendtorch ``camera.py:191-204``): the camera
    -Z axis points at the target, +Y is the projected up vector.
    """
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    upv = np.asarray(up, dtype=np.float64)
    right = np.cross(fwd, upv)
    norm = np.linalg.norm(right)
    if norm < 1e-9:  # looking along up: pick an arbitrary right vector
        right = np.cross(fwd, np.array([1.0, 0.0, 0.0]))
        norm = np.linalg.norm(right)
    right = right / norm
    true_up = np.cross(right, fwd)

    view = np.eye(4)
    view[0, :3] = right
    view[1, :3] = true_up
    view[2, :3] = -fwd
    view[:3, 3] = -view[:3, :3] @ eye
    return view


def perspective_projection(fov_y, aspect, near, far):
    """Symmetric OpenGL-style perspective matrix.

    ``fov_y`` is the full vertical field of view in radians; ``aspect`` is
    width/height.  Matches what Blender's ``calc_matrix_camera`` produces
    for a perspective camera with equivalent sensor/lens settings.
    """
    f = 1.0 / np.tan(fov_y / 2.0)
    proj = np.zeros((4, 4))
    proj[0, 0] = f / aspect
    proj[1, 1] = f
    proj[2, 2] = -(far + near) / (far - near)
    proj[2, 3] = -(2.0 * far * near) / (far - near)
    proj[3, 2] = -1.0
    return proj


def orthographic_projection(scale, aspect, near, far):
    """OpenGL-style orthographic matrix.

    ``scale`` is the full width of the view volume (Blender's
    ``ortho_scale``); height follows from ``aspect`` = width/height.
    """
    half_w = scale / 2.0
    half_h = half_w / aspect
    proj = np.eye(4)
    proj[0, 0] = 1.0 / half_w
    proj[1, 1] = 1.0 / half_h
    proj[2, 2] = -2.0 / (far - near)
    proj[2, 3] = -(far + near) / (far - near)
    return proj


def bbox_corners(minimum, maximum):
    """8 corner points of an axis-aligned box, Nx3."""
    mn = np.asarray(minimum, dtype=np.float64)
    mx = np.asarray(maximum, dtype=np.float64)
    corners = []
    for x in (mn[0], mx[0]):
        for y in (mn[1], mx[1]):
            for z in (mn[2], mx[2]):
                corners.append((x, y, z))
    return np.array(corners)


def random_spherical_loc(radius_range=None, theta_range=None, phi_range=None, rng=None):
    """Random location on a sphere shell — the domain-randomization helper
    (blendtorch ``utils.py:123-156``).  ``rng`` is a ``numpy.random.Generator``
    for reproducibility (blendtorch uses the global seed only)."""
    rng = rng or np.random.default_rng()
    r_lo, r_hi = radius_range or (1.0, 1.0)
    t_lo, t_hi = theta_range or (0.0, np.pi)
    p_lo, p_hi = phi_range or (0.0, 2 * np.pi)
    r = rng.uniform(r_lo, r_hi)
    t = rng.uniform(t_lo, t_hi)
    p = rng.uniform(p_lo, p_hi)
    return np.array(
        [np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)]
    ) * r
