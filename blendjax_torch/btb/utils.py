"""Blender-side scene helpers: a copy of ``blendjax.btb.utils``.

The pure math (``hom``, ``dehom``, ``random_spherical_loc``) lives in
:mod:`blendjax_torch.btb.camera_math` and is re-exported here; everything
else reads the scene through ``bpy`` (and ``mathutils``), imported where it
is used, so the module imports outside Blender.
"""

from __future__ import annotations

import numpy as np

from blendjax_torch.btb.camera_math import (  # noqa: F401  (re-exports)
    dehom,
    hom,
    random_spherical_loc,
)


def _bpy():
    import bpy

    return bpy


def find_first_view3d():
    """First VIEW_3D area, its space, and its widest window region: what
    offscreen rendering draws into.  Returns ``(area, space, region)``."""
    areas = [a for a in _bpy().context.screen.areas if a.type == "VIEW_3D"]
    if not areas:
        raise RuntimeError("No VIEW_3D area found; offscreen rendering needs a UI.")
    area = areas[0]
    regions = sorted([r for r in area.regions if r.type == "WINDOW"],
                     key=lambda r: r.width, reverse=True)
    spaces = [s for s in area.spaces if s.type == "VIEW_3D"]
    if not regions or not spaces:
        raise RuntimeError("VIEW_3D area lacks window region or space.")
    return area, spaces[0], regions[0]


def _evaluated(objs, depsgraph):
    dg = depsgraph or _bpy().context.evaluated_depsgraph_get()
    return [obj.evaluated_get(dg) for obj in objs]


def object_coordinates(*objs, depsgraph=None):
    """Nx3 object-space vertex coordinates, modifiers applied."""
    coords = []
    for eo in _evaluated(objs, depsgraph):
        coords.extend(tuple(v.co) for v in eo.data.vertices)
    return np.array(coords)


def world_coordinates(*objs, depsgraph=None):
    """Nx3 world-space vertex coordinates, modifiers applied."""
    coords = []
    for eo in _evaluated(objs, depsgraph):
        m = eo.matrix_world
        coords.extend(tuple(m @ v.co) for v in eo.data.vertices)
    return np.array(coords)


def bbox_world_coordinates(*objs, depsgraph=None):
    """Nx3 world-space bounding-box corners (8 per object)."""
    from mathutils import Vector

    coords = []
    for eo in _evaluated(objs, depsgraph):
        m = eo.matrix_world
        coords.extend(tuple(m @ Vector(c)) for c in eo.bound_box)
    return np.array(coords)


def compute_object_visibility(obj, cam, N=25, scene=None, view_layer=None, dist=None,
                              rng=None):
    """Monte-Carlo visibility fraction of ``obj`` from camera ``cam`` by ray
    casting."""
    bpy = _bpy()
    scene = scene or bpy.context.scene
    vl = view_layer or bpy.context.view_layer
    rng = rng or np.random.default_rng()
    src = cam.bpy_camera.matrix_world.translation
    dist = dist or 1.70141e38
    cam_inv = cam.bpy_camera.matrix_world.inverted()

    ids = rng.integers(0, len(obj.data.vertices), size=N)
    visible = 0
    for idx in ids:
        dst_world = obj.matrix_world @ obj.data.vertices[int(idx)].co
        direction = (dst_world - src).normalized()
        dst_cam = cam_inv @ dst_world
        if dst_cam.z <= 0.0 and np.isfinite(np.asarray(direction)).all():
            hit, _, _, _, hit_obj, _ = scene.ray_cast(vl, src, direction, distance=dist)
            if hit and hit_obj == obj:
                visible += 1
    return visible / N


def scene_stats():
    """Live and orphaned block counts per data collection: a debug aid."""
    bpy = _bpy()
    stats = {}
    for attr in dir(bpy.data):
        coll = getattr(bpy.data, attr, None)
        if isinstance(coll, bpy.types.bpy_prop_collection) and len(coll):
            orphaned = sum(1 for o in coll if getattr(o, "users", 1) == 0)
            stats[attr] = (len(coll) - orphaned, orphaned)
    return stats
