"""Clip-box interaction: picking and dragging (host-side numpy).

Parity with util.ts:145-263 and the viewer's clip-plane editing
(viewer.ts:1359-1440): CPU ray-box intersection, mouse->world rays, AABB
face picking by perpendicular distance, closest points between skew lines,
and the face-drag update of the normalized clip bounds. Face indices
follow the reference: 0 +z front, 1 -z back, 2 -x left, 3 +x right,
4 +y top, 5 -y bottom.
"""

from __future__ import annotations

import numpy as np

FACE_NORMALS = np.array(
    [
        [0.0, 0.0, 1.0],  # 0 front  (+z)
        [0.0, 0.0, -1.0],  # 1 back   (-z)
        [-1.0, 0.0, 0.0],  # 2 left   (-x)
        [1.0, 0.0, 0.0],  # 3 right  (+x)
        [0.0, 1.0, 0.0],  # 4 top    (+y)
        [0.0, -1.0, 0.0],  # 5 bottom (-y)
    ],
    dtype=np.float64,
)

MIN_CLIP_GAP = 0.1  # minimum slab thickness kept by drags (viewer.ts:1410+)


def ray_box_intersection(origin, direction, aabb_lo, aabb_hi):
    """CPU slab test (util.ts:151-160). Returns (hit, near, far)."""
    origin = np.asarray(origin, np.float64)
    direction = np.asarray(direction, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / direction
        lo = (np.asarray(aabb_lo, np.float64) - origin) * inv
        hi = (np.asarray(aabb_hi, np.float64) - origin) * inv
    tmin = np.minimum(lo, hi)
    tmax = np.maximum(lo, hi)
    near = max(0.0, float(np.max(tmin)))
    far = float(np.min(tmax))
    return near <= far, near, far


def ray_box_positions(origin, direction, aabb_lo, aabb_hi):
    """Entry/exit positions, origin-clamped when inside (util.ts:162-178)."""
    hit, near, far = ray_box_intersection(origin, direction, aabb_lo, aabb_hi)
    if not hit:
        return None
    origin = np.asarray(origin, np.float64)
    direction = np.asarray(direction, np.float64)
    if near < 0:
        return origin.copy(), origin + direction * far
    return origin + direction * near, origin + direction * far


def world_ray(camera, screen_xy, aspect: float):
    """Mouse (NDC [-1,1]^2) -> world ray from the camera (util.ts:180-197)."""
    inv_proj = np.linalg.inv(camera.proj_matrix(aspect).astype(np.float64))
    clip = np.array([screen_xy[0], screen_xy[1], 0.0, 1.0])
    view_h = inv_proj @ clip
    view = view_h[:3] / view_h[3]
    inv_view = np.linalg.inv(camera.view_matrix().astype(np.float64))
    world_h = inv_view @ np.array([*view, 1.0])
    world = world_h[:3] / world_h[3]
    direction = world - camera.pos
    direction = direction / np.linalg.norm(direction)
    return camera.pos.copy(), direction


def cube_face(aabb_lo, aabb_hi, pos) -> int | None:
    """Pick the AABB face nearest to a world position (util.ts:207-243)."""
    if pos is None:
        return None
    pos = np.asarray(pos, np.float64)
    lo = np.asarray(aabb_lo, np.float64)
    hi = np.asarray(aabb_hi, np.float64)
    dists = [
        abs(pos[2] - hi[2]),  # front
        abs(pos[2] - lo[2]),  # back
        abs(pos[0] - lo[0]),  # left
        abs(pos[0] - hi[0]),  # right
        abs(pos[1] - hi[1]),  # top
        abs(pos[1] - lo[1]),  # bottom
    ]
    clamped = np.clip(pos, lo, hi)
    eps = 1e-5
    candidates = []
    if abs(clamped[2] - hi[2]) <= eps:
        candidates.append(0)
    if abs(clamped[2] - lo[2]) <= eps:
        candidates.append(1)
    if abs(clamped[0] - lo[0]) <= eps:
        candidates.append(2)
    if abs(clamped[0] - hi[0]) <= eps:
        candidates.append(3)
    if abs(clamped[1] - hi[1]) <= eps:
        candidates.append(4)
    if abs(clamped[1] - lo[1]) <= eps:
        candidates.append(5)
    if not candidates:
        return None
    return min(candidates, key=lambda i: dists[i])


def closest_points(o1, d1, o2, d2):
    """Closest points on two skew lines (util.ts:244-263); None if parallel."""
    o1 = np.asarray(o1, np.float64)
    d1 = np.asarray(d1, np.float64)
    o2 = np.asarray(o2, np.float64)
    d2 = np.asarray(d2, np.float64)
    r = o1 - o2
    a = d1 @ d1
    b = d1 @ d2
    c = d2 @ d2
    d = d1 @ r
    e = d2 @ r
    denom = a * c - b * b
    if abs(denom) <= 1e-8:
        return None
    t = (b * e - c * d) / denom
    u = (a * e - b * d) / denom
    return o1 + d1 * t, o2 + d2 * u


class ClipBoxController:
    """Stateful clip-box editing (viewer.ts:1359-1440).

    Drive with hover(mouse) -> face index for highlight, then begin_drag()
    / drag(mouse) / end_drag() to resize the clip box along the picked
    face's normal. Mouse positions are NDC [-1,1]^2.
    """

    def __init__(self, renderer):
        self.renderer = renderer
        self.adjusting = False
        self._last_face: int | None = None
        self._last_world_pos: np.ndarray | None = None

    def _aabb_clipped(self):
        return self.renderer.volume.aabb_clipped(
            self.renderer.settings.volume_clip_min,
            self.renderer.settings.volume_clip_max,
        )

    def hover(self, mouse_ndc, aspect: float = 1.0) -> int | None:
        """currentCubeFace (viewer.ts:1362-1369)."""
        if self.adjusting:
            return self._last_face
        lo, hi = self._aabb_clipped()
        origin, direction = world_ray(self.renderer.camera, mouse_ndc, aspect)
        positions = ray_box_positions(origin, direction, lo, hi)
        self._last_world_pos = positions[0] if positions else None
        self._last_face = cube_face(lo, hi, self._last_world_pos)
        return self._last_face

    def begin_drag(self) -> bool:
        self.adjusting = self._last_face is not None
        return self.adjusting

    def end_drag(self) -> None:
        self.adjusting = False

    def drag(self, mouse_ndc, aspect: float = 1.0) -> None:
        """rescaleAABBFromClippingInput (viewer.ts:1398-1440)."""
        if not self.adjusting or self._last_face is None or self._last_world_pos is None:
            return
        face = self._last_face
        normal = FACE_NORMALS[face]
        cam_o, cam_d = world_ray(self.renderer.camera, mouse_ndc, aspect)
        points = closest_points(self._last_world_pos, normal, cam_o, cam_d)
        if points is None:
            return
        new_pos = points[0]
        lo, hi = self.renderer.volume.aabb()
        s = self.renderer.settings
        cmin = list(s.volume_clip_min)
        cmax = list(s.volume_clip_max)
        span = hi - lo
        gap = MIN_CLIP_GAP
        if face == 0:  # +z front
            cmax[2] = min(max(cmin[2] + gap, 1 - (hi[2] - new_pos[2]) / span[2]), 1)
        elif face == 1:  # -z back
            cmin[2] = max(min(cmax[2] - gap, 1 - (hi[2] - new_pos[2]) / span[2]), 0)
        elif face == 2:  # -x left
            cmin[0] = max(min(cmax[0] - gap, 1 - (hi[0] - new_pos[0]) / span[0]), 0)
        elif face == 3:  # +x right
            cmax[0] = min(max(cmin[0] + gap, 1 - (hi[0] - new_pos[0]) / span[0]), 1)
        elif face == 4:  # +y top
            cmax[1] = min(max(cmin[1] + gap, 1 - (hi[1] - new_pos[1]) / span[1]), 1)
        elif face == 5:  # -y bottom
            cmin[1] = max(min(cmax[1] - gap, 1 - (hi[1] - new_pos[1]) / span[1]), 0)
        s.volume_clip_min = [float(v) for v in cmin]
        s.volume_clip_max = [float(v) for v in cmax]
        self.renderer.restart_rendering()
