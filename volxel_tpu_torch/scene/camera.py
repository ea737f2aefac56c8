"""Orbit camera with the reference's control semantics.

Parity with representation/scene.ts: yaw/pitch rotation around the look-at
point with pitch clamped to +/-(pi/2 - 0.01) (scene.ts:15-32), zoom with the
[0.1, 10] distance window (scene.ts:34-39), plane translation (scene.ts:41-46),
and view/projection matrices with fovy=pi/3, near=0.1, far=1000
(scene.ts:58-72). Host-side numpy; matrices feed the jitted render as args.
"""

from __future__ import annotations

import numpy as np

from volxel_tpu_torch.utils.mathutil import look_at, perspective

UP = np.array([0.0, 1.0, 0.0], dtype=np.float64)


def _axis_rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation matrix about a unit axis."""
    axis = axis / np.linalg.norm(axis)
    k = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


class Camera:
    def __init__(self, distance: float = 1.0):
        self.view = np.zeros(3, dtype=np.float64)
        self.pos = np.array([0.0, 0.0, -float(distance)], dtype=np.float64)
        self.yaw = 0.0
        self.pitch = 0.0

    def rotate_around_view(self, by_x: float, by_y: float) -> None:
        """scene.ts:15-32 — accumulate yaw/pitch, recompute pos on the orbit."""
        self.yaw += -by_x
        self.pitch += by_y
        max_pitch = np.pi / 2 - 0.01
        self.pitch = float(np.clip(self.pitch, -max_pitch, max_pitch))

        r_yaw = _axis_rotation(UP, self.yaw)
        right = r_yaw @ np.array([1.0, 0.0, 0.0])
        right = right / np.linalg.norm(right)
        r_pitch = _axis_rotation(right, self.pitch)
        orientation = r_pitch @ r_yaw
        dist = np.linalg.norm(self.pos - self.view)
        final_dir = orientation @ np.array([0.0, 0.0, -1.0]) * dist
        self.pos = final_dir + self.view

    def zoom(self, by: float) -> bool:
        """scene.ts:34-39 — multiplicative zoom, distance clamped to (0.1, 10)."""
        direction = self.pos - self.view
        d = np.linalg.norm(direction)
        if d * by <= 0.1 or d * by >= 10:
            return False
        self.pos = direction * by + self.view
        return True

    def translate_on_plane(self, by_x: float, by_y: float) -> None:
        """scene.ts:41-46"""
        direction = self.pos - self.view
        right = np.cross(direction, UP)
        right = right / np.linalg.norm(right)
        local_up = np.cross(direction, right)
        local_up = local_up / np.linalg.norm(local_up)
        self.translate(right * (by_x * 5) + local_up * (-by_y * 5))

    def translate(self, by) -> None:
        by = np.asarray(by, dtype=np.float64)
        self.pos = self.pos + by
        self.view = self.view + by

    def view_matrix(self) -> np.ndarray:
        return look_at(self.pos, self.view, UP)

    def proj_matrix(self, aspect: float, fov: float = np.pi / 3) -> np.ndarray:
        return perspective(fov, aspect, 0.1, 1000.0)
