"""Light-direction editing model (elements/cubeDirection.ts, DOM-free).

The reference's UnitCubeDisplay is a CSS-3D cube the user drags to set the
directional light; its data model is a (pitch, yaw) pair with drag deltas,
a pitch clamp, and a direction vector getter/setter emitting change events
(cubeDirection.ts:151-207, 245-258). This class is that model; listeners
typically assign `settings.light_dir`.

Faithful quirks: the getter returns (-x, +y, +z) of the origin->camera
vector — the reference negates only the x component when converting to the
"camera->origin" direction (cubeDirection.ts:162-167) — and the setter is
its exact inverse, so set->get round-trips.
"""

from __future__ import annotations

import math
from typing import Callable

DRAG_SCALE = 0.5  # degrees per pixel (cubeDirection.ts:251-252)


class LightDirectionCube:
    def __init__(self, pitch: float = -20.0, yaw: float = 45.0):
        # initial rotation (cubeDirection.ts:110-111), degrees
        self.pitch = pitch
        self.yaw = yaw
        self._listeners: list[Callable[[tuple[float, float, float]], None]] = []

    def on_change(self, fn: Callable[[tuple[float, float, float]], None]) -> None:
        self._listeners.append(fn)

    def _emit(self) -> None:
        d = self.direction
        for fn in self._listeners:
            fn(d)

    def drag(self, dx: float, dy: float) -> None:
        """Mouse-drag delta in pixels (cubeDirection.ts:245-258)."""
        self.yaw += dx * DRAG_SCALE
        self.pitch -= dy * DRAG_SCALE
        self.pitch = max(-90.0, min(90.0, self.pitch))
        self._emit()

    @property
    def direction(self) -> tuple[float, float, float]:
        rx = math.radians(self.pitch)
        ry = math.radians(self.yaw)
        cam = (
            math.cos(rx) * math.sin(ry),
            math.sin(rx),
            math.cos(rx) * math.cos(ry),
        )
        return (-cam[0], cam[1], cam[2])

    @direction.setter
    def direction(self, vec) -> None:
        x, y, z = (float(v) for v in vec)
        mag = math.sqrt(x * x + y * y + z * z)
        if mag == 0.0:
            raise ValueError("Cannot set direction with a zero vector")
        ox, oy, oz = -x / mag, y / mag, z / mag
        self.pitch = math.degrees(math.asin(max(-1.0, min(1.0, oy))))
        self.yaw = math.degrees(math.atan2(ox, oz))
        self._emit()
