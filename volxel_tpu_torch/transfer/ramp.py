"""Color-ramp editing model (elements/colorramp.ts, DOM-free).

The reference's transfer-function editor is an SVG widget; its data model
— an ordered list of color stops with add / move / remove / recolor
operations emitting change events — is what the renderer consumes. This
class is that model: mutations keep stops ordered, clamp to [0, 1], and
notify listeners (which typically call Renderer.set_transfer_colors).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from volxel_tpu_torch.transfer.function import generate_transfer_function


class ColorRamp:
    def __init__(self, stops: list[dict] | None = None):
        self._stops = [dict(s) for s in stops] if stops else [
            {"color": [1.0, 1.0, 1.0, 0.0], "stop": 0.0},
            {"color": [1.0, 1.0, 1.0, 1.0], "stop": 1.0},
        ]
        self._sort()
        self._listeners: list[Callable[[list[dict]], None]] = []

    def _sort(self) -> None:
        self._stops.sort(key=lambda s: s["stop"])

    def _emit(self) -> None:
        for fn in self._listeners:
            fn(self.stops)

    def on_change(self, fn: Callable[[list[dict]], None]) -> None:
        self._listeners.append(fn)

    @property
    def stops(self) -> list[dict]:
        return [dict(s) for s in self._stops]

    def add_stop(self, position: float, color=None) -> int:
        """Insert a stop; color defaults to the ramp's value there."""
        position = float(np.clip(position, 0.0, 1.0))
        if color is None:
            color = self.sample(position).tolist()
        self._stops.append({"color": list(color), "stop": position})
        self._sort()
        self._emit()
        return next(
            i for i, s in enumerate(self._stops) if s["stop"] == position
        )

    def move_stop(self, index: int, position: float) -> None:
        self._stops[index]["stop"] = float(np.clip(position, 0.0, 1.0))
        self._sort()
        self._emit()

    def set_color(self, index: int, color) -> None:
        self._stops[index]["color"] = [float(c) for c in color]
        self._emit()

    def remove_stop(self, index: int) -> None:
        if len(self._stops) <= 1:
            raise ValueError("At least one color stop required")
        del self._stops[index]
        self._emit()

    def lut(self, steps: int = 128) -> np.ndarray:
        return generate_transfer_function(self._stops, steps)

    def sample(self, position: float) -> np.ndarray:
        """RGBA of the ramp at a position (for default insert colors)."""
        lut = self.lut()
        idx = int(np.clip(position * len(lut), 0, len(lut) - 1))
        return lut[idx]
