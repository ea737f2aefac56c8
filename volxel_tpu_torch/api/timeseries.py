"""4D time-series CT playback (BASELINE config 5): the PyTorch counterpart
of volxel_tpu.api.timeseries.

Plays a (T, Z, Y, X) series through a Renderer: each timestep's brick grid
is built on the host (native C++ when available) and uploaded to the
renderer's device once and kept (until `evict`): showing step t also
uploads step t+1, so that step t+1 is shown without an upload.
"""

from __future__ import annotations

import numpy as np

from volxel_tpu_torch.grid.brick import BrickGrid, construct_brick_grid
from volxel_tpu_torch.render.sampling import device_grid_from_brick


class TimeSeriesPlayer:
    def __init__(self, renderer, volumes: "np.ndarray | list[BrickGrid]"):
        """volumes: (T, Z, Y, X) float32 densities, or prebuilt BrickGrids."""
        self.renderer = renderer
        if isinstance(volumes, np.ndarray):
            if volumes.ndim != 4:
                raise ValueError("expected a (T, Z, Y, X) volume stack")
            self.grids = [construct_brick_grid(volumes[t]) for t in range(len(volumes))]
        else:
            self.grids = list(volumes)
        if not self.grids:
            raise ValueError("empty time series")
        self._device_cache: dict[int, object] = {}

    @classmethod
    def from_zips(cls, renderer, zip_sources: list) -> "TimeSeriesPlayer":
        """One DICOM ZIP per timestep (4D CT as commonly exported)."""
        from volxel_tpu_torch.ingest.ziploader import read_zip_to_grid

        grids = [read_zip_to_grid(z) for z in zip_sources]
        return cls(renderer, grids)

    def __len__(self) -> int:
        return len(self.grids)

    def _device_grid(self, t: int):
        if t not in self._device_cache:
            self._device_cache[t] = device_grid_from_brick(self.grids[t], self.renderer.device)
        return self._device_cache[t]

    def set_timestep(self, t: int) -> None:
        """Swap the renderer to timestep t, prefetching t+1's upload."""
        r = self.renderer
        r.grid = self.grids[t]
        # keep the existing volume transform/clip; only the density changes
        if r.volume is None:
            r.restart_from_grid(self.grids[t])
        r._device_grid = self._device_grid(t)
        # prefetch the next timestep's upload
        if t + 1 < len(self.grids):
            self._device_grid(t + 1)
        r.restart_rendering()

    def play(self, samples_per_step: int = 8, steps: "list[int] | None" = None):
        """Render each timestep; yields (t, tonemapped image)."""
        for t in steps if steps is not None else range(len(self.grids)):
            self.set_timestep(t)
            for _ in range(samples_per_step):
                self.renderer.render_frame()
            yield t, self.renderer.image()

    def evict(self, t: int) -> None:
        """Free a timestep's device buffers (bounded-memory playback)."""
        self._device_cache.pop(t, None)
