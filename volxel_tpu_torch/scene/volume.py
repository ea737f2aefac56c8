"""Volume placement: index->world transforms, AABBs, clip boxes.

Parity with representation/volume.ts plus the viewer's unit-cube rescale
(viewer.ts:1086-1099): after load, the volume is re-centered at the origin
and uniformly scaled so its longest side is 1, and the density scale
absorbs the size factor.
"""

from __future__ import annotations

import numpy as np

from volxel_tpu_torch.utils.mathutil import scale_matrix, transform_point, translate_matrix


class Volume:
    def __init__(self, index_extent, grid_transform, min_maj=(0.0, 1.0)):
        self.index_extent = np.asarray(index_extent, dtype=np.float32)  # (x, y, z)
        self.grid_transform = np.asarray(grid_transform, dtype=np.float32)
        self.transform = np.eye(4, dtype=np.float32)  # user/world transform
        self.min_maj = (float(min_maj[0]), float(min_maj[1]))

    @classmethod
    def from_grid(cls, grid):
        return cls(grid.index_extent, grid.transform, grid.min_maj)

    def combined_transform(self) -> np.ndarray:
        """volume.ts:14-16 — world = transform @ grid_transform @ index."""
        return (self.transform @ self.grid_transform).astype(np.float32)

    def to_world(self, index_pos) -> np.ndarray:
        return transform_point(self.combined_transform(), index_pos)

    def to_index(self, world_pos) -> np.ndarray:
        return transform_point(np.linalg.inv(self.combined_transform()), world_pos)

    def aabb(self) -> tuple[np.ndarray, np.ndarray]:
        """volume.ts:25-31 — world AABB from index origin/extent corners."""
        lo = self.to_world([0.0, 0.0, 0.0])
        hi = self.to_world(self.index_extent)
        return lo, hi

    def aabb_clipped(self, clip_min, clip_max) -> tuple[np.ndarray, np.ndarray]:
        """volume.ts:32-37 — lerp normalized clip bounds inside the AABB."""
        lo, hi = self.aabb()
        clip_min = np.asarray(clip_min, dtype=np.float32)
        clip_max = np.asarray(clip_max, dtype=np.float32)
        return lo + (hi - lo) * clip_min, lo + (hi - lo) * clip_max

    def set_transform(self, m) -> None:
        self.transform = np.asarray(m, dtype=np.float32)

    def rescale_to_unit_cube(self) -> float:
        """viewer.ts:1088-1099 — center at origin, longest side -> 1.

        Returns the density-scale factor the caller must multiply in
        (the reference multiplies densityScale by the original size).
        """
        lo, hi = self.aabb()
        extent = hi - lo
        size = float(np.max(extent))
        if size == 1.0:
            return 1.0
        m = scale_matrix((1.0 / size, 1.0 / size, 1.0 / size)) @ translate_matrix(
            -lo - extent * 0.5
        )
        self.set_transform(m)
        return size
