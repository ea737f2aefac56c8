"""DistributedRenderer: the Renderer facade over a mesh, the PyTorch
counterpart of volxel_tpu.parallel.distributed.

Same public API as api.renderer.Renderer, but each progressive step runs
sample-parallel x pixel-parallel over the mesh (parallel/shard.py) and
advances `sp` samples at once. Convergence matches the single-card
renderer (RNG keyed by global pixel + sample index); the accumulator
update accounts for the sp-sample stride. Everything else (image() and
its tonemap, the error state, settings, checkpoints) is the Renderer's, on
the renderer's device, which defaults to this process's first device of
the mesh. With vz > 1 the volume's dense field lies in z-slabs over the
mesh's 'vz' axis (parallel/volshard.py), for volumes beyond one card's
memory; the frames stay bit-equal to the replicated field's, and the
shear-warp previews, which need the whole field, raise.

The mesh's positions may be one process's cards (one process a host) or
lie on several processes, e.g. one process a card on a node under
`torchrun --nproc-per-node=N` with an explicit mesh of (rank, card)
positions (`make_mesh(vz=N, devices=[(rank, f"cuda:{rank}") for rank in
range(N)])`); a 'vz' row may span the processes of one node, whose
slabs are then shared between them (parallel/nodeshare.py), or span
nodes, whose slabs stay on their own node while the legs' lanes move to
them (parallel/migrate.py; the row's process groups are made with the
slabs, once for each set of processes, and kept for later loads and
timestep swaps). Every process calls the same methods in the same order
(each step, load and timestep swap is collective), and close() before it
drops a renderer whose slabs are shared.
"""

from __future__ import annotations

import numpy as np
import torch

from volxel_tpu_torch.api.renderer import Renderer
from volxel_tpu_torch.parallel.mesh import make_mesh
from volxel_tpu_torch.parallel.shard import CardOperands, render_sample_sharded
from volxel_tpu_torch.parallel.volshard import build_slabbed_volume, build_slabbed_volume_from_brick


class DistributedRenderer(Renderer):
    """vz > 1 shards the volume's dense field into halo'd z-slabs over the
    mesh's 'vz' axis (parallel/volshard.py); `vz_tap_dtype` "bfloat16"
    rounds each trilinear sum to bf16 there (render.sampling.SlabGrid)."""

    def __init__(self, *args, mesh=None, sp: int = 1, px: int | None = None, vz: int = 1,
                 vz_tap_dtype: str = "float32", **kwargs):
        if vz_tap_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"vz_tap_dtype must be 'float32' or 'bfloat16', got {vz_tap_dtype!r}")
        self.mesh = mesh if mesh is not None else make_mesh(sp=sp, px=px, vz=vz)
        local = self.mesh.local_devices()
        if local:
            kwargs.setdefault("device", local[0])
        super().__init__(*args, **kwargs)
        self.sp = self.mesh.shape["sp"]
        self.vz = self.mesh.shape.get("vz", 1)
        self.vz_tap_dtype = vz_tap_dtype
        self._slabbed = None  # the SlabbedVolume of a vz > 1 mesh
        self._slab_source = None  # the grid object it was built from
        self._cached_operands = None
        self._cards = CardOperands()  # the operands' copies on the mesh's cards

    def _upload_grid(self, grid):
        """On a vz mesh (restart_from_grid) the dense field goes straight
        from the host brick grid to the cards' z-slabs
        (build_slabbed_volume_from_brick), never whole on one card or on
        the host; the renderer's device grid is then the slabs' metadata,
        without a dense field."""
        if self.vz == 1:
            return super()._upload_grid(grid)
        self._drop_slabs()
        self._slabbed = build_slabbed_volume_from_brick(grid, self.mesh, tap_dtype=self.vz_tap_dtype)
        self._slab_source = self._slabbed.meta
        return self._slabbed.meta

    def _render_grid(self):
        """The grid operand of a step: the device grid, or on a vz mesh its
        slabs, built again from the device grid when it is another object
        (a time series' timestep swap puts a whole field there)."""
        if self.vz == 1:
            return self._device_grid
        if self._slabbed is None or self._slab_source is not self._device_grid:
            self._drop_slabs()
            self._slabbed = build_slabbed_volume(self._device_grid, self.mesh, tap_dtype=self.vz_tap_dtype)
            self._slab_source = self._device_grid
        return self._slabbed

    def _drop_slabs(self) -> None:
        """Release the slabs (collective where they are shared between
        processes: SlabbedVolume.release) and what holds them."""
        if self._slabbed is not None:
            self._cached_operands = None
            self._slabbed.release()
            self._slabbed = None

    def close(self) -> None:
        """Release the volume's slabs; every process of the mesh calls it
        before it drops a renderer whose slabs are shared (a no-op
        otherwise, and safe to call twice)."""
        self._drop_slabs()

    def restart_rendering(self) -> None:
        """Any visual-state change flows through here, so the cached
        operands (and their copies on the mesh's cards) are dropped exactly
        when they can change."""
        super().restart_rendering()
        self._cached_operands = None
        self._cards = CardOperands()

    def _prime_operands(self, config):
        """(config, grid, params, lut, env, inv_view, inv_proj, light_dir),
        built once per state change (or a new config), not per step."""
        if self._cached_operands is None or self._cached_operands[0] != config:
            inv_view, inv_proj, light_dir = self._camera_operands(config)
            self._cached_operands = (config, self._render_grid(), self.volume_params(), self._lut,
                                     self.environment.state, inv_view, inv_proj, light_dir)
        return self._cached_operands

    def render_frame(self) -> torch.Tensor:
        """One sharded step = `sp` progressive samples, mean-combined.

        All samples accumulate uniformly from index 0, with no warm-up
        weighting and no low-res preview (the reference's zero-weight
        warm-up is a display nicety for its low-res preview frames; every
        sample is an iid estimator, so including indices 0..4 changes
        nothing statistically).
        """
        if self._device_grid is None:
            raise RuntimeError("No volume loaded")
        if self.errored:
            raise RuntimeError("Renderer is in an error state (clear_error() to resume)") from self.last_error
        if self.suspend:
            return self._framebuffer
        config = self._config()
        n = config.width * config.height
        if self._framebuffer.shape[0] != n:
            self._framebuffer = torch.zeros((n, 3), dtype=torch.float32, device=self.device)
        config, *operands = self._prime_operands(config)
        # the sharded call renders samples [f*sp, f*sp + sp) for step f
        step = self.frame_index
        mean_sp = render_sample_sharded(config, self.mesh, *operands, step, cards=self._cards).to(self.device)
        count = step * self.sp
        self._framebuffer = (count * self._framebuffer + self.sp * mean_sp) / (count + self.sp)
        self.frame_index += 1
        return self._framebuffer

    def samples_rendered(self) -> int:
        return self.frame_index * self.sp

    def render(self, samples: int | None = None) -> np.ndarray:
        """Progressive render on the mesh (in place of the single-card
        path: each step already advances sp samples)."""
        total = samples if samples is not None else self.settings.max_samples
        for _ in range(-(-total // self.sp)):
            self.render_frame()
        return self.image()
