"""Multi-view batch rendering (BASELINE config 5's data-parallel axis): the
PyTorch counterpart of volxel_tpu.parallel.multiview.

Renders V camera views of the same scene in one dispatch. On one card the
V views' rays are stacked into one wavefront of V * n lanes and traced by
one trace_path, so each leg is one kernel launch for all views (what the
JAX package's vmap computes); on a mesh the views are split over 'sp' and
the pixels over 'px' (and over a third axis, as in parallel.shard). Each
view consumes a distinct RNG stream (sample index = frame * V + view,
seeded per lane), so batched results are bit-identical to rendering the
views one at a time.
"""

from __future__ import annotations

import torch

from volxel_tpu_torch.parallel.mesh import Mesh
from volxel_tpu_torch.parallel.shard import CardOperands, gather_rows, mesh_rows, operand_device, render_rows
from volxel_tpu_torch.render.pathtrace import RenderConfig, camera_ndc, render_rays
from volxel_tpu_torch.render.rays import Rays, camera_rays


def view_wavefront(config: RenderConfig, grid, params, lut, env, inv_views, inv_projs, light_dir, pixel_index,
                   views: range, n_views: int, frame_index: int):
    """Views `views` (rows of inv_views / inv_projs) over `pixel_index`
    as one wavefront -> (len(views), len(pixel_index), 3); view v renders
    sample frame_index * n_views + v."""
    n = pixel_index.shape[0]
    device = pixel_index.device
    lanes = pixel_index.repeat(len(views))
    samples = torch.tensor([frame_index * n_views + v for v in views], dtype=torch.int64, device=device)
    state, ndc = camera_ndc(config, lanes, samples.repeat_interleave(n))
    rays = [camera_rays(inv_views[v], inv_projs[v], ndc[i * n:(i + 1) * n]) for i, v in enumerate(views)]
    rays = Rays(torch.cat([r.origin for r in rays]), torch.cat([r.direction for r in rays]))
    return render_rays(config, grid, params, lut, env, light_dir, state, rays).reshape(len(views), n, 3)


def render_views(config: RenderConfig, grid, params, lut, env, inv_views, inv_projs, light_dir, frame_index):
    """V views on the operands' card in one wavefront -> (V, width*height, 3).

    inv_views, inv_projs: (V, 4, 4)."""
    n = config.width * config.height
    n_views = inv_views.shape[0]
    pixel_index = torch.arange(n, dtype=torch.int64, device=inv_views.device)
    return view_wavefront(config, grid, params, lut, env, inv_views, inv_projs, light_dir, pixel_index,
                          range(n_views), n_views, int(frame_index))


def sharded_multiview_fn(config: RenderConfig, mesh: Mesh, n_views: int):
    """Views split over 'sp', pixels over 'px' and, on a mesh with a third
    axis, each position's pixels over that axis too (parallel.shard): a
    function of (grid, params, lut, env, inv_views, inv_projs, light_dir,
    frame_index) -> (V, n, 3), on this process's first device of the mesh.
    Each position renders its views over its pixels as one wavefront. On a
    'vz' mesh the grid is replicated, as the JAX package's in_specs P()
    has it (a SlabbedVolume is read through each position's slab table)."""
    n = config.width * config.height
    sp, px = mesh.shape["sp"], mesh.shape["px"]
    if n_views % sp != 0 or n % px != 0:
        raise ValueError(f"views {n_views} must divide sp={sp}, pixels {n} must divide px={px}")
    mesh_rows(mesh)  # refuses a row across nodes whose processes own unequal parts of it
    local_n, local_v = n // px, n_views // sp
    cards = CardOperands()

    def render(grid, params, lut, env, inv_views, inv_projs, light_dir, frame_index):
        parts = render_rows(config, mesh, cards, (grid, params, lut, env, inv_views, inv_projs, light_dir),
                            local_n, lambda g, rest, pixels, s: view_wavefront(config, g, *rest, pixels,
                                                                               range(s * local_v, (s + 1) * local_v),
                                                                               n_views, int(frame_index)))
        first = operand_device(mesh, grid)
        blocks = gather_rows(mesh, parts, (local_v, local_n, 3), first)
        out = torch.empty((n_views, n, 3), dtype=torch.float32, device=first)
        for (s, p), block in blocks.items():
            out[s * local_v:(s + 1) * local_v, p * local_n:(p + 1) * local_n] = block
        return out

    return render
