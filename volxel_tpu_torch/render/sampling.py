"""Device-side brick-grid lookups and transfer-function sampling.

PyTorch counterpart of volxel_tpu.render.sampling (shaders/sampling/
common.glsl), cut to what the ported render modes run:

  * the brick atlas is decoded once to a dense (Z, Y, X) bfloat16 field on
    the device, so a voxel read is one gather (the JAX package's DeviceGrid
    docstring explains the trade);
  * every range-mip level is nearest-upsampled to the finest brick
    resolution and stacked into one (4, bz, by, bx) majorant pyramid, so
    the traced mip index is one more gather coordinate;
  * the transfer LUT is sampled NEAREST with sample-range rejection
    (common.glsl:78-83), one fused fetch on the card (render.gather); the
    legs of every mode fetch it inside their own kernels (render.ddaleg,
    render.trackleg, render.tilemarch);
  * out-of-extent voxel taps return 0.0 like GL texelFetch robust access;
  * a SlabGrid holds the field as z-slabs with SLAB_HALO-voxel halos, one
    slab per card of a mesh's slab axis (parallel.volshard): the two
    lookups below read a tap from the slab that owns it, and the legs'
    kernels read it through a table of the slabs' device pointers.

The JAX package's pair/quad/octo packings and MXU byte planes work around
serialized TPU gathers and are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from volxel_tpu_torch import kernels
from volxel_tpu_torch.grid.brick import BrickGrid
from volxel_tpu_torch.render import gather
from volxel_tpu_torch.render.rng import rng3, rng3_where


class DeviceGrid(NamedTuple):
    """Brick grid resident on the device."""

    dense: torch.Tensor  # (Z, Y, X) bfloat16 decoded density
    # all range-mip levels upsampled to finest brick resolution:
    maj_mips: torch.Tensor  # (4, bz, by, bx) float32 — level 0 = range_hi
    # (x, y, z) index extent, on the host: the legs' kernels take it as
    # arguments and the plain lookups clip to it, with no read-back (a host sync)
    extent: tuple[int, int, int]
    # premultiplied pyramid vol_maj * transfer_alpha(majorant), built per
    # render from the current transfer and settings
    # (modes.build_premul_majorant); the DDA march reads it directly
    maj_alpha: torch.Tensor | None = None  # (4, bz, by, bx) float32

    @property
    def field(self):
        """What the legs read the density from: the dense field."""
        return self.dense


SLAB_HALO = 2  # dilation half-width (brick.rs:101-103)


class SlabGrid:
    """A grid whose dense field lies in z-slabs, one per position of a
    mesh's slab axis (render-time volume slabs, parallel.volshard).

    Slab v holds global z slices [v * slab - SLAB_HALO, (v + 1) * slab +
    SLAB_HALO), zeros beyond the field, on its card; the majorant pyramids
    and the extent are the lanes' card's copies. A tap is answered by the
    slab that owns it: an integer tap by the owner of its z, a trilinear
    stencil by the owner of its clipped base z, whose halo holds the
    stencil's other taps (and every tap of the stochastic tricubic pick,
    offsets -1..+2). The plain lookups gather on each slab's card and bring
    the values to the lanes' card; the legs' kernels load through the table
    of the slabs' device pointers on the lanes' card (`table`), a peer load
    where a slab lies on another card. The renders are bit-equal to those
    of the whole field.

    A peer load goes around torch, so `ready` holds an event recorded on
    each CUDA slab's card after the slab was written (slabs_written), and
    `table` orders the reading card's stream after it.

    A slab held on another node (a row across nodes) is None here and its
    pointer in `table` is 0: nothing on this process can load it. The legs
    park a lane before they ask for such a slab and parallel.migrate moves
    the lane to the process that owns it; `row` is that row's exchange
    (parallel.migrate.Row), None where every slab is readable. A lookup
    here that reaches an absent slab raises.

    tap_dtype "bfloat16" rounds each owner's value (the unscaled trilinear
    sum; an integer tap is a bf16 value already) to bf16, which is what the
    JAX package's bf16 all-reduce of one owner's value and zeros gives.

    A plain class, not a NamedTuple, so that moving a mesh step's operands
    to a card (parallel.shard.to_device) leaves the slabs where they are.
    """

    def __init__(self, slabs, slab: int, maj_mips, extent, tap_dtype: str = "float32", maj_alpha=None,
                 tables: dict | None = None, ready=None, row=None):
        if tap_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"tap_dtype must be 'float32' or 'bfloat16', got {tap_dtype!r}")
        self.slabs = tuple(slabs)  # vz (slab + 2 * SLAB_HALO, Y, X) bf16, each on its card (None: another node's)
        self.ready = slabs_written(self.slabs) if ready is None else tuple(ready)
        self.slab = int(slab)  # z slices each slab owns
        self.maj_mips = maj_mips
        self.maj_alpha = maj_alpha
        self.extent = tuple(int(v) for v in extent)
        self.tap_dtype = tap_dtype
        self._tables = {} if tables is None else tables  # device -> the slabs' pointer table there
        self.row = row

    @property
    def field(self) -> "SlabGrid":
        """What the legs read the density from: the slabs."""
        return self

    def _replace(self, **changes) -> "SlabGrid":
        kw = {"slabs": self.slabs, "slab": self.slab, "maj_mips": self.maj_mips, "extent": self.extent,
              "tap_dtype": self.tap_dtype, "maj_alpha": self.maj_alpha, "row": self.row, **changes}
        if "slabs" in changes:  # the tables and events are the old slabs'
            return SlabGrid(**kw)
        return SlabGrid(**kw, tables=self._tables, ready=self.ready)

    def table(self, device: torch.device) -> torch.Tensor:
        """The slabs' device pointers as an int64 tensor on CUDA `device`,
        made once, with `device`'s peer access to each slab's card enabled
        (kernels.enable_peer_access, which raises where it cannot be).

        Each call orders `device`'s current stream, which the launch that
        reads through the table runs on, after each slab's writes (`ready`),
        and ties each slab's memory to that stream (record_stream): a card's
        caching allocator orders a freed block only after its own stream, so
        without this a dropped slab could be reused under another card's
        reads."""
        device = torch.device(device)
        reader = torch.cuda.current_stream(device)
        held = [(s, written) for s, written in zip(self.slabs, self.ready) if s is not None]
        for s, written in held:
            reader.wait_event(written)
            s.record_stream(reader)
        if device not in self._tables:
            for s, _ in held:
                kernels.enable_peer_access(device, s.device)
            ptrs = torch.tensor([0 if s is None else s.data_ptr() for s in self.slabs], dtype=torch.int64)
            self._tables[device] = ptrs.to(device)
        return self._tables[device]

    def absent(self, device) -> torch.Tensor:
        """(vz,) bool on `device`: which slabs lie on another node."""
        return torch.tensor([s is None for s in self.slabs], dtype=torch.bool, device=device)


def slabs_written(slabs) -> tuple:
    """An event recorded on each CUDA slab's card's current stream, after
    whatever wrote the slab there (None for a CPU slab or an absent one)."""
    events = []
    for s in slabs:
        event = None
        if s is not None and s.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(s.device))
        events.append(event)
    return tuple(events)


def field_grid(field, extent):
    """A grid to look densities up in, from what a leg reads: `field` as it
    is when it is a SlabGrid, else a DeviceGrid of the dense field."""
    return field if isinstance(field, SlabGrid) else DeviceGrid(dense=field, maj_mips=None, extent=tuple(extent))


class VolumeParams(NamedTuple):
    """Per-frame volume uniforms (viewer.ts bindUniforms, :1295-1357)."""

    aabb_lo: torch.Tensor  # (3,) world-space clipped AABB
    aabb_hi: torch.Tensor  # (3,)
    transform_inv: torch.Tensor  # (4, 4) world -> index
    vol_min: torch.Tensor  # scalar: minorant * density_scale * multiplier
    vol_maj: torch.Tensor  # scalar majorant (same scaling)
    inv_maj: torch.Tensor  # 1 / vol_maj
    density_scale: torch.Tensor  # density_scale * multiplier
    albedo: torch.Tensor  # (3,) — 0.9 constant in the reference
    phase_g: torch.Tensor  # scalar — 0 in the reference
    sample_range: torch.Tensor  # (2,)


def _upsample_nearest(arr: np.ndarray, factor: int) -> np.ndarray:
    return np.repeat(np.repeat(np.repeat(arr, factor, 0), factor, 1), factor, 2)


def _decode_bricks(voxels, range_lo, range_hi) -> torch.Tensor:
    """(bz * by * bx, 8, 8, 8) u8 brick voxels and their (bz, by, bx)
    ranges -> the (bz * 8, by * 8, bx * 8) bf16 field, in
    decode_dense_device's op order."""
    bz, by, bx = range_lo.shape
    occupied = (range_lo != range_hi).reshape(-1)
    lo = range_lo.reshape(-1, 1, 1, 1)
    hi = range_hi.reshape(-1, 1, 1, 1)
    voxels = torch.where(occupied[:, None, None, None], voxels.to(torch.float32), 0.0)
    decoded = lo + voxels * np.float32(1.0 / 255.0).item() * (hi - lo)
    dense = decoded.reshape(bz, by, bx, 8, 8, 8).permute(0, 3, 1, 4, 2, 5).reshape(bz * 8, by * 8, bx * 8)
    return dense.to(torch.bfloat16)


def decode_dense_device(atlas, range_lo, range_hi, ptr) -> torch.Tensor:
    """Decode the brick atlas to the dense bf16 field on the atlas's device.

    Same f32 op sequence as the JAX package's host `decode_dense` (scale by
    1/255, by the range, add the minimum; eager ops never fuse), rounded to
    bf16 at the end, so the field is bit-equal to
    decode_dense(...).astype(bf16) and to the JAX package's device decode.
    """
    bz, by, bx = range_lo.shape
    az_b = atlas.shape[0] // 8 if atlas.shape[0] else 0
    if az_b == 0:
        return torch.zeros((bz * 8, by * 8, bx * 8), dtype=torch.bfloat16, device=atlas.device)
    atlas_bricks = (
        atlas.reshape(az_b, 8, by, 8, bx, 8).permute(0, 2, 4, 1, 3, 5).reshape(az_b * by * bx, 8, 8, 8)
    )
    p = ptr.reshape(-1, 3).to(torch.int64)
    slot = p[:, 2] * (by * bx) + p[:, 1] * bx + p[:, 0]
    return _decode_bricks(atlas_bricks[torch.clamp_max(slot, az_b * by * bx - 1)], range_lo, range_hi)


def decode_dense_rows_device(grid: BrickGrid, b0: int, b1: int, device) -> torch.Tensor:
    """Brick z-rows [b0, b1) of the dense bf16 field, decoded on `device`:
    bit-equal to decode_dense_device(...)[b0 * 8 : b1 * 8]. Only the rows'
    atlas bricks, gathered on the host, and their ranges are uploaded."""
    bx, by, bz = grid.brick_count
    if b1 <= b0:
        return torch.zeros((0, by * 8, bx * 8), dtype=torch.bfloat16, device=device)
    lo = torch.from_numpy(np.ascontiguousarray(grid.range_lo[b0:b1])).to(device)
    hi = torch.from_numpy(np.ascontiguousarray(grid.range_hi[b0:b1])).to(device)
    az_b = grid.atlas.shape[0] // 8 if grid.atlas.shape[0] else 0
    if az_b == 0:
        return torch.zeros(((b1 - b0) * 8, by * 8, bx * 8), dtype=torch.bfloat16, device=device)
    ptr = grid.indirection[b0:b1].reshape(-1, 3).astype(np.int64)
    slot = np.minimum(ptr[:, 2] * (by * bx) + ptr[:, 1] * bx + ptr[:, 0], az_b * by * bx - 1)
    sz, rest = np.divmod(slot, by * bx)
    sy, sx = np.divmod(rest, bx)
    raw = grid.atlas.reshape(az_b, 8, by, 8, bx, 8)[sz, :, sy, :, sx, :]  # (bricks, 8, 8, 8)
    return _decode_bricks(torch.from_numpy(np.ascontiguousarray(raw)).to(device), lo, hi)


def build_majorant_pyramid(grid: BrickGrid) -> np.ndarray:
    """Stacked (NUM_MIPS+1, bz, by, bx) f32 majorant pyramid — every
    range-mip level nearest-upsampled to finest brick resolution."""
    mips = [grid.range_hi]
    for level, (_, hi) in enumerate(grid.range_mips):
        mips.append(_upsample_nearest(hi, 1 << (level + 1)))
    return np.stack(mips, axis=0).astype(np.float32)


def device_grid_from_brick(grid: BrickGrid, device) -> DeviceGrid:
    """Upload a BrickGrid and decode its dense field on `device`."""
    dense = decode_dense_device(
        torch.from_numpy(np.ascontiguousarray(grid.atlas)).to(device),
        torch.from_numpy(np.ascontiguousarray(grid.range_lo)).to(device),
        torch.from_numpy(np.ascontiguousarray(grid.range_hi)).to(device),
        torch.from_numpy(np.ascontiguousarray(grid.indirection)).to(device),
    )
    return DeviceGrid(
        dense=dense,
        maj_mips=torch.from_numpy(build_majorant_pyramid(grid)).to(device),
        extent=tuple(int(v) for v in grid.index_extent),
    )


def _transform(m, p, translate: bool):
    """Rows 0..2 of the (4, 4) matrix m applied to points/directions (..., 3),
    written out elementwise (see render.rays)."""
    cols = []
    for j in range(3):
        c = p[..., 0] * m[j, 0] + p[..., 1] * m[j, 1] + p[..., 2] * m[j, 2]
        cols.append(c + m[j, 3] if translate else c)
    return torch.stack(cols, dim=-1)


def world_to_index_point(params: VolumeParams, p):
    return _transform(params.transform_inv, p, True)


def world_to_index_dir(params: VolumeParams, d):
    return _transform(params.transform_inv, d, False)


# -- raw voxel lookups ---------------------------------------------------------


def _clip_to_extent(grid: DeviceGrid, ip):
    """Integer coords (..., 3) clipped to [0, extent - 1] on each axis."""
    return torch.stack([ip[..., k].clamp(0, e - 1) for k, e in enumerate(grid.extent)], dim=-1)


def lookup_density_brick_int(grid, iipos, owner=None):
    """Decoded density at integer voxel coords (common.glsl:36-43), read
    from the dense field or, on a SlabGrid, from the slab that owns the
    tap's z (the JAX package's _slab_density_int) or, with `owner` (...,),
    from that slab, whose halo holds the tap (the slab of a tricubic pick's
    base cell, as the legs' kernels read it). iipos: (..., 3) integer
    (x, y, z). OOB taps return 0.0."""
    ip = _clip_to_extent(grid, iipos)
    inside = (ip == iipos).all(dim=-1)
    ip = ip.to(torch.int64)
    if isinstance(grid, SlabGrid):
        value = _slab_taps(grid, ip, ip[..., 2] // grid.slab if owner is None else owner)
    else:
        _, ny, nx = grid.dense.shape
        flat = (ip[..., 2] * ny + ip[..., 1]) * nx + ip[..., 0]
        value = grid.dense.reshape(-1)[flat].to(torch.float32)
    return torch.where(inside, value, 0.0)


def parked_owner(grid: SlabGrid, z):
    """The slab a leg's lookup at index-space z reads, where it lies on
    another node, else -1 (int64, z's shape): the owner of the clipped
    base z floor(z - 0.5) of the trilinear stencil or the tricubic pick.
    A lane parks there before it reads (parallel.migrate)."""
    owner = slab_owner(grid, z)
    return torch.where(grid.absent(z.device)[owner], owner, -1)


def slab_owner(grid: SlabGrid, z):
    """The slab that owns the clipped base z floor(z - 0.5) of a lookup at
    index-space z (int64, z's shape)."""
    return torch.floor(z - 0.5).to(torch.int64).clamp(0, grid.extent[2] - 1) // grid.slab


def _slab_taps(grid: SlabGrid, ip, owner):
    """The f32 values at the clipped int64 coords `ip` (..., 3), each read
    from slab `owner` (broadcast to ip's (...,)) at local z
    ip_z - owner * slab + SLAB_HALO: each slab gathers the taps it owns on
    its own card, and they are put in place on the lanes' card."""
    owner = owner.expand(ip.shape[:-1]).reshape(-1)
    lz = ip[..., 2].reshape(-1) - owner * grid.slab + SLAB_HALO
    iy, ix = ip[..., 1].reshape(-1), ip[..., 0].reshape(-1)
    value = torch.empty(owner.shape, dtype=torch.float32, device=ip.device)
    for v, slab in enumerate(grid.slabs):
        mine = torch.nonzero(owner == v).squeeze(1)
        if slab is None:
            if mine.numel():
                raise ValueError(f"{mine.numel()} taps of slab {v}, which lies on another node: a leg parks such "
                                 "lanes (parallel.migrate), a lookup asks the slab's owner")
            continue
        _, ny, nx = slab.shape
        flat = (lz[mine] * ny + iy[mine]) * nx + ix[mine]
        value[mine] = slab.reshape(-1)[flat.to(slab.device)].to(ip.device).to(torch.float32)
    return value.reshape(ip.shape[:-1])


def _majorant_coords(grid: DeviceGrid, ipos):
    """Brick coordinates of a majorant tap: floor -> clip to the extent ->
    brick index."""
    ip = _clip_to_extent(grid, torch.floor(ipos).to(torch.int32))
    return ip[..., 0] >> 3, ip[..., 1] >> 3, ip[..., 2] >> 3


def lookup_majorant_premul(grid: DeviceGrid, ipos, mip):
    """Fully-scaled DDA step majorant from the premultiplied pyramid
    (grid.maj_alpha) at a traced mip level in [0, 3]."""
    bxc, byc, bzc = _majorant_coords(grid, ipos)
    _, bz, by, bx = grid.maj_alpha.shape
    flat = ((mip.to(torch.int64) * bz + bzc) * by + byc) * bx + bxc
    return grid.maj_alpha.reshape(-1)[flat]


# the 8 stencil taps in the JAX package's order (dz outer, dx inner)
_TAPS = tuple((dx, dy, dz) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1))
_TAP_OFFSETS: dict = {}  # _TAPS as an (8, 3) int64 tensor, per device


def _tap_offsets(device) -> torch.Tensor:
    offsets = _TAP_OFFSETS.get(device)
    if offsets is None:
        offsets = _TAP_OFFSETS[device] = torch.tensor(_TAPS, dtype=torch.int64, device=device)
    return offsets


def lookup_density_trilinear(grid: DeviceGrid, params: VolumeParams, ipos):
    """Trilinear filtered scaled density (common.glsl:61-69):
    density_scale * trilinear_sum."""
    return params.density_scale * trilinear_sum(grid, ipos)


def trilinear_sum(grid, ipos):
    """The unscaled trilinear sum of the dense field at index-space points.

    The 8 taps are fetched in one gather; each weight is
    ((wx * wy) * wz) and the weighted taps are summed one after another in
    the tap order of the JAX package's _trilinear_acc, so every value is
    rounded as there. On a SlabGrid the owner of the clipped base z reads
    all eight taps from its slab (the JAX package's
    _slab_density_trilinear), and with tap_dtype "bfloat16" the sum is
    rounded to bf16."""
    p = ipos - 0.5
    base = torch.floor(p).to(torch.int64)
    f = p - base.to(torch.float32)
    offsets = _tap_offsets(ipos.device)
    iipos = base[..., None, :] + offsets  # (..., 8, 3)
    if isinstance(grid, SlabGrid):
        ip = _clip_to_extent(grid, iipos)
        owner = base[..., 2].clamp(0, grid.extent[2] - 1) // grid.slab
        taps = torch.where((ip == iipos).all(dim=-1), _slab_taps(grid, ip, owner[..., None]), 0.0)
    else:
        taps = lookup_density_brick_int(grid, iipos)  # (..., 8)
    w1 = torch.stack([1 - f, f], dim=-1)  # (..., 3 axes, 2): weight of offset 0 / 1
    idx = offsets.T  # (3, 8)
    w = (w1[..., 0, idx[0]] * w1[..., 1, idx[1]]) * w1[..., 2, idx[2]]
    terms = taps * w
    acc = terms[..., 0]
    for k in range(1, len(_TAPS)):
        acc = acc + terms[..., k]
    if isinstance(grid, SlabGrid) and grid.tap_dtype == "bfloat16":
        acc = acc.to(torch.bfloat16).to(torch.float32)
    return acc


def stochastic_tricubic_offsets(ipos, state, mask=None):
    """Weighted-reservoir tricubic tap selection (common.glsl:9-32).

    Returns (state, iipos (..., 3) int32), the chosen tap. Each of taps 1..3
    takes one rng3 draw (x, y, z) and replaces the pick where
    r < w / max(1e-3, sum_w); with `mask`, lanes where it is False consume
    none of the nine draws. The weights follow the JAX package's op order
    term for term (tilemarch.cu repeats it)."""
    p = ipos - 0.5
    iipos = torch.floor(p).to(torch.int32)
    t = p - iipos.to(torch.float32)
    t2 = t * t
    t3 = t * t2
    sixth = 1.0 / 6.0
    w0 = sixth * (-t3 + 3.0 * t2 - 3.0 * t + 1.0)
    w1 = sixth * (3.0 * t3 - 6.0 * t2 + 4.0)
    w2 = sixth * (-3.0 * t3 + 3.0 * t2 + 3.0 * t + 1.0)
    w3 = sixth * t3
    sum_w = w0
    idx = torch.zeros_like(iipos)
    for tap, w in ((1, w1), (2, w2), (3, w3)):
        sum_w = sum_w + w
        state, r = rng3(state) if mask is None else rng3_where(mask, state)
        take = r < w / torch.clamp_min(sum_w, 1e-3)
        idx = torch.where(take, tap, idx)
    return state, iipos + idx - 1


# -- transfer function ---------------------------------------------------------


def lookup_transfer(lut: torch.Tensor, sample_range, density):
    """NEAREST LUT sample with range rejection (common.glsl:78-83).

    lut: (K, 4). density: (...,) normalized by the majorant. Returns (..., 4).
    On the card one launch of the fused fetch (render.gather, kernel 2).
    """
    return gather.lookup_transfer_fetch(lut, sample_range, density)
