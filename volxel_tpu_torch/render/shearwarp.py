"""Shear-warp direct volume rendering: the deterministic preview.

Counterpart of volxel_tpu.render.shearwarp. The Lacroute-Levoy
factorisation of a parallel projection along the principal view axis:

  1. choose the principal axis k = argmax |view dir| and permute the
     (Z, Y, X) volume so it comes first, flipped when the view runs -k
     (host: `shear_parameters`);
  2. per slice z: classify the density through the NEAREST transfer LUT,
     place the slice at (sy * z + ty, sx * z + tx) bilinearly and
     composite front to back, C += T * alpha' * rgb, T *= 1 - alpha',
     alpha' = 1 - exp(-sigma dt) (`shearwarp_intermediate`: kernel 7,
     csrc/shearwarp.cu, on the card);
  3. warp the intermediate image to the screen through the homography of
     its reference plane (host matrix, then a bilinear resample on the
     device), composite over the background and tonemap (kernel 4).

Two canvases, each with its own rule for the size and the shift origin,
carried over exactly because they round differently:

  * static (`render_dvr`): out_h = y_n + ceil(|sy| (z_n - 1)) + 1, with
    tx, ty computed as Python floats and rounded to f32;
  * fixed (`render_preview`, the interactive path): out_h = y_n + z_n for
    every view (|s| <= 1), with tx, ty computed in f32 from the f32 sx, sy.

The bilinear placement is the Pallas kernel's 4-tap form (frac_block), not
the XLA scan's separable one; the two differ at the ulp level. A tap
outside the slice contributes nothing (the JAX kernel pads after
classifying). The JAX versions' early out (skip the remaining slices once
max(t) <= 1e-4 over the canvas) is not carried over: the canvas's last row
is only ever reached by a slice whose shift sits at the clip's upper bound,
an integer, so it receives taps weighted by fy = 0 alone, keeps t = 1, and
the test never passes (tests/test_torch_shearwarp.py pins this). The TPU's
(8, 128) canvas padding and its mask are not carried over either.

Dispatch is on the volume's device: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel (or raises). There is no fallback.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from volxel_tpu_torch import kernels
from volxel_tpu_torch.render.pallas_ops import tonemap_display

BACKGROUND = (0.04, 0.04, 0.05)  # the preview's dark grey (warp_to_screen's default)

# layout of the (6,) f32 scalars the kernel reads, as the JAX kernel's params
P_SX, P_SY, P_TX, P_TY, P_INV_MAJ, P_SIGMA_DT = range(6)

# the kernel stages the LUT in shared memory (48 KiB at this size; the
# kernel opts in to more than 48 KiB of dynamic shared memory)
MAX_LUT_ROWS = 3072


def upload(array, device) -> torch.Tensor:
    """A small host array as f32 on `device`. To a card it goes through
    pinned memory without waiting: a plain copy from pageable memory
    would make the host wait for the work queued before it."""
    host = torch.from_numpy(np.array(array, dtype=np.float32))
    if torch.device(device).type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


# -- host math (numpy copies of the JAX package's) -----------------------------


def shear_parameters(view_dir: np.ndarray):
    """Principal axis + per-slice shear for a parallel projection.

    Returns (perm, flip, sx, sy): permute the (Z, Y, X) volume by `perm`
    so the principal axis is Z, flip slice order if the view runs -z,
    then slice z is translated by (sx*z, sy*z) in (y, x).
    """
    d = np.asarray(view_dir, np.float64)
    k = int(np.argmax(np.abs(d)))  # 0=x, 1=y, 2=z in (x, y, z) order
    # permutation of (Z, Y, X) axes putting principal axis first
    perms = {
        2: (0, 1, 2),  # z principal: (Z, Y, X)
        1: (1, 0, 2),  # y principal: (Y, Z, X)
        0: (2, 1, 0),  # x principal: (X, Y, Z)
    }
    perm = perms[k]
    # sx shifts slice COLUMNS, sy slice ROWS: an x-principal slice is
    # (rows=worldY, cols=worldZ), y-principal (rows=worldZ, cols=worldX),
    # z-principal (rows=worldY, cols=worldX)
    axes_xyz = {2: (0, 1), 1: (0, 2), 0: (2, 1)}[k]
    dz = d[k]
    flip = dz < 0
    # a ray's (row, col) drift per slice is d_rc/|d_p| with or without the
    # flip: reversing the slice order also reverses the traversal
    s = -d[list(axes_xyz)] / abs(dz)
    sx, sy = float(s[0]), float(s[1])
    return perm, bool(flip), sx, sy


def _homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3x3 projective transform mapping 4 src (x, y) points onto dst."""
    a = []
    b = []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        b.append(u)
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.append(v)
    h = np.linalg.solve(np.asarray(a, np.float64), np.asarray(b, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def _plane_homography(perm, flip, sx, sy, vol_shape, out_h: int, out_w: int, combined_transform, view, proj,
                      width: int, height: int, occupied_mid) -> np.ndarray:
    """Screen pixel -> intermediate (c, r) homography of the reference plane
    at the occupied region's mid slice (the principal axis's mid when
    `occupied_mid` is None): its 4 corners pushed through index -> world
    -> clip -> pixel. Float64, as in the JAX package."""
    dims = np.array(vol_shape, np.int64)  # (Z, Y, X) of the ORIGINAL field
    pdims = dims[list(perm)]  # permuted (z', rows, cols)
    z_n = int(pdims[0])
    ty = max(0.0, -sy * (z_n - 1))
    tx = max(0.0, -sx * (z_n - 1))
    if occupied_mid is not None:
        mid_p = np.asarray(occupied_mid, np.float64)[list(perm)]
        zm = float(mid_p[0])
        if flip:
            zm = (z_n - 1) - zm
    else:
        zm = 0.5 * (z_n - 1)

    corners_rc = np.array(
        [[0, 0], [0, out_w - 1], [out_h - 1, 0], [out_h - 1, out_w - 1]],
        np.float64,
    )
    y_p = corners_rc[:, 0] - (sy * zm + ty)
    x_p = corners_rc[:, 1] - (sx * zm + tx)
    zp = np.full(4, zm)
    if flip:
        zp = (z_n - 1) - zp
    # permuted (z', row, col) -> original (Z, Y, X) index
    pcoords = np.stack([zp, y_p, x_p], axis=1)
    idx_zyx = np.empty((4, 3), np.float64)
    for i, axis in enumerate(perm):
        idx_zyx[:, axis] = pcoords[:, i]
    idx_xyz1 = np.stack(
        [idx_zyx[:, 2], idx_zyx[:, 1], idx_zyx[:, 0], np.ones(4)], axis=1
    )
    world = (combined_transform.astype(np.float64) @ idx_xyz1.T).T
    clip = (proj.astype(np.float64) @ view.astype(np.float64) @ world.T).T
    ndc = clip[:, :2] / clip[:, 3:4]
    px = (ndc[:, 0] + 1.0) * 0.5 * width
    py = (1.0 - (ndc[:, 1] + 1.0) * 0.5) * height  # row 0 = top
    return _homography(np.stack([px, py], axis=1), corners_rc[:, ::-1].astype(np.float64))


def warp_homography(view_dir, vol_shape, out_h: int, out_w: int, combined_transform, view, proj,
                    width: int, height: int, occupied_mid=None) -> np.ndarray:
    """The homography half of warp_to_screen for an (out_h, out_w)
    intermediate image (float64)."""
    perm, flip, sx, sy = shear_parameters(view_dir)
    return _plane_homography(perm, flip, sx, sy, vol_shape, out_h, out_w, combined_transform, view, proj,
                             width, height, occupied_mid)


def preview_homography(view_dir, vol_shape, combined_transform, view, proj, width: int, height: int,
                       occupied_mid=None):
    """Host-side per-frame math for the fixed-canvas preview: shear
    parameters + the screen->intermediate homography. Returns
    (perm, flip, sx, sy, h_mat), h_mat in f32."""
    perm, flip, sx, sy = shear_parameters(view_dir)
    pdims = np.array(vol_shape, np.int64)[list(perm)]
    z_n, y_n, x_n = int(pdims[0]), int(pdims[1]), int(pdims[2])
    h_mat = _plane_homography(perm, flip, sx, sy, vol_shape, y_n + z_n, x_n + z_n, combined_transform, view,
                              proj, width, height, occupied_mid)
    return perm, flip, sx, sy, h_mat.astype(np.float32)


def canvas(vol_shape, sx: float, sy: float, inv_maj: float, sigma_dt: float, fixed_canvas: bool):
    """(out_h, out_w, params) of an intermediate image: the canvas size and
    the (6,) f32 scalars (sx, sy, tx, ty, inv_maj, sigma_dt) by the static
    or the fixed canvas's rule (module docstring)."""
    z_n, y_n, x_n = (int(v) for v in vol_shape)
    if fixed_canvas:
        out_h, out_w = y_n + z_n, x_n + z_n  # >= the static size for |s| <= 1
        sx32, sy32 = np.float32(sx), np.float32(sy)
        ty = np.maximum(np.float32(0.0), -sy32 * np.float32(z_n - 1))
        tx = np.maximum(np.float32(0.0), -sx32 * np.float32(z_n - 1))
    else:
        out_h = y_n + int(np.ceil(abs(sy) * (z_n - 1))) + 1
        out_w = x_n + int(np.ceil(abs(sx) * (z_n - 1))) + 1
        ty = max(0.0, -sy * (z_n - 1))
        tx = max(0.0, -sx * (z_n - 1))
    params = np.array([sx, sy, tx, ty, inv_maj, sigma_dt], np.float32)
    return out_h, out_w, params


# -- the intermediate image ----------------------------------------------------


def _classify(slice_vals, lut, inv_maj, sigma_dt):
    """Density -> (rgb, alpha') through the NEAREST transfer LUT."""
    k = lut.shape[0]
    idx = torch.clamp(torch.floor(slice_vals * inv_maj * k).to(torch.int64), 0, k - 1)
    rgba = lut[idx]
    alpha = 1.0 - torch.exp(-rgba[..., 3] * sigma_dt)
    return rgba[..., :3], alpha


def _frac_block(img, fy, fx):
    """(Y, X, C) -> (Y + 1, X + 1, C): the slice's bilinear footprint at
    fractional offset (fy, fx), the JAX kernel's 4-tap frac_block."""
    p00 = F.pad(img, (0, 0, 0, 1, 0, 1))
    p10 = F.pad(img, (0, 0, 0, 1, 1, 0))
    p01 = F.pad(img, (0, 0, 1, 0, 0, 1))
    p11 = F.pad(img, (0, 0, 1, 0, 1, 0))
    return p00 * (1 - fy) * (1 - fx) + p10 * fy * (1 - fx) + p01 * (1 - fy) * fx + p11 * fy * fx


def _composite_slice(c_acc, t_acc, rgb, alpha):
    """Front-to-back over operator (raymarch.glsl Beer-Lambert analog)."""
    contrib = t_acc[..., None] * alpha[..., None] * rgb
    return c_acc + contrib, t_acc * (1.0 - alpha)


def slice_shifts(params: np.ndarray, vol_shape, out_h: int, out_w: int):
    """Per-slice integer shifts and fractions, (iy, ix, fy, fx) as (z_n,)
    CPU tensors, computed in f32 as the kernel computes them:
    u = clamp(s * z + t, 0, out - n - 1), i = floor(u), f = u - i."""
    z_n, y_n, x_n = (int(v) for v in vol_shape)
    p = torch.from_numpy(params)
    zf = torch.arange(z_n, dtype=torch.float32)
    uy = torch.clamp(p[P_SY] * zf + p[P_TY], 0.0, float(out_h - y_n - 1))
    ux = torch.clamp(p[P_SX] * zf + p[P_TX], 0.0, float(out_w - x_n - 1))
    iy = torch.floor(uy).to(torch.int64)
    ix = torch.floor(ux).to(torch.int64)
    return iy, ix, uy - iy.to(torch.float32), ux - ix.to(torch.float32)


def shearwarp_intermediate_plain(vol, lut, sx: float, sy: float, inv_maj: float, sigma_dt: float,
                                 fixed_canvas: bool):
    """Plain PyTorch slice loop; see `shearwarp_intermediate`. Each slice
    updates only the (y_n + 1, x_n + 1) block its taps reach: elsewhere the
    update adds 0 and multiplies by 1."""
    z_n, y_n, x_n = vol.shape
    out_h, out_w, params = canvas(vol.shape, sx, sy, inv_maj, sigma_dt, fixed_canvas)
    dev = vol.device
    iy, ix, fy, fx = slice_shifts(params, vol.shape, out_h, out_w)
    fy, fx = fy.to(dev), fx.to(dev)
    p = upload(params, dev)
    c = torch.zeros((out_h, out_w, 3), dtype=torch.float32, device=dev)
    t = torch.ones((out_h, out_w), dtype=torch.float32, device=dev)
    for z, (y0, x0) in enumerate(zip(iy.tolist(), ix.tolist())):
        rgb, alpha = _classify(vol[z].to(torch.float32), lut, p[P_INV_MAJ], p[P_SIGMA_DT])
        blk = _frac_block(torch.cat([alpha[..., None], rgb], dim=-1), fy[z], fx[z])
        rows, cols = slice(y0, y0 + y_n + 1), slice(x0, x0 + x_n + 1)
        c[rows, cols], t[rows, cols] = _composite_slice(c[rows, cols], t[rows, cols], blk[..., 1:], blk[..., 0])
    return c, t


def shearwarp_intermediate_cuda(vol, lut, sx: float, sy: float, inv_maj: float, sigma_dt: float,
                                fixed_canvas: bool):
    """The slice loop as one launch of csrc/shearwarp.cu: each warp owns a
    31x6 tile of the intermediate image and walks the slices that reach
    it, classifying each voxel once; see `shearwarp_intermediate`."""
    kernels.require_cuda("shearwarp_intermediate", vol, dtype=torch.bfloat16)
    kernels.require_cuda("shearwarp_intermediate", lut, dtype=torch.float32, device=vol.device)
    if vol.dim() != 3:
        raise ValueError(f"shearwarp_intermediate: expected a (Z, Y, X) volume, got {tuple(vol.shape)}")
    if lut.dim() != 2 or lut.shape[1] != 4 or not 0 < lut.shape[0] <= MAX_LUT_ROWS:
        raise ValueError(f"shearwarp_intermediate: lut must be (K, 4) with K <= {MAX_LUT_ROWS}, "
                         f"got {tuple(lut.shape)}")
    if lut.data_ptr() % 16:
        raise ValueError("shearwarp_intermediate: the kernel reads 16-byte LUT rows; lut is misaligned")
    z_n, y_n, x_n = vol.shape
    out_h, out_w, params = canvas(vol.shape, sx, sy, inv_maj, sigma_dt, fixed_canvas)
    scalars = upload(params, vol.device)
    c = torch.empty((out_h, out_w, 3), dtype=torch.float32, device=vol.device)
    t = torch.empty((out_h, out_w), dtype=torch.float32, device=vol.device)
    kernels.launch(
        "vx_shearwarp_intermediate", vol, vol.data_ptr(), z_n, y_n, x_n, lut.data_ptr(), lut.shape[0],
        scalars.data_ptr(), out_h, out_w, c.data_ptr(), t.data_ptr(), counter="shearwarp_intermediate",
    )
    return c, t


def shearwarp_intermediate(vol, lut, sx: float, sy: float, inv_maj: float, sigma_dt: float, fixed_canvas: bool):
    """(Z, Y, X) permuted volume -> (out_h, out_w, 3) colour and (out_h,
    out_w) transmittance of the intermediate image, on the static or the
    fixed canvas. The kernel takes bf16 volumes; the plain version any
    float type (each slice is widened to f32, which is exact from bf16)."""
    if vol.device.type == "cpu":
        return shearwarp_intermediate_plain(vol, lut, sx, sy, inv_maj, sigma_dt, fixed_canvas)
    return shearwarp_intermediate_cuda(vol, lut, sx, sy, inv_maj, sigma_dt, fixed_canvas)


# -- full render: permute -> intermediate -> screen warp -------------------------


def permuted_volume(dense, perm, flip: bool):
    """The (Z, Y, X) field permuted so the principal axis comes first, slice
    order flipped for a -k view, as one contiguous copy."""
    vol = dense.permute(*perm).contiguous()
    return vol.flip(0) if flip else vol


def render_dvr(dense, lut, view_dir, vol_maj: float, density_scale: float = 1.0):
    """Deterministic shear-warp DVR of a dense (Z, Y, X) field on the static
    canvas -> the intermediate-space (colour, transmittance)."""
    perm, flip, sx, sy = shear_parameters(view_dir)
    vol = permuted_volume(dense, perm, flip)
    sigma_dt = density_scale * float(np.sqrt(1.0 + sx * sx + sy * sy))
    return shearwarp_intermediate(vol, lut, sx, sy, 1.0 / vol_maj, sigma_dt, fixed_canvas=False)


def _warp_resample(c_img, t_img, h_mat, width: int, height: int):
    """Inverse-homography bilinear resample of the intermediate image to
    (height, width) screen pixels -> (colour, transmittance); pixels that
    map outside it get colour 0 and transmittance 1."""
    out_h, out_w = t_img.shape
    dev = t_img.device
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(width, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij",
    )
    hm = h_mat
    denom = hm[2, 0] * xs + hm[2, 1] * ys + hm[2, 2]
    src_c = (hm[0, 0] * xs + hm[0, 1] * ys + hm[0, 2]) / denom
    src_r = (hm[1, 0] * xs + hm[1, 1] * ys + hm[1, 2]) / denom
    r0 = torch.floor(src_r)
    c0 = torch.floor(src_c)
    fr = src_r - r0
    fc = src_c - c0
    inside = (src_r >= 0) & (src_r <= out_h - 1) & (src_c >= 0) & (src_c <= out_w - 1)
    r0i = torch.clamp(r0.to(torch.int64), 0, out_h - 1)
    c0i = torch.clamp(c0.to(torch.int64), 0, out_w - 1)
    r1i = torch.clamp(r0i + 1, 0, out_h - 1)
    c1i = torch.clamp(c0i + 1, 0, out_w - 1)

    def bil(img):
        t00 = img[r0i, c0i]
        t01 = img[r0i, c1i]
        t10 = img[r1i, c0i]
        t11 = img[r1i, c1i]
        fr_ = fr[..., None] if img.dim() == 3 else fr
        fc_ = fc[..., None] if img.dim() == 3 else fc
        top = t00 * (1 - fc_) + t01 * fc_
        bot = t10 * (1 - fc_) + t11 * fc_
        return top * (1 - fr_) + bot * fr_

    color = torch.where(inside[..., None], bil(c_img), 0.0)
    trans = torch.where(inside, bil(t_img), 1.0)
    return color, trans


def warp_to_screen(c_img, t_img, view_dir, vol_shape, combined_transform: np.ndarray, view: np.ndarray,
                   proj: np.ndarray, width: int, height: int, background=None, occupied_mid=None):
    """Resample the intermediate (sheared-space) image to screen pixels.

    The intermediate plane at the occupied region's mid slice maps
    projectively onto the screen (`warp_homography`); points off that plane
    take the classic shear-warp parallax approximation. Returns (height,
    width, 3) f32, row 0 = image top, composited over `background`
    (default dark grey) through the intermediate transmittance.
    """
    out_h, out_w = int(t_img.shape[0]), int(t_img.shape[1])
    h_mat = warp_homography(view_dir, vol_shape, out_h, out_w, combined_transform, view, proj, width, height,
                            occupied_mid)
    color, trans = _warp_resample(c_img, t_img, upload(h_mat, t_img.device), width, height)
    bg = upload(background if background is not None else BACKGROUND, t_img.device)
    return color + trans[..., None] * bg


def display(image, exposure: float, gamma: float):
    """(..., 3) linear colour -> tonemapped (kernel 4 on the card) and
    clamped to [0, 1]."""
    mapped = tonemap_display(image.reshape(-1, 3), exposure, gamma)
    return torch.clamp(mapped.reshape(image.shape), 0.0, 1.0)


def _warp_apply(c_img, t_img, h_mat, width: int, height: int, bg, exposure: float, gamma: float):
    """Inverse-homography resample + composite + tonemap."""
    color, trans = _warp_resample(c_img, t_img, h_mat, width, height)
    return display(color + trans[..., None] * bg, exposure, gamma)


def preview_image(vol, lut, sx: float, sy: float, inv_maj: float, sigma_dt: float, h_mat, exposure: float,
                  gamma: float, width: int, height: int):
    """One interactive preview frame from a permuted volume on the fixed
    canvas: (height, width, 3) in [0, 1], row 0 = top. `h_mat` is
    preview_homography's f32 matrix."""
    c, t = shearwarp_intermediate(vol, lut, sx, sy, inv_maj, sigma_dt, fixed_canvas=True)
    return _warp_apply(c, t, upload(h_mat, vol.device), width, height, upload(BACKGROUND, vol.device), exposure,
                       gamma)
