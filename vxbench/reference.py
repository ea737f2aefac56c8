"""The plain reference renderer the benchmark judges the port against.

A lane is one (pixel, frame) pair: the reference traces the progressive
sample that the viewer's fragment shader traces for that pixel at that
frame index (shaders/fragment.frag), with the same per-ray random stream
(TEA over the pixel index and the frame, expanded to xoshiro128++ words,
shaders/random.glsl), and folds a pixel's samples into the viewer's
running average (viewer.ts:1356). Everything it reads it derives itself
from the benchmark's inputs (`scene.reference_scene`): the brick grid's ranges
and 8-bit voxels, the dense field, the majorant pyramid, the transfer LUT,
the environment's importance pyramid and the camera. It imports nothing of
the program under test.

Written in plain PyTorch so that it runs where the benchmark runs, on the
card or the CPU, and over any float dtype: `dtype=torch.float32` is the
reference; a lower precision (`torch.bfloat16`) is the control that the
comparison in `judge.py` has to reject. Integer work (the random words,
tap indices) is exact in either.

The three traversal modes follow the GLSL as the port's plain versions
state it (tests/oracle.py is the scalar transliteration of the same
shaders): the default mode's DDA null-collision march over a four-level
premultiplied majorant pyramid, with a per-lane step budget (1024 steps in
the camera leg, 100 in the shadow leg, dda.glsl:18) and the reference's
binary-shadow quirk; no_dda's delta and ratio tracking against the global
majorant (at most 512 events a leg); raymarch's 64 fixed steps with the
stochastic tricubic pick. The field holds each voxel's 8-bit brick decode
rounded to bfloat16, the precision the configuration states for it.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
WARMUP_SAMPLES = 5  # viewer.ts:132
DDA_SAMPLE_MAX_STEPS = 1024
DDA_TRANSMITTANCE_MAX_STEPS = 100  # dda.glsl:18
TRACKING_MAX_EVENTS = 512
RAYMARCH_STEPS = 64  # raymarch.glsl:6
MIP_START = 3.0
MIP_SPEED_UP = 0.25
MIP_SPEED_DOWN = 2.0
IMP_DIM = 512
IMP_BASE_MIP = 9
LUMA = (0.212671, 0.715160, 0.072169)  # utils.glsl:100
K_AMBIENT, K_DIFFUSE, K_SPECULAR, SHININESS = 0.15, 0.75, 0.25, 32.0
_TAPS = tuple((dx, dy, dz) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1))


# -- random streams (random.glsl:41-106) ----------------------------------------


def _rotl(x, k: int):
    return ((x << k) | (x >> (32 - k))) & M32


def tea(v0, v1, rounds: int = 32):
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & M32) ^ ((v1 + s0) & M32) ^ ((v1 >> 5) + 0xC8013EA4))) & M32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & M32) ^ ((v0 + s0) & M32) ^ ((v0 >> 5) + 0x7E95761E))) & M32
    return v0


def _wang(x):
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & M32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & M32
    return x ^ (x >> 15)


def seed_lanes(pixel, frame):
    """(n,) int64 pixel indices and frame indices -> (n, 4) int64 words."""
    seed = tea((42 * pixel) & M32, frame & M32)
    return torch.stack([_wang((seed + i) & M32) for i in range(4)], dim=-1)


class Stream:
    """Per-lane xoshiro128++ words; `draw(mask)` advances only the lanes
    where `mask` holds (the shader draws inside `if` bodies) and returns a
    float in [0, 1) from the top 24 bits of each lane's word."""

    def __init__(self, words, dtype):
        self.s = words
        self.dtype = dtype

    def draw(self, mask=None):
        s0, s1, s2, s3 = self.s.unbind(-1)
        result = (_rotl((s0 + s2) & M32, 7) + s0) & M32
        t = (s1 << 9) & M32
        s2 = s2 ^ s0
        s3 = s3 ^ s1
        s1 = s1 ^ s2
        s0 = s0 ^ s3
        s2 = s2 ^ t
        s3 = _rotl(s3, 11)
        nxt = torch.stack([s0, s1, s2, s3], dim=-1)
        self.s = nxt if mask is None else torch.where(mask[:, None], nxt, self.s)
        return (result >> 8).to(torch.float32).mul(1.0 / 16777216.0).to(self.dtype)

    def take(self, idx):
        return Stream(self.s[idx], self.dtype)

    def put(self, idx, sub: "Stream"):
        self.s[idx] = sub.s


# -- small vector helpers ----------------------------------------------------------


def _affine(m, v):
    """Rows of m (k, 4) applied to homogeneous v (n, 4), summed left to right."""
    return torch.stack([v[:, 0] * r[0] + v[:, 1] * r[1] + v[:, 2] * r[2] + v[:, 3] * r[3] for r in m], dim=-1)


def _transform(m, p, translate: bool):
    cols = []
    for j in range(3):
        c = p[:, 0] * m[j, 0] + p[:, 1] * m[j, 1] + p[:, 2] * m[j, 2]
        cols.append(c + m[j, 3] if translate else c)
    return torch.stack(cols, dim=-1)


def _norm3(v):
    return torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])


def _luma(rgb):
    return rgb[..., 0] * LUMA[0] + rgb[..., 1] * LUMA[1] + rgb[..., 2] * LUMA[2]


def _power_heuristic(a, b):
    return (a * a) / (a * a + b * b)


def _phase_hg(cos_t, g):
    denom = 1.0 + g * g + 2.0 * g * cos_t
    return (1.0 / (4.0 * math.pi)) * (1.0 - g * g) / (denom * torch.sqrt(torch.clamp_min(denom, 1e-12)))


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1], a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)


def _sample_hg(direction, g, u, v):
    """utils.glsl:106-139: an HG direction around `direction`."""
    sqr_g = g * g
    frac = (1.0 - sqr_g) / (1.0 - g + 2.0 * g * u + 1e-20)
    hg_cos = (1.0 + sqr_g - frac * frac) / (2.0 * g + 1e-20)
    cos_t = torch.where(torch.abs(g) < 1e-4, 1.0 - 2.0 * u, hg_cos)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * math.pi * v
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
    n = direction
    use_x = torch.abs(n[:, 0]) > torch.abs(n[:, 1])
    inv_xz = 1.0 / torch.sqrt(n[:, 0] ** 2 + n[:, 2] ** 2 + 1e-20)
    inv_yz = 1.0 / torch.sqrt(n[:, 1] ** 2 + n[:, 2] ** 2 + 1e-20)
    zero = torch.zeros_like(n[:, 0])
    t = torch.where(use_x[:, None], torch.stack([-n[:, 2], zero, n[:, 0]], -1) * inv_xz[:, None],
                    torch.stack([zero, n[:, 2], -n[:, 1]], -1) * inv_yz[:, None])
    b = _cross(n, t)
    out = local[:, 0:1] * t + local[:, 1:2] * b + local[:, 2:3] * n
    return out / _norm3(out)[:, None]


def _box(origin, direction, lo, hi):
    """utils.glsl:61-69 -> (hit, near, far)."""
    inv = 1.0 / direction
    a = (lo - origin) * inv
    b = (hi - origin) * inv
    near = torch.clamp_min(torch.minimum(a, b).amax(dim=-1), 0.0)
    far = torch.maximum(a, b).amin(dim=-1)
    return near <= far, near, far


# -- the scene as the reference holds it -----------------------------------------


class Scene:
    """What the reference renders from, on one device in one dtype.

    field (Z, Y, X): the voxels' 8-bit brick decode rounded to bf16;
    maj (4, bz, by, bx): vol_maj * alpha(LUT(density_scale * range max of
    each level's brick * inv_maj)); lut (K, 4); envmap (H, W, 3) texture
    space and imp (10 levels, 512^2 .. 1^2); the rest are uniforms."""

    def __init__(self, host: dict, device, dtype=torch.float32):
        self.dtype = dtype
        self.device = torch.device(device)

        def f(x):
            return torch.as_tensor(x).to(self.device).to(dtype)

        self.field = f(host["field"])
        self.extent = tuple(int(v) for v in host["extent"])
        self.maj = f(host["maj"])
        self.lut = f(host["lut"])
        self.envmap = f(host["envmap"])
        self.imp = [f(m) for m in host["imp"]]
        self.env_strength = f(host["env_strength"])
        self.aabb_lo, self.aabb_hi = f(host["aabb_lo"]), f(host["aabb_hi"])
        self.tinv = f(host["transform_inv"])
        self.vol_maj, self.inv_maj = f(host["vol_maj"]), f(host["inv_maj"])
        self.density_scale = f(host["density_scale"])
        self.albedo = f(host["albedo"])
        self.phase_g = f(host["phase_g"])
        self.sample_range = f(host["sample_range"])
        self.inv_view, self.inv_proj = f(host["inv_view"]), f(host["inv_proj"])
        self.light_dir = f(host["light_dir"])
        self.width, self.height = int(host["width"]), int(host["height"])
        s = host["settings"]
        self.mode = s["mode"]
        self.bounces = int(s["bounces"])
        self.show_environment = bool(s["show_environment"])
        self.use_env = bool(s["use_env"])
        self.gradient_shading = bool(s["gradient_shading"])

    # -- lookups -----------------------------------------------------------------

    def transfer(self, density):
        """NEAREST LUT row with range rejection (common.glsl:78-83)."""
        k = self.lut.shape[0]
        rejected = (density < self.sample_range[0]) | (density > self.sample_range[1])
        idx = torch.clamp(torch.floor(density * k).to(torch.int64), 0, k - 1)
        return torch.where(rejected[:, None], 0.0, self.lut[idx])

    def voxel(self, ip):
        """Field values at int64 (n, ..., 3) xyz coords; 0 outside the extent."""
        inside = torch.ones(ip.shape[:-1], dtype=torch.bool, device=ip.device)
        for k, e in enumerate(self.extent):
            inside &= (ip[..., k] >= 0) & (ip[..., k] < e)
        _, ny, nx = self.field.shape
        cl = torch.stack([ip[..., k].clamp(0, e - 1) for k, e in enumerate(self.extent)], dim=-1)
        flat = (cl[..., 2] * ny + cl[..., 1]) * nx + cl[..., 0]
        return torch.where(inside, self.field.reshape(-1)[flat], 0.0)

    def trilinear(self, pos):
        """Unscaled trilinear sum (common.glsl:61-69): weights (wx*wy)*wz,
        the eight taps summed z-outer, x-inner."""
        p = pos - 0.5
        base = torch.floor(p).to(torch.int64)
        fr = p - base.to(p.dtype)
        offs = torch.tensor(_TAPS, dtype=torch.int64, device=pos.device)
        taps = self.voxel(base[:, None, :] + offs)
        acc = None
        for k, (dx, dy, dz) in enumerate(_TAPS):
            wx = fr[:, 0] if dx else 1 - fr[:, 0]
            wy = fr[:, 1] if dy else 1 - fr[:, 1]
            wz = fr[:, 2] if dz else 1 - fr[:, 2]
            term = taps[:, k] * ((wx * wy) * wz)
            acc = term if acc is None else acc + term
        return acc

    def decode(self, pos):
        """The LUT row at index-space points: density_scale * trilinear * inv_maj."""
        density = self.density_scale * self.trilinear(pos)
        return self.transfer(density * self.inv_maj)

    def majorant(self, pos, mip_i):
        ip = torch.floor(pos).to(torch.int64)
        b = [ip[:, k].clamp(0, e - 1) >> 3 for k, e in enumerate(self.extent)]
        _, bz, by, bx = self.maj.shape
        flat = ((mip_i * bz + b[2]) * by + b[1]) * bx + b[0]
        return self.maj.reshape(-1)[flat]

    # -- environment (environment.glsl) ------------------------------------------

    def _bilinear(self, u, v):
        tex = self.envmap
        h, w = tex.shape[0], tex.shape[1]
        x = u * w - 0.5
        y = v * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = (x - x0)[:, None], (y - y0)[:, None]
        x0i = torch.remainder(x0.to(torch.int64), w)
        x1i = torch.remainder(x0i + 1, w)
        y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
        y1i = torch.clamp(y0.to(torch.int64) + 1, 0, h - 1)
        t00, t10, t01, t11 = tex[y0i, x0i], tex[y0i, x1i], tex[y1i, x0i], tex[y1i, x1i]
        return t00 * (1 - fx) * (1 - fy) + t10 * fx * (1 - fy) + t01 * (1 - fx) * fy + t11 * fx * fy

    def env_lookup(self, d):
        if not self.use_env:
            glow = torch.clamp(torch.pow(torch.clamp_min((d * (-self.light_dir)).sum(-1), 0.0), 300.0), 0.0, 1.0)
            return self.env_strength * (glow * 4.0 + 0.01)[:, None] * torch.ones(3, dtype=d.dtype, device=d.device)
        u = torch.atan2(d[:, 2], d[:, 0]) / (2.0 * math.pi) + 0.5
        v = 1.0 - torch.acos(torch.clamp(d[:, 1], -1.0, 1.0)) / math.pi
        return self.env_strength * self._bilinear(u, v)

    def env_pdf(self, d):
        return _luma(self.env_lookup(d)) / self.imp[IMP_BASE_MIP][0, 0] * (1.0 / (4.0 * math.pi))

    def env_sample(self, px, py):
        """The hierarchical warp (environment.glsl:36-80) -> (Le, pdf, w_i)."""
        n = px.shape[0]
        if not self.use_env:
            le = (self.env_strength * 4.01).expand(n)[:, None] * torch.ones(3, dtype=px.dtype, device=px.device)
            return le, torch.ones(n, dtype=px.dtype, device=px.device), (-self.light_dir).expand(n, 3)
        pos_x = torch.zeros(n, dtype=torch.int64, device=px.device)
        pos_y = torch.zeros_like(pos_x)
        for mip in range(IMP_BASE_MIP - 1, -1, -1):
            imp = self.imp[mip]
            dim = imp.shape[1]
            flat = imp.reshape(-1)
            row0 = (pos_y * 2) * dim + pos_x * 2
            w00, w10, w01, w11 = flat[row0], flat[row0 + 1], flat[row0 + dim], flat[row0 + dim + 1]
            q0, q1 = w00 + w01, w10 + w11
            dd = q0 / torch.clamp_min(q0 + q1, 1e-8)
            right = px >= dd
            e = torch.where(right, w10, w00) / torch.clamp_min(torch.where(right, q1, q0), 1e-8)
            px = torch.where(right, (px - dd) / torch.clamp_min(1.0 - dd, 1e-8), px / torch.clamp_min(dd, 1e-8))
            pos_x = pos_x * 2 + right.to(torch.int64)
            up = py >= e
            py = torch.where(up, (py - e) / torch.clamp_min(1.0 - e, 1e-8), py / torch.clamp_min(e, 1e-8))
            pos_y = pos_y * 2 + up.to(torch.int64)
        uv_x = (pos_x.to(px.dtype) + px) * (1.0 / IMP_DIM)
        uv_y = (pos_y.to(px.dtype) + py) * (1.0 / IMP_DIM)
        theta = torch.clamp(1.0 - uv_y, 0.0, 1.0) * math.pi
        phi = (torch.clamp(uv_x, 0.0, 1.0) * 2.0 - 1.0) * math.pi
        sin_t = torch.sin(theta)
        w_i = torch.stack([sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi)], dim=-1)
        le = self.env_strength * self._bilinear(uv_x, uv_y)
        pdf = self.imp[0].reshape(-1)[pos_y * IMP_DIM + pos_x] / self.imp[IMP_BASE_MIP][0, 0] * (1.0 / (4.0 * math.pi))
        return le, pdf, w_i

    # -- camera (fragment.frag:57-65, 143-147; utils.glsl:23-40) --------------------

    def camera(self, pixel, frame):
        """Seeded streams and jittered camera rays for (pixel, frame) lanes."""
        rs = Stream(seed_lanes(pixel, frame), self.dtype)
        j1x, j1y, j2x, j2y = rs.draw(), rs.draw(), rs.draw(), rs.draw()
        w, h = self.width, self.height
        px = (pixel % w).to(self.dtype)
        py = (pixel // w).to(self.dtype)
        tex = torch.stack([(px + 0.5) / w, (py + 0.5) / h], dim=-1)
        jitter = torch.stack([(j1x + j2x) / 2.0, (j1y + j2y) / 2.0], dim=-1)
        size = torch.tensor([w, h], dtype=self.dtype, device=pixel.device)
        ndc = tex + (jitter * 2.0 - 1.0) / size
        h_cam = self.inv_view[:, 3]
        cam = h_cam[:3] / h_cam[3]
        ones = torch.ones_like(ndc[:, :1])
        clip = torch.cat([ndc * 2.0 - 1.0, torch.zeros_like(ones), ones], dim=-1)
        view_h = _affine(self.inv_proj, clip)
        view = view_h[:, :3] / view_h[:, 3:4]
        world_h = _affine(self.inv_view, torch.cat([view, ones], dim=-1))
        world = world_h[:, :3] / world_h[:, 3:4]
        d = world - cam
        d = d / _norm3(d)[:, None]
        return rs, cam.expand_as(d).clone(), d

    def in_box(self, pixel, frame):
        """Which (pixel, frame) camera rays start a camera leg: inside the
        box with near + 1e-6 < far."""
        _, o, d = self.camera(pixel, frame)
        hit, near, far = _box(o, d, self.aabb_lo, self.aabb_hi)
        return hit & (near + 1e-6 < far)

    # -- legs -------------------------------------------------------------------------

    def _index_rays(self, o, d):
        return _transform(self.tinv, o, True), _transform(self.tinv, d, False)

    def sample_volume(self, o, d, rs, active):
        """(hit, t, rgb) of the mode's camera leg; draws only where the shader does."""
        if self.mode == "default":
            return self._dda(o, d, rs, active, shadow=False)
        if self.mode == "no_dda":
            return self._track(o, d, rs, active, shadow=False)
        return self._raymarch(o, d, rs, active, shadow=False)

    def transmittance(self, o, d, rs, active):
        if self.mode == "default":
            return self._dda(o, d, rs, active, shadow=True)
        if self.mode == "no_dda":
            return self._track(o, d, rs, active, shadow=True)
        return self._raymarch(o, d, rs, active, shadow=True)

    def _dda(self, o, d, rs, active, shadow: bool):
        """dda.glsl:21-98: march to each collision candidate over the
        premultiplied pyramid, decode and draw there, march on."""
        n = o.shape[0]
        hit_box, near, far = _box(o, d, self.aabb_lo, self.aabb_hi)
        ipos, idir = self._index_rays(o, d)
        ri = 1.0 / idir
        xi = rs.draw(active & hit_box)
        t = near + 1e-6
        tau = -torch.log(1.0 - xi)
        running = active & hit_box & (t < far)
        mip = torch.full_like(t, MIP_START)
        budget = torch.full((n,), DDA_TRANSMITTANCE_MAX_STEPS if shadow else DDA_SAMPLE_MAX_STEPS,
                            dtype=torch.int64, device=o.device)
        hit = torch.zeros(n, dtype=torch.bool, device=o.device)
        rgb = torch.ones((n, 3), dtype=o.dtype, device=o.device)
        tr = torch.ones(n, dtype=o.dtype, device=o.device)
        lanes = torch.nonzero(running).squeeze(1)
        while lanes.numel():
            lp, ld, lri, lt, ltau, lmip, lfar = ipos[lanes], idir[lanes], ri[lanes], t[lanes], tau[lanes], mip[lanes], far[lanes]
            mip_i = torch.clamp(torch.floor(lmip + 0.5).to(torch.int64), 0, 3)
            curr = lp + lt[:, None] * ld
            maj = self.majorant(curr, mip_i)
            dim = (8 << mip_i).to(o.dtype)[:, None]
            offs = torch.where(lri >= 0.0, dim + 0.5, -0.5)
            dt = ((torch.floor(curr / dim) * dim + offs - curr) * lri).amin(dim=-1)
            t_new = lt + dt
            tau_new = ltau - maj * dt
            collided = tau_new <= 0.0
            t_coll = t_new + tau_new / torch.clamp_min(maj, 1e-20)
            escaped = t_coll >= lfar
            out_far = ~collided & (t_new >= lfar)
            lt = torch.where(collided, t_coll, t_new)
            ltau = torch.where(collided, ltau, tau_new)
            lmip = torch.where(collided, lmip, torch.clamp_max(lmip + MIP_SPEED_UP, 3.0))
            left = budget[lanes] - 1
            budget[lanes] = left
            live = collided & ~escaped
            go_on = ~collided & ~out_far
            # the collision at the live lanes: decode, then the real/null draw
            sub = rs.take(lanes)
            rgba = self.decode(lp + lt[:, None] * ld)
            dens = self.vol_maj * rgba[:, 3]
            xi1 = sub.draw(live)
            real = live & (xi1 * maj < dens)
            if shadow:
                ratio = torch.clamp_min(1.0 - self.vol_maj / torch.clamp_min(maj, 1e-20), 0.0)
                trl = torch.where(real, tr[lanes] * ratio, tr[lanes])
                rr = real & (trl < 0.1)
                xi_rr = sub.draw(rr)
                killed = rr & (xi_rr < (1.0 - trl))
                trl = torch.where(rr & ~killed, trl / torch.clamp_min(trl, 1e-20), trl)
                tr[lanes] = torch.where(killed, 0.0, trl)
                redraw = live & ~killed
                ended = killed
            else:
                hit[lanes] = hit[lanes] | real
                rgb[lanes] = torch.where(real[:, None], rgba[:, :3], rgb[lanes])
                redraw = live & ~real
                ended = real
            xi2 = sub.draw(redraw)
            ltau = torch.where(redraw, -torch.log(1.0 - xi2), ltau)
            lmip = torch.where(redraw, torch.clamp_min(lmip - MIP_SPEED_DOWN, 0.0), lmip)
            rs.put(lanes, sub)
            t[lanes], tau[lanes], mip[lanes] = lt, ltau, lmip
            keep = (go_on | (live & ~ended)) & (left > 0)
            lanes = lanes[keep]
        if shadow:
            return tr
        return hit, t, rgb

    def _track(self, o, d, rs, active, shadow: bool):
        """normal.glsl: delta tracking (camera) and ratio tracking (shadow)
        against the global majorant, at most TRACKING_MAX_EVENTS events."""
        n = o.shape[0]
        hit_box, near, far = _box(o, d, self.aabb_lo, self.aabb_hi)
        ipos, idir = self._index_rays(o, d)
        xi = rs.draw(active & hit_box)
        t = near - torch.log(1.0 - xi) * self.inv_maj
        running = active & hit_box & (t < far)
        hit = torch.zeros(n, dtype=torch.bool, device=o.device)
        rgb = torch.ones((n, 3), dtype=o.dtype, device=o.device)
        tr = torch.ones(n, dtype=o.dtype, device=o.device)
        lanes = torch.nonzero(running).squeeze(1)
        for _ in range(TRACKING_MAX_EVENTS):
            if not lanes.numel():
                break
            lt = t[lanes]
            rgba = self.decode(ipos[lanes] + lt[:, None] * idir[lanes])
            sub = rs.take(lanes)
            if shadow:
                trl = tr[lanes] * (1.0 - self.vol_maj * rgba[:, 3] * self.inv_maj)
                rr = trl < 0.1
                xi_rr = sub.draw(rr)
                killed = rr & (xi_rr < (1.0 - trl))
                trl = torch.where(rr & ~killed, trl / torch.clamp_min(trl, 1e-20), trl)
                tr[lanes] = torch.where(killed, 0.0, trl)
                xi2 = sub.draw(~killed)
                lt = lt - torch.log(1.0 - xi2) * self.inv_maj
                ended = killed
            else:
                p_real = self.vol_maj * rgba[:, 3] * self.inv_maj
                real = sub.draw() < p_real
                xi2 = sub.draw(~real)
                lt = torch.where(real, lt, lt - torch.log(1.0 - xi2) * self.inv_maj)
                hit[lanes] = real
                rgb[lanes] = torch.where(real[:, None], rgba[:, :3], rgb[lanes])
                ended = real
            rs.put(lanes, sub)
            t[lanes] = lt
            lanes = lanes[~ended & (lt < far[lanes])]
        if shadow:
            return tr
        return hit, t, rgb

    def _tricubic_pick(self, pos, sub, mask):
        """Weighted-reservoir tricubic tap (common.glsl:9-32): nine draws."""
        p = pos - 0.5
        base = torch.floor(p).to(torch.int64)
        tt = p - base.to(p.dtype)
        t2 = tt * tt
        t3 = tt * t2
        sixth = 1.0 / 6.0
        ws = (sixth * (-t3 + 3.0 * t2 - 3.0 * tt + 1.0), sixth * (3.0 * t3 - 6.0 * t2 + 4.0),
              sixth * (-3.0 * t3 + 3.0 * t2 + 3.0 * tt + 1.0), sixth * t3)
        sum_w = ws[0]
        idx = torch.zeros_like(base)
        for tap in (1, 2, 3):
            sum_w = sum_w + ws[tap]
            r = torch.stack([sub.draw(mask), sub.draw(mask), sub.draw(mask)], dim=-1)
            idx = torch.where(r < ws[tap] / torch.clamp_min(sum_w, 1e-3), tap, idx)
        return base + idx - 1

    def _raymarch(self, o, d, rs, active, shadow: bool):
        """raymarch.glsl: 64 fixed steps of a stochastic tricubic tap."""
        n = o.shape[0]
        hit_box, near, far = _box(o, d, self.aabb_lo, self.aabb_hi)
        ipos, idir = self._index_rays(o, d)
        dt = (far - near) / RAYMARCH_STEPS
        valid = active & hit_box
        target = None
        if not shadow:
            target = -torch.log(1.0 - rs.draw(valid))
        start = near + rs.draw(valid) * dt
        tau = torch.zeros(n, dtype=o.dtype, device=o.device)
        hit = torch.zeros(n, dtype=torch.bool, device=o.device)
        t_out = torch.zeros(n, dtype=o.dtype, device=o.device)
        rgb = torch.ones((n, 3), dtype=o.dtype, device=o.device)
        lanes = torch.nonzero(valid).squeeze(1)
        for i in range(RAYMARCH_STEPS):
            if not lanes.numel():
                break
            t = torch.minimum(start[lanes] + i * dt[lanes], far[lanes])
            sub = rs.take(lanes)
            tap = self._tricubic_pick(ipos[lanes] + t[:, None] * idir[lanes], sub, None)
            rs.put(lanes, sub)
            rgba = self.transfer(self.density_scale * self.voxel(tap) * self.inv_maj)
            tau_new = tau[lanes] + rgba[:, 3] * self.vol_maj * dt[lanes]
            tau[lanes] = tau_new
            if not shadow:
                new_hit = tau_new >= target[lanes]
                hit[lanes] = new_hit
                t_out[lanes] = torch.where(new_hit, t, t_out[lanes])
                rgb[lanes] = torch.where(new_hit[:, None], rgba[:, :3], rgb[lanes])
                lanes = lanes[~new_hit]
        if shadow:
            return torch.exp(-tau)
        return hit, t_out, rgb

    # -- the integrator ------------------------------------------------------------------

    def trace_path(self, o, d, rs):
        """fragment.frag:79-124 over lanes, bounce by bounce."""
        n = o.shape[0]
        dev, dt = o.device, o.dtype
        radiance = torch.zeros((n, 3), dtype=dt, device=dev)
        throughput = torch.ones((n, 3), dtype=dt, device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        n_paths = torch.zeros(n, dtype=torch.int64, device=dev)
        f_p = torch.zeros(n, dtype=dt, device=dev)
        for _ in range(self.bounces):
            hit, t, rgb = self.sample_volume(o, d, rs, active)
            hit = hit & active
            miss = active & ~hit
            if self.show_environment:
                le = self.env_lookup(d)
                mis = torch.where(n_paths > 0, _power_heuristic(f_p, self.env_pdf(d)), 1.0)
                radiance = radiance + torch.where(miss[:, None], throughput * mis[:, None] * le, 0.0)
            active = hit
            o = torch.where(hit[:, None], o + t[:, None] * d, o)
            throughput = torch.where(hit[:, None], throughput * self.albedo * rgb, throughput)
            u1, u2 = rs.draw(active), rs.draw(active)
            le_nee, pdf_nee, w_i = self.env_sample(u1, u2)
            valid = active & (pdf_nee > 0.0)
            f_nee = _phase_hg((-d * w_i).sum(dim=-1), self.phase_g)
            mis_nee = _power_heuristic(pdf_nee, f_nee) if self.show_environment else torch.ones_like(f_nee)
            tr = self.transmittance(o, w_i, rs, valid)
            radiance = radiance + torch.where(
                valid[:, None], throughput * (mis_nee * f_nee * tr / torch.clamp_min(pdf_nee, 1e-20))[:, None] * le_nee,
                0.0)
            n_paths = n_paths + active.to(torch.int64)
            active = active & (n_paths < self.bounces)
            rr_val = _luma(throughput)
            low = active & (rr_val < 0.1)
            xi_rr = rs.draw(low)
            killed = low & (xi_rr < 1.0 - rr_val)
            throughput = torch.where((low & ~killed)[:, None], throughput / torch.clamp_min(rr_val, 1e-20)[:, None],
                                     throughput)
            active = active & ~killed
            v1, v2 = rs.draw(active), rs.draw(active)
            new_d = _sample_hg(d, self.phase_g, v1, v2)
            f_p = torch.where(active, _phase_hg((-d * new_d).sum(dim=-1), self.phase_g), f_p)
            d = torch.where(active[:, None], new_d, d)
        return torch.where(torch.isfinite(radiance), radiance, 0.0)

    def trace_shaded(self, o, d, rs):
        """First-hit central-difference Blinn-Phong with a shadow ray toward
        the light (the port's gradient shading, render/shading.py)."""
        n = o.shape[0]
        active = torch.ones(n, dtype=torch.bool, device=o.device)
        hit, t, rgb = self.sample_volume(o, d, rs, active)
        hit_pos = o + t[:, None] * d
        ipos = _transform(self.tinv, hit_pos, True)
        grads = []
        for axis in range(3):
            off = torch.zeros(3, dtype=o.dtype, device=o.device)
            off[axis] = 1.0
            hi = self.density_scale * self.trilinear(ipos + off)
            lo = self.density_scale * self.trilinear(ipos - off)
            grads.append((hi - lo) * 0.5)
        grad = torch.stack(grads, dim=-1)
        normal = -grad / torch.clamp_min(torch.linalg.norm(grad, dim=-1, keepdim=True), 1e-8)
        facing = (normal * (-d)).sum(dim=-1, keepdim=True)
        normal = torch.where(facing < 0, -normal, normal)
        light = -self.light_dir.expand(n, 3)
        shadow = self.transmittance(hit_pos, light, rs, hit)
        n_dot_l = torch.clamp_min((normal * light).sum(dim=-1), 0.0)
        half = light - d
        half = half / torch.clamp_min(torch.linalg.norm(half, dim=-1, keepdim=True), 1e-8)
        spec = torch.pow(torch.clamp_min((normal * half).sum(dim=-1), 0.0), SHININESS)
        shaded = rgb * (K_AMBIENT + K_DIFFUSE * (n_dot_l * shadow)[:, None]) + K_SPECULAR * (spec * shadow)[:, None]
        bg = self.env_lookup(d) if self.show_environment else torch.zeros_like(rgb)
        out = torch.where(hit[:, None], shaded, bg)
        return torch.where(torch.isfinite(out), out, 0.0)

    def samples(self, pixel, frame):
        """One progressive sample a (pixel, frame) lane -> (n, 3)."""
        rs, o, d = self.camera(pixel, frame)
        if self.gradient_shading:
            return self.trace_shaded(o, d, rs)
        return self.trace_path(o, d, rs)


def accumulate(scene: Scene, pixels, frames, block: int | None = None):
    """The running average (viewer.ts:1356) of `frames` (a list of frame
    indices in the order the viewer rendered them, from a restart) at
    `pixels`, as the viewer's framebuffer holds it after the last one:
    frames before WARMUP_SAMPLES overwrite it, later ones average in.
    Lanes are traced in blocks of about `block` (2^19 on a card, 2^15 on
    the CPU) so that memory stays small.
    Returns (len(pixels), 3) in the scene's dtype."""
    pixels = pixels.to(scene.device)
    block = block or (1 << 19 if scene.device.type == "cuda" else 1 << 15)
    fb = torch.zeros((pixels.shape[0], 3), dtype=scene.dtype, device=scene.device)
    per = max(1, block // max(1, pixels.shape[0]))
    for at in range(0, len(frames), per):
        chunk = frames[at:at + per]
        frame = torch.tensor(chunk, dtype=torch.int64, device=scene.device).repeat_interleave(pixels.shape[0])
        s = scene.samples(pixels.repeat(len(chunk)), frame).reshape(len(chunk), pixels.shape[0], 3)
        for k, f in enumerate(chunk):
            fv = torch.tensor(float(f), dtype=torch.float32)
            w = torch.tensor(0.0) if f < WARMUP_SAMPLES else (fv - WARMUP_SAMPLES) / (fv - WARMUP_SAMPLES + 1.0)
            w = w.to(scene.device).to(scene.dtype)
            fb = w * fb + (1.0 - w) * s[k]
    return fb


HABLE = (0.15, 0.50, 0.10, 0.20, 0.02, 0.30)
HABLE_WHITE = 11.2


def _hable(x):
    a, b, c, d, e, f = HABLE
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def tonemap(linear, exposure: float, gamma: float):
    """Hable/Uncharted2 filmic map and gamma (blit.frag:17-35)."""
    white = _hable(torch.tensor(HABLE_WHITE, dtype=linear.dtype, device=linear.device))
    mapped = _hable(exposure * linear) / white
    return torch.pow(torch.clamp_min(mapped, 0.0), 1.0 / torch.tensor(gamma, dtype=linear.dtype))
