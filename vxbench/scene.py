"""A configuration's inputs, made from the seed, and the scene they describe.

`make_volume` draws the CT-like volume of a configuration on the device
from `--seed`: the nested density shells of the JAX package's
`synthetic_ct_volume` (an outer soft-tissue ellipsoid, a medium shell, a
dense core) with uniform noise inside the body, quantized to the stored
bits. Both the program and the reference take that volume, normalised by
its maximum, as their input.

`reference_scene` derives, from that volume and the configuration alone,
everything `reference.Scene` renders from: the brick grid's dilated
ranges (rounded through float16) and 8-bit voxels (brick.rs:76-205), the
bf16 field they decode to, the majorant pyramid, the transfer LUT
(data.ts:21-60), the environment's importance pyramid (environment.ts)
and the camera (scene.ts). The host math is a frozen copy of the
viewer's; nothing here imports the program.

`port_renderer` sets the program up for the same configuration through
its public `Renderer` surface.
"""

from __future__ import annotations

import io
import struct
import time
import zipfile

import numpy as np
import torch
import torch.nn.functional as F

BRICK = 8
NUM_MIPS = 3


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0x7FFF_FFFF_FFFF_FFFF)
    return gen


def make_volume(size, bits: int, seed: int, device) -> torch.Tensor:
    """(Z, Y, X) float32 holding whole numbers in [0, 2^bits - 1]: the
    shells of synthetic_ct_volume with the noise drawn by a torch.Generator
    on `device` (one call), computed in float32 and truncated as a uint16
    cast truncates."""
    z, y, x = (int(v) for v in size)
    f32 = dict(dtype=torch.float32, device=device)
    zz2 = ((torch.arange(z, **f32) - (z - 1) / 2) / (z * 0.45)) ** 2
    yy2 = ((torch.arange(y, **f32) - (y - 1) / 2) / (y * 0.45)) ** 2
    xx2 = ((torch.arange(x, **f32) - (x - 1) / 2) / (x * 0.45)) ** 2
    r2 = zz2[:, None, None] + (yy2[:, None] + xx2[None, :])[None]
    body = r2 < 1.0
    density = body * 0.25 + (r2 < 0.49) * 0.25 + (r2 < 0.1225) * 0.4
    noise = torch.rand((z, y, x), generator=_generator(seed, device), **f32)
    density = density + noise * 0.05 * body
    max_val = (1 << int(bits)) - 1
    return torch.trunc(torch.clamp(density, 0.0, 1.0) * max_val)


def normalised(volume: torch.Tensor) -> torch.Tensor:
    """The density the renderer loads: the volume over its maximum."""
    return volume / volume.max()


def _dicom_element(group: int, elem: int, vr: bytes, value: bytes) -> bytes:
    if len(value) % 2:
        value += b"\x00"
    head = struct.pack("<HH", group, elem)
    if vr in (b"OB", b"OW", b"SQ", b"UN", b"UT"):
        return head + vr + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + vr + struct.pack("<H", len(value)) + value


def dicom_slice(pixels: np.ndarray, instance: int, bits_stored: int) -> bytes:
    """One (rows, cols) uint16 slice as an Explicit VR Little Endian DICOM
    file, pixel spacing and slice thickness 1 (utils/fixtures.py's writer)."""
    rows, cols = pixels.shape
    meta_body = _dicom_element(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1")
    meta = _dicom_element(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_body))) + meta_body
    ds = _dicom_element(0x0018, 0x0050, b"DS", b"1.0")
    ds += _dicom_element(0x0020, 0x0013, b"IS", str(instance).encode())
    ds += _dicom_element(0x0028, 0x0002, b"US", struct.pack("<H", 1))
    ds += _dicom_element(0x0028, 0x0010, b"US", struct.pack("<H", rows))
    ds += _dicom_element(0x0028, 0x0011, b"US", struct.pack("<H", cols))
    ds += _dicom_element(0x0028, 0x0030, b"DS", b"1.0\\1.0")
    ds += _dicom_element(0x0028, 0x0100, b"US", struct.pack("<H", 16))
    ds += _dicom_element(0x0028, 0x0101, b"US", struct.pack("<H", bits_stored))
    ds += _dicom_element(0x0028, 0x0102, b"US", struct.pack("<H", bits_stored - 1))
    ds += _dicom_element(0x0028, 0x0103, b"US", struct.pack("<H", 0))
    ds += _dicom_element(0x7FE0, 0x0010, b"OW", np.ascontiguousarray(pixels, "<u2").tobytes())
    return b"\x00" * 128 + b"DICM" + meta + ds


def dicom_zip(volume: np.ndarray, bits_stored: int) -> bytes:
    """A (Z, Y, X) uint16 volume as a single-folder deflated ZIP of DICOM
    slices, as a scan is handed to the viewer (deflate level 1: the bytes
    differ from level 6's, the files in them do not)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED, compresslevel=1) as zf:
        for z in range(volume.shape[0]):
            zf.writestr(f"series/slice_{z:04d}.dcm", dicom_slice(volume[z], z + 1, bits_stored))
    return buf.getvalue()


def sky_image(width: int, height: int) -> np.ndarray:
    """utils/fixtures.py's synthetic_env_hdr image: a sky gradient and a
    bright sun patch, (height, width, 3) float32, row 0 at the top."""
    v = np.linspace(0, 1, height, dtype=np.float32)[:, None]
    u = np.linspace(0, 1, width, dtype=np.float32)[None, :]
    sky = np.stack([0.3 + 0.2 * (1 - v) * np.ones_like(u), 0.4 + 0.3 * (1 - v) * np.ones_like(u),
                    0.7 + 0.3 * (1 - v) * np.ones_like(u)], axis=-1)
    sun = np.exp(-(((u - 0.25) * 18) ** 2 + ((v - 0.25) * 12) ** 2))
    return (sky + sun[..., None] * np.array([40.0, 35.0, 25.0], np.float32)).astype(np.float32)


def encode_rgbe(image: np.ndarray) -> bytes:
    """A flat (non-RLE) Radiance .hdr stream of (H, W, 3) float32."""
    img = np.asarray(image, np.float32)[..., :3]
    h, w, _ = img.shape
    maxc = img.max(axis=-1)
    with np.errstate(divide="ignore"):
        exp = np.where(maxc > 1e-32, np.ceil(np.log2(np.maximum(maxc, 1e-32))) + 1, 0)
    scale = np.where(maxc > 1e-32, np.ldexp(1.0, (-exp).astype(np.int32)) * 256.0, 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc > 1e-32, exp + 128, 0).astype(np.uint8)
    return b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode() + rgbe.tobytes()


def decode_rgbe(data: bytes) -> np.ndarray:
    """A flat Radiance .hdr stream -> (H, W, 3) float32, row 0 at the top:
    (mantissa + 0.5) * 2^(exponent - 136)."""
    head, _, rest = data.partition(b"\n\n")
    size, _, body = rest.partition(b"\n")
    _, h, _, w = size.split()
    rgbe = np.frombuffer(body, np.uint8).reshape(int(h), int(w), 4).astype(np.float32)
    scale = np.where(rgbe[..., 3] > 0, np.ldexp(1.0, (rgbe[..., 3] - 136.0).astype(np.int32)), 0.0)
    return ((rgbe[..., :3] + 0.5) * scale[..., None]).astype(np.float32)


def environment(config: dict):
    """The configuration's environment map: (texture-space image (H, W, 3)
    for the reference, bytes for the program or None for its default
    map, strength)."""
    env = config.get("environment", {"kind": "default"})
    if env["kind"] == "default":
        return np.ascontiguousarray(default_environment_image()[::-1]), None, 1.0
    data = encode_rgbe(sky_image(env["width"], env["height"]))
    return np.ascontiguousarray(decode_rgbe(data)[::-1]), data, float(env.get("strength", 1.0))


# the viewer's defaults (viewer.ts:147-163) for what a configuration leaves out
DEFAULTS = {"density_multiplier": 1.0, "sample_range": [0.0, 1.0], "exposure": 5.5, "gamma": 2.2,
            "light_dir": (np.ones(3) * -1.0 / np.linalg.norm(np.ones(3))).tolist(), "resolution_factor": 1.0,
            "use_env": True,
            "show_environment": True, "bounces": 3, "gradient_shading": False}


def settings(config: dict, workload: dict) -> dict:
    return {**DEFAULTS, **config["settings"], **workload.get("settings", {})}


def render_size(config: dict, workload: dict) -> tuple[int, int]:
    factor = float(settings(config, workload)["resolution_factor"])
    return max(1, round(int(config["width"]) * factor)), max(1, round(int(config["height"]) * factor))


# -- the viewer's host math (frozen copies) --------------------------------------


def _look_at(eye, center, up) -> np.ndarray:
    f = np.asarray(center, np.float64) - np.asarray(eye, np.float64)
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -np.dot(s, eye), -np.dot(u, eye), np.dot(f, eye)
    return m.astype(np.float32)


def _perspective(fovy: float, aspect: float, near: float = 0.1, far: float = 1000.0) -> np.ndarray:
    f = 1.0 / np.tan(fovy / 2.0)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0], m[1, 1] = f / aspect, f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = (2.0 * far * near) / (near - far)
    m[3, 2] = -1.0
    return m.astype(np.float32)


def _axis_rotation(axis, angle):
    axis = axis / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


UP = np.array([0.0, 1.0, 0.0])


def camera_matrices(camera: dict, width: int, height: int):
    """scene.ts:15-72: the orbit camera at distance 1, rotated around its
    view point and zoomed as the configuration says, or placed at `pos`
    looking at `look_at` (a settings export's camera) -> (inv_view, inv_proj)."""
    view = np.asarray(camera.get("look_at", [0.0, 0.0, 0.0]), np.float64)
    pos = np.asarray(camera.get("pos", [0.0, 0.0, -1.0]), np.float64)
    yaw = pitch = 0.0
    if "rotate_around_view" in camera:
        bx, by = camera["rotate_around_view"]
        yaw, pitch = -bx, float(np.clip(by, -(np.pi / 2 - 0.01), np.pi / 2 - 0.01))
        r_yaw = _axis_rotation(UP, yaw)
        right = r_yaw @ np.array([1.0, 0.0, 0.0])
        orient = _axis_rotation(right / np.linalg.norm(right), pitch) @ r_yaw
        pos = orient @ np.array([0.0, 0.0, -1.0]) * np.linalg.norm(pos - view) + view
    if "zoom" in camera:
        direction = pos - view
        d = np.linalg.norm(direction)
        by = float(camera["zoom"])
        if 0.1 < d * by < 10:
            pos = direction * by + view
    inv_view = np.linalg.inv(_look_at(pos, view, UP)).astype(np.float32)
    inv_proj = np.linalg.inv(_perspective(np.pi / 3, width / height)).astype(np.float32)
    return inv_view, inv_proj


def transfer_lut(stops, steps: int = 128) -> np.ndarray:
    """data.ts:21-60, with its quirks (zero fill before the first stop,
    hold after the last, the step skipped at a crossing)."""
    stops = sorted(stops, key=lambda c: c["stop"])
    current, out, i = -1, [], 0
    while i < steps:
        position = i / steps
        if current < 0:
            if stops[0]["stop"] >= position:
                current = 0
                out.append(list(stops[0]["color"]))
            else:
                out.append([0.0, 0.0, 0.0, 0.0])
        else:
            nxt = stops[current + 1] if current + 1 < len(stops) else None
            if nxt is None:
                out.append(list(stops[current]["color"]))
            else:
                span = nxt["stop"] - stops[current]["stop"]
                progress = (position - stops[current]["stop"]) / span if span else 1.0
                if progress >= 1.0:
                    out.append(list(nxt["color"]))
                    current += 1
                    i += 1
                    continue
                a = np.asarray(stops[current]["color"], np.float64)
                b = np.asarray(nxt["color"], np.float64)
                out.append(((1 - progress) * a + progress * b).tolist())
        i += 1
    return np.asarray(out, np.float32)


def placement(extent_xyz):
    """volume.ts plus the unit-cube rescale (viewer.ts:1086-1099) of an
    identity grid transform -> (aabb_lo, aabb_hi, transform_inv, size)."""
    ext = np.asarray(extent_xyz, np.float32)
    lo, hi = np.zeros(3, np.float32), ext.copy()
    size = float(np.max(hi - lo))
    combined = np.eye(4, dtype=np.float32)
    if size != 1.0:
        s = np.eye(4, dtype=np.float32)
        s[0, 0] = s[1, 1] = s[2, 2] = 1.0 / size
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = -lo - (hi - lo) * 0.5
        combined = (s @ t).astype(np.float32)
    else:
        size = 1.0

    def world(p):
        h = combined @ np.append(np.asarray(p, np.float32), 1.0).astype(np.float32)
        return h[:3] / h[3]

    lo_w, hi_w = world([0.0, 0.0, 0.0]), world(ext)
    clip_lo, clip_hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    aabb_lo = lo_w + (hi_w - lo_w) * clip_lo
    aabb_hi = lo_w + (hi_w - lo_w) * clip_hi
    return aabb_lo, aabb_hi, np.linalg.inv(combined).astype(np.float32), size


def default_environment_image() -> np.ndarray:
    """environment.ts:94-120: 8x6 checker with a bright top third, row 0 at the top."""
    data = np.zeros((6, 8, 3), np.float32)
    for yy in range(6):
        for xx in range(8):
            light = ((xx + yy) & 1) == 0
            data[yy, xx, :] = (3.0 if light else 0.9) if yy < 2 else (0.1 if light else 0.0)
    return data


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """An antialiased linear (triangle) resize's (n_in, n_out) weights, in float64."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float64, device=device)[:, None]
    w = torch.clamp_min(1.0 - torch.abs(sample[None, :] - src) / kernel_scale, 0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def importance_pyramid(texture: torch.Tensor) -> list:
    """The environment's luma resized to 512^2 and mean-pooled to 1^2
    (environment.ts), each texel ((tl + tr) + (bl + br)) * 0.25."""
    rgb = texture
    lum = rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169
    out = lum.to(torch.float64)
    h, w = lum.shape
    if h != 512:
        out = _resize_weights(h, 512, lum.device).T @ out
    if w != 512:
        out = out @ _resize_weights(w, 512, lum.device)
    level = out.to(torch.float32)
    levels = [level]
    for _ in range(9):
        level = ((level[0::2, 0::2] + level[0::2, 1::2]) + (level[1::2, 0::2] + level[1::2, 1::2])) * 0.25
        levels.append(level)
    return levels


def _f16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float16).to(torch.float32)


def brick_field(data: torch.Tensor):
    """The brick grid of a normalised (Z, Y, X) volume, as the renderer
    reads it: per-brick min/max over the dilated [-2, 10)^3 window with
    zeros outside (brick.rs:99-112), rounded through float16; voxels
    quantized to 8 bits against those ranges (round half up) and decoded
    as lo + v / 255 * (hi - lo), rounded to bf16; the 2^3-pooled range
    mips, rounded through float16 per level. Returns (field (bz*8, by*8,
    bx*8) f32 of bf16 values, the (4, bz, by, bx) max pyramid upsampled
    to the finest bricks, the index extent (x, y, z) of whole bricks)."""
    ez, ey, ex = data.shape
    align = 1 << NUM_MIPS
    nb = [-(-(-(-n // BRICK)) // align) * align for n in (ez, ey, ex)]
    full = torch.zeros([b * BRICK for b in nb], dtype=torch.float32, device=data.device)
    full[:ez, :ey, :ex] = data
    padded = F.pad(full[None, None], (2, 2, 2, 2, 2, 2))
    raw_hi = F.max_pool3d(padded, BRICK + 4, BRICK)[0, 0]
    raw_lo = -F.max_pool3d(-padded, BRICK + 4, BRICK)[0, 0]
    del padded
    occupied = raw_lo != raw_hi
    lo, hi = _f16(raw_lo), _f16(raw_hi)

    def up(a):
        return a.repeat_interleave(BRICK, 0).repeat_interleave(BRICK, 1).repeat_interleave(BRICK, 2)

    lo_v, hi_v = up(lo), up(hi)
    width = hi_v - lo_v
    norm = torch.clamp((full - lo_v) / torch.where(width > 0, width, 1.0), 0.0, 1.0)
    enc = torch.floor(255.0 * torch.where(width > 0, norm, 0.0) + 0.5)
    enc = torch.where(up(occupied), enc, 0.0)
    del norm, full
    field = (lo_v + enc * float(np.float32(1.0 / 255.0)) * width).to(torch.bfloat16).to(torch.float32)
    del lo_v, hi_v, width, enc
    mips, src_lo, src_hi = [hi], lo, hi
    for level in range(NUM_MIPS):
        b = src_lo.shape
        src_lo = _f16(src_lo.reshape(b[0] // 2, 2, b[1] // 2, 2, b[2] // 2, 2).amin(dim=(1, 3, 5)))
        src_hi = _f16(src_hi.reshape(b[0] // 2, 2, b[1] // 2, 2, b[2] // 2, 2).amax(dim=(1, 3, 5)))
        f = 1 << (level + 1)
        mips.append(src_hi.repeat_interleave(f, 0).repeat_interleave(f, 1).repeat_interleave(f, 2))
    # the index extent is the bricks' (brick.rs:207-269), padding included
    return field, torch.stack(mips), (nb[2] * BRICK, nb[1] * BRICK, nb[0] * BRICK)


def reference_scene(config: dict, workload: dict, mode: str, data: torch.Tensor) -> dict:
    """The host description of the scene for reference.Scene, derived from
    the normalised volume `data` (on the device the reference runs on) and
    the configuration."""
    width, height = render_size(config, workload)
    s = settings(config, workload)
    field, maj_mips, extent = brick_field(data)
    aabb_lo, aabb_hi, tinv, size = placement(extent)
    scale = size * float(s["density_multiplier"])
    maj = 1.0 * scale  # the brick grid's majorant, 1, times the density scale
    lut = transfer_lut(config["transfer_stops"])
    sample_range = np.asarray(s["sample_range"], np.float32)
    dev = data.device
    lut_t = torch.from_numpy(lut).to(dev)
    density = (float(np.float32(scale)) * maj_mips) * float(np.float32(1.0 / maj))
    k = lut.shape[0]
    rejected = (density < float(sample_range[0])) | (density > float(sample_range[1]))
    alpha = torch.where(rejected, 0.0, lut_t[torch.clamp(torch.floor(density * k).to(torch.int64), 0, k - 1), 3])
    premul = float(np.float32(maj)) * alpha
    texture, _, strength = environment(config)
    texture = torch.from_numpy(texture).to(dev)
    inv_view, inv_proj = camera_matrices(config.get("camera", {}), width, height)
    light = np.asarray(s["light_dir"], np.float32)
    return {
        "field": field, "extent": extent, "maj": premul, "lut": lut, "envmap": texture,
        "imp": importance_pyramid(texture), "env_strength": np.float32(strength),
        "aabb_lo": aabb_lo, "aabb_hi": aabb_hi, "transform_inv": tinv,
        "vol_maj": np.float32(maj), "inv_maj": np.float32(1.0 / maj), "density_scale": np.float32(scale),
        "albedo": np.full(3, 0.9, np.float32), "phase_g": np.float32(0.0), "sample_range": sample_range,
        "inv_view": inv_view, "inv_proj": inv_proj, "light_dir": light, "width": width, "height": height,
        "settings": {"mode": mode, "bounces": int(s["bounces"]), "show_environment": bool(s["show_environment"]),
                     "use_env": bool(s["use_env"]), "gradient_shading": bool(s["gradient_shading"])},
    }


def port_renderer(config: dict, workload: dict, volume: torch.Tensor, device) -> tuple:
    """The program, set up for the configuration through its Renderer:
    the volume loaded (as a brick grid built from its normalised density,
    or as a DICOM ZIP through restart_from_zip), the environment, the
    camera, the transfer and the settings. Returns (renderer, seconds from
    the load's start to the grid decoded on the device, the same for the
    ZIP's ingest alone or None, seconds the harness took to encode the
    input file)."""
    from volxel_tpu_torch import Renderer
    from volxel_tpu_torch.grid import construct_brick_grid

    vol = config["volume"]
    r = Renderer(int(config["width"]), int(config["height"]), device=device)
    ingest_s, encode_s = None, 0.0
    if vol.get("load", "grid") == "zip":
        started = time.monotonic()
        data = dicom_zip(volume.to(torch.int32).cpu().numpy().astype(np.uint16), int(vol["bits_stored"]))
        encode_s = time.monotonic() - started
        started = time.monotonic()
        r.restart_from_zip(data)
        _fence(device)
        ingest_s = load_s = time.monotonic() - started
    else:
        data = normalised(volume).cpu().numpy()
        started = time.monotonic()
        r.restart_from_grid(construct_brick_grid(data, transform=np.eye(4, dtype=np.float32)))
        _fence(device)
        load_s = time.monotonic() - started
    del data
    _, env_bytes, strength = environment(config)
    if env_bytes is not None:
        r.load_env(env_bytes, strength=strength)
    camera = config.get("camera", {})
    if "pos" in camera:
        r.camera.pos = np.asarray(camera["pos"], np.float64)
        r.camera.view = np.asarray(camera["look_at"], np.float64)
    if "rotate_around_view" in camera:
        r.camera.rotate_around_view(*camera["rotate_around_view"])
    if "zoom" in camera:
        r.camera.zoom(camera["zoom"])
    r.set_transfer_colors(config["transfer_stops"])
    for key, value in {**config["settings"], **workload.get("settings", {})}.items():
        setattr(r.settings, key, value)
    r.settings.max_samples = 10 ** 9
    r.render_mode = workload["modes"][0]
    return r, load_s, ingest_s, encode_s


def _fence(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def lanes_in_box(scene, frame: int) -> int:
    """The camera rays of `frame` that start a camera leg (inside the box)."""
    pixels = torch.arange(scene.width * scene.height, dtype=torch.int64, device=scene.device)
    return int(scene.in_box(pixels, torch.full_like(pixels, frame)).sum())


FIELD_BYTES_PER_VOXEL = 2  # the field is read as bf16


def reachable_bricks(scene) -> torch.Tensor:
    """Which 8^3 bricks of the volume's extent the frame's camera rays can
    reach, as a (bz, by, bx) mask: those whose corners project onto the
    image, or lie on both sides of the camera's plane. In the default mode
    only those whose finest majorant is above 0, since the DDA steps over
    the others without a tap; the other modes tap wherever their rays go."""
    dev = scene.device
    ext = torch.tensor(scene.extent, dtype=torch.float64, device=dev)  # x, y, z
    nb = [-(-e // BRICK) for e in scene.extent]
    grids = torch.meshgrid(*[torch.arange(n, dtype=torch.float64, device=dev) for n in reversed(nb)], indexing="ij")
    lo = torch.stack(grids[::-1], dim=-1).reshape(-1, 3) * BRICK  # (bricks, 3) xyz, z outermost
    corners = torch.tensor([[dx, dy, dz] for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)],
                           dtype=torch.float64, device=dev) * BRICK
    pts = torch.minimum(lo[:, None, :] + corners, ext)
    to_world = torch.linalg.inv(scene.tinv.to(torch.float64))
    to_clip = torch.linalg.inv(scene.inv_proj.to(torch.float64)) @ torch.linalg.inv(scene.inv_view.to(torch.float64))
    clip = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1) @ (to_clip @ to_world).T
    w = clip[..., 3]
    ahead = w > 0
    ndc = clip[..., :2] / torch.where(ahead, w, 1.0)[..., None]
    on_image = ahead.all(dim=1) & (ndc.amin(dim=1) <= 1.0).all(dim=1) & (ndc.amax(dim=1) >= -1.0).all(dim=1)
    reach = ((ahead.any(dim=1) & ~ahead.all(dim=1)) | on_image).reshape(nb[2], nb[1], nb[0])
    if scene.mode == "default":
        reach &= scene.maj[0, :nb[2], :nb[1], :nb[0]] > 0
    return reach


def reachable_field_bytes(scene) -> int:
    """Bytes of the field in the bricks that the frame's camera rays can
    reach (`reachable_bricks`): a camera call that reaches a brick reads it
    at least once."""
    ext = scene.extent
    reach = reachable_bricks(scene)
    voxels = 1
    for axis, e in enumerate(ext):  # x, y, z: each brick's span, cut at the extent
        span = torch.clamp(e - torch.arange(reach.shape[2 - axis], device=reach.device) * BRICK, max=BRICK)
        voxels = voxels * span.reshape([-1 if k == 2 - axis else 1 for k in range(3)])
    return int((voxels * reach).sum().item()) * FIELD_BYTES_PER_VOXEL
