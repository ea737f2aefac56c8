"""Seeded operands for the port's collision step (render/collide.py), the
default-mode legs (render/ddaleg.py) and the no_dda legs
(render/trackleg.py), shared by tests/test_torch_collide.py and
tests/test_torch_trackleg.py (CPU) and tests/test_torch_cuda.py (card).
Imports neither JAX nor volxel_tpu."""

from __future__ import annotations

import numpy as np
import torch

from volxel_tpu_torch.render.pyrmarch import KIND_COLL, KIND_DONE, KIND_IDLE
from volxel_tpu_torch.render.rng import seed_rays

SIDE = 12
EXTENT = (SIDE, SIDE - 1, SIDE - 2)  # short of the dense field in y and z: those taps read 0
VOL_MAJ = 1.5


def collide_lanes(device, n=4096, seed=31, alpha=None, sample_range=(0.05, 0.9), maj=None, edge_cases=False):
    """(dense, extent, scalars, lut, ipos, idir, t, maj, kind, state, tau,
    mip, running) for `n` lanes through a random 12^3 bf16 field, then the
    sample leg's (hit, rgb) and the shadow leg's tr.

    Lanes are running or not and parked (KIND_COLL), done or idle at
    random; positions reach past the extent on every side. `alpha` fixes
    the LUT's alpha column, `maj` every lane's majorant. With `edge_cases`
    the first 24 lanes are parked and running: some positions are NaN or
    +-inf, some lie on lattice points (trilinear weights exactly 0 and 1),
    some majorants are 0, NaN, 1e-30 or negative, some tr sit at the
    russian-roulette threshold or are NaN; and a LUT row is NaN."""
    rng = np.random.default_rng(seed)
    dense = torch.from_numpy(rng.random((SIDE,) * 3, dtype=np.float32)).to(torch.bfloat16)
    lut = rng.uniform(0.05, 1.0, (8, 4)).astype(np.float32)
    if alpha is not None:
        lut[:, 3] = alpha
    if edge_cases:
        lut[5] = np.nan
    inv_maj = np.float32(1.0) / np.float32(VOL_MAJ)
    scalars = np.array([inv_maj, VOL_MAJ, 1.0, *sample_range], dtype=np.float32)
    ipos = rng.uniform(-2.0, SIDE + 2.0, (n, 3)).astype(np.float32)
    idir = rng.normal(size=(n, 3)).astype(np.float32)
    idir /= np.linalg.norm(idir, axis=-1, keepdims=True)
    t = rng.uniform(0.0, 2.0, n).astype(np.float32)
    majorant = rng.uniform(0.3, 4.0, n).astype(np.float32) if maj is None else np.full(n, maj, np.float32)
    kind = rng.choice([KIND_IDLE, KIND_COLL, KIND_COLL, KIND_COLL, KIND_DONE], n).astype(np.int32)
    running = rng.random(n) < 0.85
    tau = rng.uniform(0.0, 3.0, n).astype(np.float32)
    mip = (rng.integers(0, 13, n) * 0.25).astype(np.float32)
    tr = rng.uniform(0.0, 1.0, n).astype(np.float32)
    if edge_cases:
        ipos[0:3, 0] = [np.nan, np.inf, -np.inf]
        t[3] = np.nan
        majorant[4:8] = [0.0, np.nan, 1e-30, -1.0]
        ipos[8:16] = np.floor(ipos[8:16]) + 0.5
        t[8:16] = 0.0
        tr[16:24] = [0.0, 1e-30, 0.1, np.float32(0.1) * (1 + 2**-23), 1.0, np.nan, 0.05, 0.0999]
        kind[:24] = KIND_COLL
        running[:24] = True

    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return dict(
        dense=dense.to(device), extent=EXTENT, scalars=dev(scalars), lut=dev(lut), ipos=dev(ipos), idir=dev(idir),
        t=dev(t), maj=dev(majorant), kind=dev(kind), state=seed_rays(torch.arange(n, dtype=torch.int64), 7).to(device),
        tau=dev(tau), mip=dev(mip), running=dev(running), hit=torch.zeros(n, dtype=torch.bool, device=device),
        rgb=torch.ones((n, 3), dtype=torch.float32, device=device), tr=dev(tr),
    )


SAMPLE_ARGS = ("dense", "extent", "scalars", "lut", "ipos", "idir", "t", "maj", "kind", "state", "tau", "mip",
               "running", "hit", "rgb")
SHADOW_ARGS = SAMPLE_ARGS[:-2] + ("tr",)


def leg_args(lanes, leg):
    """The operands of dda_collide_sample (leg "sample") or
    dda_collide_shadow (leg "shadow"), mutable ones cloned."""
    names = SAMPLE_ARGS if leg == "sample" else SHADOW_ARGS
    return [lanes[k].clone() if isinstance(lanes[k], torch.Tensor) and k not in ("dense", "lut", "scalars") else
            lanes[k] for k in names]


LEG_ARGS = ("dense", "maj_alpha", "extent", "scalars", "lut", "ipos", "idir", "ri", "far", "t", "tau", "mip", "state",
            "running")


def leg_lanes(device, n=1024, seed=41, alpha=None, sample_range=(0.05, 0.9), maj=None, far=None, edge_cases=False):
    """The operands of ddaleg.dda_leg_sample (LEG_ARGS) and the shadow
    leg's tr for `n` lanes through tests' random 12^3 bf16 field and a
    random (4, 2, 2, 2) premultiplied pyramid.

    Lanes start anywhere within 2 voxels of the field, at t in [0, 2) with
    a box exit 1 to 40 further on (`far`, when given, for every lane), at a
    random mip; 85% of them run. `alpha` fixes the LUT's alpha column, `maj`
    every majorant of the pyramid. With `edge_cases` the first 16 lanes
    run: some positions or starts are NaN or +-inf, some lie 2e12 voxels
    out, some start on lattice points; Tr sits at the roulette threshold
    or is NaN; and pyramid cells hold 0, 1e-30, +inf and a negative
    majorant."""
    rng = np.random.default_rng(seed)
    dense = torch.from_numpy(rng.random((SIDE,) * 3, dtype=np.float32)).to(torch.bfloat16)
    lut = rng.uniform(0.05, 1.0, (8, 4)).astype(np.float32)
    if alpha is not None:
        lut[:, 3] = alpha
    pyramid = rng.uniform(0.3, 4.0, (4, 2, 2, 2)).astype(np.float32)
    if maj is not None:
        pyramid[:] = maj
    inv_maj = np.float32(1.0) / np.float32(VOL_MAJ)
    scalars = np.array([inv_maj, VOL_MAJ, 1.0, *sample_range], dtype=np.float32)
    ipos = rng.uniform(-2.0, SIDE + 2.0, (n, 3)).astype(np.float32)
    idir = rng.normal(size=(n, 3)).astype(np.float32)
    idir /= np.linalg.norm(idir, axis=-1, keepdims=True)
    t = rng.uniform(0.0, 2.0, n).astype(np.float32)
    exit_ = t + rng.uniform(1.0, 40.0, n).astype(np.float32) if far is None else np.full(n, far, np.float32)
    tau = (-np.log1p(-rng.random(n))).astype(np.float32)
    mip = (rng.integers(0, 13, n) * 0.25).astype(np.float32)
    running = rng.random(n) < 0.85
    tr = rng.uniform(0.0, 1.0, n).astype(np.float32)
    if edge_cases:
        ipos[0:3, 0] = [np.nan, np.inf, -np.inf]
        t[3] = np.nan
        ipos[4, 0], ipos[5, 1] = 2e12, -2e12
        ipos[6:10] = np.floor(ipos[6:10]) + 0.5
        t[6:10] = 0.0
        tr[8:16] = [0.0, 1e-30, 0.1, np.float32(0.1) * (1 + 2**-23), 1.0, np.nan, 0.05, 0.0999]
        running[:16] = True
        pyramid[0, 0, 0, 0], pyramid[1, 1, 0, 1], pyramid[2, 0, 1, 1], pyramid[0, 1, 1, 0] = 0.0, 1e-30, np.inf, -1.0

    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return dict(
        dense=dense.to(device), maj_alpha=dev(pyramid), extent=EXTENT, scalars=dev(scalars), lut=dev(lut),
        ipos=dev(ipos), idir=dev(idir), ri=dev(np.float32(1.0) / idir), far=dev(exit_), t=dev(t), tau=dev(tau),
        mip=dev(mip), state=seed_rays(torch.arange(n, dtype=torch.int64), 9).to(device), running=dev(running),
        tr=dev(tr),
    )


def leg_call(lanes, leg):
    """The positional operands of dda_leg_sample (leg "sample") or
    dda_leg_shadow (leg "shadow" or "physical")."""
    args = [lanes[k] for k in LEG_ARGS]
    return args if leg == "sample" else args + [lanes["tr"], leg == "physical"]


TRACK_ARGS = ("dense", "extent", "scalars", "lut", "ipos", "idir", "far", "t", "state", "running")


def track_lanes(device, n=1024, seed=51, alpha=None, sample_range=(0.05, 0.9), far=None, edge_cases=False):
    """The operands of trackleg.track_leg_sample (TRACK_ARGS) and the shadow
    leg's tr for `n` lanes through tests' random 12^3 bf16 field, tracked
    against the global majorant VOL_MAJ.

    Lanes start anywhere within 2 voxels of the field, at t in [0, 2), with
    a box exit from 0.5 before the start to 40 after it (`far`, when
    given, for every lane), so some running lanes start at or past their
    exit; 85% of them run. `alpha` fixes the LUT's alpha column. With
    `edge_cases` the first 16 lanes run: some positions, starts or exits
    are NaN or +-inf, some lie 2e12 voxels out, some start on lattice
    points, some start exactly at their exit; Tr sits at the roulette
    threshold or is NaN."""
    rng = np.random.default_rng(seed)
    dense = torch.from_numpy(rng.random((SIDE,) * 3, dtype=np.float32)).to(torch.bfloat16)
    lut = rng.uniform(0.05, 1.0, (8, 4)).astype(np.float32)
    if alpha is not None:
        lut[:, 3] = alpha
    inv_maj = np.float32(1.0) / np.float32(VOL_MAJ)
    scalars = np.array([inv_maj, VOL_MAJ, 1.0, *sample_range], dtype=np.float32)
    ipos = rng.uniform(-2.0, SIDE + 2.0, (n, 3)).astype(np.float32)
    idir = rng.normal(size=(n, 3)).astype(np.float32)
    idir /= np.linalg.norm(idir, axis=-1, keepdims=True)
    t = rng.uniform(0.0, 2.0, n).astype(np.float32)
    exit_ = t + rng.uniform(-0.5, 40.0, n).astype(np.float32) if far is None else np.full(n, far, np.float32)
    running = rng.random(n) < 0.85
    tr = rng.uniform(0.0, 1.0, n).astype(np.float32)
    if edge_cases:
        ipos[0:3, 0] = [np.nan, np.inf, -np.inf]
        t[3], exit_[4], exit_[5] = np.nan, np.nan, np.inf
        ipos[6, 0], ipos[7, 1] = 2e12, -2e12
        ipos[8:12] = np.floor(ipos[8:12]) + 0.5
        t[8:12] = 0.0
        exit_[12:14] = t[12:14]
        tr[8:16] = [0.0, 1e-30, 0.1, np.float32(0.1) * (1 + 2**-23), 1.0, np.nan, 0.05, 0.0999]
        running[:16] = True

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return dict(
        dense=dense.to(device), extent=EXTENT, scalars=dev(scalars), lut=dev(lut), ipos=dev(ipos), idir=dev(idir),
        far=dev(exit_), t=dev(t), state=seed_rays(torch.arange(n, dtype=torch.int64), 5).to(device),
        running=dev(running), tr=dev(tr),
    )


def select_lanes(lanes, idx):
    """The lanes at `idx` of a track_lanes or leg_lanes dict (the field, the
    pyramid, the LUT and the scalars are shared)."""
    shared = ("dense", "maj_alpha", "lut", "scalars")
    return {k: v[idx] if isinstance(v, torch.Tensor) and v.dim() and k not in shared else v
            for k, v in lanes.items()}


def track_call(lanes, leg):
    """The positional operands of track_leg_sample (leg "sample") or
    track_leg_shadow (leg "shadow")."""
    args = [lanes[k] for k in TRACK_ARGS]
    return args if leg == "sample" else args + [lanes["tr"]]


def _words_key(row) -> tuple:
    return tuple(int(w) for w in row)


def shadow_leg_draws(args):
    """The plain shadow leg (trackleg.track_leg_shadow_plain) on `args`, and
    per lane the roulette draws it made and whether a roulette draw killed
    the lane. The leg draws through trackleg.rng_where twice an event: first
    where tr < 0.1 (the roulette), then where the lane was not killed (the
    free flight). Each drawn row is matched to its lane by the lane's
    current words (every lane's words are its own)."""
    from volxel_tpu_torch.render import trackleg

    state = args[8]
    n = state.shape[0]
    lane_of = {_words_key(row): i for i, row in enumerate(state.tolist())}
    roulette = torch.zeros(n, dtype=torch.int64)
    killed = torch.zeros(n, dtype=torch.bool)
    calls = [0]
    original = trackleg.rng_where

    def counting(mask, words):
        lanes = [lane_of.pop(_words_key(row)) for row in words.tolist()]
        idx = torch.tensor(lanes, dtype=torch.int64)
        out, xi = original(mask, words)
        if calls[0] % 2 == 0:
            roulette[idx] += mask.cpu().to(torch.int64)
        else:
            killed[idx] |= ~mask.cpu()
        calls[0] += 1
        lane_of.update({_words_key(row): i for i, row in zip(lanes, out.tolist())})
        return out, xi

    trackleg.rng_where = counting
    try:
        out = trackleg.track_leg_shadow_plain(*args)
    finally:
        trackleg.rng_where = original
    return out, roulette, killed


def advance_words(state, draws):
    """Each lane's xoshiro words advanced by its own number of draws."""
    from volxel_tpu_torch.render.rng import next_u32

    words = state.clone()
    for k in range(int(draws.max()) if draws.numel() else 0):
        stepped, _ = next_u32(words)
        words = torch.where((k < draws)[:, None], stepped, words)
    return words


FIELD_END_SHAPE = (5, 7, 9)  # (Z, Y, X): odd nx, and an odd count of elements


def field_end_lanes(device, n=2048, seed=61):
    """track_lanes' operands for `n` lanes that start in the last voxels of a
    seeded (5, 7, 9) bf16 field whose extent is the whole field (ex == nx,
    nx odd, 315 elements): their first taps straddle the last x column, the
    last rows and the field's final element. Directions are seeded unit
    vectors, starts t in [0, 0.3), exits 0.5 to 6 further; tr in (0, 1)."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = FIELD_END_SHAPE
    lanes = track_lanes(device, n=n, seed=seed)
    dense = torch.from_numpy(rng.random(FIELD_END_SHAPE, dtype=np.float32)).to(torch.bfloat16)
    ipos = np.stack([rng.uniform(d - 1.5, d + 0.5, n) for d in (nx, ny, nz)], axis=-1).astype(np.float32)
    idir = rng.normal(size=(n, 3)).astype(np.float32)
    idir /= np.linalg.norm(idir, axis=-1, keepdims=True)
    t = rng.uniform(0.0, 0.3, n).astype(np.float32)
    far = t + rng.uniform(0.5, 6.0, n).astype(np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    lanes.update(dense=dense.to(device), extent=(nx, ny, nz), ipos=dev(ipos), idir=dev(idir), t=dev(t), far=dev(far))
    return lanes


def pyramid_lanes(side, n=1024, seed=81, scale=1.0):
    """ddaleg.dda_leg_sample's operands (LEG_ARGS) and the shadow leg's tr
    for `n` lanes through the brick grid of a seeded side^3 synthetic CT
    volume: its decoded bf16 field and its stacked majorant pyramid
    (sampling.build_majorant_pyramid) times `scale`, which stands in for the
    premultiplied one (any f32 values are a pyramid to the march).

    Lanes start anywhere in the volume (the grid's index extent is padded
    to whole 64-voxel blocks of bricks), at t in [0, 2), with a box exit 4
    to 2 * side further on, a tau drawn as the legs draw it and a random
    mip; 85% of them run. The bench's LUT shape (64 rows) and
    sample range; tr in (0, 1)."""
    from volxel_tpu_torch.grid import construct_brick_grid
    from volxel_tpu_torch.render.sampling import build_majorant_pyramid, device_grid_from_brick
    from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

    rng = np.random.default_rng(seed)
    vol = synthetic_ct_volume((side,) * 3, bits_stored=12, seed=seed)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    dense = device_grid_from_brick(grid, "cpu").dense
    pyramid = (build_majorant_pyramid(grid) * np.float32(scale)).astype(np.float32)
    extent = tuple(int(v) for v in grid.index_extent)
    lut = rng.uniform(0.05, 1.0, (64, 4)).astype(np.float32)
    inv_maj = np.float32(1.0) / np.float32(VOL_MAJ)
    scalars = np.array([inv_maj, VOL_MAJ, 1.0, 0.0564, 1.0], dtype=np.float32)
    ipos = rng.uniform(0.0, side, (n, 3)).astype(np.float32)
    idir = rng.normal(size=(n, 3)).astype(np.float32)
    idir /= np.linalg.norm(idir, axis=-1, keepdims=True)
    t = rng.uniform(0.0, 2.0, n).astype(np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return dict(
        dense=dense, maj_alpha=dev(pyramid), extent=extent, scalars=dev(scalars), lut=dev(lut), ipos=dev(ipos),
        idir=dev(idir), ri=dev(np.float32(1.0) / idir), far=dev(t + rng.uniform(4.0, 2.0 * side, n).astype(np.float32)),
        t=dev(t), tau=dev((-np.log1p(-rng.random(n))).astype(np.float32)),
        mip=dev((rng.integers(0, 13, n) * 0.25).astype(np.float32)),
        state=seed_rays(torch.arange(n, dtype=torch.int64), 11), running=dev(rng.random(n) < 0.85),
        tr=dev(rng.uniform(0.0, 1.0, n).astype(np.float32)),
    )


def dda_lanes_of(lanes, maj, seed=0):
    """A track_lanes dict (field_end_lanes' among them) made into
    leg_lanes' operands: a pyramid that covers its extent with `maj` in
    every cell (a large one puts each lane's first collision within a
    fraction of a voxel of its start), 1 / idir, a tau drawn as the legs
    draw it and a random mip."""
    rng = np.random.default_rng(seed)
    ex, ey, ez = lanes["extent"]
    device = lanes["t"].device
    n = lanes["t"].shape[0]
    pyramid = torch.full((4, -(-ez // 8), -(-ey // 8), -(-ex // 8)), maj, dtype=torch.float32, device=device)
    tau = torch.from_numpy((-np.log1p(-rng.random(n))).astype(np.float32)).to(device)
    mip = torch.from_numpy((rng.integers(0, 13, n) * 0.25).astype(np.float32)).to(device)
    return {**lanes, "maj_alpha": pyramid, "ri": 1.0 / lanes["idir"], "tau": tau, "mip": mip}
