"""Seeded operands for the port's collision step (render/collide.py), shared
by tests/test_torch_collide.py (CPU) and tests/test_torch_cuda.py (card).
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
