"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests import neither JAX nor volxel_tpu, so they also run on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card the tests marked `cuda` skip (a CUDA kernel has no CPU
mode). Tolerances: the tile-march kernels, the shear-warp intermediate and
both table fetches are bit-equal (the library is built with --fmad=false
and each kernel follows its plain version's operation order), and so are
both default-mode legs, both no_dda legs and the tonemap (built with
--fmad=true so that logf and powf round as ATen's log and pow do, with
every other f32 operation written as a never-contracted intrinsic), and
the pyramid (its plain version sums each 2x2 block in the kernel's order).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from tests.torch_lanes import (VOL_MAJ, dda_lanes_of, field_end_lanes, leg_call, leg_lanes, select_lanes,
                               shadow_leg_draws, track_call, track_lanes)
from volxel_tpu_torch import Renderer, kernels
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.render import ddaleg, gather, modes, pallas_ops, shearwarp, tilemarch, trackleg
from volxel_tpu_torch.render.modes import _march_setup, _tracking_setup, raymarch_prologue
from volxel_tpu_torch.render.pathtrace import camera_wavefront, with_premul_majorant
from volxel_tpu_torch.render.rng import seed_rays
from volxel_tpu_torch.render.sampling import DeviceGrid, VolumeParams
from volxel_tpu_torch.render.tilemarch import volume_scalars
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _renderer(device, side=48):
    vol = synthetic_ct_volume((32, 32, 32), bits_stored=12)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    r = Renderer(side, side, device=device)
    r.restart_from_grid(grid)
    return r


def _scene_leg_args(r, leg: str):
    """The arguments of dda_leg_sample (leg "sample") or dda_leg_shadow
    (leg "shadow" or "physical") for the camera lanes of the 32^3 scene,
    half of them moved to seeded mid-march states."""
    config = r._config()
    params = r.volume_params()
    grid = with_premul_majorant(config, r._device_grid, params, r._lut)
    inv_view, inv_proj, _ = r._camera_operands(config)
    n = config.width * config.height
    pixels = torch.arange(n, dtype=torch.int64, device=r.device)
    state, rays = camera_wavefront(config, inv_view, inv_proj, pixels, 0)
    active = torch.ones(n, dtype=torch.bool, device=r.device)
    state, ipos, idir, ri, far, t, tau, mip, running = _march_setup(
        grid, params, rays.origin, rays.direction, state, active
    )
    rng = np.random.default_rng(4)
    mid = torch.from_numpy(rng.random(n) < 0.5).to(r.device)
    u = torch.from_numpy(rng.random(n, dtype=np.float32)).to(r.device)
    t = torch.where(mid & running, t + u * (far - t), t)
    mip = torch.where(mid, torch.from_numpy(rng.integers(0, 13, n).astype(np.float32) * 0.25).to(r.device), mip)
    args = [grid.dense, grid.maj_alpha, grid.extent, volume_scalars(params), r._lut, ipos, idir, ri, far, t,
            tau, mip, state, running]
    return args if leg == "sample" else args + [torch.ones_like(t), leg == "physical"]


def _scene_track_args(r, leg: str):
    """The arguments of track_leg_sample (leg "sample") or track_leg_shadow
    (leg "shadow") for the camera lanes of the 32^3 scene after the no_dda
    setup, half of them moved to seeded points further along their ray."""
    config = r._config()
    params = r.volume_params()
    inv_view, inv_proj, _ = r._camera_operands(config)
    n = config.width * config.height
    pixels = torch.arange(n, dtype=torch.int64, device=r.device)
    state, rays = camera_wavefront(config, inv_view, inv_proj, pixels, 0)
    active = torch.ones(n, dtype=torch.bool, device=r.device)
    state, ipos, idir, far, t, running = _tracking_setup(params, rays.origin, rays.direction, state, active)
    rng = np.random.default_rng(5)
    mid = torch.from_numpy(rng.random(n) < 0.5).to(r.device)
    u = torch.from_numpy(rng.random(n, dtype=np.float32)).to(r.device)
    t = torch.where(mid & running, t + u * (far - t), t)
    args = [r._device_grid.dense, r._device_grid.extent, volume_scalars(params), r._lut, ipos, idir, far, t, state,
            running]
    return args if leg == "sample" else args + [torch.ones_like(t)]


def _tile_march_args(device, n=2048, side=64, nan_lanes=False):
    """tile_march_sample's arguments for 2048 seeded rays through a random
    64^3 field, after the raymarch prologue. About a fifth of the rays miss
    the box, 5% are inactive, and the index extent stops short of the field
    in x and y, so taps at the box's faces and past the extent read 0. With
    `nan_lanes` the first lanes are valid but have a NaN position, start or
    box exit, or a position far past the extent (where the int conversion
    saturates, the cubic weights grow huge or NaN and a quotient of the
    reservoir overflows)."""
    rng = np.random.default_rng(8)
    dense = torch.from_numpy(rng.random((side,) * 3, dtype=np.float32) * 0.9).to(torch.bfloat16)
    grid = DeviceGrid(dense=dense.to(device), maj_mips=None, extent=(side - 5, side - 2, side))

    def f32(*v):
        return torch.tensor(v if len(v) > 1 else v[0], dtype=torch.float32, device=device)

    params = VolumeParams(
        aabb_lo=f32(0.0, 0.0, 0.0), aabb_hi=f32(side, side, side),
        transform_inv=torch.eye(4, dtype=torch.float32, device=device),
        vol_min=f32(0.0), vol_maj=f32(1.2), inv_maj=f32(1 / 1.2), density_scale=f32(1.0),
        albedo=f32(0.9, 0.9, 0.9), phase_g=f32(0.0), sample_range=f32(0.02, 0.98),
    )
    lut = torch.from_numpy(rng.random((128, 4), dtype=np.float32)).to(device)
    origin = (side / 2 + rng.normal(size=(n, 3)) * side).astype(np.float32)
    target = (rng.random((n, 3)) * 1.4 - 0.2) * side
    d = (target - origin).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    active = torch.from_numpy(rng.random(n) > 0.05).to(device)
    state = seed_rays(torch.arange(n, dtype=torch.int64, device=device), 2)
    args = raymarch_prologue(grid, params, lut, torch.from_numpy(origin).to(device), torch.from_numpy(d).to(device),
                             state, active)
    if nan_lanes:
        ipos, start, far, valid = (a.clone() for a in (args[1], args[3], args[5], args[6]))
        ipos[0, 0], start[1], far[2], ipos[3] = float("nan"), float("nan"), float("nan"), 1e30
        ipos[4, 0], ipos[5, 1] = 2e12, -2e12
        valid[:6] = True
        args = (args[0], ipos, args[2], start, args[4], far, valid, *args[7:])
    return args


def _sums_args(args):
    dense, ipos, idir, start, dt, far, valid, _, _, _, _, extent = args
    return dense, ipos, idir, start, dt, far, valid, extent, tilemarch.STEPS


def _transmittance_args(args):
    """tile_march_transmittance's arguments from tile_march_sample's (no tau
    target)."""
    dense, ipos, idir, start, dt, far, valid, _, state, lut, scalars, extent = args
    return dense, ipos, idir, start, dt, far, valid, state, lut, scalars, extent


def _shearwarp_args(device, view_dir, shape=(40, 24, 32)):
    """A seeded bf16 (Z, Y, X) volume with densities past the LUT's range,
    a LUT whose row 0 is not zero (a tap outside the slice must not read
    it), and the shear of `view_dir`."""
    rng = np.random.default_rng(11)
    vol = torch.from_numpy(rng.uniform(-0.1, 1.3, shape).astype(np.float32)).to(torch.bfloat16)
    lut = torch.from_numpy(rng.uniform(0.05, 2.0, (128, 4)).astype(np.float32))
    _, _, sx, sy = shearwarp.shear_parameters(view_dir)
    return vol.to(device), lut.to(device), sx, sy, 1 / 1.1, 1.7 * float(np.sqrt(1 + sx * sx + sy * sy))


def _random_words(n, seed=12):
    """f32 values from random 32-bit words (NaN payloads, denormals) with
    +-inf, +-0 and NaNs of both signs mixed in."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    bits[:8] = [0x7F800000, 0xFF800000, 0, 0x80000000, 0x7FC00000, 0xFFC00001, 1, 0x807FFFFF]
    return torch.from_numpy(bits.view(np.float32).copy())


def _assert_bits_equal(got, want):
    for a, b in zip(got, want):
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def test_tile_march_scene_covers_its_cases():
    """The card tests' lanes (built here on the CPU) miss the box, hit,
    march through, and tap past the extent."""
    args = _tile_march_args("cpu")
    valid = args[6]
    assert 0.05 < (~valid).float().mean() < 0.5
    _, hit, _, _ = tilemarch.tile_march_sample(*args)
    assert 0.1 < hit.float().mean() < 0.9
    sums = tilemarch.tile_march_sums(*_sums_args(args))
    assert (sums[valid] > 0).float().mean() > 0.5 and (sums[~valid] == 0).all()


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper called with CPU tensors raises instead of running anything."""
    r = _renderer("cpu", side=8)
    with pytest.raises(ValueError, match="CUDA"):
        ddaleg.dda_leg_sample_cuda(*_scene_leg_args(r, "sample"))
    with pytest.raises(ValueError, match="CUDA"):
        ddaleg.dda_leg_shadow_cuda(*_scene_leg_args(r, "shadow"))
    with pytest.raises(ValueError, match="CUDA"):
        pallas_ops.build_importance_pyramid_cuda(r.environment.state.imp_mips[0])
    with pytest.raises(ValueError, match="CUDA"):
        trackleg.track_leg_sample_cuda(*_scene_track_args(r, "sample"))
    with pytest.raises(ValueError, match="CUDA"):
        trackleg.track_leg_shadow_cuda(*track_call(track_lanes("cpu", n=64), "shadow"))
    with pytest.raises(ValueError, match="CUDA"):
        pallas_ops.tonemap_cuda(torch.zeros((4, 3)), 1.0, 2.2)
    with pytest.raises(ValueError, match="CUDA"):
        pallas_ops.copy16(torch.zeros((4, 3)))
    args = _tile_march_args("cpu", n=64)
    with pytest.raises(ValueError, match="CUDA"):
        tilemarch.tile_march_sample_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        tilemarch.tile_march_sums_cuda(*_sums_args(args))
    with pytest.raises(ValueError, match="CUDA"):
        tilemarch.tile_march_transmittance_cuda(*_transmittance_args(args))
    with pytest.raises(ValueError, match="CUDA"):
        ddaleg.dda_leg_shadow_cuda(*leg_call(leg_lanes("cpu", n=64), "physical"))
    with pytest.raises(ValueError, match="CUDA"):
        ddaleg.neg_log1m_cuda(torch.zeros(4))
    with pytest.raises(ValueError, match="CUDA"):
        shearwarp.shearwarp_intermediate_cuda(*_shearwarp_args("cpu", [0.2, 0.3, 0.9]), fixed_canvas=True)
    with pytest.raises(ValueError, match="CUDA"):
        gather.gather_f32_cuda(torch.zeros(8), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        gather.lookup_transfer_cuda(torch.zeros((128, 4)), torch.tensor([0.0, 1.0]), torch.zeros(16))


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result when there is no
    CUDA device; on a card it is the end-to-end run itself, not this test."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("leg", ["sample", "shadow", "physical"])
def test_march_kernel_bit_equal_to_plain(cuda_device, leg):
    """Both leg kernels (the march with its collisions) against their plain
    legs on every output of the 32^3 scene's camera lanes, half of them
    starting mid-march; the inputs are left as they are."""
    args = _scene_leg_args(_renderer(cuda_device), leg)
    before = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    cuda_fn = ddaleg.dda_leg_sample_cuda if leg == "sample" else ddaleg.dda_leg_shadow_cuda
    plain_fn = ddaleg.dda_leg_sample_plain if leg == "sample" else ddaleg.dda_leg_shadow_plain
    got = cuda_fn(*args)
    _assert_bits_equal(got, plain_fn(*args))
    _assert_bits_equal([a for a in args if isinstance(a, torch.Tensor)],
                       [a for a in before if isinstance(a, torch.Tensor)])
    assert not torch.equal(got[0], args[12]) and (got[-1] < got[-1].max()).any()


@pytest.mark.cuda
def test_tile_march_sample_kernel_bit_equal_to_plain(cuda_device):
    """Every output of every lane; lanes outside the box keep their words;
    valid lanes with NaN or far-off positions."""
    args = _tile_march_args(cuda_device, nan_lanes=True)
    got = tilemarch.tile_march_sample_cuda(*args)
    _assert_bits_equal(got, tilemarch.tile_march_sample_plain(*args))
    valid = args[6]
    assert torch.equal(got[0][~valid], args[8][~valid]) and not torch.equal(got[0][valid], args[8][valid])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 77])
def test_tile_march_transmittance_kernel_bit_equal_to_plain(cuda_device, n):
    """State and tau of every lane (0 outside the box), valid lanes with NaN
    or far-off positions among them, at a lane count that fills no claim of
    128 lanes too."""
    args = _tile_march_args(cuda_device, n=n, nan_lanes=True)
    got = tilemarch.tile_march_transmittance_cuda(*_transmittance_args(args))
    _assert_bits_equal(got, tilemarch.tile_march_transmittance_plain(*_transmittance_args(args)))
    assert (got[1][~args[6]] == 0).all() and (got[1][args[6]] > 0).any()


def _lanes_where(args, valid, n):
    """The first `n` lanes of tile_march_sample's arguments `args`, with
    `valid` (of those n lanes) in place of theirs."""
    per_lane = [a[:n].contiguous() for a in args[1:6]]
    return (args[0], *per_lane, valid, args[7][:n].contiguous(), args[8][:n].contiguous(), *args[9:])


def _leg_fns(leg):
    """The kernel's wrapper, its plain version and the call's arguments
    (from tile_march_sample's) of a step loop ("sample" or "shadow")."""
    if leg == "sample":
        return tilemarch.tile_march_sample_cuda, tilemarch.tile_march_sample_plain, lambda args: args
    return tilemarch.tile_march_transmittance_cuda, tilemarch.tile_march_transmittance_plain, _transmittance_args


@pytest.mark.cuda
@pytest.mark.parametrize("leg", ["sample", "shadow"])
@pytest.mark.parametrize("case", ["all", "none", "one_per_warp", "nan"])
@pytest.mark.parametrize("n", [1, 77, 2048])
def test_tile_march_kernel_lane_cases(cuda_device, leg, case, n):
    """Each step loop bit-equal to its plain version on every output of
    every lane with every lane inside the box (lanes that miss it march
    from wherever their start and box exit put them), none inside, one
    inside lane in each warp of 32 (at a place that moves from warp to
    warp), and the NaN and far-off lanes of _tile_march_args among the
    others; the words of the lanes outside are handed back unchanged, with
    tau 0 (the shadow leg) or no hit, t 0 and colour 1 (the camera leg)."""
    cuda_fn, plain_fn, leg_args = _leg_fns(leg)
    args = _tile_march_args(cuda_device, n=max(n, 8), nan_lanes=case == "nan")
    lane = torch.arange(n, device=cuda_device)
    valid = {"all": torch.ones(n, dtype=torch.bool, device=cuda_device),
             "none": torch.zeros(n, dtype=torch.bool, device=cuda_device),
             "one_per_warp": lane % 32 == (lane // 32 * 7 + 3) % 32 if n > 1 else lane == 0,
             "nan": args[6][:n]}[case]
    call = leg_args(_lanes_where(args, valid.contiguous(), n))
    state_in = call[7 if leg == "shadow" else 8].clone()
    got = cuda_fn(*call)
    _assert_bits_equal(got, plain_fn(*call))
    assert torch.equal(got[0][~valid], state_in[~valid])
    if leg == "shadow":
        assert (got[1][~valid] == 0).all()
    else:
        assert not got[1][~valid].any() and (got[2][~valid] == 0).all() and (got[3][~valid] == 1).all()
    assert torch.equal(call[7 if leg == "shadow" else 8], state_in)  # the operands are left as they are
    if bool(valid.any()):
        assert not torch.equal(got[0][valid], state_in[valid])


@pytest.mark.cuda
@pytest.mark.parametrize("target", ["zero", "inf", "last_step"])
def test_tile_march_sample_kernel_hits_at_the_first_and_last_step(cuda_device, target):
    """The camera leg's kernel bit-equal to its plain version where every
    lane hits at step 0 (a tau target of 0), where none hits (+inf: every
    lane inside takes all 64 steps and their draws) and where lanes hit at
    the last step (a target equal to the lane's tau after all 64 steps, the
    shadow leg's tau on the same lanes); NaN and far-off lanes among
    them."""
    args = list(_tile_march_args(cuda_device, nan_lanes=True))
    if target == "last_step":
        args[7] = tilemarch.tile_march_transmittance_plain(*_transmittance_args(args))[1]
    else:
        args[7] = torch.full_like(args[7], 0.0 if target == "zero" else float("inf"))
    got = tilemarch.tile_march_sample_cuda(*args)
    _assert_bits_equal(got, tilemarch.tile_march_sample_plain(*args))
    _, hit, _, _, _, taken = tilemarch.tile_march_plain(*args)
    valid = args[6]
    if target == "zero":
        assert (taken[hit] == 1).all() and hit.sum() > valid.sum() - 8
    elif target == "inf":
        assert not hit.any() and (taken[valid] == tilemarch.STEPS).all()
    else:
        assert (hit & (taken == tilemarch.STEPS)).sum() > 100


@pytest.mark.cuda
@pytest.mark.parametrize("leg", ["shadow", "sample", "sums"])
def test_tile_march_kernels_index_a_field_past_int32(cuda_device, leg):
    """On a field whose extent holds 2^31 + 2^20 bf16 elements (4 GiB), past
    the reach of the 32-bit tap index, each kernel of tile_march.cu takes
    its 64-bit one: lanes that march through the field's last planes agree
    with the plain version bit for bit. Each kernel keeps at least one
    block of 4 warps resident on an SM."""
    shape = (2049, 1024, 1024)
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    dense = torch.rand(shape, generator=gen, device=cuda_device, dtype=torch.bfloat16)
    n = 2048
    rng = np.random.default_rng(76)
    ipos = np.stack([rng.uniform(0.0, 1024.0, n), rng.uniform(0.0, 1024.0, n), rng.uniform(2040.0, 2049.0, n)], axis=-1)
    idir = rng.normal(size=(n, 3))
    idir /= np.linalg.norm(idir, axis=-1, keepdims=True)

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=cuda_device)

    lut = f32(rng.random((128, 4)))
    rays = (dense, f32(ipos), f32(idir), f32(rng.uniform(0.0, 0.1, n)), f32(np.full(n, 0.1)), f32(np.full(n, 20.0)),
            torch.ones(n, dtype=torch.bool, device=cuda_device))
    state = seed_rays(torch.arange(n, dtype=torch.int64, device=cuda_device), 3)
    scalars, extent = f32([1 / 1.2, 1.2, 1.0, 0.02, 0.98]), (1024, 1024, 2049)
    if leg == "shadow":
        call = (*rays, state, lut, scalars, extent)
        got = tilemarch.tile_march_transmittance_cuda(*call)
        _assert_bits_equal(got, tilemarch.tile_march_transmittance_plain(*call))
        assert (got[1] > 0).sum() > n // 2
    elif leg == "sample":
        call = (*rays, f32(-np.log1p(-rng.random(n))), state, lut, scalars, extent)
        got = tilemarch.tile_march_sample_cuda(*call)
        _assert_bits_equal(got, tilemarch.tile_march_sample_plain(*call))
        assert got[1].sum() > n // 4
    else:
        call = (*rays, extent, tilemarch.STEPS)
        got = tilemarch.tile_march_sums_cuda(*call)
        _assert_bits_equal([got], [tilemarch.tile_march_sums_plain(*call)])
        assert (got > 0).sum() > n // 2
    legs = ("sample", "sample_wide", "shadow", "shadow_wide", "sums", "sums_wide")
    assert min(tilemarch.resident_warps(name, 128, cuda_device) for name in legs) >= 4
    del dense, rays, call
    torch.cuda.empty_cache()


LEG_CASES = {"random": {}, "edge": {"edge_cases": True},
             "opaque": {"alpha": 1.0, "sample_range": (0.0, 10.0), "maj": VOL_MAJ},
             "exhausted": {"maj": 0.0, "far": 1e6}, "rejected": {"sample_range": (2.0, 3.0), "alpha": 1.0}}


@pytest.mark.cuda
@pytest.mark.parametrize("leg", ["sample", "shadow", "physical"])
@pytest.mark.parametrize("case", list(LEG_CASES))
def test_collide_kernels_bit_equal_to_plain(cuda_device, leg, case):
    """Both leg kernels against their plain legs on every output of every
    lane of tests/torch_lanes.py's constructed lanes: random lanes (running
    or not, positions past the extent on every side); NaN and infinite
    positions and starts, lanes 2e12 voxels out, lattice points,
    degenerate majorants in the pyramid and Tr at the roulette threshold;
    an opaque LUT at maj = vol_maj, where every collision hits or kills;
    majorants of 0 and a far box exit, where every lane spends its budget;
    and a sample range that rejects every density."""
    lanes = leg_lanes(cuda_device, **LEG_CASES[case])
    cuda_fn = ddaleg.dda_leg_sample_cuda if leg == "sample" else ddaleg.dda_leg_shadow_cuda
    plain_fn = ddaleg.dda_leg_sample_plain if leg == "sample" else ddaleg.dda_leg_shadow_plain
    got = cuda_fn(*leg_call(lanes, leg))
    _assert_bits_equal(got, plain_fn(*leg_call(lanes, leg)))
    assert not torch.equal(got[0], lanes["state"]) or case == "exhausted"


TRACK_CASES = {"random": {}, "edge": {"edge_cases": True}, "opaque": {"alpha": 1.0, "sample_range": (0.0, 10.0)},
               "capped": {"alpha": 0.0, "far": 1e30}, "rejected": {"sample_range": (2.0, 3.0), "alpha": 1.0}}


def _track_fns(leg):
    if leg == "sample":
        return trackleg.track_leg_sample_cuda, trackleg.track_leg_sample_plain
    return trackleg.track_leg_shadow_cuda, trackleg.track_leg_shadow_plain


def _family(family, leg):
    """(kernel, plain leg, operands of a lanes dict) of a leg of the no_dda
    family ("track": csrc/track_leg.cu) or the default family ("dda":
    csrc/dda_leg.cu, the shadow leg with the reference's quirk)."""
    if family == "track":
        return (*_track_fns(leg), lambda lanes: track_call(lanes, leg))
    if leg == "sample":
        return ddaleg.dda_leg_sample_cuda, ddaleg.dda_leg_sample_plain, lambda lanes: leg_call(lanes, leg)
    return ddaleg.dda_leg_shadow_cuda, ddaleg.dda_leg_shadow_plain, lambda lanes: leg_call(lanes, leg)


FAMILIES = ["track", "dda"]


@pytest.mark.cuda
@pytest.mark.parametrize("leg", ["sample", "shadow"])
@pytest.mark.parametrize("case", list(TRACK_CASES))
def test_track_leg_kernels_bit_equal_to_plain(cuda_device, leg, case):
    """Both no_dda leg kernels against their plain legs on every output of
    every lane, events left included, on tests/torch_lanes.py's constructed
    lanes: random lanes (running or not, some starting at or past their
    exit, positions past the extent on every side); NaN and infinite
    positions, starts and exits, lanes 2e12 voxels out, lattice points and
    Tr at the roulette threshold; an opaque LUT, where the first event hits
    or kills; alpha 0 and an exit 1e30 away, where lanes spend all
    TRACKING_MAX_EVENTS; and a sample range that rejects every density."""
    lanes = track_lanes(cuda_device, **TRACK_CASES[case])
    cuda_fn, plain_fn = _track_fns(leg)
    got = cuda_fn(*track_call(lanes, leg))
    _assert_bits_equal(got, plain_fn(*track_call(lanes, leg)))
    assert not torch.equal(got[0], lanes["state"])
    if case == "capped":
        assert (got[-1] == 0).sum() > 500


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("leg", ["sample", "shadow"])
def test_track_leg_kernels_at_the_field_end(cuda_device, family, leg):
    """The leg kernels of both families (the no_dda legs and the default
    legs, which share leg_common.cuh's tap fetch) against their plain legs
    on lanes whose cells straddle the last x column of a field with an odd
    nx and ex == nx, its last rows and its final element
    (tests/torch_lanes.py's field_end_lanes, 315 elements: the loads at the
    row's end and at the allocation's end; for the default legs under a
    pyramid of majorant 50, so that each lane's first collision lies within
    a fraction of a voxel of its start), every output of every lane."""
    lanes = field_end_lanes(cuda_device)
    if family == "dda":
        lanes = dda_lanes_of(lanes, 50.0, seed=62)
    cuda_fn, plain_fn, call = _family(family, leg)
    got = cuda_fn(*call(lanes))
    _assert_bits_equal(got, plain_fn(*call(lanes)))
    cap = trackleg.TRACKING_MAX_EVENTS if family == "track" else int(got[-1].max())
    assert (got[-1] < cap - 1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("leg", ["sample", "shadow"])
@pytest.mark.parametrize("n", [1, 31, 129])
def test_track_leg_kernels_on_few_lanes(cuda_device, family, leg, n):
    """The leg kernels of both families against their plain legs on 1 lane,
    on 31 (less than a warp) and on 129 (a block and one lane more), the
    first lane running."""
    lanes = track_lanes(cuda_device, n=n, seed=50 + n) if family == "track" else leg_lanes(cuda_device, n=n,
                                                                                           seed=50 + n)
    lanes["running"][0] = True
    cuda_fn, plain_fn, call = _family(family, leg)
    got = cuda_fn(*call(lanes))
    _assert_bits_equal(got, plain_fn(*call(lanes)))
    cap = (trackleg.TRACKING_MAX_EVENTS if family == "track" else ddaleg.DDA_SAMPLE_MAX_STEPS if leg == "sample"
           else ddaleg.DDA_TRANSMITTANCE_MAX_STEPS)
    assert got[-1][0] < cap


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("leg", ["sample", "shadow"])
def test_track_leg_kernels_on_shuffled_edge_lanes(cuda_device, family, leg):
    """The leg kernels of both families against their plain legs on the
    edge-case lanes (NaN and infinite positions, starts and exits, lanes
    2e12 voxels out, lattice points, Tr at the roulette threshold; for the
    default legs also degenerate majorants in the pyramid) in a seeded
    order, so that they share warps with other lanes than in pixel
    order."""
    lanes = (track_lanes if family == "track" else leg_lanes)(cuda_device, edge_cases=True)
    perm = torch.from_numpy(np.random.default_rng(8).permutation(lanes["t"].shape[0])).to(cuda_device)
    lanes = select_lanes(lanes, perm)
    cuda_fn, plain_fn, call = _family(family, leg)
    _assert_bits_equal(cuda_fn(*call(lanes)), plain_fn(*call(lanes)))


@pytest.mark.cuda
def test_track_leg_shadow_kernel_with_many_roulette_draws(cuda_device):
    """The shadow leg kernel against its plain leg on lanes that start just
    above and below the roulette threshold through a thin medium, so that
    thousands of roulette draws are made and over a hundred lanes survive
    one (tr renormalised to 1) and fly on; every output of every lane."""
    lanes = track_lanes("cpu", n=4096, seed=71, alpha=0.2, far=60.0)
    lanes["tr"] = torch.from_numpy(np.random.default_rng(72).uniform(0.02, 0.12, 4096).astype(np.float32))
    _, roulette, killed = shadow_leg_draws(track_call(lanes, "shadow"))
    assert roulette.sum() > 2000 and (roulette - killed.to(torch.int64)).sum() > 100
    lanes = {k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v for k, v in lanes.items()}
    _assert_bits_equal(trackleg.track_leg_shadow_cuda(*track_call(lanes, "shadow")),
                       trackleg.track_leg_shadow_plain(*track_call(lanes, "shadow")))


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("leg", ["sample", "shadow"])
def test_track_leg_kernels_index_a_field_past_int32(cuda_device, family, leg):
    """A field of 2^31 + 2^20 bf16 elements (4 GiB), which the kernels'
    64-bit tap index reaches: lanes whose cells lie in its last planes,
    past index 2^31, agree with the plain legs bit for bit, in both
    families (the default legs under a pyramid of majorant 5, whose 32-bit
    index covers its 16.8M entries, so that their collisions fall near
    their starts)."""
    shape = (2049, 1024, 1024)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    dense = torch.rand(shape, generator=gen, device=cuda_device, dtype=torch.bfloat16)
    lanes = track_lanes("cpu", n=2048, seed=73)
    rng = np.random.default_rng(74)
    ipos = np.stack([rng.uniform(0.0, 1024.0, 2048), rng.uniform(0.0, 1024.0, 2048),
                     rng.uniform(2046.0, 2049.5, 2048)], axis=-1).astype(np.float32)
    lanes = {k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v for k, v in lanes.items()}
    lanes.update(dense=dense, extent=(1024, 1024, 2049), ipos=torch.from_numpy(ipos).to(cuda_device))
    if family == "dda":
        lanes = dda_lanes_of(lanes, 5.0, seed=75)
    cuda_fn, plain_fn, call = _family(family, leg)
    got = cuda_fn(*call(lanes))
    _assert_bits_equal(got, plain_fn(*call(lanes)))
    del dense, lanes
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_track_leg_resident_warps(cuda_device, family):
    """trackleg.resident_warps and ddaleg.resident_warps read from the card
    the warps each leg kernel keeps resident on one SM: at least one block
    of 4 warps, at most the SM's 64; the no_dda camera leg, which keeps
    more events in flight, no more than its shadow leg."""
    if family == "track":
        sample, shadow = trackleg.resident_warps("sample", cuda_device), trackleg.resident_warps("shadow", cuda_device)
        assert 4 <= sample <= shadow <= 64 and sample % 4 == 0 and shadow % 4 == 0
    else:
        for leg in ("sample", "shadow", "physical"):
            warps = ddaleg.resident_warps(leg, cuda_device)
            assert 4 <= warps <= 64 and warps % 4 == 0


@pytest.mark.cuda
@pytest.mark.parametrize("leg", ["sample", "shadow"])
def test_track_leg_kernels_on_scene_lanes(cuda_device, leg):
    """Both no_dda leg kernels against their plain legs on every output of
    the 32^3 scene's camera lanes, half of them starting further along
    their ray; the inputs are left as they are."""
    args = _scene_track_args(_renderer(cuda_device), leg)
    before = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    cuda_fn, plain_fn = _track_fns(leg)
    got = cuda_fn(*args)
    _assert_bits_equal(got, plain_fn(*args))
    _assert_bits_equal([a for a in args if isinstance(a, torch.Tensor)],
                       [a for a in before if isinstance(a, torch.Tensor)])
    assert (got[-1] < trackleg.TRACKING_MAX_EVENTS - 1).any()


@pytest.mark.cuda
def test_legs_make_no_host_sync(cuda_device):
    """The legs of every mode (their setup and their kernel) run with
    torch.cuda.set_sync_debug_mode("error"), which raises at any call that
    waits for the card."""
    r = _renderer(cuda_device, side=32)
    for mode in ("default", "raymarch", "no_dda"):
        r.render_mode = mode
        r.render_frame()  # builds the library and the premultiplied pyramid
        config = r._config()
        params = r.volume_params()
        grid = with_premul_majorant(config, r._device_grid, params, r._lut)
        inv_view, inv_proj, _ = r._camera_operands(config)
        n = config.width * config.height
        state, rays = camera_wavefront(config, inv_view, inv_proj, torch.arange(n, device=cuda_device), 1)
        active = torch.ones(n, dtype=torch.bool, device=cuda_device)
        sample_volume, transmittance = modes.get_mode_functions(mode)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, hit, *_ = sample_volume(grid, params, r._lut, rays.origin, rays.direction, state, active)
            state, tr = transmittance(grid, params, r._lut, rays.origin, rays.direction, state, active)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert bool(hit.any()) and bool((tr < 1).any())


@pytest.mark.cuda
def test_legs_launch_on_the_operands_card(cuda_device, monkeypatch):
    """With cuda:0 current and every operand on cuda:1, each wrapper calls
    its library entry point with cuda:1 current (a device guard), so that
    the launch and what the entry point asks of the current card (the
    gather's SM count, K7's shared-memory attribute) concern the operands'
    card; the default and no_dda legs, the gather, K7 and the tonemap agree
    with their plain
    versions there (the tonemap bit for bit, through its 16-byte path and
    its scalar tail), and cuda:0 is current again afterwards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    library, current = kernels.lib(), []

    class Recording:
        def __getattr__(self, name):
            def call(*args):
                current.append(torch.cuda.current_device())
                return getattr(library, name)(*args)
            return call

    monkeypatch.setattr(kernels, "lib", Recording)
    second = torch.device("cuda", 1)
    with torch.cuda.device(0):
        lanes = leg_lanes(second)
        for leg, cuda_fn, plain_fn in (("sample", ddaleg.dda_leg_sample_cuda, ddaleg.dda_leg_sample_plain),
                                       ("physical", ddaleg.dda_leg_shadow_cuda, ddaleg.dda_leg_shadow_plain)):
            got = cuda_fn(*leg_call(lanes, leg))
            assert got[0].device == second
            _assert_bits_equal(got, plain_fn(*leg_call(lanes, leg)))
        tracks = track_lanes(second, edge_cases=True)
        for leg in ("sample", "shadow"):
            cuda_fn, plain_fn = _track_fns(leg)
            got = cuda_fn(*track_call(tracks, leg))
            assert got[0].device == second
            _assert_bits_equal(got, plain_fn(*track_call(tracks, leg)))
        table = _random_words(5000).to(second)
        idx = torch.arange(-4999, 5000, 3, dtype=torch.int32, device=second)
        _assert_bits_equal([gather.gather_f32_cuda(table, idx)], [gather.gather_f32_plain(table, idx)])
        args = _shearwarp_args(second, [0.2, 0.3, 0.9])
        _assert_bits_equal(shearwarp.shearwarp_intermediate_cuda(*args, fixed_canvas=True),
                           shearwarp.shearwarp_intermediate_plain(*args, fixed_canvas=True))
        fb = _tonemap_input(1001, second)
        _assert_bits_equal([pallas_ops.tonemap_cuda(fb, 5.5, 2.2)], [pallas_ops.tonemap_plain(fb, 5.5, 2.2)])
        torch.cuda.synchronize(second)
        assert torch.cuda.current_device() == 0
    assert len(current) == 7 and set(current) == {1}, current


@pytest.mark.cuda
def test_neg_log1m_matches_torch_log_on_every_draw(cuda_device):
    """The leg kernels' -logf(1 - xi) is bit-equal to -torch.log(1.0 - xi)
    at all 2^24 values a draw takes (k * 2^-24)."""
    xi = torch.arange(2**24, dtype=torch.int32, device=cuda_device).to(torch.float32) * (1.0 / 16777216.0)
    got, want = ddaleg.neg_log1m_cuda(xi), -torch.log(1.0 - xi)
    bad = (got.view(torch.int32) != want.view(torch.int32)).nonzero()
    assert bad.numel() == 0, f"{bad.numel()} draws differ, first xi {xi[bad[:4, 0]].tolist()}"


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [64, 0, 1, 7, 65])
def test_tile_march_sums_kernel_bit_equal_to_plain(cuda_device, steps):
    """The sums kernel, which loads a chunk of steps' taps before it adds
    them, at step counts that are a multiple of its chunk, 0, and not a
    multiple (a last, guarded chunk), with NaN and far-off lanes."""
    args = _sums_args(_tile_march_args(cuda_device, nan_lanes=True))[:-1] + (steps,)
    got = tilemarch.tile_march_sums_cuda(*args)
    _assert_bits_equal([got], [tilemarch.tile_march_sums_plain(*args)])
    assert (got == 0).all() if steps == 0 else (got[args[6]] > 0).any()


@pytest.mark.cuda
def test_pyramid_kernel_matches_plain(cuda_device):
    base = torch.from_numpy(np.random.default_rng(0).uniform(0, 5, (512, 512)).astype(np.float32)).to(cuda_device)
    _assert_bits_equal(pallas_ops.build_importance_pyramid_cuda(base), pallas_ops.build_importance_pyramid_plain(base))


@pytest.mark.cuda
def test_pyramid_kernel_bit_equal_on_special_values_in_one_launch(cuda_device):
    """Bit-equal on every level of a seeded base with NaN, +-inf,
    denormals and the largest floats scattered in it, in one launch per
    build (run twice: the ticket is reset for the next build); the nine
    levels are contiguous views of one buffer."""
    rng = np.random.default_rng(13)
    base = rng.uniform(0, 5, (512, 512)).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 1e-40, -1e-40, 1e-45, 3.4e38, -3.4e38], dtype=np.float32)
    at = rng.choice(base.size, 400, replace=False)
    base.reshape(-1)[at] = special[np.arange(at.size) % special.size]
    base[:2, :2] = 1e-40  # a block of denormals only
    base = torch.from_numpy(base).to(cuda_device)
    for _ in range(2):
        kernels.reset_launch_counts()
        got = pallas_ops.build_importance_pyramid_cuda(base)
        assert kernels.LAUNCHES["importance_pyramid"] == 1
        _assert_bits_equal(got, pallas_ops.build_importance_pyramid_plain(base))
    assert [tuple(level.shape) for level in got] == [(512 >> k, 512 >> k) for k in range(1, 10)]
    assert all(level.is_contiguous() and level.untyped_storage().data_ptr() == got[0].untyped_storage().data_ptr()
               for level in got)
    assert bool(got[0].isnan().any() and got[0].isinf().any() and got[-1].isnan().all())
    assert float(got[0][0, 0]) == float(np.float32(1e-40))


@pytest.mark.cuda
def test_pyramid_kernel_refuses_a_misaligned_base(cuda_device):
    base = torch.zeros(512 * 512 + 1, dtype=torch.float32, device=cuda_device)[1:].view(512, 512)
    with pytest.raises(ValueError, match="16-byte"):
        pallas_ops.build_importance_pyramid_cuda(base)


@pytest.mark.cuda
def test_renderer_runs_on_the_card_by_default(cuda_device):
    """A Renderer made without a device lives on the card and renders
    through its kernels."""
    kernels.reset_launch_counts()
    vol = synthetic_ct_volume((32, 32, 32), bits_stored=12)
    r = Renderer(16, 16)
    assert r.device.type == "cuda" and r.environment.state.imp_mips[0].is_cuda
    r.restart_from_grid(construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32)))
    img = r.render(6)
    assert np.isfinite(img).all() and img.shape == (16, 16, 3)
    assert kernels.LAUNCHES["importance_pyramid"] == 1 and kernels.LAUNCHES["dda_leg_sample"] > 0


def _tonemap_input(rows, device, seed=1):
    """(rows, 3) f32 radiances, seeded in [-0.5, 4), with NaN, +-inf, -0,
    negatives, denormals and the largest floats among the first values."""
    fb = np.random.default_rng(seed).uniform(-0.5, 4.0, rows * 3).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, -1.0, 1e-40, -1e-40, 3.4e38, -3.4e38, 11.2, 1e4],
                       dtype=np.float32)
    k = min(special.size, fb.size)
    fb[:k] = special[:k]
    return torch.from_numpy(fb.reshape(rows, 3)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1920 * 1080, 1920 * 1080 // 64 + 1, 1001, 1])
@pytest.mark.parametrize("offset", [0, 1])
def test_tonemap_kernel_matches_plain(cuda_device, rows, offset):
    """Bit-equal at 1080p, on buffers whose 3N floats leave a scalar tail
    of N * 3 % 4 floats (an odd count among them) and at one pixel, with
    NaN, +-inf, negative and denormal radiances, on a buffer that starts at
    its storage (16-byte aligned) and on one 4 bytes past it (the scalar
    path); NaN stays NaN. Also the 16-byte copy that the kernel is timed
    against."""
    fb = _tonemap_input(rows, cuda_device)
    storage = torch.empty(fb.numel() + offset, dtype=torch.float32, device=cuda_device)
    src = storage[offset:].view(fb.shape)
    src.copy_(fb)
    assert src.data_ptr() % 16 == 4 * offset
    for exposure, gamma in ((5.5, 2.2), (1.0, 1.0), (0.37, 2.4)):
        got = pallas_ops.tonemap_cuda(src, exposure, gamma)
        _assert_bits_equal([got], [pallas_ops.tonemap_plain(fb, exposure, gamma)])
        assert bool(got.reshape(-1)[0].isnan())
    if offset == 0:
        n4 = 4 * (fb.numel() // 4)
        _assert_bits_equal([pallas_ops.copy16(fb).reshape(-1)[:n4]], [fb.reshape(-1)[:n4]])


# one view per (principal axis, flip), two of them with |s| = 1 or nearly
SHEARWARP_VIEWS = [[0.2, 0.3, 0.9], [0.0, 0.0, -1.0], [1.0, -1.0, 1.0], [-0.9, 0.1, 0.3], [0.7, 0.7001, -0.69],
                   [0.1, -0.8, 0.2]]


def test_shearwarp_views_reach_every_volume():
    """The card tests' views use all six (perm, flip) volumes."""
    keys = {shearwarp.shear_parameters(v)[:2] for v in SHEARWARP_VIEWS}
    assert len(keys) == 6
    assert max(max(abs(sx), abs(sy)) for _, _, sx, sy in map(shearwarp.shear_parameters, SHEARWARP_VIEWS)) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("fixed_canvas", [False, True])
@pytest.mark.parametrize("view_dir", SHEARWARP_VIEWS)
@pytest.mark.parametrize("shape", [(40, 24, 32), (37, 45, 71), (5, 1, 3)])
def test_shearwarp_kernel_bit_equal_to_plain(cuda_device, view_dir, fixed_canvas, shape):
    """Volumes whose Y and X are not multiples of the kernel's 31x24 block
    tile, views of all six volumes, and a LUT whose row 0 is not zero."""
    args = _shearwarp_args(cuda_device, view_dir, shape)
    assert bool((args[1][0] != 0).all())
    got = shearwarp.shearwarp_intermediate_cuda(*args, fixed_canvas=fixed_canvas)
    want = shearwarp.shearwarp_intermediate_plain(*args, fixed_canvas=fixed_canvas)
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    _assert_bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("fixed_canvas", [False, True])
@pytest.mark.parametrize("view_dir", SHEARWARP_VIEWS[:3])
def test_shearwarp_kernel_opaque_tiles(cuda_device, view_dir, fixed_canvas):
    """At 200 times the density every class has alpha' = 1, so tiles turn
    opaque after their first slices and blend alpha alone (a blend above 1
    flips the sign of t = 0); with a LUT row that is not finite, which no
    voxel reaches, no tile may switch."""
    vol, lut, sx, sy, inv_maj, sigma_dt = _shearwarp_args(cuda_device, view_dir, (37, 45, 71))
    nonfinite = lut.clone()
    nonfinite[-1, 0] = float("inf")
    low = vol.float().clamp(0.0, 0.5).to(torch.bfloat16)  # LUT rows below k / 2
    for v, table in ((vol, lut), (low, nonfinite)):
        args = (v, table, sx, sy, inv_maj, 200.0 * sigma_dt)
        want = shearwarp.shearwarp_intermediate_plain(*args, fixed_canvas=fixed_canvas)
        _assert_bits_equal(shearwarp.shearwarp_intermediate_cuda(*args, fixed_canvas=fixed_canvas), want)
        assert float((want[1] == 0).float().mean()) > 0.2


@pytest.mark.cuda
def test_shearwarp_kernel_misaligned_volume_and_largest_lut(cuda_device):
    """A volume whose pointer is 2 bytes past a 16-byte boundary (the
    patch copies start at any column), and a LUT of MAX_LUT_ROWS rows (more
    than 48 KiB of shared memory in all)."""
    vol, lut, sx, sy, inv_maj, sigma_dt = _shearwarp_args(cuda_device, [0.3, -0.5, 0.8], (37, 45, 71))
    storage = torch.empty(vol.numel() + 1, dtype=vol.dtype, device=cuda_device)
    shifted = storage[1:].view(vol.shape)
    shifted.copy_(vol)
    assert shifted.data_ptr() % 16 == 2
    rng = np.random.default_rng(15)
    big = torch.from_numpy(rng.uniform(0.05, 2.0, (shearwarp.MAX_LUT_ROWS, 4)).astype(np.float32)).to(cuda_device)
    for v, table in ((shifted, lut), (vol, big), (shifted, big)):
        for fixed_canvas in (False, True):
            args = (v, table, sx, sy, inv_maj, sigma_dt)
            _assert_bits_equal(shearwarp.shearwarp_intermediate_cuda(*args, fixed_canvas=fixed_canvas),
                               shearwarp.shearwarp_intermediate_plain(*args, fixed_canvas=fixed_canvas))


@pytest.mark.cuda
def test_gather_kernels_bit_equal_to_plain(cuda_device):
    """gather_f32 on int32 indices: sizes around the 4-word groups, an
    index tensor whose pointer is not 16-byte aligned, negative indices
    and the special words; the LUT fetch; and the launch floor runs."""
    table = _random_words(5000).reshape(50, 100).to(cuda_device)
    rng = np.random.default_rng(13)
    for shape in [(1,), (3,), (5,), (4097,), (777,), (3, 41, 12)]:
        idx = torch.from_numpy(rng.integers(-table.numel(), table.numel(), shape).astype(np.int32)).to(cuda_device)
        first = min(8, idx.numel())
        idx.view(-1)[:first] = torch.arange(first, dtype=torch.int32, device=cuda_device)  # the special words
        _assert_bits_equal([gather.gather_f32_cuda(table, idx)], [gather.gather_f32_plain(table, idx)])
        assert bool((idx < 0).any()) or idx.numel() < 8
        for offset in (1, 2, 3):  # a storage offset: the pointer is 4, 8 or 12 bytes past 16
            storage = torch.empty(idx.numel() + offset, dtype=torch.int32, device=cuda_device)
            shifted = storage[offset:].view(idx.shape)
            shifted.copy_(idx)
            assert shifted.data_ptr() % 16 == 4 * offset
            _assert_bits_equal([gather.gather_f32(table, shifted)], [gather.gather_f32_plain(table, idx)])
    gather.launch_floor(4097, cuda_device)
    torch.cuda.synchronize()

    lut = _random_words(512, seed=14).reshape(128, 4).to(cuda_device)
    density = torch.from_numpy(rng.uniform(-0.2, 1.2, 3000).astype(np.float32))
    density[:133] = torch.cat([torch.arange(129) / 128, torch.tensor([np.nan, np.inf, -np.inf, -0.0])])
    density = density.reshape(30, 100).to(cuda_device)
    for lo, hi in ((0.0564, 1.0), (-1.0, np.inf)):
        sample_range = torch.tensor([lo, hi], dtype=torch.float32, device=cuda_device)
        _assert_bits_equal([gather.lookup_transfer_cuda(lut, sample_range, density)],
                           [gather.lookup_transfer_plain(lut, sample_range, density)])


@pytest.mark.cuda
def test_gather_kernel_refuses_int64_indices(cuda_device):
    """The card's gather takes int32 indices only; the environment builds
    them so."""
    table = torch.zeros(64, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        gather.gather_f32_cuda(table, torch.zeros(4, dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError, match="int32"):
        gather.gather_f32(table, torch.zeros(4, dtype=torch.int64, device=cuda_device))


@pytest.mark.cuda
def test_render_on_card_goes_through_every_kernel(cuda_device):
    """Each mode's render and the preview go through their kernels;
    tile_march_sums is on no render path."""
    kernels.reset_launch_counts()
    r = _renderer(cuda_device, side=32)
    img = r.render(8)
    assert np.isfinite(img).all() and img.shape == (32, 32, 3)
    r.render_mode = "raymarch"
    assert np.isfinite(r.render(6)).all()
    r.render_mode = "no_dda"
    assert np.isfinite(r.render(6)).all()
    for image in (r.render_preview(), r.render_dvr(screen=True)):
        assert np.isfinite(image).all() and image.shape == (32, 32, 3)
    ran = {name for name, count in kernels.LAUNCHES.items() if count > 0}
    assert ran == set(kernels.LAUNCHES) - {"tile_march_sums"}, kernels.LAUNCHES


@pytest.mark.cuda
def test_lut_fetch_left_to_the_premul_build(cuda_device):
    """Per default sample the standalone LUT fetch launches once (the premul
    pyramid) and each leg is one launch per bounce; a raymarch or no_dda
    sample launches no LUT fetch, and each of its legs once per bounce."""
    r = _renderer(cuda_device, side=32)
    legs = {"default": ("dda_leg_sample", "dda_leg_shadow"),
            "raymarch": ("tile_march_sample", "tile_march_transmittance"),
            "no_dda": ("track_leg_sample", "track_leg_shadow")}
    for mode, (camera, shadow) in legs.items():
        r.render_mode = mode
        r.render_frame()
        kernels.reset_launch_counts()
        for _ in range(3):
            r.render_frame()
        launches = dict(kernels.LAUNCHES)
        assert launches["lookup_transfer"] == (3 if mode == "default" else 0)
        assert launches[camera] == launches[shadow] == 3 * r.settings.bounces


def _loaded(device, side=64):
    """A Renderer on `device` after restart_from_zip and load_env of the
    fixture writers' 32^3 DICOM zip and 64x32 HDR map."""
    from volxel_tpu_torch.utils.fixtures import synthetic_env_hdr, write_dicom_zip

    vol = synthetic_ct_volume((32, 32, 32), bits_stored=12)
    r = Renderer(side, side, device=device)
    r.restart_from_zip(write_dicom_zip(vol, bits_stored=12))
    r.load_env(synthetic_env_hdr(64, 32))
    return r


@pytest.mark.cuda
def test_load_env_on_the_card_launches_the_pyramid_once(cuda_device):
    from volxel_tpu_torch.utils.fixtures import synthetic_env_hdr

    r = Renderer(16, 16, device=cuda_device)
    kernels.reset_launch_counts()
    r.load_env(synthetic_env_hdr(128, 64), strength=1.5)
    assert kernels.LAUNCHES["importance_pyramid"] == 1
    state = r.environment.state
    assert state.envmap.is_cuda and all(m.is_cuda for m in state.imp_mips) and r.env_strength == 1.5
    cpu = Renderer(16, 16, device="cpu")
    cpu.load_env(synthetic_env_hdr(128, 64), strength=1.5)
    torch.testing.assert_close(state.envmap.cpu(), cpu.environment.state.envmap, rtol=0, atol=0)
    for got, want in zip(state.imp_mips, cpu.environment.state.imp_mips):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_restart_from_zip_puts_the_grid_on_the_card(cuda_device):
    r = _loaded(cuda_device, side=16)
    g = r._device_grid
    assert g.dense.is_cuda and g.maj_mips.is_cuda and r.grid.brick_counter > 0
    assert np.isfinite(r.render(6)).all()


@pytest.mark.cuda
def test_benchmark_record_on_the_card(cuda_device):
    from volxel_tpu_torch.api.benchmark import run_single_benchmark

    r = _loaded(cuda_device, side=32)
    r.settings.max_samples = 3
    rec = run_single_benchmark(r, name="card")
    acc = rec["device"]["accelerator"]
    assert acc["platform"] == "gpu" and acc["kind"] == torch.cuda.get_device_name(0)
    assert rec["device"]["powerLimit"].endswith("W")
    assert rec["device"]["torchVersion"] == torch.__version__ and rec["device"]["cudaVersion"] == torch.version.cuda
    assert rec["timePerSample"] > 0 and rec["viewport"] == [0, 0, 32, 32]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "raymarch", "no_dda"])
def test_render_after_zip_matches_cpu(cuda_device, mode):
    """64x64 after restart_from_zip + load_env, card against CPU, at
    chip_smoke.py phase 5's contract (tests/test_parity_oracle.py's)."""
    images = []
    for device in (cuda_device, "cpu"):
        r = _loaded(device)
        r.render_mode = mode
        for _ in range(12):
            r.render_frame()
        images.append(r._framebuffer.cpu().numpy().astype(np.float64))
    gpu, cpu = images
    rel = np.abs(gpu - cpu) / (np.abs(cpu) + 1e-3)
    assert float((rel.max(axis=-1) < 1e-3).mean()) > 0.98
    assert float(np.median(rel)) < 1e-4
    assert abs(gpu.mean() - cpu.mean()) < 5e-3 * max(cpu.mean(), 1e-3) and cpu.mean() > 0
