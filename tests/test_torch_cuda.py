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
The app layer on the card: gradient shading's legs bit-equal at every
call, debug hits within 1e-5 of the CPU, a frame and a drag preview served
by PreviewServer.step(), the PNG of image() read back exactly. The mesh on
the card: a DistributedRenderer whose 2x2 positions name one card (each
mode) and render_views, bit-equal to single render_sample calls;
step_statistics through the legs' kernels equal to it through their plain
versions; positions on two cards (skips on one). A vz = 2 row across two
processes of the node, each mapping the other's slab through CUDA IPC,
with a timestep swap at every step (two cards over NCCL skip on one). The
legs' park forms (a vz row across nodes) bit-equal to their plain park
forms, and parked then resumed bit-equal to the slab form's one launch.
The per-ray RNG's seeding and draws bit-equal to the plain int64 version
at every lane, masked-out lanes included, one launch a call. The
environment's warp sample, lookup and pdf (csrc/env.cu) bit-equal to the
plain version at every lane, one launch a call, and whole frames of each
mode at bounces 3 bit-equal with the kernels and with the plain version.
Gradient shading's kernel (csrc/shade.cu) bit-equal to the plain version
at every one of 1080p lanes on a dense field and on slabs with f32 and
bf16 taps, and gradient-shaded frames of each mode bit-equal with it and
with the plain version, one launch a frame.
"""

from __future__ import annotations

import ctypes
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from tests.torch_lanes import (VOL_MAJ, dda_lanes_of, field_end_lanes, leg_call, leg_lanes, select_lanes,
                               shadow_leg_draws, track_call, track_lanes)
from tests.torch_mesh import replayed_framebuffer
from volxel_tpu_torch import Renderer, kernels
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.render import (ddaleg, gather, modes, pallas_ops, sampling, shading, shearwarp, tilemarch,
                                     trackleg)
from volxel_tpu_torch.render.modes import _march_setup, _tracking_setup, raymarch_prologue
from volxel_tpu_torch.render.pathtrace import camera_wavefront, with_premul_majorant
from volxel_tpu_torch.render import rng as rng_mod
from volxel_tpu_torch.render.rng import seed_rays
from volxel_tpu_torch.render.sampling import DeviceGrid, VolumeParams
from volxel_tpu_torch.render.tilemarch import volume_scalars
from volxel_tpu_torch.scene import environment as env_mod
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


_DECLARED = re.compile(r'extern "C" int (vx_\w+)\(([^)]*)\)')
# the entry points that take no stream: the occupancy queries and the
# peer-access switch
_NO_STREAM = ("vx_dda_leg_resident_warps", "vx_track_leg_resident_warps", "vx_tile_march_resident_warps",
              "vx_enable_peer_access")


def _declarations() -> list[tuple[str, str, list[str]]]:
    """(source, entry point, its parameters) of every `extern "C" int
    vx_...(...)` declaration in csrc/*.cu."""
    return [(src.name, name, [" ".join(p.split()) for p in params.split(",") if p.strip()])
            for src in sorted(kernels.CSRC.glob("*.cu")) for name, params in _DECLARED.findall(src.read_text())]


def _ctype(param: str):
    return (ctypes.c_void_p if "*" in param or param.startswith("cudaStream_t ") else
            ctypes.c_longlong if param.startswith("long long ") else ctypes.c_uint if param.startswith("unsigned ")
            else ctypes.c_float if param.startswith("float ") else ctypes.c_int if param.startswith("int ") else param)


@pytest.mark.parametrize("name", [name for _, name, _ in _declarations()] + ["python_call_sites"])
def test_entry_points_bound_as_declared(name):
    """Each C entry point of csrc/*.cu is declared in one source, and
    kernels binds it with one ctypes type per declared parameter: a pointer
    or a stream as a void pointer, `long long` as c_longlong, `unsigned` as
    c_uint, `float` as c_float, `int` as c_int; the last is the stream but
    in the occupancy queries and the peer-access switch. The last case:
    every entry point the package's Python names (a literal "vx_..." or
    "vx_" and a launch counter's name) is declared."""
    declared = _declarations()
    names = [n for _, n, _ in declared]
    if name == "python_call_sites":
        named = {m for path in (REPO / "volxel_tpu_torch").rglob("*.py")
                 for m in re.findall(r"[\"'](vx_\w+)[\"']", path.read_text())} - {"vx_slab_"}
        named |= {f"vx_{counter}" for counter in kernels.LAUNCHES}
        assert named and named <= set(names), sorted(named - set(names))
        return
    sources = [src for src, n, _ in declared if n == name]
    assert len(sources) == 1, f"{name} is declared in {sources}"
    (params,) = [p for _, n, p in declared if n == name]
    bound = kernels.signatures()[name]
    assert len(bound) == len(params) and bound == [_ctype(p) for p in params]
    assert params[-1].startswith("cudaStream_t ") == (name not in _NO_STREAM)
    if name not in _NO_STREAM:
        assert bound[-1] is ctypes.c_void_p


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
    path); NaN stays NaN."""
    fb = _tonemap_input(rows, cuda_device)
    storage = torch.empty(fb.numel() + offset, dtype=torch.float32, device=cuda_device)
    src = storage[offset:].view(fb.shape)
    src.copy_(fb)
    assert src.data_ptr() % 16 == 4 * offset
    for exposure, gamma in ((5.5, 2.2), (1.0, 1.0), (0.37, 2.4)):
        got = pallas_ops.tonemap_cuda(src, exposure, gamma)
        _assert_bits_equal([got], [pallas_ops.tonemap_plain(fb, exposure, gamma)])
        assert bool(got.reshape(-1)[0].isnan())


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
    and the special words; and the LUT fetch."""
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
    """Each mode's render, a gradient-shaded one and the preview go
    through their kernels; tile_march_sums and gather_f32 (whose environment sites csrc/env.cu
    took) are on no render path, the legs' slab forms run only
    over volume slabs (test_slab_leg_kernels_bit_equal_to_plain) and their
    park forms only on a row across nodes
    (test_park_forms_bit_equal_to_plain_and_to_one_launch)."""
    kernels.reset_launch_counts()
    r = _renderer(cuda_device, side=32)
    img = r.render(8)
    assert np.isfinite(img).all() and img.shape == (32, 32, 3)
    r.render_mode = "raymarch"
    assert np.isfinite(r.render(6)).all()
    r.render_mode = "no_dda"
    assert np.isfinite(r.render(6)).all()
    r.settings.gradient_shading = True
    assert np.isfinite(r.render(2)).all()
    for image in (r.render_preview(), r.render_dvr(screen=True)):
        assert np.isfinite(image).all() and image.shape == (32, 32, 3)
    ran = {name for name, count in kernels.LAUNCHES.items() if count > 0}
    slab_forms = {name for name in kernels.LAUNCHES if name.endswith(("_slabs", "_slabs_park"))}
    assert ran == set(kernels.LAUNCHES) - {"tile_march_sums", "gather_f32"} - slab_forms, kernels.LAUNCHES


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


# the legs of each mode: (name in render.modes, the CUDA entry, the plain version)
_MODE_LEGS = {
    "default": (("dda_leg_sample", ddaleg.dda_leg_sample_cuda, ddaleg.dda_leg_sample_plain),
                ("dda_leg_shadow", ddaleg.dda_leg_shadow_cuda, ddaleg.dda_leg_shadow_plain)),
    "raymarch": (("tile_march_sample", tilemarch.tile_march_sample_cuda, tilemarch.tile_march_sample_plain),
                 ("tile_march_transmittance", tilemarch.tile_march_transmittance_cuda,
                  tilemarch.tile_march_transmittance_plain)),
    "no_dda": (("track_leg_sample", trackleg.track_leg_sample_cuda, trackleg.track_leg_sample_plain),
               ("track_leg_shadow", trackleg.track_leg_shadow_cuda, trackleg.track_leg_shadow_plain)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "raymarch", "no_dda"])
def test_gradient_shading_legs_bit_equal_at_every_call(cuda_device, monkeypatch, mode):
    """A gradient-shaded sample calls each leg of its mode once (the shadow
    leg from the hit points, on the lanes that hit); at each call the
    kernel equals its plain version on every output."""
    r = _renderer(cuda_device, side=48)
    r.render_mode = mode
    r.settings.gradient_shading = True
    calls = []

    def held(name, cuda_fn, plain_fn):
        def call(*args):
            got = cuda_fn(*args)
            _assert_bits_equal(got, plain_fn(*args))
            calls.append(name)
            return got
        return call

    for name, cuda_fn, plain_fn in _MODE_LEGS[mode]:
        monkeypatch.setattr(modes, name, held(name, cuda_fn, plain_fn))
    for _ in range(2):
        fb = r.render_frame()
    assert calls == [name for name, *_ in _MODE_LEGS[mode]] * 2
    assert bool(torch.isfinite(fb).all()) and float(fb.mean()) > 0


@pytest.mark.cuda
def test_debug_hits_on_the_card_launch_no_leg(cuda_device):
    r = _renderer(cuda_device, side=32)
    r.settings.debug_hits = True
    kernels.reset_launch_counts()
    r.render_frame()
    ran = {name for name, count in kernels.LAUNCHES.items() if count}
    # the environment behind the box; the camera's jitter
    assert ran <= {"gather_f32", "env_lookup", "rng_seed", "rng_draw"}
    cpu = _renderer("cpu", side=32)
    cpu.settings.debug_hits = True
    cpu.render_frame()
    torch.testing.assert_close(r._framebuffer.cpu(), cpu._framebuffer, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_served_frame_through_the_preview_server_on_the_card(cuda_device):
    """PreviewServer.step() on a renderer on the card: a progressive frame
    (each leg once a bounce, K4 once), then a drag preview (K7 and K4);
    each PNG decodes to its size."""
    from volxel_tpu_torch.api.server import PreviewServer
    from volxel_tpu_torch.utils.png import decode_png

    s = PreviewServer(_renderer(cuda_device, side=32), port=0)
    kernels.reset_launch_counts()
    assert s.step() == "frame"
    assert decode_png(s._png).shape == (32, 32, 3)
    bounces = s.renderer.settings.bounces
    assert kernels.LAUNCHES["dda_leg_sample"] == kernels.LAUNCHES["dda_leg_shadow"] == bounces
    assert kernels.LAUNCHES["tonemap"] == 1
    s._commands.put({"type": "rotate", "by": [0.2, 0.1]})
    assert s.step() == "preview"
    assert decode_png(s._png).shape == (16, 16, 3)
    assert kernels.LAUNCHES["shearwarp_intermediate"] == 1 and kernels.LAUNCHES["tonemap"] == 2
    assert s.last_error is None


@pytest.mark.cuda
def test_png_of_image_on_the_card(cuda_device, tmp_path):
    from volxel_tpu_torch.utils.png import decode_png, write_png

    r = _renderer(cuda_device, side=40)
    img = r.render(6)
    rgb = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    write_png(tmp_path / "frame.png", rgb)
    got = decode_png((tmp_path / "frame.png").read_bytes())
    np.testing.assert_array_equal(got, rgb)
    assert got.shape == (40, 40, 3) and got.max() > 0


def _mesh_renderer(devices, mode="default", side=32):
    from volxel_tpu_torch.parallel import make_mesh
    from volxel_tpu_torch.parallel.distributed import DistributedRenderer

    vol = synthetic_ct_volume((32, 32, 32), bits_stored=12)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    r = DistributedRenderer(side, side, mesh=make_mesh(sp=2, px=len(devices) // 2, devices=devices))
    r.restart_from_grid(grid)
    r.render_mode = mode
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "raymarch", "no_dda"])
def test_distributed_renderer_on_one_card_bit_equal(cuda_device, mode):
    """A 2x2 mesh whose four positions name the card: each leg launches
    once a position a bounce, the LUT fetch once a default step (one
    card), and the framebuffer is bit-equal to the replayed samples."""
    r = _mesh_renderer([cuda_device] * 4, mode)
    assert r.device.type == "cuda"
    kernels.reset_launch_counts()
    r.render_frame()
    r.render_frame()
    legs = {"default": ("dda_leg_sample", "dda_leg_shadow"), "raymarch": ("tile_march_sample",
            "tile_march_transmittance"), "no_dda": ("track_leg_sample", "track_leg_shadow")}[mode]
    assert [kernels.LAUNCHES[name] for name in legs] == [2 * 4 * r.settings.bounces] * 2
    assert kernels.LAUNCHES["lookup_transfer"] == (2 if mode == "default" else 0)
    _assert_bits_equal([r._framebuffer], [replayed_framebuffer(r, 2)])
    assert np.isfinite(r.image()).all()


@pytest.mark.cuda
def test_render_views_on_the_card_one_launch_a_leg(cuda_device):
    """Four views in one wavefront: each leg one launch a bounce, each
    view bit-equal to render_sample at frame * 4 + view."""
    from volxel_tpu_torch.parallel.multiview import render_views
    from volxel_tpu_torch.render.pathtrace import render_sample

    r = _renderer(cuda_device, side=32)
    config = r._config()
    cams = []
    for _ in range(4):
        r.camera.rotate_around_view(0.3, 0.0)
        cams.append(r._camera_operands(config))
    ops = (r._device_grid, r.volume_params(), r._lut, r.environment.state)
    kernels.reset_launch_counts()
    views = render_views(config, *ops, torch.stack([c[0] for c in cams]), torch.stack([c[1] for c in cams]),
                         cams[0][2], 3)
    assert kernels.LAUNCHES["dda_leg_sample"] == kernels.LAUNCHES["dda_leg_shadow"] == r.settings.bounces
    for v in range(4):
        _assert_bits_equal([views[v]], [render_sample(config, *ops, *cams[v], 3 * 4 + v)])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "no_dda"])
def test_step_statistics_on_the_card_equal_the_plain_legs(cuda_device, monkeypatch, mode):
    """step_statistics through the legs' kernels (one launch each) equals
    step_statistics through their plain versions on the same card."""
    from volxel_tpu_torch.utils.stepstats import step_statistics

    r = _renderer(cuda_device, side=48)
    kernels.reset_launch_counts()
    stats = step_statistics(r, mode)
    legs = ("dda_leg_sample", "dda_leg_shadow") if mode == "default" else ("track_leg_sample", "track_leg_shadow")
    assert [kernels.LAUNCHES[name] for name in legs] == [1, 1]
    for name in legs:
        module = ddaleg if mode == "default" else trackleg
        monkeypatch.setattr(modes, name, getattr(module, f"{name}_plain"))
    assert step_statistics(r, mode) == stats
    assert stats["sample"]["frac_at_cap"] == stats["transmittance"]["frac_at_cap"] == 0.0


@pytest.mark.cuda
def test_distributed_renderer_over_two_cards(cuda_device):
    """sp = 2 over cuda:0 and cuda:1 (positions (0, 0) and (1, 0)): bit-equal
    to the replayed samples on cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    r = _mesh_renderer([torch.device("cuda", 0), torch.device("cuda", 1)])
    r.render_frame()
    r.render_frame()
    assert r._framebuffer.device == torch.device("cuda", 0)
    _assert_bits_equal([r._framebuffer], [replayed_framebuffer(r, 2)])


# -- render-time volume slabs ----------------------------------------------------


def _slab_renderers(devices, mode, vz, tap_dtype="float32", side=32, setting=None):
    """(a vz = 1 renderer on devices[0], a (1, 1, vz) one over `devices`),
    the same 40x32x32 scene (z not divisible by 4 in slices of the padded
    field's bricks) at bounces 2."""
    from volxel_tpu_torch.parallel import make_mesh
    from volxel_tpu_torch.parallel.distributed import DistributedRenderer

    vol = synthetic_ct_volume((40, 32, 32), bits_stored=12)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    out = []
    for mesh in (make_mesh(sp=1, px=1, devices=devices[:1]), make_mesh(sp=1, px=1, vz=vz, devices=devices)):
        r = DistributedRenderer(side, side, mesh=mesh, vz_tap_dtype=tap_dtype)
        r.restart_from_grid(grid)
        r.camera.rotate_around_view(0.4, 0.2)
        r.camera.zoom(2.0)
        r.render_mode = mode
        r.settings.bounces = 2
        if setting:
            setattr(r.settings, setting, True)
        out.append(r)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode,tap_dtype,setting", [("default", "float32", None), ("default", "bfloat16", None),
                                                    ("default", "float32", "physical_shadows"),
                                                    ("raymarch", "float32", None), ("no_dda", "float32", None),
                                                    ("no_dda", "bfloat16", None)])
def test_slab_leg_kernels_bit_equal_to_plain(cuda_device, monkeypatch, mode, tap_dtype, setting):
    """A vz = 4 renderer on one card: every leg call goes through the slab
    form of its kernel (counted apart from the dense form), which equals
    its plain slab version on every output."""
    _, r = _slab_renderers([cuda_device] * 4, mode, 4, tap_dtype, setting=setting)
    calls = []

    def held(name, cuda_fn, plain_fn):
        def call(*args):
            got = cuda_fn(*args)
            _assert_bits_equal(got, plain_fn(*args))
            calls.append(name)
            return got
        return call

    for name, cuda_fn, plain_fn in _MODE_LEGS[mode]:
        monkeypatch.setattr(modes, name, held(name, cuda_fn, plain_fn))
    kernels.reset_launch_counts()
    r.render_frame()
    assert len(calls) == 4 * 2 * 2  # four positions, two bounces, two legs
    for name, *_ in _MODE_LEGS[mode]:
        assert kernels.LAUNCHES[name] == 0 and kernels.LAUNCHES[f"{name}_slabs"] == 8


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "raymarch", "no_dda"])
def test_slabs_on_one_card_bit_equal_to_the_whole_field(cuda_device, mode):
    """vz = 4 on one card, two steps: the framebuffer is bit-equal to the
    vz = 1 renderer's; gradient shading too."""
    rep, slab = _slab_renderers([cuda_device] * 4, mode, 4)
    for _ in range(2):
        a, b = rep.render_frame(), slab.render_frame()
    _assert_bits_equal([b], [a])
    for r in (rep, slab):
        r.settings.gradient_shading = True
    _assert_bits_equal([slab.render_frame()], [rep.render_frame()])


@pytest.mark.cuda
def test_slab_table_refuses_another_card_and_a_short_table(cuda_device):
    """The wrappers check the slab table: one a slab, int64, on the lanes'
    card."""
    from volxel_tpu_torch.render.sampling import SlabGrid

    _, r = _slab_renderers([cuda_device] * 4, "no_dda", 4)
    r.render_frame()
    args = list(track_call(track_lanes(cuda_device, n=64), "sample"))
    grid = r._slabbed.local_grid()
    args[0], args[1] = grid, grid.extent
    trackleg.track_leg_sample_cuda(*args)  # the table is made on the lanes' card
    short = SlabGrid(grid.slabs[:3], grid.slab, grid.maj_mips, grid.extent)
    with pytest.raises(ValueError, match="outside the slabs"):
        trackleg.track_leg_sample_cuda(short, *args[1:])
    bad = SlabGrid(grid.slabs, grid.slab, grid.maj_mips, grid.extent, tables={torch.device("cuda", 0):
                                                                               torch.zeros(2, dtype=torch.int64,
                                                                                           device=cuda_device)})
    with pytest.raises(ValueError, match="slab table"):
        trackleg.track_leg_sample_cuda(bad, *args[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("mode,tap_dtype,setting", [("default", "float32", None), ("default", "bfloat16", None),
                                                    ("default", "float32", "physical_shadows"),
                                                    ("raymarch", "float32", None), ("no_dda", "float32", None),
                                                    ("no_dda", "bfloat16", None)])
def test_park_forms_bit_equal_to_plain_and_to_one_launch(cuda_device, monkeypatch, mode, tap_dtype, setting):
    """Each leg call of a vz = 4 frame on one card, with slab 0 on "node B"
    and slabs 1-3 on "node A" (absent slabs: null table entries): the park
    form's kernel equals its plain park form on every output (the parked
    set, the parked state, the rest), on A's grid, on B's for the parked
    lanes and on A's again for those that parked once more; the lanes
    parked and resumed give the slab form's one launch on the whole grid
    bit for bit. Each park form launch counts as its `_slabs_park`."""
    from volxel_tpu_torch.parallel import migrate

    _, r = _slab_renderers([cuda_device] * 4, mode, 4, tap_dtype, setting=setting)
    calls = {name: [] for name, *_ in _MODE_LEGS[mode]}

    def recorded(name, fn):
        def call(*args):
            calls[name].append(args)
            return fn(*args)
        return call

    for name, *_ in _MODE_LEGS[mode]:
        monkeypatch.setattr(modes, name, recorded(name, getattr(modes, name)))
    r.render_frame()
    parked = 0
    for name, cuda_fn, _ in _MODE_LEGS[mode]:
        leg = migrate.LEGS[name]
        plain_fn = getattr({"dda": ddaleg, "track": trackleg, "tile": tilemarch}[name.split("_")[0]],
                           f"{leg.park}_plain")
        for whole, *args in calls[name]:
            node_a = whole._replace(slabs=[None, *whole.slabs[1:]])
            node_b = whole._replace(slabs=[whole.slabs[0], None, None, None])
            want = cuda_fn(whole, *args)
            consts, lanes = migrate.home_lanes(leg, args)

            def both(grid, lanes):
                kernels.reset_launch_counts()
                got = migrate.park_call(leg, grid, consts, lanes)
                assert kernels.LAUNCHES[f"{name}_slabs_park"] == 1
                _assert_bits_equal([got[k] for k in leg.outs],
                                   plain_fn(grid, *migrate.park_args(leg, consts, lanes)))
                return got

            outs = both(node_a, lanes)
            first = torch.nonzero(outs["park"] >= 0).squeeze(1)
            parked += first.numel()
            carry = migrate.parked_carry(leg, lanes, outs, first)
            outs_b = both(node_b, carry)
            again = outs_b["park"] >= 0
            outs_a = both(node_a, migrate.parked_carry(leg, carry, outs_b, torch.nonzero(again).squeeze(1)))
            assert bool((outs_a["park"] < 0).all())
            got = {k: outs[k].clone() for k in leg.result}
            for k in leg.result:
                got[k][first[~again]] = outs_b[k][~again]
                got[k][first[again]] = outs_a[k]
            _assert_bits_equal([got[k] for k in leg.result], want)
    assert parked > 0


def _lane_slabs(lanes, device, vz=4):
    """The SlabGrid of vz slabs of track_lanes' 12^3 field, all on `device`."""
    from volxel_tpu_torch.parallel import make_mesh
    from volxel_tpu_torch.parallel.volshard import build_slabbed_volume

    field = DeviceGrid(dense=lanes["dense"], maj_mips=None, extent=tuple(lanes["extent"]))
    return build_slabbed_volume(field, make_mesh(sp=1, px=1, vz=vz, devices=[device] * vz)).local_grid()


@pytest.mark.cuda
def test_slab_launch_waits_for_the_slabs_writes(cuda_device):
    """Slabs written on a side stream behind a ~25 ms sleep: a slab leg
    launched at once on the card's current stream, with no host sync,
    waits for those writes (SlabGrid.ready, waited on in SlabGrid.table)
    and equals its plain version on the finished slabs; on zero slabs the
    leg's result differs, so a launch that did not wait would show."""
    from volxel_tpu_torch.render.sampling import SlabGrid

    lanes = track_lanes(cuda_device, n=256)
    args = track_call(lanes, "sample")
    grid = _lane_slabs(lanes, cuda_device)
    want = trackleg.track_leg_sample_plain(grid, *args[1:])
    zeros = SlabGrid([torch.zeros_like(s) for s in grid.slabs], grid.slab, grid.maj_mips, grid.extent)
    assert not all(torch.equal(a, b) for a, b in zip(trackleg.track_leg_sample_plain(zeros, *args[1:]), want))
    late = [torch.zeros_like(s) for s in grid.slabs]
    torch.cuda.synchronize(cuda_device)
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        for dst, src in zip(late, grid.slabs):
            dst.copy_(src)
        written = SlabGrid(late, grid.slab, grid.maj_mips, grid.extent)
    got = trackleg.track_leg_sample_cuda(written, *args[1:])
    torch.cuda.synchronize(cuda_device)
    _assert_bits_equal(got, want)


@pytest.mark.cuda
def test_slab_timestep_swaps_over_two_cards_without_a_host_sync(cuda_device):
    """A time series over vz = 2 on cuda:0 and cuda:1, a timestep swap at
    every step and the previous timestep evicted, with no host sync
    between steps: each swap rebuilds the slabs and frees the old ones to
    their cards' allocators while the other card's legs may still be
    reading them (SlabGrid.table ties them to the readers' streams). Each
    step's framebuffer is bit-equal to the vz = 1 player's on cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from volxel_tpu_torch.api.timeseries import TimeSeriesPlayer
    from volxel_tpu_torch.parallel import make_mesh
    from volxel_tpu_torch.parallel.distributed import DistributedRenderer

    base = synthetic_ct_volume((40, 32, 32), bits_stored=12).astype(np.float32) / 4095.0
    vols = np.stack([base * np.float32(1.0 - 0.2 * t) for t in range(4)])
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    frames = []
    for devices in (cards[:1], cards):
        r = DistributedRenderer(32, 32, mesh=make_mesh(sp=1, px=1, vz=len(devices), devices=devices))
        r.restart_from_grid(construct_brick_grid(vols[0], transform=np.eye(4, dtype=np.float32)))
        r.camera.rotate_around_view(0.4, 0.2)
        r.camera.zoom(2.0)
        r.settings.bounces = 2
        player = TimeSeriesPlayer(r, vols)
        out = []
        for t in (0, 1, 2, 3, 0, 1, 2, 3):
            player.set_timestep(t)
            player.evict((t - 1) % len(vols))
            out.append(r.render_frame().clone())
        frames.append(out)
    for card in cards:
        torch.cuda.synchronize(card)
    for step, (a, b) in enumerate(zip(*frames)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f"step {step}"
    assert not torch.equal(frames[1][0], frames[1][1])


_NODE_SLAB_WORKER = """
import sys
import numpy as np
import torch
from volxel_tpu_torch.api.timeseries import TimeSeriesPlayer
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.parallel import initialize_multihost, make_mesh
from volxel_tpu_torch.parallel.distributed import DistributedRenderer
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

addr, pid, cards = sys.argv[1], int(sys.argv[2]), sys.argv[3].split(",")
device = torch.device(cards[pid])
torch.cuda.set_device(device)
assert initialize_multihost(addr, 2, pid, backend="gloo" if cards[0] == cards[1] else "nccl")
base = synthetic_ct_volume((40, 32, 32), bits_stored=12).astype(np.float32) / 4095.0
vols = np.stack([base * np.float32(1.0 - 0.2 * t) for t in range(4)])
frames = []
for mesh in (make_mesh(sp=1, px=1, devices=[(pid, device)]), make_mesh(sp=1, px=1, vz=2, devices=list(enumerate(cards)))):
    r = DistributedRenderer(32, 32, mesh=mesh, device=device)
    r.restart_from_grid(construct_brick_grid(vols[0], transform=np.eye(4, dtype=np.float32)))
    r.camera.rotate_around_view(0.4, 0.2)
    r.camera.zoom(2.0)
    r.settings.bounces = 2
    if mesh.shape.get("vz", 1) == 2:
        (key,) = r._slabbed.mapped
        assert key[1] == 1 - pid and r._slabbed.slabs[key].is_cuda, r._slabbed.slabs.keys()
    player = TimeSeriesPlayer(r, vols)
    out = []
    for t in (0, 1, 2, 3, 0, 1, 2, 3):  # a swap at every step, no host sync between them
        player.set_timestep(t)
        player.evict((t - 1) % len(vols))
        out.append(r.render_frame().clone())
    frames.append(out)
    r.close()
torch.cuda.synchronize(device)
for step, (a, b) in enumerate(zip(*frames)):
    assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f"step {step}"
assert not torch.equal(frames[1][0], frames[1][1])
assert "jax" not in sys.modules and "volxel_tpu" not in sys.modules
print(f"proc {pid} ok", flush=True)
torch.distributed.destroy_process_group()
"""


@pytest.mark.cuda
@pytest.mark.parametrize("cards", ["cuda:0,cuda:0", "cuda:0,cuda:1"])
def test_slab_row_across_two_processes(cuda_device, cards):
    """A vz = 2 row across two processes of the node, each holding its own
    slab and mapping the other's through CUDA IPC (parallel/nodeshare.py):
    on one card over gloo, and on cuda:0 and cuda:1 over NCCL (skips on
    one card). A time series swaps the timestep at every step, with no
    host sync between steps, so each swap releases slabs the other process
    may have just read; every step's framebuffer is bit-equal to the
    process's own vz = 1 player's."""
    if cards.endswith("cuda:1") and torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{sock.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=str(REPO), GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, "-c", _NODE_SLAB_WORKER, addr, str(pid), cards], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for pid in (0, 1)]
    try:
        outs = [proc.communicate(timeout=240) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for pid, (proc, (out, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0 and f"proc {pid} ok" in out, f"{out}\n{err[-3000:]}"


@pytest.mark.cuda
def test_slabs_over_two_cards(cuda_device):
    """vz = 2 over cuda:0 and cuda:1: each card's lanes read the other's
    slab with peer loads; bit-equal to vz = 1 on cuda:0 in each mode."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    for mode in ("default", "raymarch", "no_dda"):
        rep, slab = _slab_renderers([torch.device("cuda", 0), torch.device("cuda", 1)], mode, 2)
        kernels.reset_launch_counts()
        a, b = rep.render_frame(), slab.render_frame()
        assert b.device == torch.device("cuda", 0)
        _assert_bits_equal([b], [a])
        assert kernels.LAUNCHES[f"{_MODE_LEGS[mode][0][0]}_slabs"] == 2 * 2


# -- the per-ray RNG (csrc/rng.cu) ---------------------------------------------

_DRAWS = {"rng": (1, False), "rng2": (2, False), "rng3": (3, False), "rng_where": (1, True),
          "rng2_where": (2, True), "rng3_where": (3, True)}


def _call_draw(name, state, mask):
    fn = getattr(rng_mod, name)
    return fn(mask, state) if _DRAWS[name][1] else fn(state)


def _pixels(n, dtype, shape=None):
    """n pixel indices of `dtype` with the low ones, ones at and above
    2^32 / 42 (where 42 * p wraps) and, for int64, ones past 2^32 and
    below 0; reshaped to `shape` when given."""
    top = 2**31 - 1 if dtype == torch.int32 else 2**40
    g = np.random.default_rng(5)
    p = g.integers(0, top, n, dtype=np.int64)
    edge = [0, 1, 2**32 // 42, 2**32 // 42 + 1, 2**31 - 1]
    if dtype == torch.int64:
        edge += [2**32 - 1, 2**32, 2**32 + 7, -1, -42]
    p[:len(edge)] = edge[:n]
    t = torch.from_numpy(p).to(dtype)
    return t if shape is None else t.reshape(shape)


def _mask(kind, shape):
    if kind == "all":
        return torch.ones(shape, dtype=torch.bool)
    if kind == "none":
        return torch.zeros(shape, dtype=torch.bool)
    return torch.from_numpy(np.random.default_rng(9).random(shape) < 0.5)


def test_rng_on_cpu_tensors_takes_the_plain_path():
    """On CPU tensors seed_rays and every draw give the plain version's
    words and floats, and neither RNG counter moves."""
    kernels.reset_launch_counts()
    pix = _pixels(257, torch.int64)
    frames = torch.arange(257, dtype=torch.int64) * 3
    for frame in (7, frames):
        state = rng_mod.seed_rays(pix, frame)
        assert torch.equal(state, rng_mod.seed_rays_plain(pix, frame))
    mask = _mask("mixed", (257,))
    for name, (k, masked) in _DRAWS.items():
        got = _call_draw(name, state, mask)
        want = rng_mod.draw_plain(state, k, mask if masked else None)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
        state = got[0]
    assert kernels.LAUNCHES["rng_seed"] == kernels.LAUNCHES["rng_draw"] == 0


@pytest.mark.parametrize("case", ["cpu_state", "cpu_seed", "int32_state", "three_words", "k4", "byte_mask",
                                  "float_pixels", "float_frames"])
def test_rng_cuda_wrappers_refuse_what_the_kernels_do_not_take(case):
    """The RNG's CUDA wrappers raise, before any launch, on CPU tensors,
    on a state that is not (..., 4) int64, on k outside 1..3, on a mask
    that is not bool and on indices or frames that are not int32 or
    int64."""
    state = rng_mod.seed_rays_plain(_pixels(8, torch.int64), 3)
    calls = {
        "cpu_state": (lambda: rng_mod.draw_cuda(state, 2), "CUDA"),
        "cpu_seed": (lambda: rng_mod.seed_rays_cuda(_pixels(8, torch.int64), 3), "CUDA"),
        "int32_state": (lambda: rng_mod.draw_cuda(state.to(torch.int32), 1), "int64"),
        "three_words": (lambda: rng_mod.draw_cuda(state[:, :3], 1), r"\(\.\.\., 4\)"),
        "k4": (lambda: rng_mod.draw_cuda(state, 4), "k must be"),
        "byte_mask": (lambda: rng_mod.draw_cuda(state, 1, torch.ones(8, dtype=torch.uint8)), "bool"),
        "float_pixels": (lambda: rng_mod.seed_rays_cuda(torch.zeros(8), 3), "pixel indices"),
        "float_frames": (lambda: rng_mod.seed_rays_cuda(_pixels(8, torch.int64), torch.zeros(8)), "frames"),
    }
    fn, match = calls[case]
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        fn()
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("pixel_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("shape", [(4099,), (37, 61)])
@pytest.mark.parametrize("frame", ["int", "big_int", "per_pixel", "per_pixel_int32", "one_tensor"])
def test_seed_rays_kernel_bit_equal_to_plain(cuda_device, pixel_dtype, shape, frame):
    """One launch of rng_seed_kernel gives the plain version's words at
    every lane: int32 and int64 pixel indices (those at and above
    2^32 / 42 too), (n,) and (h, w), one frame as an int or a one-element
    tensor, or one frame a pixel as int64 or int32."""
    n = int(np.prod(shape))
    pix = _pixels(n, pixel_dtype, shape)
    frames = {"int": 5, "big_int": 2**31 + 3, "per_pixel": torch.arange(n, dtype=torch.int64).reshape(shape) * 7,
              "per_pixel_int32": torch.arange(n, dtype=torch.int32).reshape(shape) * 3 - 100,
              "one_tensor": torch.tensor(2**32 - 2, dtype=torch.int64)}[frame]
    on_card = frames.to(cuda_device) if isinstance(frames, torch.Tensor) else frames
    kernels.reset_launch_counts()
    got = rng_mod.seed_rays(pix.to(cuda_device), on_card)
    assert kernels.LAUNCHES["rng_seed"] == 1 and kernels.LAUNCHES["rng_draw"] == 0
    assert got.shape == (*shape, 4) and got.dtype == torch.int64
    assert torch.equal(got.cpu(), rng_mod.seed_rays_plain(pix, frames))


@pytest.mark.cuda
@pytest.mark.parametrize("name, mask_kind", [(name, kind) for name, (_, masked) in _DRAWS.items()
                                             for kind in (("all", "none", "mixed") if masked else (None,))])
@pytest.mark.parametrize("layout", ["flat", "image", "strided"])
def test_rng_draw_kernel_bit_equal_to_plain(cuda_device, name, mask_kind, layout):
    """One launch of rng_draw_kernel a call gives the plain version's
    words and floats at every lane, the masked-out lanes' values included:
    (n, 4) and (h, w, 4) states and a non-contiguous state[::2]; masks all
    true, all false and mixed. The state given is left as it was."""
    k, masked = _DRAWS[name]
    state = rng_mod.seed_rays_plain(_pixels(2 * 4099, torch.int64), 11)
    state = {"flat": state[:4099], "image": state[:37 * 61].reshape(37, 61, 4), "strided": state[::2]}[layout]
    mask = _mask(mask_kind or "all", state.shape[:-1])
    card = state.to(cuda_device)
    if layout == "strided":
        card = state.to(cuda_device).repeat_interleave(2, dim=0)[::2]
        assert not card.is_contiguous()
    kept = card.clone()
    kernels.reset_launch_counts()
    got_state, got = _call_draw(name, card, mask.to(cuda_device))
    assert kernels.LAUNCHES["rng_draw"] == 1 and kernels.LAUNCHES["rng_seed"] == 0
    want_state, want = rng_mod.draw_plain(state, k, mask if masked else None)
    assert torch.equal(got_state.cpu(), want_state) and torch.equal(got.cpu(), want)
    assert torch.equal(card, kept)


@pytest.mark.cuda
def test_rng_kernels_on_zero_lanes(cuda_device):
    """Zero lanes launch nothing and give empty outputs of the plain
    version's shapes."""
    kernels.reset_launch_counts()
    state = rng_mod.seed_rays(torch.zeros(0, dtype=torch.int64, device=cuda_device), 3)
    assert state.shape == (0, 4)
    for name, (k, _) in _DRAWS.items():
        s, x = _call_draw(name, state, torch.zeros(0, dtype=torch.bool, device=cuda_device))
        assert s.shape == (0, 4) and x.shape == ((0, k) if k > 1 else (0,))
    assert kernels.LAUNCHES["rng_seed"] == kernels.LAUNCHES["rng_draw"] == 0


@pytest.mark.cuda
def test_rng_stream_on_the_card_over_many_draws(cuda_device):
    """Seeding a 1080p frame on the card and drawing from it in turns of
    every form, masks changing each call, keeps the words bit-equal to the
    plain version's at every lane; one launch each call."""
    pix = torch.arange(1920 * 1080, dtype=torch.int64)
    kernels.reset_launch_counts()
    card = rng_mod.seed_rays(pix.to(cuda_device), 17)
    cpu = rng_mod.seed_rays_plain(pix, 17)
    g = np.random.default_rng(1)
    for i, (name, (k, masked)) in enumerate(list(_DRAWS.items()) * 2):
        mask = torch.from_numpy(g.random(pix.shape[0]) < 0.7)
        card, got = _call_draw(name, card, mask.to(cuda_device))
        cpu, want = rng_mod.draw_plain(cpu, k, mask if masked else None)
        assert torch.equal(got.cpu(), want), (i, name)
    assert torch.equal(card.cpu(), cpu)
    assert kernels.LAUNCHES["rng_seed"] == 1 and kernels.LAUNCHES["rng_draw"] == 2 * len(_DRAWS)


# -- the environment (csrc/env.cu) ---------------------------------------------

_ENV_LAUNCHES = ("env_sample", "env_lookup")


def _env_state(kind, strength, device):
    """The default 8x6 map, the fixture writers' 64x32 HDR map, or that map
    with its lower half and a band of columns black (the pyramid then holds
    quadrants of zero importance, where the warp's 1e-8 clamps act), built
    on `device`."""
    from volxel_tpu_torch.ingest.hdr import decode_env_bytes
    from volxel_tpu_torch.utils.fixtures import synthetic_env_hdr

    if kind == "default":
        image = env_mod.default_environment_image()
    else:
        image = np.array(decode_env_bytes(synthetic_env_hdr(64, 32))[..., :3], dtype=np.float32)
        if kind == "black":
            image[16:] = 0.0
            image[:, 8:20] = 0.0
    return env_mod.Environment(image, strength, device=device).state


def _uniforms(n):
    """n (n, 2) uniforms: every pair of 0, 0.5 and 1 - ulp first, then seeded ones."""
    u = np.random.default_rng(3).random((n, 2), dtype=np.float32)
    edge = np.array([0.0, 0.5, np.nextafter(np.float32(1.0), np.float32(0.0))], np.float32)
    u[:9] = np.stack(np.meshgrid(edge, edge), axis=-1).reshape(-1, 2)
    return torch.from_numpy(u)


def _directions(n):
    """n (n, 3) directions: the poles, the u seam (atan2 at +-pi), rows past
    v's clamp, |y| past 1, then seeded unit directions."""
    d = np.random.default_rng(4).normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    edge = np.array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [1e-7, 1.0, -1e-7], [-1e-7, -1.0, 1e-7],
                     [-1.0, 0.0, 0.0], [-1.0, 0.0, -0.0], [-1.0, 0.3, 1e-7], [-1.0, 0.3, -1e-7],
                     [-0.8, -0.6, -0.0], [0.02, 0.9998, 0.01], [0.02, -0.9998, -0.01], [0.0, 1.0000001, 0.0],
                     [0.5, -1.5, 0.5]], np.float32)
    d[:len(edge)] = edge
    return torch.from_numpy(d)


def _lanes_on(t, layout, device):
    """2 x 4099 lanes of `t` on `device` as (4099, k), (37, 61, k) or a
    non-contiguous [::2] of all of them."""
    if layout == "flat":
        return t[:4099].to(device)
    if layout == "image":
        return t[:37 * 61].reshape(37, 61, -1).to(device)
    lanes = t.to(device)[::2]
    assert not lanes.is_contiguous()
    return lanes


def _env_calls(env, direction, physical):
    """(name, entry point, plain version, arguments) of each lookup form."""
    return [("lookup", env_mod.lookup_environment, env_mod.lookup_environment_plain, (env, direction)),
            ("pdf", env_mod.pdf_environment, env_mod.pdf_environment_plain, (env, direction, physical)),
            ("lookup_pdf", env_mod.lookup_environment_pdf, env_mod.lookup_environment_pdf_plain,
             (env, direction, physical)),
            ("background", lambda e, d: env_mod.background_color(e, d, False), env_mod.lookup_environment_plain,
             (env, direction))]


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def test_env_on_cpu_tensors_takes_the_plain_path():
    """On CPU tensors every environment entry point gives the plain
    version's outputs bit for bit and launches nothing."""
    env = _env_state("hdr", 1.5, "cpu")
    rnd, d = _uniforms(256), _directions(256)
    kernels.reset_launch_counts()
    for physical in (False, True):
        _assert_bits_equal(env_mod.sample_environment(env, rnd, physical),
                           env_mod.sample_environment_plain(env, rnd, physical))
        for name, fn, plain, args in _env_calls(env, d, physical):
            got, want = _as_tuple(fn(*args)), _as_tuple(plain(*args))
            assert len(got) == len(want)
            _assert_bits_equal(got, want)
    assert not any(kernels.LAUNCHES.values())
    assert "env.cu" in kernels.FMAD_SOURCES


@pytest.mark.parametrize("case", ["cpu_lanes", "float64_uniforms", "three_uniforms", "two_components",
                                  "int_directions", "four_channel_map", "nine_levels", "wrong_level",
                                  "two_strengths"])
def test_env_cuda_wrappers_refuse_what_the_kernels_do_not_take(case):
    """The environment's CUDA wrappers raise, before any launch, on CPU
    tensors, on uniforms that are not (..., 2) f32, on directions that are
    not (..., 3) f32, on a map that is not (H, W, 3), on a pyramid that is
    not ten levels of 512^2 ... 1^2 and on more than one strength."""
    env = _env_state("default", 1.0, "cpu")
    rnd, d = _uniforms(16), _directions(16)
    mips = list(env.imp_mips)
    calls = {
        "cpu_lanes": (lambda: env_mod.sample_environment_cuda(env, rnd), "CUDA"),
        "float64_uniforms": (lambda: env_mod.sample_environment_cuda(env, rnd.double()), "float32"),
        "three_uniforms": (lambda: env_mod.sample_environment_cuda(env, d), r"\(\.\.\., 2\)"),
        "two_components": (lambda: env_mod.lookup_environment_cuda(env, rnd), r"\(\.\.\., 3\)"),
        "int_directions": (lambda: env_mod.pdf_environment_cuda(env, d.to(torch.int32)), "float32"),
        "four_channel_map": (lambda: env_mod.lookup_environment_pdf_cuda(
            env._replace(envmap=torch.zeros(6, 8, 4)), d), r"\(H, W, 3\)"),
        "nine_levels": (lambda: env_mod.sample_environment_cuda(env._replace(imp_mips=tuple(mips[:9])), rnd),
                        "importance levels"),
        "wrong_level": (lambda: env_mod.lookup_environment_cuda(
            env._replace(imp_mips=tuple(mips[:3] + [torch.zeros(32, 32)] + mips[4:])), d), "importance levels"),
        "two_strengths": (lambda: env_mod.sample_environment_cuda(env._replace(strength=torch.ones(2)), rnd),
                          "one strength"),
    }
    fn, match = calls[case]
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        fn()
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["default", "hdr", "black"])
@pytest.mark.parametrize("strength", [1.0, 1.5])
@pytest.mark.parametrize("physical", [False, True])
@pytest.mark.parametrize("layout", ["flat", "image", "strided"])
def test_env_sample_kernel_bit_equal_to_plain(cuda_device, kind, strength, physical, layout):
    """One launch of env_sample_kernel gives the plain warp's radiance, pdf
    and direction at every lane: the default 8x6 map, a 64x32 HDR map and
    one with black quadrants, strength 1 and 1.5, both pdfs, uniforms at
    0, 0.5 and 1 - ulp, flat, image and non-contiguous lanes."""
    env = _env_state(kind, strength, cuda_device)
    if kind == "black":
        assert all(bool((m == 0).any()) for m in env.imp_mips[:6])
    rnd = _lanes_on(_uniforms(2 * 4099), layout, cuda_device)
    kernels.reset_launch_counts()
    got = env_mod.sample_environment(env, rnd, physical)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"env_sample": 1}
    want = env_mod.sample_environment_plain(env, rnd, physical)
    assert [t.shape for t in got] == [t.shape for t in want]
    assert got[0].shape == (*rnd.shape[:-1], 3)
    _assert_bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["default", "hdr", "black"])
@pytest.mark.parametrize("strength", [1.0, 1.5])
@pytest.mark.parametrize("physical", [False, True])
@pytest.mark.parametrize("layout", ["flat", "image", "strided"])
def test_env_lookup_kernel_bit_equal_to_plain(cuda_device, kind, strength, physical, layout):
    """One launch of env_lookup_kernel a call gives the plain version's
    radiance, pdf, or both, at every lane (the poles, the u seam, v's
    clamp rows and |y| past 1 among them), and background_color's map."""
    env = _env_state(kind, strength, cuda_device)
    d = _lanes_on(_directions(2 * 4099), layout, cuda_device)
    for name, fn, plain, args in _env_calls(env, d, physical):
        kernels.reset_launch_counts()
        got = _as_tuple(fn(*args))
        assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"env_lookup": 1}, name
        want = _as_tuple(plain(*args))
        assert [t.shape for t in got] == [t.shape for t in want], name
        _assert_bits_equal(got, want)


@pytest.mark.cuda
def test_env_kernels_on_zero_lanes(cuda_device):
    """Zero lanes launch nothing and give empty outputs of the plain
    version's shapes."""
    env = _env_state("default", 1.0, cuda_device)
    rnd = torch.zeros(0, 2, device=cuda_device)
    d = torch.zeros(5, 0, 3, device=cuda_device)
    kernels.reset_launch_counts()
    got = env_mod.sample_environment(env, rnd, True)
    assert [t.shape for t in got] == [t.shape for t in env_mod.sample_environment_plain(env, rnd, True)]
    for name, fn, plain, args in _env_calls(env, d, False):
        assert [t.shape for t in _as_tuple(fn(*args))] == [t.shape for t in _as_tuple(plain(*args))], name
    assert not any(kernels.LAUNCHES[k] for k in _ENV_LAUNCHES)


def _plain_environment(monkeypatch):
    """Send every environment call on the card through the plain version."""
    for name in ("sample_environment", "lookup_environment", "pdf_environment", "lookup_environment_pdf"):
        monkeypatch.setattr(env_mod, f"{name}_cuda", getattr(env_mod, f"{name}_plain"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "raymarch", "no_dda"])
@pytest.mark.parametrize("setting", ["reference", "physical_pdf", "hdr", "no_use_env", "gradient_shading"])
def test_env_kernels_in_frames_bit_equal_to_plain(cuda_device, monkeypatch, mode, setting):
    """Two 32x24 frames at bounces 3 on the card give the same framebuffer
    bit for bit with the environment's kernels and with its plain version:
    the reference's pdf, the physical one, an HDR map, the light fallback
    (the escape's pdf alone) and gradient shading (one background lookup a
    frame). The kernels launch once a bounce each (env_lookup alone without
    use_env; one env_lookup a gradient-shaded frame)."""
    from volxel_tpu_torch.utils.fixtures import synthetic_env_hdr

    vol = synthetic_ct_volume((32, 32, 32), bits_stored=12)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))

    def frames():
        r = Renderer(32, 24, device=cuda_device)
        r.restart_from_grid(grid)
        if setting == "hdr":
            r.load_env(synthetic_env_hdr(64, 32), strength=1.5)
        r.render_mode = mode
        r.settings.physical_pdf = setting == "physical_pdf"
        r.settings.use_env = setting != "no_use_env"
        r.settings.gradient_shading = setting == "gradient_shading"
        assert r.settings.bounces == 3
        kernels.reset_launch_counts()
        for _ in range(2):
            fb = r.render_frame()
        return fb.clone(), {k: kernels.LAUNCHES[k] for k in _ENV_LAUNCHES}

    fb, launches = frames()
    want = {"gradient_shading": (0, 1), "no_use_env": (0, 3)}.get(setting, (3, 3))
    assert launches == {"env_sample": 2 * want[0], "env_lookup": 2 * want[1]}
    with monkeypatch.context() as m:
        _plain_environment(m)
        plain_fb, plain_launches = frames()
    assert plain_launches == dict.fromkeys(_ENV_LAUNCHES, 0)
    assert bool(torch.isfinite(fb).all()) and float(fb.mean()) > 0
    _assert_bits_equal([fb], [plain_fb])


# -- gradient shading (csrc/shade.cu) --------------------------------------------


def _shade_grid(device, field):
    """A renderer on `device` over a 40x32x32 CT at bounces 1, and the grid
    its shading reads: the dense field, or vz = 4 slabs of it on `device`
    with f32 or bf16 taps (`field`)."""
    from volxel_tpu_torch.parallel import make_mesh
    from volxel_tpu_torch.parallel.volshard import build_slabbed_volume

    vol = synthetic_ct_volume((40, 32, 32), bits_stored=12)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    r = Renderer(8, 8, device=device)
    r.restart_from_grid(grid)
    if field == "dense":
        return r, r._device_grid
    mesh = make_mesh(sp=1, px=1, vz=4, devices=[device] * 4)
    return r, build_slabbed_volume(r._device_grid, mesh, tap_dtype=field).local_grid()


def _shade_args(r, grid, origin_kind, n, background=True, seed=7):
    """shade_hits' arguments for n lanes on r's device whose hit points fall
    inside, on and around the extent: a quarter on a face (one coordinate
    at -1, -0.5, 0, 0.25, 0.5 or 1 from either end), an eighth at corners
    and edges (all three so), a quarter within 1e-5 of half-integers (where
    the base cell changes), the rest anywhere in the extent widened by 3;
    15% of the lanes missed, t at NaN, +inf, -inf and 0 on hit lanes,
    shadows of 0 and 1, the background (or None: black) with NaN and inf
    among the missed lanes. `origin_kind` "lanes" gives each lane its
    origin, "camera" one origin expanded over the lanes."""
    rng = np.random.default_rng(seed)
    device = r._device_grid.dense.device
    params = r.volume_params()
    ext = np.array(grid.extent, np.float64)
    ipos = rng.uniform(0.0, 1.0, (n, 3)) * (ext + 6.0) - 3.0
    near = np.array([-1.0, -0.5, 0.0, 0.25, 0.5, 1.0])
    specials = [np.concatenate([near, e - near]) for e in ext]
    k = np.arange(n)
    face, corner, half = k % 8 < 2, k % 8 == 2, k % 8 >= 6
    axis = rng.integers(0, 3, n)
    for a in range(3):
        rows = face & (axis == a)
        ipos[rows, a] = rng.choice(specials[a], rows.sum())
        ipos[corner, a] = rng.choice(specials[a], corner.sum())
    ipos[half] = np.round(ipos[half] * 2.0) / 2.0 + rng.choice([-1e-5, -1e-6, 0.0, 1e-6, 1e-5], (half.sum(), 3))
    m = params.transform_inv.cpu().double().numpy()
    world = (np.linalg.inv(m) @ np.concatenate([ipos, np.ones((n, 1))], 1).T).T[:, :3]
    if origin_kind == "camera":
        eye = np.array([0.3, -2.5, 1.7])
        t = np.linalg.norm(world - eye, axis=-1)
        d = (world - eye) / t[:, None]
        origin = torch.tensor(eye, dtype=torch.float32, device=device).expand(n, 3)
    else:
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t = rng.uniform(0.0, 3.0, n)
        origin = torch.from_numpy((world - t[:, None] * d).astype(np.float32)).to(device)
    t = t.astype(np.float32)
    hit = rng.random(n) < 0.85
    t[:4] = [np.nan, np.inf, -np.inf, 0.0]
    hit[:4] = True
    rgb = rng.random((n, 3), dtype=np.float32)
    shadow = rng.random(n, dtype=np.float32)
    shadow[::7], shadow[::11] = 0.0, 1.0
    bg = rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    bg[np.flatnonzero(~hit)[:6]] = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30], np.float32)[:, None]
    light_dir = torch.tensor(r.settings.light_dir, dtype=torch.float32, device=device)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (grid, params, light_dir, origin, on(d.astype(np.float32)), on(t), on(hit), on(rgb), on(shadow),
            on(bg) if background else None)


_SHADE_FIELDS = ("dense", "float32", "bfloat16")
_SHADE_LANES = (("lanes", True), ("camera", False))


def test_shade_lanes_cover_their_cases():
    """The shading tests' lanes (built here on the CPU) hit inside the
    extent and outside it, shade to radiance that varies with the normal,
    and give NaN or inf before sanitize on the lanes of special t."""
    r, grid = _shade_grid("cpu", "dense")
    args = _shade_args(r, grid, "lanes", 4099)
    _, params, _, origin, direction, t, hit = args[:7]
    ipos = sampling.world_to_index_point(params, origin + t[:, None] * direction)
    ext = torch.tensor(grid.extent, dtype=torch.float32)
    inside = ((ipos > 0.5) & (ipos < ext - 0.5)).all(-1)
    assert 0.3 < float(inside.float().mean()) < 0.9
    assert not bool(torch.isfinite(ipos[:3]).all())
    out = shading.shade_hits_plain(*args)
    shaded = out[hit & inside]
    assert bool((shaded != 0).any(-1).all()) and len(torch.unique(shaded[:, 0])) > 1000
    assert bool((out[~hit] == 0).any())  # the sanitized background


@pytest.mark.parametrize("field", _SHADE_FIELDS)
def test_shade_on_cpu_tensors_takes_the_plain_path(field):
    """On CPU tensors shade_hits is the plain version bit for bit, for a
    dense field and for slabs, and launches nothing."""
    r, grid = _shade_grid("cpu", field)
    kernels.reset_launch_counts()
    for origin_kind, background in _SHADE_LANES:
        args = _shade_args(r, grid, origin_kind, 2048, background)
        _assert_bits_equal([shading.shade_hits(*args)], [shading.shade_hits_plain(*args)])
    assert not any(kernels.LAUNCHES.values())
    assert "shade.cu" in kernels.FMAD_SOURCES


def test_shade_cuda_wrapper_refuses_cpu_tensors():
    """shade_hits_cuda raises on CPU tensors before any launch."""
    r, grid = _shade_grid("cpu", "dense")
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        shading.shade_hits_cuda(*_shade_args(r, grid, "lanes", 64))
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("field", _SHADE_FIELDS)
@pytest.mark.parametrize("origin_kind,background", _SHADE_LANES)
def test_shade_kernel_bit_equal_to_plain(cuda_device, field, origin_kind, background):
    """One launch of shade_kernel gives the plain version's radiance at
    every one of 1920 x 1080 lanes (_shade_args: hits inside, on the faces
    and corners of the extent and past it, missed lanes, t at NaN and
    +-inf), on a dense field and on vz = 4 slabs with f32 and bf16 taps,
    with an origin a lane and with one camera origin, over a background and
    over black."""
    r, grid = _shade_grid(cuda_device, field)
    args = _shade_args(r, grid, origin_kind, 1920 * 1080, background)
    kernels.reset_launch_counts()
    got = shading.shade_hits(*args)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"shade": 1}
    want = shading.shade_hits_plain(*args)
    assert got.shape == want.shape == (1920 * 1080, 3)
    _assert_bits_equal([got], [want])
    assert float(want[args[6]].abs().sum()) > 0


@pytest.mark.cuda
def test_shade_kernel_on_zero_lanes(cuda_device):
    """Zero lanes launch nothing and give an empty (0, 3) radiance."""
    r, grid = _shade_grid(cuda_device, "dense")
    args = _shade_args(r, grid, "lanes", 64)
    args = (*args[:3], *(a[:0] for a in args[3:]))
    kernels.reset_launch_counts()
    assert shading.shade_hits(*args).shape == (0, 3)
    assert kernels.LAUNCHES["shade"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "raymarch", "no_dda"])
def test_shade_kernel_in_frames_bit_equal_to_plain(cuda_device, monkeypatch, mode):
    """Two gradient-shaded 96x64 frames on the card give the same
    framebuffer bit for bit with csrc/shade.cu (one launch a frame) and
    with the plain version in its place."""

    vol = synthetic_ct_volume((32, 32, 32), bits_stored=12)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))

    def frames():
        r = Renderer(96, 64, device=cuda_device)
        r.restart_from_grid(grid)
        r.camera.rotate_around_view(0.4, 0.2)
        r.render_mode = mode
        r.settings.gradient_shading = True
        kernels.reset_launch_counts()
        for _ in range(2):
            fb = r.render_frame()
        return fb.clone(), kernels.LAUNCHES["shade"]

    fb, launches = frames()
    assert launches == 2
    with monkeypatch.context() as m:
        m.setattr(shading, "shade_hits_cuda", shading.shade_hits_plain)
        plain_fb, plain_launches = frames()
    assert plain_launches == 0
    assert bool(torch.isfinite(fb).all()) and float(fb.mean()) > 0
    _assert_bits_equal([fb], [plain_fb])


@pytest.mark.cuda
def test_shade_kernel_launches_once_a_shaded_frame(cuda_device):
    """kernels.LAUNCHES["shade"] counts one launch a gradient-shaded frame
    and none in a frame without gradient shading."""
    r = _renderer(cuda_device, side=32)
    kernels.reset_launch_counts()
    r.render_frame()
    assert kernels.LAUNCHES["shade"] == 0
    r.settings.gradient_shading = True
    for frame in range(1, 4):
        r.render_frame()
        assert kernels.LAUNCHES["shade"] == frame
