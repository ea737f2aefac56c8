"""The raymarch step-loop kernels and the nearest-tap sums
(csrc/tile_march.cu) beside their design variants
(examples/tilemarch_variants.cu) and, with --parent, a former design, at
the calls of one 1080p raymarch sample, on one card.

    python examples/tilemarch_variants.py [--leg shadow|sample|sums] [--parent DIR] [--rounds 2]
                                          [--variants 2,3] [--bounces 1]

Renders one raymarch sample of chip_smoke.py's bench scene (512^3 synthetic
CT, 1920x1080, bounces 1 unless --bounces says otherwise) through this
checkout's kernels and records the operands of each call of the leg: the
shadow leg's step loop (tile_march_transmittance, the default), the camera
leg's (tile_march_sample), or tile_march_sums on the camera leg's rays at
64 steps. Builds examples/tilemarch_variants.cu with the flags
volxel_tpu_torch.kernels gives tile_march.cu, this checkout's
csrc/tile_march.cu and, with --parent, DIR's csrc/tile_march.cu, and prints
each build's `-Xptxas -v` report, each kernel's registers, resident warps
per SM and the static SASS of one step (chip_smoke.step_loop). Then, at
each recorded call:

  * holds every variant but the issue-only ones, this checkout's kernel
    and the parent's bit-equal to the plain version on every output of
    every lane (exit 1 otherwise); the shadow leg's issue-only variants to
    its words, the camera leg's to its words and hits (they are given tau
    targets at which their constant taps hit at the steps where the real
    taps do, so they take the same steps);
  * counts the lanes inside the box and the warps that hold one (32 lanes
    in pixel order) and the steps the lanes take: the warp efficiency (the
    steps over 32 times the most a lane of the warp takes); for the camera
    leg also the step at which the inside lanes hit (a histogram over the
    64 steps) and the lanes that never hit;
  * in turns over --rounds rounds (the order reversed every other round),
    times each kernel by CUDA events (mean of --reps launches,
    chip_smoke.device_ms; a packed variant's pack kernel and its counter's
    reset included);
  * prints the issue floor of each: a step's SASS at every warp step (the
    most steps a lane of each warp takes, summed over the warps; of
    ceil(inside / 32) warps of 64 steps for the packed variants) over 132
    SMs x 4 a cycle at the card's largest SM clock.

The variants (VARIANTS here, their template arguments in the .cu file)
change one thing at a time: the taps of 1, 2 or 4 later steps in flight
(each step's tap consumed after the next one is issued, "ahead", or
before, "ring": a slot's tap consumed before it is refilled, or after,
over two sets of slots used in turns, "pingpong"; in the camera leg
speculatively, past a lane's hit),
the launch bounds' blocks per SM (1, or 10 and 12: 40 and 48 resident
warps), a grid of 2-8 blocks an SM walking the lanes at its stride
("cap"), the 32-bit forms of the cell, the box
test and the LUT row, a 32-bit tap index, where the LUT is read from, the
inside lanes packed by a kernel on the card, the reservoir's compares
decided exactly in f64 without the division ("div64"), their divisor
clamped by one max.NaN ("nanmax"), the sums' taps
loaded a chunk of 4-32 steps at a time, and issue-only twins whose taps
are register constants.

The card's name and power limit come first, then one JSON line per build,
per kernel's static facts, per call's counts and per kernel, call and
round, and last per kernel its lowest and highest time over the rounds
(summed over the calls).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import volxel_tpu_torch.render.modes as modes  # noqa: E402
from volxel_tpu_torch import kernels  # noqa: E402
from volxel_tpu_torch.grid import construct_brick_grid  # noqa: E402
from volxel_tpu_torch.render import tilemarch  # noqa: E402
from volxel_tpu_torch.render.gather import lookup_transfer_plain  # noqa: E402
from volxel_tpu_torch.render.pathtrace import render_sample  # noqa: E402
from volxel_tpu_torch.render.sampling import (  # noqa: E402
    DeviceGrid,
    lookup_density_brick_int,
    stochastic_tricubic_offsets,
)
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume  # noqa: E402

SOURCE = Path(__file__).resolve().with_suffix(".cu")
# per leg, variant number: (name, issue-only, packed); the template arguments
# are in SOURCE's VARIANTS, SAMPLE_VARIANTS and SUMS_VARIANTS lists
VARIANTS = {
    "shadow": {
        0: ("parent_form", False, False), 1: ("issue_only_parent_form", True, False), 2: ("ahead1", False, False),
        3: ("ahead2", False, False), 4: ("ahead4", False, False), 5: ("ahead2_nobounds", False, False),
        6: ("tight", False, False), 7: ("lut_when_inside", False, False), 8: ("lut_global", False, False),
        9: ("ahead1_tight", False, False), 10: ("ahead2_tight", False, False), 11: ("ahead4_tight", False, False),
        12: ("ahead2_tight_narrow", False, False), 13: ("ahead2_tight_lut_when_inside", False, False),
        14: ("ahead2_tight_lut_global", False, False), 15: ("ahead2_tight_packed", False, True),
        16: ("issue_only_ahead2_tight", True, False), 17: ("packed", False, True),
        18: ("tight_minb10", False, False), 19: ("tight_minb12", False, False),
        20: ("ahead1_tight_minb10", False, False), 21: ("ahead2_tight_minb10", False, False),
        22: ("ahead2_tight_minb12", False, False), 23: ("ahead2_tight_lut_global_minb10", False, False),
        24: ("issue_only_tight_minb10", True, False), 25: ("ring2_tight", False, False),
        26: ("ring3_tight", False, False), 27: ("ring4_tight", False, False),
        28: ("ring2_tight_narrow", False, False), 29: ("issue_only_ring2_tight", True, False),
        30: ("ring3_tight_narrow", False, False), 31: ("pingpong1_tight", False, False),
        32: ("pingpong2_tight", False, False), 33: ("pingpong2_tight_narrow", False, False),
        34: ("issue_only_pingpong2_tight", True, False), 35: ("ahead2_tight_narrow_div64", False, False),
        36: ("ahead2_tight_narrow_nanmax", False, False),
    },
    "sample": {
        0: ("parent_form", False, False), 1: ("issue_only_parent_form", True, False), 2: ("tight", False, False),
        3: ("tight_narrow", False, False), 4: ("tight_narrow_minb1", False, False),
        5: ("ahead1_tight_narrow", False, False), 6: ("ahead2_tight_narrow", False, False),
        7: ("ahead1_tight_narrow_nobounds", False, False), 8: ("ahead2_tight_narrow_nobounds", False, False),
        9: ("div64", False, False), 10: ("tight_narrow_minb1_div64", False, False),
        11: ("ahead1_tight_narrow_div64", False, False), 12: ("ahead2_tight_narrow_div64", False, False),
        13: ("issue_only_tight_narrow_minb1", True, False), 14: ("issue_only_ahead1_tight_narrow", True, False),
        15: ("issue_only_ahead2_tight_narrow", True, False), 16: ("ahead1_tight", False, False),
        17: ("tight_narrow_cap8", False, False), 18: ("tight_narrow_cap6", False, False),
        19: ("issue_only_tight_narrow", True, False), 20: ("tight_narrow_nanmax", False, False),
        21: ("issue_only_tight_narrow_nanmax", True, False),
    },
    "sums": {
        0: ("parent_form", False, False), 1: ("issue_only_parent_form", True, False),
        2: ("tight_narrow", False, False), 3: ("chunk4_tight_narrow", False, False),
        4: ("chunk8_tight_narrow", False, False), 5: ("chunk16_tight_narrow", False, False),
        6: ("chunk8", False, False), 7: ("chunk16", False, False), 8: ("chunk16_tight", False, False),
        9: ("issue_only_chunk16_tight_narrow", True, False), 10: ("chunk32_tight_narrow", False, False),
        11: ("parent_form_cap8", False, False), 12: ("parent_form_cap6", False, False),
        13: ("parent_form_cap4", False, False), 14: ("chunk16_tight_narrow_cap8", False, False),
        15: ("chunk16_tight_narrow_cap6", False, False), 16: ("chunk16_tight_narrow_cap4", False, False),
        17: ("chunk16_tight_cap6", False, False), 18: ("chunk32_tight_narrow_cap6", False, False),
        19: ("chunk8_tight_narrow_cap6", False, False), 20: ("chunk16_tight_cap4", False, False),
        21: ("tight_narrow_cap6", False, False), 22: ("chunk16_tight_narrow_cap2", False, False),
        23: ("tight_narrow_cap2", False, False), 24: ("chunk16_tight_narrow_cap1", False, False),
        25: ("chunk16_tight_narrow_cap3", False, False), 26: ("chunk32_tight_narrow_cap2", False, False),
        27: ("chunk8_tight_narrow_cap2", False, False), 28: ("chunk16_tight_cap2", False, False),
        29: ("parent_form_cap2", False, False), 30: ("issue_only_chunk16_tight_narrow_cap2", True, False),
        31: ("chunk32_tight_narrow_cap1", False, False), 32: ("chunk4_tight_narrow_cap2", False, False),
    },
}
# per leg: the recorded function of modes, the variants' C entry point, this
# checkout's kernel symbol (a 32-bit-index instantiation where there is one),
# its wrapper, its plain version, the parent's C entry point and the leg's
# name for tilemarch.resident_warps
LEGS = {
    "shadow": ("tile_march_transmittance", "vx_tilemarch_variant", "tile_march_transmittance_kernel",
               tilemarch.tile_march_transmittance_cuda, tilemarch.tile_march_transmittance_plain,
               "vx_tile_march_transmittance", "shadow"),
    "sample": ("tile_march_sample", "vx_tilemarch_sample_variant", "tile_march_sample_kernel",
               tilemarch.tile_march_sample_cuda, tilemarch.tile_march_sample_plain, "vx_tile_march_sample",
               "sample"),
    "sums": ("tile_march_sample", "vx_tilemarch_sums_variant", "tile_march_sums_kernel",
             tilemarch.tile_march_sums_cuda, tilemarch.tile_march_sums_plain, "vx_tile_march_sums", "sums"),
}
WARPS_PER_BLOCK = 4  # the .cu file's kThreads = 128
_P, _I = ctypes.c_void_p, ctypes.c_int
# the variants' C entry points, each ending in n, steps, regs, per_sm, stream
VARIANT_ARGS = {
    # variant, dense, ny, nx, ex, ey, ez, ipos, idir, start, dt, far, valid,
    # state, lut, lut_k, scalars, state_out, tau_out, order, count
    "shadow": [_I, _P, _I, _I, _I, _I, _I] + [_P] * 8 + [_I] + [_P] * 5,
    # variant, dense, ny, nx, ex, ey, ez, ipos, idir, start, dt, far, valid,
    # tau_target, state, lut, lut_k, scalars, state_out, hit, t_out, rgb_out, fake
    "sample": [_I, _P, _I, _I, _I, _I, _I] + [_P] * 9 + [_I] + [_P] * 5 + [ctypes.c_uint],
    # variant, dense, ny, nx, ex, ey, ez, ipos, idir, start, dt, far, valid, sums
    "sums": [_I, _P, _I, _I, _I, _I, _I] + [_P] * 7,
}
TAIL_ARGS = [_I, _I, _P, _P, _P]
LUT_K_ARG = {"shadow": 15, "sample": 16}  # where lut_k lies among the arguments


def build(src: Path, flags: list[str], out_dir: Path, tag: str, sass_dir=None):
    """Compile `src` into a library; print its ptxas report; return the
    loaded library, its SASS by function and its kernels' registers."""
    nvcc = kernels._nvcc()
    obj, lib, cubin = (str(out_dir / f"{tag}.{ext}") for ext in ("o", "so", "cubin"))
    procs = [subprocess.Popen([nvcc, *flags, *extra, str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for extra in (["-Xptxas", "-v", "-cubin", "-o", cubin], ["-c", "-o", obj])]
    ptxas = ""
    for p in procs:
        _, err = p.communicate(timeout=900)
        if p.returncode:
            raise SystemExit(f"nvcc failed on {src}:\n{err}")
        ptxas = ptxas or err
    subprocess.run([nvcc, "-shared", *kernels.ARCH, "-o", lib, obj], check=True, timeout=300)
    sass = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", cubin], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    report = [line.strip() for line in ptxas.splitlines() if "entry function" in line or "Used" in line
              or "spill" in line]
    print(json.dumps({"build": tag, "ptxas": report}), flush=True)
    if sass_dir:
        Path(sass_dir).mkdir(parents=True, exist_ok=True)
        (Path(sass_dir) / f"{tag}.sass").write_text(sass)
    return ctypes.CDLL(lib), chip_smoke.sass_functions(sass), chip_smoke.ptxas_registers(ptxas)


def record_calls(r, leg: str) -> list:
    """The operands of every call of the leg in one raymarch sample of `r`
    (for the sums, the camera leg's rays at tilemarch.STEPS steps)."""
    calls = []
    name = LEGS[leg][0]
    original = getattr(modes, name)

    def recording(*args):
        calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return original(*args)

    setattr(modes, name, recording)
    try:
        render_sample(*chip_smoke.sample_operands(r), 0)
    finally:
        setattr(modes, name, original)
    torch.cuda.synchronize()
    if leg == "sums":
        calls = [(*c[:7], c[11], tilemarch.STEPS) for c in calls]
    return calls


def bf16_value(bits: int, device) -> torch.Tensor:
    """The f32 value of bf16 bits, as a (1,) tensor on `device`."""
    return torch.from_numpy(np.array([bits], np.uint16).view(np.int16)).view(torch.bfloat16).float().to(device)


def fake_bits(call) -> int:
    """bf16 bits of a density whose LUT row is not rejected and has alpha >
    0, for the camera leg's issue-only variants (the LUT row of the largest
    alpha that a bf16 value reaches)."""
    lut, scalars = call[9], call[10]
    k = lut.shape[0]
    for row in torch.argsort(lut[:, 3], descending=True).tolist():
        dens = (row + 0.5) / k
        v = torch.tensor(dens / float(scalars[2] * scalars[0]), dtype=torch.float32).to(torch.bfloat16)
        bits = int(v.view(torch.int16)) & 0xFFFF
        voxel = bf16_value(bits, lut.device)
        alpha = lookup_transfer_plain(lut, scalars[3:5], (scalars[2] * voxel) * scalars[0])[0, 3]
        if float(alpha) > 0:
            return bits
    raise SystemExit("no LUT row with alpha > 0 inside the sample range")


def twin_targets(call, bits: int, steps, hit) -> torch.Tensor:
    """Tau targets at which a camera lane whose every tap inside the extent
    reads `bits` (outside, 0, as the kernels' taps) hits at the step where
    the plain leg's lane hits (+inf where it never hits): its tau after
    that step, from the plain step loop over a field of that value, every
    lane taking every step. A real hit's tap adds to tau, so it lies inside
    the extent, where the twin's adds a constant > 0: the twin's tau
    reaches the target first at that step."""
    dense, ipos, idir, start, dt, far, valid, _, state, lut, scalars, extent = call
    grid = DeviceGrid(dense=torch.full_like(dense, float(bf16_value(bits, "cpu"))), maj_mips=None,
                      extent=tuple(extent))
    tau = torch.zeros_like(dt)
    targets = torch.full_like(dt, float("inf"))
    for k in range(tilemarch.STEPS):
        t = torch.minimum(start + k * dt, far)
        state, tap = stochastic_tricubic_offsets(ipos + t[:, None] * idir, state, valid)
        voxel = lookup_density_brick_int(grid, tap)
        tau = tau + lookup_transfer_plain(lut, scalars[3:5], (scalars[2] * voxel) * scalars[0])[:, 3] * scalars[1] * dt
        targets = torch.where(hit & (steps == k + 1), tau, targets)
    return targets


class Kernels:
    """Launchers of one leg's variants and the parent's kernel at a call's
    operands."""

    def __init__(self, leg, variants_lib, parent_lib):
        self.leg, self.lib, self.parent = leg, variants_lib, parent_lib
        self.fn = getattr(variants_lib, LEGS[leg][1])
        self.fn.argtypes = VARIANT_ARGS[leg] + TAIL_ARGS
        self.fn.restype = ctypes.c_int
        if parent_lib is not None:
            self.former_fn = getattr(parent_lib, LEGS[leg][5])
            self.former_fn.argtypes = kernels._SIGNATURES[LEGS[leg][5]]
            self.former_fn.restype = ctypes.c_int

    def facts(self, variant: int, lut_k: int) -> tuple[int, int]:
        """(registers, resident blocks per SM) of a variant's kernel."""
        regs, per_sm = ctypes.c_int(), ctypes.c_int()
        head = [variant] + [None if t is _P else 0 for t in VARIANT_ARGS[self.leg][1:]]
        if self.leg in LUT_K_ARG:
            head[LUT_K_ARG[self.leg]] = lut_k
        code = self.fn(*head, 0, tilemarch.STEPS, ctypes.byref(regs), ctypes.byref(per_sm), None)
        if code:
            raise SystemExit(f"variant {variant}: cudaError {code}")
        return regs.value, per_sm.value

    def variant(self, variant: int, args, fake=None):
        """One launch (and, for a packed variant, its pack kernel); returns
        the leg's outputs. `fake`: (bf16 bits, tau targets) of the camera
        leg's issue-only variants."""
        stream = torch.cuda.current_stream().cuda_stream
        if self.leg == "sums":
            dense, ipos, idir, start, dt, far, valid, extent, steps = args
            _, ny, nx = dense.shape
            sums = torch.empty_like(start)
            code = self.fn(variant, dense.data_ptr(), ny, nx, *extent,
                           *(a.data_ptr() for a in (ipos, idir, start, dt, far, valid, sums)), start.shape[0], steps,
                           None, None, stream)
            out = sums
        elif self.leg == "sample":
            dense, ipos, idir, start, dt, far, valid, tau_target, state, lut, scalars, extent = args
            bits, tau_target = fake if fake is not None else (0x3F00, tau_target)
            _, ny, nx = dense.shape
            state_o, hit, t_o, rgb = (torch.empty_like(a) for a in (state, valid, start, ipos))
            code = self.fn(variant, dense.data_ptr(), ny, nx, *extent,
                           *(a.data_ptr() for a in (ipos, idir, start, dt, far, valid, tau_target, state, lut)),
                           lut.shape[0], *(a.data_ptr() for a in (scalars, state_o, hit, t_o, rgb)), bits,
                           start.shape[0], tilemarch.STEPS, None, None, stream)
            out = (state_o, hit, t_o, rgb)
        else:
            dense, ipos, idir, start, dt, far, valid, state, lut, scalars, extent = args
            n = start.shape[0]
            _, ny, nx = dense.shape
            state_o, tau = torch.empty_like(state), torch.empty_like(start)
            order = torch.empty(n, dtype=torch.int32, device=start.device)
            count = torch.empty(1, dtype=torch.int32, device=start.device)
            code = self.fn(variant, dense.data_ptr(), ny, nx, *extent,
                           *(a.data_ptr() for a in (ipos, idir, start, dt, far, valid, state, lut)), lut.shape[0],
                           *(a.data_ptr() for a in (scalars, state_o, tau, order, count)), n, tilemarch.STEPS,
                           None, None, stream)
            out = (state_o, tau)
        if code:
            raise SystemExit(f"variant {variant}: cudaError {code}")
        return out

    def former(self, args):
        """One launch of the parent's kernel."""
        stream = torch.cuda.current_stream().cuda_stream
        if self.leg == "sums":
            dense, ipos, idir, start, dt, far, valid, extent, steps = args
            _, ny, nx = dense.shape
            sums = torch.empty_like(start)
            code = self.former_fn(dense.data_ptr(), ny, nx, *extent,
                                  *(a.data_ptr() for a in (ipos, idir, start, dt, far, valid, sums)), start.shape[0],
                                  steps, stream)
            out = sums
        elif self.leg == "sample":
            dense, ipos, idir, start, dt, far, valid, tau_target, state, lut, scalars, extent = args
            _, ny, nx = dense.shape
            state_o, hit, t_o, rgb = (torch.empty_like(a) for a in (state, valid, start, ipos))
            code = self.former_fn(dense.data_ptr(), ny, nx, *extent,
                                  *(a.data_ptr() for a in (ipos, idir, start, dt, far, valid, tau_target, state, lut)),
                                  lut.shape[0], *(a.data_ptr() for a in (scalars, state_o, hit, t_o, rgb)),
                                  start.shape[0], tilemarch.STEPS, stream)
            out = (state_o, hit, t_o, rgb)
        else:
            dense, ipos, idir, start, dt, far, valid, state, lut, scalars, extent = args
            _, ny, nx = dense.shape
            state_o, tau = torch.empty_like(state), torch.empty_like(start)
            code = self.former_fn(dense.data_ptr(), ny, nx, *extent,
                                  *(a.data_ptr() for a in (ipos, idir, start, dt, far, valid, state, lut)),
                                  lut.shape[0], scalars.data_ptr(), state_o.data_ptr(), tau.data_ptr(),
                                  start.shape[0], tilemarch.STEPS, stream)
            out = (state_o, tau)
        if code:
            raise SystemExit(f"parent: cudaError {code}")
        return out


def equal_outputs(got, want) -> bool:
    got, want = (got,) if isinstance(got, torch.Tensor) else got, (want,) if isinstance(want, torch.Tensor) else want
    return all(chip_smoke.bits_equal(a, b) for a, b in zip(got, want))


def call_counts(leg: str, call) -> tuple[dict, torch.Tensor | None, torch.Tensor | None]:
    """The lanes inside the box, the warps that hold one, the steps the
    lanes take and the warp steps (per warp the most a lane takes), the
    warp efficiency and, for the camera leg, where the lanes hit; also the
    camera leg's steps and hits per lane."""
    valid = call[6]
    n = valid.numel()
    pad = (-n) % 32
    steps_per_lane, hit = None, None
    if leg == "sample":
        out = tilemarch.tile_march_plain(*call)
        hit, steps_per_lane = out[1], out[5]
        taken = steps_per_lane
    else:
        taken = torch.where(valid, tilemarch.STEPS, 0)
    per_warp = torch.nn.functional.pad(taken, (0, pad)).reshape(-1, 32)
    counts = {"lanes": n, "inside": int(valid.sum()),
              "warps_with_inside": int(torch.nn.functional.pad(valid, (0, pad)).reshape(-1, 32).any(dim=1).sum()),
              "steps": int(taken.sum()), "warp_steps": int(per_warp.amax(dim=1).sum())}
    counts["warp_efficiency"] = counts["steps"] / max(32 * counts["warp_steps"], 1)
    if leg == "sample":
        at = steps_per_lane[hit] - 1
        counts["hit_step_histogram"] = torch.bincount(at, minlength=tilemarch.STEPS).tolist()
        counts["inside_hit"] = int(hit.sum())
        counts["inside_never_hit"] = counts["inside"] - counts["inside_hit"]
        counts["never_hit_share"] = counts["inside_never_hit"] / max(counts["inside"], 1)
        counts["mean_steps_inside"] = counts["steps"] / max(counts["inside"], 1)
    return counts, steps_per_lane, hit


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--leg", choices=tuple(LEGS), default="shadow")
    ap.add_argument("--parent", help="a checkout whose csrc/tile_march.cu to time beside this one's")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", help="comma-separated variant numbers (default: all of the leg's)")
    ap.add_argument("--bounces", type=int, default=1)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--sass-dir", help="a directory to write each build's cuobjdump -sass listing to")
    args = ap.parse_args()
    leg = args.leg
    table = VARIANTS[leg]
    _, _, symbol, this_fn, plain_fn, _, resident_leg = LEGS[leg]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    clock_mhz = float(smi.split(",")[-1].split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = [int(v) for v in args.variants.split(",")] if args.variants else list(table)

    vol = synthetic_ct_volume((args.size,) * 3, bits_stored=12, seed=0)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    del vol
    r = chip_smoke.bench_renderer(grid, args.width, args.height, "cuda", "raymarch", args.bounces)
    calls = record_calls(r, leg)
    if any(c[0].numel() >= 2**31 for c in calls) and any("narrow" in table[v][0] for v in chosen):
        raise SystemExit("a 32-bit tap index needs a field of fewer than 2^31 elements")
    src = kernels.CSRC / "tile_march.cu"
    flags = list(kernels._flags(src))
    lut_k = r._lut.shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        variants_lib, variant_sass, _ = build(SOURCE, flags, Path(tmp), "variants", args.sass_dir)
        _, this_sass, this_registers = build(src, flags, Path(tmp), "this", args.sass_dir)
        parent_lib = None
        if args.parent:
            parent_src = Path(args.parent) / "volxel_tpu_torch" / "csrc" / "tile_march.cu"
            parent_lib, parent_sass, parent_registers = build(parent_src, flags, Path(tmp), "parent", args.sass_dir)
        k = Kernels(leg, variants_lib, parent_lib)

        # the static facts of every kernel: registers, resident warps, a step's SASS
        loops = {}
        for v in chosen:
            name = table[v][0]
            regs, per_sm = k.facts(v, lut_k)
            body = next((b for fn, b in variant_sass.items() if f"variant{v}_{leg}" in fn), None)
            loops[name] = chip_smoke.step_loop(body) if body else None
            print(json.dumps({"kernel": name, "registers": regs, "resident_warps_per_sm": per_sm * WARPS_PER_BLOCK,
                              "step": loops[name]}), flush=True)

        def kernel_of(sass):
            """The function of `symbol` in a build: its 32-bit-index
            instantiation where the file has one (the 512^3 field's)."""
            return next((fn for fn in sass if f"{symbol}ILb1E" in fn), None) or next(
                (fn for fn in sass if symbol in fn), None)

        this_kernel = kernel_of(this_sass)
        loops["this"] = chip_smoke.step_loop(this_sass[this_kernel])
        try:
            resident = tilemarch.resident_warps(resident_leg, lut_k, "cuda")
        except ValueError:  # a checkout whose occupancy query lacks the leg
            resident = None
        print(json.dumps({"kernel": "this", "registers": this_registers.get(this_kernel),
                          "resident_warps_per_sm": resident, "step": loops["this"]}), flush=True)
        if args.parent:
            fn = kernel_of(parent_sass)
            loops["parent"] = chip_smoke.step_loop(parent_sass[fn]) if fn else None
            print(json.dumps({"kernel": "parent", "registers": parent_registers.get(fn), "step": loops["parent"]}),
                  flush=True)

        # bit-equality and the counts of every call
        counts, fakes = [], []
        for c, call in enumerate(calls):
            want = plain_fn(*call)
            cnt, steps_per_lane, hit = call_counts(leg, call)
            counts.append(cnt)
            print(json.dumps({"call": c, **cnt}), flush=True)
            if leg == "sample":
                bits = fake_bits(call)
                fakes.append((bits, twin_targets(call, bits, steps_per_lane, hit)))
            for v in chosen:
                name, issue_only, _ = table[v]
                got = k.variant(v, call, fakes[c] if leg == "sample" and issue_only else None)
                if not issue_only:
                    ok = equal_outputs(got, want)
                elif leg == "sums":
                    ok = True
                else:
                    ok = torch.equal(got[0], want[0]) and (leg == "shadow" or torch.equal(got[1], want[1]))
                if not ok:
                    print(json.dumps({"kernel": name, "call": c, "bit_equal": False}), flush=True)
                    return 1
            for name, got in (("this", this_fn(*call)),
                              *((("parent", k.former(call)),) if parent_lib is not None else ())):
                if not equal_outputs(got, want):
                    print(json.dumps({"kernel": name, "call": c, "bit_equal": False}), flush=True)
                    return 1
        print(json.dumps({"bit_equal": True, "variants": [table[v][0] for v in chosen if not table[v][1]]}),
              flush=True)

        # in turns: each kernel's time and issue floor
        order = [("parent", None)] * bool(args.parent) + [("this", None)] + [(table[v][0], v) for v in chosen]
        times = {}  # per kernel: its ms summed over the calls, per round
        for rnd in range(args.rounds):
            for name, v in order[:: 1 if rnd % 2 == 0 else -1]:
                for c, call in enumerate(calls):
                    if v is None:
                        fn = (lambda: k.former(call)) if name == "parent" else (lambda: this_fn(*call))
                    else:
                        fake = fakes[c] if leg == "sample" and table[v][1] else None
                        fn = (lambda: k.variant(v, call, fake))
                    _, ms = chip_smoke.device_ms(fn, args.reps)
                    loop = loops.get(name)
                    floor = None
                    if loop:
                        cnt = counts[c]
                        packed = v is not None and table[v][2]
                        warp_steps = -(-cnt["inside"] // 32) * tilemarch.STEPS if packed else cnt["warp_steps"]
                        floor = chip_smoke.issue_floor_ms(loop["per_step"], warp_steps, clock_mhz, sms)
                    print(json.dumps({"kernel": name, "call": c, "round": rnd, "ms": ms, "issue_floor_ms": floor}),
                          flush=True)
                    times.setdefault(name, [0.0] * args.rounds)[rnd] += ms
        for name, per_round in times.items():
            print(json.dumps({"kernel": name, "ms_low": min(per_round), "ms_high": max(per_round),
                              "rounds": args.rounds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
