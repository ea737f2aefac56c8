"""The default-mode leg kernels (csrc/dda_leg.cu) beside their design
variants (examples/ddaleg_variants.cu) and, with --parent, a former design,
at the calls of one 1080p default sample, on one card.

    python examples/ddaleg_variants.py [--parent DIR] [--rounds 2] [--variants 2,8] [--bounces 1]

Renders one default sample of chip_smoke.py's bench scene (512^3 synthetic
CT, 1920x1080, bounces 1 unless --bounces says otherwise) through this
checkout's kernels and records the operands of each leg call (the camera
leg and the shadow leg with the reference's quirk). Builds
examples/ddaleg_variants.cu with the flags volxel_tpu_torch.kernels gives
dda_leg.cu (and, with --parent, DIR's csrc/dda_leg.cu alone, against DIR's
own headers), and prints each build's `-Xptxas -v` report, each kernel's
registers and resident warps per SM, and the static sizes of its march
step and collision in SASS (chip_smoke.march_loops). Then, at each
recorded call:

  * holds every variant but the issue-only ones, this checkout's kernel
    and the parent's bit-equal to the plain leg on every output of every
    lane, and the issue-only ones to its steps (each lane's budget left)
    (exit 1 otherwise);
  * counts the plain rounds' march steps and collisions per lane and per
    warp (chip_smoke.march_rounds): the nested and the flat loop's warp
    iterations;
  * in turns over --rounds rounds (the order reversed every other round),
    times each kernel by CUDA events (mean of --reps launches,
    chip_smoke.device_ms);
  * prints the issue floor of each (its SASS sizes at the nested loop's
    warp iterations, or the flat loop's for the flat variants, over 132
    SMs x 4 a cycle at the card's largest SM clock).

The variants (VARIANTS here, their template arguments in the .cu file)
change one thing at a time: majorant fetches in flight (1-4), the launch
bounds' blocks per SM, the former tap form, the next segment's fetches issued
after the draws, a flat loop (each branch issuing its lane's next step, or
the warp's lanes issuing it together after the branches), a 32-bit
pyramid index, the levels 1-3 read from compact copies (from global
memory, or levels 2-3 from shared memory under a persistent grid), the
running lanes packed ahead of the others (the partition's time counted),
and issue-only twins whose loads read a register constant (their lanes forced
to the plain run's march rounds).

The card's name and power limit come first, then one JSON line per build,
per kernel's static facts, per call's counts and per kernel, call and
round.
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
from volxel_tpu_torch.render import ddaleg  # noqa: E402
from volxel_tpu_torch.render.pathtrace import render_sample  # noqa: E402
from volxel_tpu_torch.render.pyrmarch import KIND_COLL  # noqa: E402
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume  # noqa: E402

SOURCE = Path(__file__).resolve().with_suffix(".cu")
# variant number: (name, its loop: 0 nested, 1 or 2 flat, issue-only); the
# template arguments are in SOURCE's VARIANTS list
VARIANTS = {
    0: ("old_k1_late_nobounds", 0, False), 1: ("tight_k1_late", 0, False), 2: ("tight_k1", 0, False),
    3: ("tight_k2", 0, False), 4: ("tight_k3", 0, False), 5: ("tight_k4", 0, False), 6: ("flat_k1", 1, False),
    7: ("converged_k1", 2, False), 8: ("converged_k1_narrow", 2, False), 9: ("converged_k1_narrow_nobounds", 2, False),
    10: ("converged_k1_narrow_minb4", 2, False), 11: ("converged_k1_narrow_compact", 2, False),
    12: ("converged_k1_narrow_compact_smem", 2, False), 13: ("converged_k2_narrow", 2, False),
    14: ("converged_k1_narrow_packed", 2, False), 15: ("issue_only_old_k1_late_nobounds", 0, True),
    16: ("issue_only_converged_k1_narrow", 2, True),
}
PACKED = {14}  # the variants that take the lanes in packed_order's order
LOOPS = ("nested", "flat, each branch issuing", "flat, issued together")
WARPS_PER_BLOCK = 4  # leg_common.cuh's kThreads = 128
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# vx_ddaleg_variant: leg, variant, maj, bz, by, bx, levels, dims, dense, ny,
# nx, ex, ey, ez, lut, lut_k, scalars, ipos, idir, ri, far, t, tau, mip,
# state, running, tr, forced_at, forced_seg, order, cap, state_out, hit_out,
# t_out, rgb_out, tr_out, budget_out, n, regs, per_sm, stream
VARIANT_ARGS = ([_I, _I, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I] + [_P] * 14 + [_I] + [_P] * 6
                + [_L, _P, _P, _P])
SEG_DECODE, SEG_LAST = 1 << 13, 1 << 14  # the .cu file's kSegDecode, kSegLast
LEGS = ("sample", "shadow")


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


def record_calls(r) -> dict:
    """The operands of every leg call of one default sample of `r` (the
    shadow leg with the reference's quirk)."""
    calls = {"sample": [], "shadow": []}
    originals = {"sample": modes.dda_leg_sample, "shadow": modes.dda_leg_shadow}

    def recording(leg):
        def run(*args):
            calls[leg].append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
            return originals[leg](*args)
        return run

    modes.dda_leg_sample, modes.dda_leg_shadow = recording("sample"), recording("shadow")
    try:
        render_sample(*chip_smoke.sample_operands(r), 0)
    finally:
        modes.dda_leg_sample, modes.dda_leg_shadow = originals["sample"], originals["shadow"]
    torch.cuda.synchronize()
    return calls


def plain_rounds(leg: str, call):
    """The plain leg's outputs at `call`, its rounds (each lane's steps in
    a round and whether it collided) and the issue-only variants' forced
    segments (forced_segments)."""
    rounds, running = [], []
    original = ddaleg.pyr_march_plain

    def march(maj_alpha, extent, ipos, idir, ri, t, tau, mip, far, budget, run, cap):
        out = original(maj_alpha, extent, ipos, idir, ri, t, tau, mip, far, budget, run, cap)
        rounds.append((budget - out[-1], run & (out[4] == KIND_COLL)))
        running.append(run.clone())
        return out

    ddaleg.pyr_march_plain = march
    try:
        want = (ddaleg.dda_leg_sample_plain if leg == "sample" else ddaleg.dda_leg_shadow_plain)(*call)
    finally:
        ddaleg.pyr_march_plain = original
    return want, rounds, forced_segments(rounds, running)


def forced_segments(rounds, running):
    """Each lane's march rounds as the issue-only variants take them: per
    lane the index of its first segment in `seg` ((n + 1,) int32) and per
    segment its steps, SEG_DECODE where it ends in a collision that is
    decoded and SEG_LAST on the lane's last ((m,) int16)."""
    n = running[0].shape[0]
    last = torch.full((n,), -1, dtype=torch.int64, device=running[0].device)
    for r, run in enumerate(running):
        last = torch.where(run, r, last)
    lanes, order, values = [], [], []
    for r, ((steps, collided), run) in enumerate(zip(rounds, running)):
        idx = torch.nonzero(run).flatten()
        if bool((steps[idx] >= SEG_DECODE).any()):
            raise SystemExit("a march round longer than the forced segments hold")
        v = steps[idx].to(torch.int64) + SEG_DECODE * collided[idx] + SEG_LAST * (last[idx] == r)
        lanes.append(idx)
        order.append(idx * len(rounds) + r)
        values.append(v)
    order = torch.cat(order)
    perm = torch.argsort(order)
    seg = torch.cat(values)[perm].to(torch.int16).contiguous()
    counts = torch.bincount(torch.cat(lanes), minlength=n)
    at = torch.zeros(n + 1, dtype=torch.int32, device=seg.device)
    at[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return at, seg


def packed_order(running):
    """The lanes in the order the packed variants take them: the running
    ones first, then the others, each in pixel order; made on the card
    without a host sync (its time counts in the variant's)."""
    n = running.shape[0]
    run = running.to(torch.int32)
    before = torch.cumsum(run, 0, dtype=torch.int32) - run
    idle_before = torch.arange(n, dtype=torch.int32, device=running.device) - before
    slot = torch.where(running, before, run.sum(dtype=torch.int32) + idle_before)
    order = torch.empty(n, dtype=torch.int32, device=running.device)
    order[slot.long()] = torch.arange(n, dtype=torch.int32, device=running.device)
    return order


def compact_levels(maj):
    """Levels 1-3 of the (4, bz, by, bx) pyramid at their distinct values:
    level mi's bricks (vz, vy, vx) for vz, vy, vx multiples of 2^mi."""
    levels = [maj[mi, ::1 << mi, ::1 << mi, ::1 << mi].contiguous() for mi in (1, 2, 3)]
    dims = torch.tensor([d for lv in levels for d in lv.shape], dtype=torch.int32)
    return levels, dims


class Kernels:
    """Launchers of the variants, this checkout's kernels and the parent's
    at one leg call's operands."""

    def __init__(self, variants_lib, parent_lib):
        self.lib, self.parent = variants_lib, parent_lib
        self.lib.vx_ddaleg_variant.argtypes = VARIANT_ARGS
        self.lib.vx_ddaleg_variant.restype = ctypes.c_int
        if parent_lib is not None:
            for name in ("vx_dda_leg_sample", "vx_dda_leg_shadow"):
                getattr(parent_lib, name).argtypes = kernels._SIGNATURES[name]
                getattr(parent_lib, name).restype = ctypes.c_int
        self._levels = {}

    def facts(self, leg: str, variant: int) -> tuple[int, int]:
        """(registers, resident blocks per SM) of a variant's kernel."""
        regs, per_sm = ctypes.c_int(), ctypes.c_int()
        code = self.lib.vx_ddaleg_variant(LEGS.index(leg), variant, None, 0, 0, 0, None, None, None, 0, 0, 0, 0, 0,
                                          None, 0, *([None] * 14), 0, *([None] * 6), 0, ctypes.byref(regs),
                                          ctypes.byref(per_sm), None)
        if code:
            raise SystemExit(f"variant {variant} ({leg}): cudaError {code}")
        return regs.value, per_sm.value

    def levels(self, maj):
        key = maj.data_ptr()
        if key not in self._levels:
            levels, dims = compact_levels(maj)
            ptrs = (ctypes.c_void_p * 3)(*(lv.data_ptr() for lv in levels))
            self._levels[key] = (levels, dims, ptrs)
        return self._levels[key]

    def variant(self, leg: str, variant: int, args, forced=None, stream=None):
        """One launch; returns the leg's outputs."""
        dense, maj, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, state, running = args[:14]
        tr = args[14] if leg == "shadow" else None
        n = t.shape[0]
        state_o, budget = torch.empty_like(state), torch.empty_like(t, dtype=torch.int32)
        hit, t_o = torch.empty_like(running), torch.empty_like(t)
        rgb, tr_o = torch.empty((n, 3), dtype=torch.float32, device=t.device), torch.empty_like(t)
        _, bz, by, bx = maj.shape
        _, ny, nx = dense.shape
        levels, dims, ptrs = self.levels(maj)
        order = packed_order(running) if variant in PACKED else None  # held until the launch is enqueued
        ptr = (lambda a: None if a is None else a.data_ptr())
        code = self.lib.vx_ddaleg_variant(
            LEGS.index(leg), variant, maj.data_ptr(), bz, by, bx, ctypes.cast(ptrs, ctypes.c_void_p),
            dims.data_ptr(), dense.data_ptr(), ny, nx, *extent, lut.data_ptr(), lut.shape[0], scalars.data_ptr(),
            *(a.data_ptr() for a in (ipos, idir, ri, far, t, tau, mip, state, running)), ptr(tr),
            *((None, None) if forced is None else (forced[0].data_ptr(), forced[1].data_ptr())),
            ptr(order),
            ddaleg.DDA_SAMPLE_MAX_STEPS if leg == "sample" else ddaleg.DDA_TRANSMITTANCE_MAX_STEPS,
            *(a.data_ptr() for a in (state_o, hit, t_o, rgb, tr_o, budget)), n, None, None,
            torch.cuda.current_stream().cuda_stream if stream is None else stream)
        if code:
            raise SystemExit(f"variant {variant} ({leg}): cudaError {code}")
        return (state_o, hit, t_o, rgb, budget) if leg == "sample" else (state_o, tr_o, budget)

    def former(self, leg: str, args):
        """One launch of the parent's kernel."""
        dense, maj, extent, scalars, lut, ipos, idir, ri, far, t, tau, mip, state, running = args[:14]
        n = t.shape[0]
        _, bz, by, bx = maj.shape
        _, ny, nx = dense.shape
        state_o, budget = torch.empty_like(state), torch.empty_like(t, dtype=torch.int32)
        head = (maj.data_ptr(), bz, by, bx, dense.data_ptr(), ny, nx, *extent, lut.data_ptr(), lut.shape[0],
                scalars.data_ptr(), *(a.data_ptr() for a in (ipos, idir, ri, far, t, tau, mip, state, running)))
        stream = torch.cuda.current_stream().cuda_stream
        if leg == "sample":
            hit, t_o = torch.empty_like(running), torch.empty_like(t)
            rgb = torch.empty((n, 3), dtype=torch.float32, device=t.device)
            code = self.parent.vx_dda_leg_sample(*head, ddaleg.DDA_SAMPLE_MAX_STEPS,
                                                 *(a.data_ptr() for a in (state_o, hit, t_o, rgb, budget)), n, stream)
            out = (state_o, hit, t_o, rgb, budget)
        else:
            tr_o = torch.empty_like(t)
            code = self.parent.vx_dda_leg_shadow(*head, args[14].data_ptr(), ddaleg.DDA_TRANSMITTANCE_MAX_STEPS, 0,
                                                 *(a.data_ptr() for a in (state_o, tr_o, budget)), n, stream)
            out = (state_o, tr_o, budget)
        if code:
            raise SystemExit(f"parent {leg}: cudaError {code}")
        return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose csrc/dda_leg.cu to time beside this one's")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", help="comma-separated variant numbers (default: all)")
    ap.add_argument("--bounces", type=int, default=1)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--sass-dir", help="a directory to write each build's cuobjdump -sass listing to")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    clock_mhz = float(smi.split(",")[-1].split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = [int(v) for v in args.variants.split(",")] if args.variants else list(VARIANTS)

    vol = synthetic_ct_volume((args.size,) * 3, bits_stored=12, seed=0)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    del vol
    r = chip_smoke.bench_renderer(grid, args.width, args.height, "cuda", "default", args.bounces)
    calls = record_calls(r)
    dda_src = kernels.CSRC / "dda_leg.cu"
    flags = list(kernels._flags(dda_src))
    with tempfile.TemporaryDirectory() as tmp:
        variants_lib, variant_sass, _ = build(SOURCE, [*flags, f"-I{kernels.CSRC}"], Path(tmp), "variants",
                                              args.sass_dir)
        _, this_sass, this_registers = build(dda_src, flags, Path(tmp), "this", args.sass_dir)
        parent_lib = None
        if args.parent:
            parent_src = Path(args.parent) / "volxel_tpu_torch" / "csrc" / "dda_leg.cu"
            parent_lib, parent_sass, parent_registers = build(parent_src, flags, Path(tmp), "parent", args.sass_dir)
        k = Kernels(variants_lib, parent_lib)

        # the static facts of every kernel: registers, resident warps, the march's SASS sizes
        loops = {}
        for leg in LEGS:
            for v in chosen:
                name = VARIANTS[v][0]
                regs, per_sm = k.facts(leg, v)
                symbol = f"variant{v}_{leg}"
                body = next((b for fn, b in variant_sass.items() if f"{len(symbol)}{symbol}E" in fn), None)
                loops[(leg, name)] = chip_smoke.march_loops(body) if body else None
                print(json.dumps({"kernel": name, "leg": leg, "loop": LOOPS[VARIANTS[v][1]], "registers": regs,
                                  "resident_warps_per_sm": per_sm * WARPS_PER_BLOCK, "march": loops[(leg, name)]}),
                      flush=True)
            symbol = "dda_leg_sample_kernel" if leg == "sample" else "dda_leg_shadow_kernelILb0E"
            this_fn = next(fn for fn in this_sass if symbol in fn)
            loops[(leg, "this")] = chip_smoke.march_loops(this_sass[this_fn])
            print(json.dumps({"kernel": "this", "leg": leg, "registers": this_registers[this_fn],
                              "resident_warps_per_sm": ddaleg.resident_warps(leg, "cuda"),
                              "march": loops[(leg, "this")]}), flush=True)
            if args.parent:
                fn = next((f for f in parent_sass if symbol in f), None)
                loops[(leg, "parent")] = chip_smoke.march_loops(parent_sass[fn]) if fn else None
                print(json.dumps({"kernel": "parent", "leg": leg, "registers": parent_registers.get(fn),
                                  "march": loops[(leg, "parent")]}), flush=True)

        # bit-equality and the counts of every call
        plain, counts, forced = {}, {}, {}
        for leg, found in calls.items():
            for c, call in enumerate(found):
                want, rounds, forced[(leg, c)] = plain_rounds(leg, call)
                stats = chip_smoke.march_stats()
                chip_smoke.march_rounds(stats, rounds, call[9].shape[0])
                counts[(leg, c)] = {key: stats[key] for key in ("steps", "collisions", "flat", "flat_coll_iters",
                                                                "nested", "coll_iters", "longest_steps",
                                                                "longest_collisions")}
                counts[(leg, c)]["lanes"] = int(call[13].sum())
                plain[(leg, c)] = want
                print(json.dumps({"leg": leg, "call": c, **counts[(leg, c)]}), flush=True)
                for v in chosen:
                    name, _, fake = VARIANTS[v]
                    if fake:  # the forced segments take each lane's steps: its budget left is the plain one
                        got = k.variant(leg, v, call, forced[(leg, c)])
                        if not torch.equal(got[-1], want[-1]):
                            print(json.dumps({"kernel": name, "leg": leg, "call": c, "forced_steps": False}), flush=True)
                            return 1
                        continue
                    got = k.variant(leg, v, call)
                    if not all(chip_smoke.bits_equal(a, b) for a, b in zip(got, want)):
                        print(json.dumps({"kernel": name, "leg": leg, "call": c, "bit_equal": False}), flush=True)
                        return 1
                mine = (ddaleg.dda_leg_sample_cuda if leg == "sample" else ddaleg.dda_leg_shadow_cuda)(*call)
                formers = [k.former(leg, call)] if parent_lib is not None else []
                for name, got in (("this", mine), *(("parent", f) for f in formers)):
                    if not all(chip_smoke.bits_equal(a, b) for a, b in zip(got, want)):
                        print(json.dumps({"kernel": name, "leg": leg, "call": c, "bit_equal": False}), flush=True)
                        return 1
        print(json.dumps({"bit_equal": True, "variants": [VARIANTS[v][0] for v in chosen if not VARIANTS[v][2]]}),
              flush=True)

        # in turns: each kernel's time and issue floor
        order = [("parent", None)] * bool(args.parent) + [("this", None)] + [(VARIANTS[v][0], v) for v in chosen]
        for rnd in range(args.rounds):
            for name, v in order[:: 1 if rnd % 2 == 0 else -1]:
                for (leg, c), want in plain.items():
                    call = calls[leg][c]
                    cnt = counts[(leg, c)]
                    if v is None:
                        fn = (lambda: k.former(leg, call)) if name == "parent" else (
                            lambda: (ddaleg.dda_leg_sample_cuda if leg == "sample"
                                     else ddaleg.dda_leg_shadow_cuda)(*call))
                    else:
                        fn = (lambda: k.variant(leg, v, call, forced[(leg, c)] if VARIANTS[v][2] else None))
                    _, ms = chip_smoke.device_ms(fn, args.reps)
                    loop = loops.get((leg, name))
                    floor = None
                    if loop:
                        if loop["loop"] == "flat":
                            warp_instrs = cnt["flat"] * loop["step"] + cnt["flat_coll_iters"] * loop["collision"]
                        else:
                            warp_instrs = cnt["nested"] * loop["step"] + cnt["coll_iters"] * loop["collision"]
                        floor = warp_instrs / (sms * 4 * clock_mhz * 1e3)
                    print(json.dumps({"kernel": name, "leg": leg, "call": c, "round": rnd, "ms": ms,
                                      "issue_floor_ms": floor}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
