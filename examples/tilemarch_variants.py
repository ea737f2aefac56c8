"""The raymarch shadow leg's step-loop kernel (tile_march_transmittance in
csrc/tile_march.cu) beside its design variants
(examples/tilemarch_variants.cu) and, with --parent, a former design, at
the calls of one 1080p raymarch sample, on one card.

    python examples/tilemarch_variants.py [--parent DIR] [--rounds 2] [--variants 2,3] [--bounces 1]

Renders one raymarch sample of chip_smoke.py's bench scene (512^3 synthetic
CT, 1920x1080, bounces 1 unless --bounces says otherwise) through this
checkout's kernels and records the operands of each shadow-leg call. Builds
examples/tilemarch_variants.cu with the flags volxel_tpu_torch.kernels
gives tile_march.cu, this checkout's csrc/tile_march.cu and, with --parent,
DIR's csrc/tile_march.cu, and prints each build's `-Xptxas -v` report, each
kernel's registers, resident warps per SM and the static SASS of one step
(chip_smoke.step_loop). Then, at each recorded call:

  * holds every variant but the issue-only ones, this checkout's kernel
    and the parent's bit-equal to the plain leg on the state and tau of
    every lane, and the issue-only ones to its words (exit 1 otherwise);
  * counts the lanes inside the box and the warps that hold one (32 lanes
    in pixel order): the warp efficiency;
  * in turns over --rounds rounds (the order reversed every other round),
    times each kernel by CUDA events (mean of --reps launches,
    chip_smoke.device_ms; a packed variant's pack kernel and its counter's
    reset included);
  * prints the issue floor of each: a step's SASS at every warp step (64
    steps of each warp with an inside lane; of ceil(inside / 32) warps for
    the packed variants) over 132 SMs x 4 a cycle at the card's largest SM
    clock.

The variants (VARIANTS here, their template arguments in the .cu file)
change one thing at a time: the taps of 1, 2 or 4 later steps in flight
(each step's tap consumed after the next one is issued, "ahead", or
before, "ring": a slot's tap consumed before it is refilled, or after,
over two sets of slots used in turns, "pingpong"),
the launch bounds' blocks per SM (1, or 10 and 12: 40 and 48 resident
warps), the 32-bit forms of the cell, the box
test and the LUT row, a 32-bit tap index, where the LUT is read from, the
inside lanes packed by a kernel on the card, and issue-only twins whose
taps are register constants.

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
from volxel_tpu_torch.render.pathtrace import render_sample  # noqa: E402
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume  # noqa: E402

SOURCE = Path(__file__).resolve().with_suffix(".cu")
# variant number: (name, issue-only, packed); the template arguments are in
# SOURCE's VARIANTS list
VARIANTS = {
    0: ("parent_form", False, False), 1: ("issue_only_parent_form", True, False), 2: ("ahead1", False, False),
    3: ("ahead2", False, False), 4: ("ahead4", False, False), 5: ("ahead2_nobounds", False, False),
    6: ("tight", False, False), 7: ("lut_when_inside", False, False), 8: ("lut_global", False, False),
    9: ("ahead1_tight", False, False), 10: ("ahead2_tight", False, False), 11: ("ahead4_tight", False, False),
    12: ("ahead2_tight_narrow", False, False), 13: ("ahead2_tight_lut_when_inside", False, False),
    14: ("ahead2_tight_lut_global", False, False), 15: ("ahead2_tight_packed", False, True),
    16: ("issue_only_ahead2_tight", True, False), 17: ("packed", False, True), 18: ("tight_minb10", False, False),
    19: ("tight_minb12", False, False), 20: ("ahead1_tight_minb10", False, False),
    21: ("ahead2_tight_minb10", False, False), 22: ("ahead2_tight_minb12", False, False),
    23: ("ahead2_tight_lut_global_minb10", False, False), 24: ("issue_only_tight_minb10", True, False),
    25: ("ring2_tight", False, False), 26: ("ring3_tight", False, False), 27: ("ring4_tight", False, False),
    28: ("ring2_tight_narrow", False, False), 29: ("issue_only_ring2_tight", True, False),
    30: ("ring3_tight_narrow", False, False), 31: ("pingpong1_tight", False, False),
    32: ("pingpong2_tight", False, False), 33: ("pingpong2_tight_narrow", False, False),
    34: ("issue_only_pingpong2_tight", True, False),
}
WARPS_PER_BLOCK = 4  # the .cu file's kThreads = 128
_P, _I = ctypes.c_void_p, ctypes.c_int
# vx_tilemarch_variant: variant, dense, ny, nx, ex, ey, ez, ipos, idir,
# start, dt, far, valid, state, lut, lut_k, scalars, state_out, tau_out,
# order, count, n, steps, regs, per_sm, stream
VARIANT_ARGS = [_I, _P, _I, _I, _I, _I, _I] + [_P] * 8 + [_I] + [_P] * 5 + [_I, _I, _P, _P, _P]


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


def record_calls(r) -> list:
    """The operands of every shadow-leg call of one raymarch sample of `r`."""
    calls = []
    original = modes.tile_march_transmittance

    def recording(*args):
        calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return original(*args)

    modes.tile_march_transmittance = recording
    try:
        render_sample(*chip_smoke.sample_operands(r), 0)
    finally:
        modes.tile_march_transmittance = original
    torch.cuda.synchronize()
    return calls


class Kernels:
    """Launchers of the variants and the parent's kernel at one shadow-leg
    call's operands."""

    def __init__(self, variants_lib, parent_lib):
        self.lib, self.parent = variants_lib, parent_lib
        self.lib.vx_tilemarch_variant.argtypes = VARIANT_ARGS
        self.lib.vx_tilemarch_variant.restype = ctypes.c_int
        if parent_lib is not None:
            parent_lib.vx_tile_march_transmittance.argtypes = kernels._SIGNATURES["vx_tile_march_transmittance"]
            parent_lib.vx_tile_march_transmittance.restype = ctypes.c_int

    def facts(self, variant: int, lut_k: int) -> tuple[int, int]:
        """(registers, resident blocks per SM) of a variant's kernel."""
        regs, per_sm = ctypes.c_int(), ctypes.c_int()
        code = self.lib.vx_tilemarch_variant(variant, None, 0, 0, 0, 0, 0, *([None] * 8), lut_k, *([None] * 5), 0,
                                             tilemarch.STEPS, ctypes.byref(regs), ctypes.byref(per_sm), None)
        if code:
            raise SystemExit(f"variant {variant}: cudaError {code}")
        return regs.value, per_sm.value

    def variant(self, variant: int, args):
        """One launch (and, for a packed variant, its pack kernel); returns
        (state, tau)."""
        dense, ipos, idir, start, dt, far, valid, state, lut, scalars, extent = args
        n = start.shape[0]
        _, ny, nx = dense.shape
        state_o, tau = torch.empty_like(state), torch.empty_like(start)
        order, count = torch.empty(n, dtype=torch.int32, device=start.device), torch.empty(
            1, dtype=torch.int32, device=start.device)
        code = self.lib.vx_tilemarch_variant(
            variant, dense.data_ptr(), ny, nx, *extent,
            *(a.data_ptr() for a in (ipos, idir, start, dt, far, valid, state, lut)), lut.shape[0],
            scalars.data_ptr(), state_o.data_ptr(), tau.data_ptr(), order.data_ptr(), count.data_ptr(), n,
            tilemarch.STEPS, None, None, torch.cuda.current_stream().cuda_stream)
        if code:
            raise SystemExit(f"variant {variant}: cudaError {code}")
        return state_o, tau

    def former(self, args):
        """One launch of the parent's kernel."""
        dense, ipos, idir, start, dt, far, valid, state, lut, scalars, extent = args
        _, ny, nx = dense.shape
        state_o, tau = torch.empty_like(state), torch.empty_like(start)
        code = self.parent.vx_tile_march_transmittance(
            dense.data_ptr(), ny, nx, *extent, *(a.data_ptr() for a in (ipos, idir, start, dt, far, valid, state, lut)),
            lut.shape[0], scalars.data_ptr(), state_o.data_ptr(), tau.data_ptr(), start.shape[0], tilemarch.STEPS,
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise SystemExit(f"parent: cudaError {code}")
        return state_o, tau


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose csrc/tile_march.cu to time beside this one's")
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
    r = chip_smoke.bench_renderer(grid, args.width, args.height, "cuda", "raymarch", args.bounces)
    calls = record_calls(r)
    if any(c[0].numel() >= 2**31 for c in calls) and any("narrow" in VARIANTS[v][0] for v in chosen):
        raise SystemExit("a 32-bit tap index needs a field of fewer than 2^31 elements")
    src = kernels.CSRC / "tile_march.cu"
    flags = list(kernels._flags(src))
    lut_k = calls[0][8].shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        variants_lib, variant_sass, _ = build(SOURCE, flags, Path(tmp), "variants", args.sass_dir)
        _, this_sass, this_registers = build(src, flags, Path(tmp), "this", args.sass_dir)
        parent_lib = None
        if args.parent:
            parent_src = Path(args.parent) / "volxel_tpu_torch" / "csrc" / "tile_march.cu"
            parent_lib, parent_sass, parent_registers = build(parent_src, flags, Path(tmp), "parent", args.sass_dir)
        k = Kernels(variants_lib, parent_lib)

        # the static facts of every kernel: registers, resident warps, a step's SASS
        loops = {}
        for v in chosen:
            name = VARIANTS[v][0]
            regs, per_sm = k.facts(v, lut_k)
            body = next((b for fn, b in variant_sass.items() if f"variant{v}_shadow" in fn), None)
            loops[name] = chip_smoke.step_loop(body) if body else None
            print(json.dumps({"kernel": name, "registers": regs, "resident_warps_per_sm": per_sm * WARPS_PER_BLOCK,
                              "step": loops[name]}), flush=True)
        # the kernel of the 512^3 field: with a 32-bit tap index where the file has one
        symbol = "tile_march_transmittance_kernel"
        this_fn = next((fn for fn in this_sass if f"{symbol}ILb1E" in fn), None) or next(
            fn for fn in this_sass if symbol in fn)
        loops["this"] = chip_smoke.step_loop(this_sass[this_fn])
        print(json.dumps({"kernel": "this", "registers": this_registers[this_fn],
                          "resident_warps_per_sm": tilemarch.resident_warps("shadow", lut_k, "cuda"),
                          "step": loops["this"]}), flush=True)
        if args.parent:
            fn = next((f for f in parent_sass if f"{symbol}ILb1E" in f), None) or next(
                (f for f in parent_sass if symbol in f), None)
            loops["parent"] = chip_smoke.step_loop(parent_sass[fn]) if fn else None
            print(json.dumps({"kernel": "parent", "registers": parent_registers.get(fn), "step": loops["parent"]}),
                  flush=True)

        # bit-equality and the counts of every call
        counts = []
        for c, call in enumerate(calls):
            want = tilemarch.tile_march_transmittance_plain(*call)
            valid = call[6]
            n = valid.numel()
            inside = int(valid.sum())
            with_inside = int(torch.nn.functional.pad(valid, (0, (-n) % 32)).reshape(-1, 32).any(dim=1).sum())
            counts.append({"lanes": n, "inside": inside, "warps_with_inside": with_inside,
                           "warp_efficiency": inside / max(32 * with_inside, 1)})
            print(json.dumps({"call": c, **counts[-1]}), flush=True)
            for v in chosen:
                name, fake, _ = VARIANTS[v]
                got = k.variant(v, call)
                ok = torch.equal(got[0], want[0]) if fake else all(
                    chip_smoke.bits_equal(a, b) for a, b in zip(got, want))
                if not ok:
                    print(json.dumps({"kernel": name, "call": c, "bit_equal": False}), flush=True)
                    return 1
            mine = tilemarch.tile_march_transmittance_cuda(*call)
            for name, got in (("this", mine), *((("parent", k.former(call)),) if parent_lib is not None else ())):
                if not all(chip_smoke.bits_equal(a, b) for a, b in zip(got, want)):
                    print(json.dumps({"kernel": name, "call": c, "bit_equal": False}), flush=True)
                    return 1
        print(json.dumps({"bit_equal": True, "variants": [VARIANTS[v][0] for v in chosen if not VARIANTS[v][1]]}),
              flush=True)

        # in turns: each kernel's time and issue floor
        order = [("parent", None)] * bool(args.parent) + [("this", None)] + [(VARIANTS[v][0], v) for v in chosen]
        times = {}  # per kernel: its ms summed over the calls, per round
        for rnd in range(args.rounds):
            for name, v in order[:: 1 if rnd % 2 == 0 else -1]:
                for c, call in enumerate(calls):
                    if v is None:
                        fn = (lambda: k.former(call)) if name == "parent" else (
                            lambda: tilemarch.tile_march_transmittance_cuda(*call))
                    else:
                        fn = (lambda: k.variant(v, call))
                    _, ms = chip_smoke.device_ms(fn, args.reps)
                    loop = loops.get(name)
                    floor = None
                    if loop:
                        cnt = counts[c]
                        warps = -(-cnt["inside"] // 32) if v is not None and VARIANTS[v][2] else cnt["warps_with_inside"]
                        floor = chip_smoke.issue_floor_ms(loop["per_step"], warps * tilemarch.STEPS, clock_mhz, sms)
                    print(json.dumps({"kernel": name, "call": c, "round": rnd, "ms": ms, "issue_floor_ms": floor}),
                          flush=True)
                    times.setdefault(name, [0.0] * args.rounds)[rnd] += ms
        for name, per_round in times.items():
            print(json.dumps({"kernel": name, "ms_low": min(per_round), "ms_high": max(per_round),
                              "rounds": args.rounds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
