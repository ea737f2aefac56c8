"""The no_dda leg kernels (csrc/track_leg.cu) beside their design variants
(examples/trackleg_variants.cu) and, with --parent, a former design, at
the calls of one 1080p no_dda sample, on one card.

    python examples/trackleg_variants.py [--parent DIR] [--rounds 2] [--variants 0,1,2]

Renders one no_dda sample of chip_smoke.py's bench scene (512^3 synthetic
CT, 1920x1080, bounces 1) through this checkout's kernels and records the
operands of each leg call. Builds examples/trackleg_variants.cu with the
flags volxel_tpu_torch.kernels gives track_leg.cu (and, with --parent,
DIR's csrc/track_leg.cu alone), and prints each build's `-Xptxas -v`
report, each kernel's registers and resident warps per SM, and the static
size of its event loop in SASS (chip_smoke.event_loop). Then, at each
recorded call:

  * holds every variant but the issue-only ones, this checkout's kernel
    and the parent's bit-equal to the plain leg on every output of every
    lane (exit 1 otherwise);
  * counts the events the lanes take and, in the shadow leg, the events
    with a roulette draw that the lane survives (where the speculation on
    no roulette draw re-derives its position);
  * in turns over --rounds rounds (the order reversed every other round),
    times each kernel by CUDA events (mean of --reps launches,
    chip_smoke.device_ms) and reads the variants' warp iterations, so
    that their warp efficiency is the events over 32 x those;
  * prints the issue floor of each (chip_smoke.issue_floor_ms at the card's
    largest SM clock, from its event loop's SASS and its warp iterations).

The variants (VARIANTS here, their template arguments in the .cu file)
change one thing at a time: the tap index's width, x taps paired in one
4- or 8-byte load, events ahead in flight (0-4), a persistent grid refilled
per warp or per lane, the tap fetch's instruction count ("lean": floors by
a magic-number add; "tight": 32-bit saturating casts, one corner index,
predicated loads), registers capped by launch bounds, and issue-only
twins whose loads read a register constant (their lanes forced to the
event counts of the plain run).

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
from volxel_tpu_torch.render import trackleg  # noqa: E402
from volxel_tpu_torch.render.pathtrace import render_sample  # noqa: E402
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume  # noqa: E402

SOURCE = Path(__file__).resolve().with_suffix(".cu")
# variant number: (name, ring phases of its event loop, issue-only); the
# template arguments are in SOURCE's VARIANTS list
VARIANTS = {
    0: ("wide_k1", 1, False), 1: ("narrow_k1", 1, False), 2: ("narrow_k2", 1, False), 3: ("narrow_k4", 1, False),
    4: ("k2_d1", 2, False), 5: ("k2_d2", 3, False), 6: ("k2_d4", 5, False), 7: ("k2_refill_warp", 1, False),
    8: ("k2_refill_lane", 1, False), 9: ("k2_d1_refill_lane", 2, False), 10: ("k1_d1", 2, False),
    11: ("k2_d2_refill_lane", 3, False), 12: ("issue_only_k2", 1, True), 13: ("issue_only_k2_d1", 2, True),
    14: ("issue_only_k2_d1_refill_lane", 2, True), 15: ("lean", 1, False), 16: ("lean_d1", 2, False),
    17: ("lean_d2", 3, False), 18: ("lean_d1_64regs", 2, False), 19: ("issue_only_lean", 1, True),
    20: ("issue_only_lean_d1", 2, True), 21: ("lean_d1_refill_warp", 2, False), 22: ("lean_d1_wide", 2, False),
    23: ("lean_48regs", 1, False), 24: ("tight", 1, False), 25: ("tight_d1", 2, False), 26: ("tight_d2", 3, False),
    27: ("issue_only_tight", 1, True), 28: ("issue_only_tight_d1", 2, True), 29: ("tight_wide", 1, False),
    30: ("tight_d1_wide", 2, False), 31: ("tight_d1_64regs", 2, False), 32: ("tight_d1_refill_lane", 2, False),
    33: ("tight_refill_warp", 1, False), 34: ("tight_d3", 4, False), 35: ("tight_d4", 5, False),
    36: ("issue_only_tight_d2", 3, True), 37: ("tight_d2_128regs", 3, False), 38: ("tight_d2_wide", 3, False),
}
WARPS_PER_BLOCK = 4  # leg_common.cuh's kThreads = 128
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# vx_trackleg_variant: leg, variant, dense, numel, ny, nx, ex, ey, ez, lut,
# lut_k, scalars, ipos, idir, far, t, state, running, tr, forced, cap,
# state_out, hit_out, t_out, rgb_out, tr_out, events_out, work, n, regs,
# per_sm, stream
VARIANT_ARGS = [_I, _I, _P, _L, _I, _I, _I, _I, _I, _P, _I] + [_P] * 9 + [_I] + [_P] * 7 + [_L, _P, _P, _P]


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


def roulette_survivals(plain_shadow_leg):
    """A stand-in for the plain shadow leg that also counts, in a list it
    returns beside it, the events of each call at which a lane made a
    roulette draw (tr < 0.1) and survived it (where a speculation on no
    roulette draw re-derives the lane's next point): trackleg.rng_where
    draws twice an event, first where tr < 0.1, then where the lane was not
    killed."""
    survived = []

    def run(*args):
        masks = []
        original = trackleg.rng_where

        def counting(mask, state):
            masks.append(int(mask.sum()) if len(masks) % 2 == 0 else int((~mask).sum()))
            return original(mask, state)

        trackleg.rng_where = counting
        try:
            out = plain_shadow_leg(*args)
        finally:
            trackleg.rng_where = original
        survived.append(sum(masks[0::2]) - sum(masks[1::2]))
        return out

    return run, survived


def record_calls(r) -> dict:
    """The operands of every leg call of one no_dda sample of `r`."""
    calls = {"sample": [], "shadow": []}
    originals = {"sample": modes.track_leg_sample, "shadow": modes.track_leg_shadow}

    def recording(leg):
        def run(*args):
            calls[leg].append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
            return originals[leg](*args)
        return run

    modes.track_leg_sample, modes.track_leg_shadow = recording("sample"), recording("shadow")
    try:
        render_sample(*chip_smoke.sample_operands(r), 0)
    finally:
        modes.track_leg_sample, modes.track_leg_shadow = originals["sample"], originals["shadow"]
    torch.cuda.synchronize()
    return calls


class Kernels:
    """Launchers of the variants, this checkout's kernels and the parent's
    at one leg call's operands."""

    def __init__(self, variants_lib, parent_lib):
        self.lib, self.parent = variants_lib, parent_lib
        self.lib.vx_trackleg_variant.argtypes = VARIANT_ARGS
        self.lib.vx_trackleg_variant.restype = ctypes.c_int
        if parent_lib is not None:
            for name in ("vx_track_leg_sample", "vx_track_leg_shadow"):
                getattr(parent_lib, name).argtypes = kernels._SIGNATURES[name]
                getattr(parent_lib, name).restype = ctypes.c_int

    def facts(self, leg: str, variant: int) -> tuple[int, int]:
        """(registers, resident blocks per SM) of a variant's kernel."""
        regs, per_sm = ctypes.c_int(), ctypes.c_int()
        work = torch.zeros(2, dtype=torch.int64, device="cuda")
        code = self.lib.vx_trackleg_variant(int(leg == "shadow"), variant, *([0] * 7), 0, 0, *([0] * 9), 0,
                                            *([0] * 6), work.data_ptr(), 0, ctypes.byref(regs),
                                            ctypes.byref(per_sm), torch.cuda.current_stream().cuda_stream)
        if code:
            raise SystemExit(f"variant {variant} ({leg}): cudaError {code}")
        return regs.value, per_sm.value

    def variant(self, leg: str, variant: int, args, forced=None):
        """One launch; returns the leg's outputs and the warps' iterations
        (a tensor on the card)."""
        dense, extent, scalars, lut, ipos, idir, far, t, state, running = args[:10]
        tr = args[10] if leg == "shadow" else None
        n = t.shape[0]
        state_o, events = torch.empty_like(state), torch.empty_like(t, dtype=torch.int32)
        hit, t_o = torch.empty_like(running), torch.empty_like(t)
        rgb, tr_o = torch.empty((n, 3), dtype=torch.float32, device=t.device), torch.empty_like(t)
        work = torch.empty(2, dtype=torch.int64, device=t.device)
        _, ny, nx = dense.shape
        ptr = (lambda a: 0 if a is None else a.data_ptr())
        code = self.lib.vx_trackleg_variant(
            int(leg == "shadow"), variant, dense.data_ptr(), dense.numel(), ny, nx, *extent, lut.data_ptr(),
            lut.shape[0], scalars.data_ptr(), *(a.data_ptr() for a in (ipos, idir, far, t, state, running)), ptr(tr),
            ptr(forced), trackleg.TRACKING_MAX_EVENTS, *(a.data_ptr() for a in (state_o, hit, t_o, rgb, tr_o, events)),
            work.data_ptr(), n, None, None, torch.cuda.current_stream().cuda_stream)
        if code:
            raise SystemExit(f"variant {variant} ({leg}): cudaError {code}")
        out = (state_o, hit, t_o, rgb, events) if leg == "sample" else (state_o, tr_o, events)
        return out, work[1]

    def former(self, leg: str, args):
        """One launch of the parent's kernel."""
        dense, extent, scalars, lut, ipos, idir, far, t, state, running = args[:10]
        n = t.shape[0]
        state_o, events = torch.empty_like(state), torch.empty_like(t, dtype=torch.int32)
        _, ny, nx = dense.shape
        head = (dense.data_ptr(), ny, nx, *extent, lut.data_ptr(), lut.shape[0], scalars.data_ptr(),
                *(a.data_ptr() for a in (ipos, idir, far, t, state, running)))
        stream = torch.cuda.current_stream().cuda_stream
        if leg == "sample":
            hit, t_o = torch.empty_like(running), torch.empty_like(t)
            rgb = torch.empty((n, 3), dtype=torch.float32, device=t.device)
            code = self.parent.vx_track_leg_sample(*head, trackleg.TRACKING_MAX_EVENTS,
                                                   *(a.data_ptr() for a in (state_o, hit, t_o, rgb, events)), n,
                                                   stream)
            out = (state_o, hit, t_o, rgb, events)
        else:
            tr_o = torch.empty_like(t)
            code = self.parent.vx_track_leg_shadow(*head, args[10].data_ptr(), trackleg.TRACKING_MAX_EVENTS,
                                                   *(a.data_ptr() for a in (state_o, tr_o, events)), n, stream)
            out = (state_o, tr_o, events)
        if code:
            raise SystemExit(f"parent {leg}: cudaError {code}")
        return out


def warp_lane_events(events_taken) -> int:
    """32 x the most events a lane of each warp of 32 lanes in pixel order
    takes, summed over the warps."""
    n = events_taken.numel()
    return 32 * int(torch.nn.functional.pad(events_taken, (0, (-n) % 32)).reshape(-1, 32).amax(dim=1).sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose csrc/track_leg.cu to time beside this one's")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", help="comma-separated variant numbers (default: all)")
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
    r = chip_smoke.bench_renderer(grid, args.width, args.height, "cuda", "no_dda")
    calls = record_calls(r)
    track_src = kernels.CSRC / "track_leg.cu"
    flags = [*kernels._flags(track_src), f"-I{kernels.CSRC}"]
    with tempfile.TemporaryDirectory() as tmp:
        variants_lib, variant_sass, _ = build(SOURCE, flags, Path(tmp), "variants", args.sass_dir)
        parent_lib = None
        _, this_sass, this_registers = build(track_src, list(kernels._flags(track_src)), Path(tmp), "this",
                                             args.sass_dir)
        if args.parent:
            parent_src = Path(args.parent) / "volxel_tpu_torch" / "csrc" / "track_leg.cu"
            parent_lib, parent_sass, _ = build(parent_src, list(kernels._flags(track_src)), Path(tmp), "parent")
        k = Kernels(variants_lib, parent_lib)

        # the static facts of every kernel: registers, resident warps, the event loop's size
        loops = {}
        for leg in ("sample", "shadow"):
            for v in chosen:
                name, phases, _ = VARIANTS[v]
                regs, per_sm = k.facts(leg, v)
                symbol = f"variant{v}_{leg}"
                body = next((b for fn, b in variant_sass.items() if f"{len(symbol)}{symbol}E" in fn), None)
                loops[(leg, name)] = chip_smoke.event_loop(body, phases) if body else None
                print(json.dumps({"kernel": name, "leg": leg, "registers": regs,
                                  "resident_warps_per_sm": per_sm * WARPS_PER_BLOCK, "event_loop": loops[(leg, name)]}),
                      flush=True)
            this_fn = next(fn for fn in this_sass if f"track_leg_{leg}_kernel" in fn)
            loops[(leg, "this")] = chip_smoke.event_loop(this_sass[this_fn])
            print(json.dumps({"kernel": "this", "leg": leg, "registers": this_registers[this_fn],
                              "resident_warps_per_sm": trackleg.resident_warps(leg, "cuda"),
                              "event_loop": loops[(leg, "this")]}), flush=True)
            if args.parent:
                body = next((b for fn, b in parent_sass.items() if f"track_leg_{leg}_kernel" in fn), None)
                loops[(leg, "parent")] = chip_smoke.event_loop(body) if body else None
                print(json.dumps({"kernel": "parent", "leg": leg, "event_loop": loops[(leg, "parent")]}), flush=True)

        # bit-equality and the counts of every call
        plain, counts = {}, {}
        for leg, found in calls.items():
            for c, call in enumerate(found):
                if leg == "sample":
                    want = trackleg.track_leg_sample_plain(*call)
                    rederived = 0
                else:
                    shadow_plain, survived = roulette_survivals(trackleg.track_leg_shadow_plain)
                    want = shadow_plain(*call)
                    rederived = survived[0]
                running = call[9]
                taken = torch.where(running, trackleg.TRACKING_MAX_EVENTS - want[-1], 0)
                lane_events = taken[running].double()
                counts[(leg, c)] = {"events": int(taken.sum()), "pixel_order_warp_lane_events": warp_lane_events(taken),
                                    "rederived": rederived, "lanes": int(running.sum()),
                                    "events_per_lane": {f"p{q}": float(lane_events.quantile(q / 100))
                                                        for q in (50, 90, 99, 100)},
                                    "lanes_at_cap": int((want[-1][running] == 0).sum())}
                plain[(leg, c)] = want
                print(json.dumps({"leg": leg, "call": c, **counts[(leg, c)]}), flush=True)
                for v in chosen:
                    name, _, fake = VARIANTS[v]
                    if fake:
                        continue
                    got, _ = k.variant(leg, v, call)
                    if not all(chip_smoke.bits_equal(a, b) for a, b in zip(got, want)):
                        print(json.dumps({"kernel": name, "leg": leg, "call": c, "bit_equal": False}), flush=True)
                        return 1
                mine = (trackleg.track_leg_sample_cuda if leg == "sample" else trackleg.track_leg_shadow_cuda)(*call)
                formers = [k.former(leg, call)] if parent_lib is not None else []
                for name, got in (("this", mine), *(("parent", f) for f in formers)):
                    if not all(chip_smoke.bits_equal(a, b) for a, b in zip(got, want)):
                        print(json.dumps({"kernel": name, "leg": leg, "call": c, "bit_equal": False}), flush=True)
                        return 1
        print(json.dumps({"bit_equal": True, "variants": [VARIANTS[v][0] for v in chosen if not VARIANTS[v][2]]}),
              flush=True)

        # in turns: each kernel's time, and the variants' warp iterations
        order = [("parent", None)] * bool(args.parent) + [("this", None)] + [(VARIANTS[v][0], v) for v in chosen]
        for rnd in range(args.rounds):
            for name, v in order[:: 1 if rnd % 2 == 0 else -1]:
                for (leg, c), want in plain.items():
                    call = calls[leg][c]
                    cnt = counts[(leg, c)]
                    row = {"kernel": name, "leg": leg, "call": c, "round": rnd}
                    if v is None:
                        fn = (lambda: k.former(leg, call)) if name == "parent" else (
                            lambda: (trackleg.track_leg_sample_cuda if leg == "sample"
                                     else trackleg.track_leg_shadow_cuda)(*call))
                        iterations = cnt["pixel_order_warp_lane_events"] // 32
                    else:
                        forced = want[-1] if VARIANTS[v][2] else None
                        fn = (lambda: k.variant(leg, v, call, forced))
                        iterations = int(fn()[1])
                    _, row["ms"] = chip_smoke.device_ms(fn, args.reps)
                    row["warp_efficiency"] = cnt["events"] / max(32 * iterations, 1)
                    loop = loops.get((leg, name))
                    row["issue_floor_ms"] = (chip_smoke.issue_floor_ms(loop["per_event"], iterations, clock_mhz, sms)
                                             if loop else None)
                    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
