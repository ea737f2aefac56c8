"""Per-sample time of two checkouts of the PyTorch/CUDA port, in turns, on one card.

    python examples/ab_torch_paths.py BEFORE_DIR AFTER_DIR [--rounds 2] [--modes default,raymarch]
    python examples/ab_torch_paths.py --kernels DIR [DIR ...] [--rounds 2] [--reps 20]
    python examples/ab_torch_paths.py --table-fetch-turns 10
    python examples/ab_torch_paths.py --legs BEFORE_DIR AFTER_DIR [--modes default]

Each run is a fresh process in one checkout (its own volxel_tpu_torch and
chip_smoke.py, its kernels built from its own sources), in the order
before, after, after, before (repeated `--rounds` / 2 times). A run renders
chip_smoke.py's bench scene (512^3 synthetic CT, 1920x1080, bounces 1) in
each of --modes (default: the default and the raymarch mode; no_dda is
the third): 5 warm-up frames, then 5 frames timed
between two torch.cuda.synchronize() (ms/sample on the host clock), then
one sample under torch.profiler (device-side kernels and their busy ms).
Prints one JSON line per run and mode, and the card's name and power
limit first.

With --kernels it instead times the raymarch step-loop kernels of each
checkout (tile_march_sample and, where the checkout has it,
tile_march_transmittance) at the one call of each in a 1080p raymarch
sample of that scene: CUDA events over --reps launches, each on a fresh
copy of the RNG state (chip_smoke.device_ms), one process per checkout in
the order given, then reversed, --rounds times in all; one JSON line per
checkout and kernel.

With --legs it instead renders one 1080p sample of that scene in each
mode of --modes (default: the default mode; no_dda is the other) in each
checkout (one process each), in the default mode once with the
reference's shadow quirk and once with physical shadows, and records a
SHA-256 digest of every output of every call of the mode's two legs
(modes.sample_volume_dda and transmittance_dda, or sample_volume_simple
and transmittance_simple) and each call's time between two
torch.cuda.synchronize(); it prints one JSON line per checkout and sample
and exits 1 unless every digest agrees between the checkouts: the legs of
the two give the same bits. It guards a change to the legs that must keep
their bits (a redesign of csrc/dda_leg.cu or csrc/track_leg.cu, of the
plain legs or of the modes' setup): chip_smoke.py holds each leg kernel
only to the plain leg of its own checkout, so a change to both at once
shows only here.

With --table-fetch-turns N it instead runs one process in this checkout
and, in each mode, alternates samples with the table fetches (render.gather)
launching their kernels and taking their plain PyTorch versions (the code
the kernels replaced), N samples of each in the order kernel, plain, plain,
kernel, ...; it prints the mean and median ms/sample of each.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = r"""
import json, sys, time
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from volxel_tpu_torch import kernels
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

kernels.lib()
vol = synthetic_ct_volume((512,) * 3, bits_stored=12, seed=0)
grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
del vol
for mode in sys.argv[2].split(","):
    r = chip_smoke.bench_renderer(grid, 1920, 1080, "cuda", mode)
    for _ in range(5):
        r.render_frame()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        r.render_frame()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000 / 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r.render_frame()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    print(json.dumps({"tree": sys.argv[1], "mode": mode, "ms_per_sample": ms,
                      "device_kernels": sum(e.count for e in device),
                      "device_busy_ms": sum(e.device_time_total for e in device) / 1000}), flush=True)
    del r
    torch.cuda.empty_cache()
"""

KERNELS = r"""
import json, sys
import numpy as np
import torch

import chip_smoke
import volxel_tpu_torch.render.modes as modes
from volxel_tpu_torch import kernels
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.render import tilemarch
from volxel_tpu_torch.render.pathtrace import render_sample
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

kernels.lib()
reps = int(sys.argv[2])
vol = synthetic_ct_volume((512,) * 3, bits_stored=12, seed=0)
grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
del vol
r = chip_smoke.bench_renderer(grid, 1920, 1080, "cuda", "raymarch")


def with_state_copy(args, at):
    return args[:at] + (args[at].clone(),) + args[at + 1:]


calls = {}
for name, at in (("tile_march_sample", 8), ("tile_march_transmittance", 7)):
    if hasattr(modes, name):
        def capture(*args, name=name, at=at, original=getattr(modes, name)):
            calls.setdefault(name, (with_state_copy(args, at), at))
            return original(*args)
        setattr(modes, name, capture)
render_sample(*chip_smoke.sample_operands(r), 0)
for name, (args, at) in calls.items():
    copies = iter([with_state_copy(args, at) for _ in range(2 * reps)])
    launch = getattr(tilemarch, name + "_cuda")
    _, ms = chip_smoke.device_ms(lambda: launch(*next(copies)), reps)
    print(json.dumps({"tree": sys.argv[1], "kernel": name, "ms": ms, "lanes": int(args[6].sum())}), flush=True)
"""

LEGS = r"""
import hashlib, json, sys, time
import numpy as np
import torch

import chip_smoke
import volxel_tpu_torch.render.modes as modes
from volxel_tpu_torch import kernels
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.render.pathtrace import render_sample
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

kernels.lib()
vol = synthetic_ct_volume((512,) * 3, bits_stored=12, seed=0)
grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
del vol
mode = sys.argv[2]
r = chip_smoke.bench_renderer(grid, 1920, 1080, "cuda", mode)
calls = []
legs = {"default": ("sample_volume_dda", "transmittance_dda"),
        "no_dda": ("sample_volume_simple", "transmittance_simple")}[mode]
for name in legs:
    def recorded(*args, name=name, original=getattr(modes, name), **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(*args, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000
        calls.append({"leg": name, "ms": ms,
                      "digests": [hashlib.sha256(o.cpu().numpy().tobytes()).hexdigest() for o in out]})
        return out
    setattr(modes, name, recorded)
render_sample(*chip_smoke.sample_operands(r), 0)  # warm
for physical in (False, True) if mode == "default" else (False,):
    r.settings.physical_shadows = physical
    calls.clear()
    render_sample(*chip_smoke.sample_operands(r), 0)
    print(json.dumps({"tree": sys.argv[1], "mode": mode, "physical": physical, "legs": calls}), flush=True)
"""

TURNS = r"""
import json, statistics, sys, time
import numpy as np
import torch

import chip_smoke
from volxel_tpu_torch import kernels
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.render import gather
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

kernels.lib()
turns = int(sys.argv[1])
vol = synthetic_ct_volume((512,) * 3, bits_stored=12, seed=0)
grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
del vol
dispatch = {"kernel": (gather.gather_f32, gather.lookup_transfer_fetch),
            "plain": (gather.gather_f32_plain, gather.lookup_transfer_plain)}
for mode in ("default", "raymarch"):
    r = chip_smoke.bench_renderer(grid, 1920, 1080, "cuda", mode)
    for _ in range(5):
        r.render_frame()
    ms = {"kernel": [], "plain": []}
    for i in range(2 * turns):
        which = ("kernel", "plain", "plain", "kernel")[i % 4]
        gather.gather_f32, gather.lookup_transfer_fetch = dispatch[which]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render_frame()
        torch.cuda.synchronize()
        ms[which].append((time.perf_counter() - t0) * 1000)
    gather.gather_f32, gather.lookup_transfer_fetch = dispatch["kernel"]
    print(json.dumps({"mode": mode, **{f"{k}_{stat.__name__}_ms": stat(v) for k, v in ms.items()
                                       for stat in (statistics.mean, statistics.median)}, "samples": ms}),
          flush=True)
    del r
    torch.cuda.empty_cache()
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="checkouts: BEFORE AFTER, or any number with --kernels")
    ap.add_argument("--rounds", type=int, default=2, help="runs of each tree (even: before, after, after, before)")
    ap.add_argument("--kernels", action="store_true", help="time the raymarch step-loop kernels of each checkout")
    ap.add_argument("--reps", type=int, default=20, help="launches per kernel timing with --kernels")
    ap.add_argument("--legs", action="store_true",
                    help="compare the legs' outputs of BEFORE and AFTER bit for bit at one 1080p sample")
    ap.add_argument("--modes", help="comma-separated render modes (default: default,raymarch; with --legs default)")
    ap.add_argument("--table-fetch-turns", type=int, default=0,
                    help="alternate the table fetches' kernels and plain versions in this checkout instead")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if args.table_fetch_turns:
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        subprocess.run([sys.executable, "-c", TURNS, str(args.table_fetch_turns)], cwd=here,
                       env=dict(os.environ, PYTHONPATH=here), check=True, timeout=900)
        return 0
    if args.legs:
        if len(args.trees) != 2:
            ap.error("--legs needs BEFORE_DIR and AFTER_DIR")
        modes = (args.modes or "default").split(",")
        lines = {"before": [], "after": []}
        for mode in modes:
            for label, tree in zip(("before", "after"), args.trees):
                tree = os.path.abspath(tree)
                out = subprocess.run([sys.executable, "-c", LEGS, label, mode], cwd=tree,
                                     env=dict(os.environ, PYTHONPATH=tree), check=True, timeout=900,
                                     capture_output=True, text=True).stdout
                print(out, end="", flush=True)
                lines[label] += [json.loads(line) for line in out.splitlines() if line.startswith("{")]
        digests = {label: [[c["digests"] for c in line["legs"]] for line in found] for label, found in lines.items()}
        expected = sum(2 if mode == "default" else 1 for mode in modes)
        same = digests["before"] == digests["after"] and len(digests["after"]) == expected
        print(json.dumps({"legs_bit_equal": same, "calls": [len(line["legs"]) for line in lines["after"]]}))
        return 0 if same else 1
    if args.kernels:
        if not args.trees:
            ap.error("--kernels needs at least one checkout")
        labelled = [(tree, tree) for tree in args.trees]
        program, extra = KERNELS, [str(args.reps)]
    else:
        if len(args.trees) != 2:
            ap.error("BEFORE_DIR and AFTER_DIR are needed without --kernels or --table-fetch-turns")
        labelled = list(zip(("before", "after"), args.trees))
        program, extra = RUN, [args.modes or "default,raymarch"]
    order = []
    for i in range(args.rounds):
        order += labelled[:: 1 if i % 2 == 0 else -1]
    for label, tree in order:
        tree = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=tree)
        subprocess.run([sys.executable, "-c", program, label, *extra], cwd=tree, env=env, check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
