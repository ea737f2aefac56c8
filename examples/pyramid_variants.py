"""The importance pyramid's kernel (csrc/importance_pyramid.cu: one launch,
64 blocks and an atomic ticket) beside its thread-block-cluster variants
(examples/pyramid_variants.cu) and, with --parent, a former design, on the
default environment's 512^2 base, on one card.

    python examples/pyramid_variants.py [--parent DIR] [--rounds 4] [--reps 50]

Builds examples/pyramid_variants.cu with the flags volxel_tpu_torch.kernels
gives importance_pyramid.cu (and, with --parent, DIR's
csrc/importance_pyramid.cu alone, whose vx_pool2x2 builds one level a
launch), holds every kernel bit-equal to build_importance_pyramid_plain on
the base of Renderer(16, 16)'s default environment and on a seeded base
with NaN, +-inf, denormals and the largest floats in it (exit 1
otherwise), then times each in turns over --rounds rounds (the order
reversed every other round) by CUDA events (mean of --reps builds,
chip_smoke.device_ms), beside the launch floor (one launch of an empty
one-block kernel).

The card's name and power limit come first, then one JSON line per kernel
and round, and last per kernel its lowest and highest time over the rounds.
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
from volxel_tpu_torch import Renderer, kernels  # noqa: E402
from volxel_tpu_torch.render import pallas_ops  # noqa: E402
from volxel_tpu_torch.render.gather import launch_floor  # noqa: E402
from volxel_tpu_torch.scene.environment import IMP_BASE_MIP, IMP_DIM  # noqa: E402

SOURCE = Path(__file__).resolve().with_suffix(".cu")
VARIANTS = {0: "cluster8", 1: "cluster16"}
DIMS = [IMP_DIM >> (k + 1) for k in range(IMP_BASE_MIP)]


def build(src: Path, out_dir: Path, tag: str) -> ctypes.CDLL:
    """Compile `src` with importance_pyramid.cu's flags into a library."""
    nvcc = kernels._nvcc()
    flags = list(kernels._flags(kernels.CSRC / "importance_pyramid.cu"))
    lib = str(out_dir / f"{tag}.so")
    subprocess.run([nvcc, *flags, "-shared", "-o", lib, str(src)], check=True, timeout=600)
    return ctypes.CDLL(lib)


def levels_of(out: torch.Tensor) -> tuple:
    views, at = [], 0
    for d in DIMS:
        views.append(out[at:at + d * d].view(d, d))
        at += d * d
    return tuple(views)


def special_base(device) -> torch.Tensor:
    rng = np.random.default_rng(13)
    base = rng.uniform(0, 5, (IMP_DIM, IMP_DIM)).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 1e-40, -1e-40, 1e-45, 3.4e38, -3.4e38], dtype=np.float32)
    at = rng.choice(base.size, 400, replace=False)
    base.reshape(-1)[at] = special[np.arange(at.size) % special.size]
    return torch.from_numpy(base).to(device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose csrc/importance_pyramid.cu (vx_pool2x2) to time beside")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cuda = torch.device("cuda")
    bases = {"environment": Renderer(16, 16).environment.state.imp_mips[0], "special": special_base(cuda)}
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(SOURCE, Path(tmp), "variants")
        lib.vx_pyramid_variant.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.vx_pyramid_variant.restype = ctypes.c_int
        parent = None
        if args.parent:
            parent = build(Path(args.parent) / "volxel_tpu_torch" / "csrc" / "importance_pyramid.cu", Path(tmp),
                           "parent")
            parent.vx_pool2x2.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p]
            parent.vx_pool2x2.restype = ctypes.c_int

        def variant(v, base):
            out = torch.empty(sum(d * d for d in DIMS), dtype=torch.float32, device=cuda)
            code = lib.vx_pyramid_variant(v, base.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if code:
                raise SystemExit(f"variant {v}: cudaError {code}")
            return levels_of(out)

        def former(base):
            levels, src = [], base
            for d in DIMS:
                dst = torch.empty((d, d), dtype=torch.float32, device=cuda)
                code = parent.vx_pool2x2(src.data_ptr(), dst.data_ptr(), d, d, torch.cuda.current_stream().cuda_stream)
                if code:
                    raise SystemExit(f"parent: cudaError {code}")
                levels.append(dst)
                src = dst
            return tuple(levels)

        kernels_of = {"this": pallas_ops.build_importance_pyramid_cuda,
                      **{name: (lambda base, v=v: variant(v, base)) for v, name in VARIANTS.items()}}
        if parent is not None:
            kernels_of["parent"] = former
        for label, base in bases.items():
            want = pallas_ops.build_importance_pyramid_plain(base)
            for name, fn in kernels_of.items():
                got = fn(base)
                if not all(chip_smoke.bits_equal(a, b) for a, b in zip(got, want)):
                    print(json.dumps({"kernel": name, "base": label, "bit_equal": False}), flush=True)
                    return 1
        print(json.dumps({"bit_equal": True, "kernels": list(kernels_of), "bases": list(bases)}), flush=True)

        base = bases["environment"]
        order = [*kernels_of, "launch floor"]
        times = {}
        for rnd in range(args.rounds):
            for name in order[:: 1 if rnd % 2 == 0 else -1]:
                fn = (lambda: launch_floor(1, cuda)) if name == "launch floor" else (lambda f=kernels_of[name]: f(base))
                _, ms = chip_smoke.device_ms(fn, args.reps)
                times.setdefault(name, []).append(ms)
                print(json.dumps({"kernel": name, "round": rnd, "ms": ms}), flush=True)
        for name, ms in times.items():
            print(json.dumps({"kernel": name, "ms_low": min(ms), "ms_high": max(ms), "rounds": args.rounds}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
