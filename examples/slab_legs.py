"""The legs' kernel time over volume slabs against the same split of the lanes over the dense field, on one card.

    python examples/slab_legs.py [--size 512] [--width 1920] [--height 1080] [--rounds 2] [--device cuda:0]
    python examples/slab_legs.py --two-cards [--rounds 2]

chip_smoke.py's bench scene (512^3 synthetic CT, bounces 1) through three
DistributedRenderers on the card: "dense" (vz = 1: each leg one call over
every lane, the dense kernel), "split" (a (1, 1, 4) mesh whose third axis
is not named 'vz', so the grid stays whole: four calls of a quarter of the
lanes each, the dense kernel) and "slabs" (vz = 4: the same four calls,
the slab form). In each mode, --rounds rounds of one held step of each in
the order dense, split, slabs, slabs, split, dense (chip_smoke.held_slab_step:
every kernel call held bit for bit against its plain version and timed
with CUDA events) print each leg's kernel ms summed over a step's calls.
"split" against "dense" is what cutting the lanes into four launches
costs; "slabs" against "split" is what the slab table costs. Prints the
card's name and power limit first.

With --two-cards (a machine with two cards or more) it instead times
whole steps, host clock, both cards fenced, of a vz = 1 renderer on
cuda:0, a vz = 2 one whose positions both name cuda:0 and a vz = 2 one
over cuda:0 and cuda:1 (each card's lanes read the other's slab with
peer loads over NVLink), --rounds rounds in the order given and back, in
each mode after one untimed step, and checks that the three framebuffers
are bit-equal.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def renderers(grid, width: int, height: int, device: str) -> dict:
    import torch

    from volxel_tpu_torch.parallel import make_mesh
    from volxel_tpu_torch.parallel.mesh import Mesh

    devices = np.empty(4, dtype=object)
    devices[:] = [torch.device(device)] * 4
    split = Mesh(devices.reshape(1, 1, 4), np.zeros((1, 1, 4), np.int64), ("sp", "px", "parts"))
    meshes = {"dense": make_mesh(sp=1, px=1, devices=[device]), "split": split,
              "slabs": make_mesh(sp=1, px=1, vz=4, devices=[device] * 4)}
    return {name: chip_smoke.slab_renderer(grid, width, height, mesh, device)[0] for name, mesh in meshes.items()}


def two_cards(grid, width: int, height: int, rounds: int) -> None:
    import torch

    from volxel_tpu_torch.parallel import make_mesh

    meshes = {"vz=1": make_mesh(sp=1, px=1, devices=["cuda:0"]),
              "vz=2 one card": make_mesh(sp=1, px=1, vz=2, devices=["cuda:0"] * 2),
              "vz=2 two cards": make_mesh(sp=1, px=1, vz=2, devices=["cuda:0", "cuda:1"])}
    rs = {name: chip_smoke.slab_renderer(grid, width, height, mesh, "cuda:0")[0] for name, mesh in meshes.items()}

    def fenced(fn):
        for d in range(2):
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        fn()
        for d in range(2):
            torch.cuda.synchronize(d)
        return (time.perf_counter() - t0) * 1000

    order = [*rs, *reversed(rs)]
    for mode in chip_smoke.MODE_LEGS:
        ms = {name: [] for name in rs}
        for r in rs.values():
            r.render_mode = mode
            r.render_frame()
        for _ in range(rounds):
            for name in order:
                ms[name].append(fenced(rs[name].render_frame))
        first = rs["vz=1"]._framebuffer
        if not all(chip_smoke.bits_equal(r._framebuffer, first) for r in rs.values()):
            raise SystemExit(f"{mode}: the framebuffers differ")
        print(f"{mode} steps: " + "; ".join(f"{name} {min(v):.3f}-{max(v):.3f} ms" for name, v in ms.items())
              + "; framebuffers bit-equal", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--two-cards", action="store_true")
    args = ap.parse_args()

    from volxel_tpu_torch.grid import construct_brick_grid
    from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    vol = synthetic_ct_volume((args.size,) * 3, bits_stored=12, seed=0)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    del vol
    if args.two_cards:
        two_cards(grid, args.width, args.height, args.rounds)
        return 0
    rs = renderers(grid, args.width, args.height, args.device)
    order = ("dense", "split", "slabs", "slabs", "split", "dense")
    for mode, legs in chip_smoke.MODE_LEGS.items():
        ms = {(name, leg): [] for name in rs for leg in legs}
        for r in rs.values():
            r.render_mode = mode
        for _ in range(args.rounds):
            for name in order:
                tallies = chip_smoke.held_slab_step(rs[name], name)
                for leg in legs:
                    ms[(name, leg)].append(tallies[leg]["ms"])
        for leg in legs:
            print(f"{mode} {leg}: " + "; ".join(
                f"{name} {min(ms[(name, leg)]):.4f}-{max(ms[(name, leg)]):.4f} ms" for name in rs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
