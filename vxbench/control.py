"""The readings the limits of `judge.py` are set from, on the card.

    python vxbench/control.py --workload <cell> --frames <n> --seeds 1,2,3 [--dtype bfloat16]

For each seed: the reference in the configuration's precision (float32)
and the control, the same reference computed in `--dtype` and put in the
program's place, each over the cell's own size, the frames a run of the
cell renders (for a cell whose modes take turns, a whole turn of each
mode) and the pixels its check samples. Prints one JSON line a seed
with the control's numbers as judge.py reads them (the image's gap over
the sampled pixels only). The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vxbench import judge, reference, scene  # noqa: E402

HOME = Path(__file__).resolve().parent


def readings(cell: str, seed: int, frames: int, dtype, device, home: Path = HOME, bench: dict | None = None,
             config: dict | None = None, workload: dict | None = None) -> dict:
    bench = bench or json.loads((home.parent / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    workload = workload or json.loads((home / "workloads" / f"{cell}.json").read_text())
    config = config or json.loads((home / "configs" / f"{entry['config']}.json").read_text())
    vol = config["volume"]
    data = scene.normalised(scene.make_volume(vol["size"], vol["bits_stored"], seed, device))
    turn = workload.get("turn_frames")
    refs, ctls = [], []
    for mode in workload["modes"]:
        host = scene.reference_scene(config, workload, mode, data)
        pixels = judge.sample_pixels(seed, host["width"], host["height"], int(workload["check"]["pixels"]))
        last = min(frames, turn) if turn else frames
        indices = list(range(reference.WARMUP_SAMPLES, last)) or [last - 1]
        refs.append(reference.accumulate(reference.Scene(host, device), pixels, indices))
        ctls.append(reference.accumulate(reference.Scene(host, device, dtype), pixels, indices))
        del host
    del data
    ref, ctl = torch.cat(refs), torch.cat(ctls)
    numbers = judge.fb_numbers(ctl.float().cpu().numpy(), ref.cpu().numpy())
    chosen = scene.settings(config, workload)
    exposure, gamma = float(chosen["exposure"]), float(chosen["gamma"])
    image = reference.tonemap(ctl, exposure, gamma).float()
    mapped = reference.tonemap(ctl.float(), exposure, gamma)
    numbers["image_gap"] = float((image - mapped).abs().max())
    return numbers


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--frames", type=int, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--dtype", default="bfloat16")
    args = p.parse_args()
    dtype = getattr(torch, args.dtype)
    for seed in (int(s) for s in args.seeds.split(",")):
        started = time.monotonic()
        numbers = readings(args.workload, seed, args.frames, dtype, "cuda")
        print(json.dumps({"cell": args.workload, "seed": seed, "dtype": args.dtype, "frames": args.frames,
                          "seconds": time.monotonic() - started,
                          **{k: (v if np.isfinite(v) else str(v)) for k, v in numbers.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
