"""What the port's spans and counters cost with no profiler running, on one card.

    python examples/span_cost.py --workload ct512-1080p.default [--frames 40] [--rounds 2] [--seed 7]

Sets a benchmark cell's configuration up through vxbench (its scene, its
settings, its modes) and renders frames of each of its modes in turns with
spans off, on, on, off (`--rounds` times): each frame render_frame() then
torch.cuda.synchronize(), as the benchmark's closed loop, after 6 warm-up
frames a turn. Prints the card's name and power limit, then one JSON line:
per state, the mean enqueue ms (render_frame's return) and fenced ms a
frame, and with spans on the span entries a frame.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from vxbench import scene  # noqa: E402
from volxel_tpu_torch.utils import profiling  # noqa: E402

WARM = 6


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args()
    print(subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    workload = json.loads((ROOT / "vxbench" / "workloads" / f"{args.workload}.json").read_text())
    config = json.loads((ROOT / "vxbench" / "configs" / f"{workload['config']}.json").read_text())
    device = torch.device("cuda")
    vol = config["volume"]
    volume = scene.make_volume(vol["size"], vol["bits_stored"], args.seed, device)
    r, *_ = scene.port_renderer(config, workload, volume, device)
    del volume
    times: dict = {"off": [], "on": []}
    entries = []
    for _ in range(args.rounds):
        for on in (False, True, True, False):
            for mode in workload["modes"]:
                r.render_mode = mode
                for _ in range(WARM):
                    r.render_frame()
                torch.cuda.synchronize()
                with profiling.spans(on):
                    for _ in range(args.frames):
                        t0 = time.perf_counter()
                        r.render_frame()
                        t1 = time.perf_counter()
                        torch.cuda.synchronize()
                        times["on" if on else "off"].append((t1 - t0, time.perf_counter() - t0))
                if on:
                    entries.append(len(profiling.take_spans()) / args.frames)
                    profiling.take_counts()
    out = {"workload": args.workload, "frames": args.frames, "rounds": args.rounds,
           "span_entries_per_frame": sorted(set(entries))}
    for state, pairs in times.items():
        out[state] = {"enqueue_ms": 1000 * sum(e for e, _ in pairs) / len(pairs),
                      "ms_per_sample": 1000 * sum(f for _, f in pairs) / len(pairs), "frames": len(pairs)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
