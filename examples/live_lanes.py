"""The lanes alive at the start of each bounce of one frame a mode, from the
port's live-lane counter (utils/profiling.bounce_span), on one card.

    python examples/live_lanes.py [--workload ct512-1080p.bounces3] [--seed 7] [--device cuda]

Sets a benchmark cell's configuration up through vxbench (its scene and
settings, three bounces in the default cell), then in each of the three
modes renders 6 warm-up frames and one frame with spans on. Prints the
card's name and power limit, then one JSON line a mode: the lanes alive at
each bounce's start (bounce 0 is the whole wavefront) and their share of
it. Not a benchmark metric. `--device cpu` rehearses it (slowly at 1080p).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from vxbench import scene  # noqa: E402
from volxel_tpu_torch.utils import profiling  # noqa: E402

WARM = 6
MODES = ("default", "no_dda", "raymarch")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="ct512-1080p.bounces3")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
    workload = json.loads((ROOT / "vxbench" / "workloads" / f"{args.workload}.json").read_text())
    config = json.loads((ROOT / "vxbench" / "configs" / f"{workload['config']}.json").read_text())
    vol = config["volume"]
    volume = scene.make_volume(vol["size"], vol["bits_stored"], args.seed, device)
    r, *_ = scene.port_renderer(config, workload, volume, device)
    del volume
    for mode in MODES:
        r.render_mode = mode
        for _ in range(WARM):
            r.render_frame()
        profiling.take_spans(), profiling.take_counts(), profiling.take_live_lanes()
        with profiling.spans():
            frame = r.frame_index
            r.render_frame()
        profiling.fence_device(device)
        live = profiling.take_live_lanes()
        profiling.take_spans(), profiling.take_counts()
        width, height = r._render_dims()
        lanes = {0: width * height, **{b: c["lanes"] for b, c in sorted(live.items())}}
        print(json.dumps({"mode": mode, "frame": frame, "bounces": r.settings.bounces, "size": [width, height],
                          "live_lanes": lanes, "live_share": {b: n / lanes[0] for b, n in lanes.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
