"""How many device records torch.profiler keeps in the windows that follow a large one, on one card.

    python examples/profiler_record_loss.py [--large 25000] [--windows 3]

Builds the port's kernels, profiles one small window in a fresh process,
then twice: one large window (`--large` launches of an elementwise kernel
on a 1M-word tensor), followed by `--windows` rounds of three small
windows, each of 100 such launches (the block) after a run of launches of
the port's empty kernel (the pads): 32 pads back to back, 32 pads 1 ms
apart, and 256 pads back to back. Prints, per window, how many pads and how
many block kernels the profiler recorded, and the card's name and power
limit first. chip_smoke.profile_call's checks rest on what this shows.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--large", type=int, default=25000, help="kernels in the large window")
    ap.add_argument("--windows", type=int, default=3, help="rounds of small windows after each large one")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profiler_record_loss: no CUDA device", file=sys.stderr)
        return 2
    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.render.gather import launch_floor

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    kernels.build()
    kernels.lib()
    cuda = torch.device("cuda")
    x = torch.zeros(1 << 20, device=cuda)

    def window(what: str, pads: int, gap_ms: float, block: int) -> None:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(pads):
                launch_floor(1, cuda)
                if gap_ms:
                    torch.cuda.synchronize()
                    time.sleep(gap_ms / 1000)
            torch.cuda.synchronize()
            for _ in range(block):
                x.mul_(1.0001)
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
        kept_pads = sum(e.count for e in device if "empty_kernel" in e.key)
        kept_block = sum(e.count for e in device if "elementwise" in e.key)
        print(f"{what}: pads {kept_pads} of {pads}, block kernels {kept_block} of {block}", flush=True)

    window("fresh process, 32 pads back to back", 32, 0.0, 100)
    for large in range(2):
        window(f"large window {large}", 0, 0.0, args.large)
        for i in range(args.windows):
            window(f"after large window {large}, round {i}: 32 pads back to back", 32, 0.0, 100)
            window(f"after large window {large}, round {i}: 32 pads 1 ms apart", 32, 1.0, 100)
            window(f"after large window {large}, round {i}: 256 pads back to back", 256, 0.0, 100)
    return 0


if __name__ == "__main__":
    sys.exit(main())
