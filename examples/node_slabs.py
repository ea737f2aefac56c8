"""chip_smoke.py's phase 2f alone: a vz = 2 row across two processes of the node.

    python examples/node_slabs.py

Builds the kernels from this checkout and runs chip_smoke.node_slab_path
on the 512^3 bench scene at 1920x1080: two processes on cuda:0 joined over
gloo, each holding its own slab and mapping the other's through CUDA IPC
(parallel/nodeshare.py), and, on a machine with two cards or more, the
same over cuda:0 and cuda:1 joined over NCCL. Prints the card's name and
power limit, the Python, torch and CUDA versions and the card count first;
exits non-zero where any check of the phase fails.
"""

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    import torch

    import chip_smoke as cs
    from volxel_tpu_torch import kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout, flush=True)
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count(), flush=True)
    t0 = time.perf_counter()
    kernels.build()
    kernels.lib()
    print(f"built {time.perf_counter() - t0:.1f}s", flush=True)
    cs.node_slab_path(512, 1920, 1080)


if __name__ == "__main__":
    main()
