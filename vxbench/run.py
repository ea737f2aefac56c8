"""Run one cell of the benchmark once:

    python vxbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for. Prints the checks on standard error and one JSON line, the result,
last on standard output.
"""

import time

STARTED = time.monotonic()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vxbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started=STARTED))
