"""setup_s: seconds from the process's start to the first timed frame:
inputs made from the seed, the program set up, the cell's modes warmed.
Read from the harness's host clock."""

UNIT, LAYER, MOVES, SOURCE = "s", "facade", None, "host_clock"


def read(run):
    return run.setup["setup_s"]
