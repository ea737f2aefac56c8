"""rng_ms_per_sample: device time of the ops launched under the program's
vx::rng span (render/rng.py: the per-ray seeding and every draw, the legs'
setup draws included), per frame of the staged windows (vxbench/stages.py:
frames profiled with the host's ops and the program's spans on)."""

from vxbench import stages

UNIT, LAYER, MOVES, SOURCE = "ms", "path tracer in PyTorch", "ms_per_sample", "program_span"


def read(run):
    return stages.ms_per_frame(stages.of(run), "vx::rng")
