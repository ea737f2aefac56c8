"""env_ms_per_sample: device time of the ops launched under the program's
vx::env span (scene/environment.py: the environment's lookups, warp
samples and pdf), per frame of the staged windows (vxbench/stages.py)."""

from vxbench import stages

UNIT, LAYER, MOVES, SOURCE = "ms", "path tracer in PyTorch", "ms_per_sample", "program_span"


def read(run):
    return stages.ms_per_frame(stages.of(run), "vx::env")
