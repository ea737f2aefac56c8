"""shade_ms_per_sample: device time of the ops launched under the program's
vx::shade span (render/shading.trace_shaded: the six trilinear density
lookups of the gradient, both legs and Blinn-Phong), per frame of the
staged windows (vxbench/stages.py). Only gradient-shaded frames have it."""

from vxbench import stages

UNIT, LAYER, MOVES, SOURCE = "ms", "path tracer in PyTorch", "ms_per_sample", "program_span"


def read(run):
    staged = stages.of(run)
    if not stages.frames(staged) or not stages.under(staged, "vx::shade"):
        return None
    return stages.ms_per_frame(staged, "vx::shade")
