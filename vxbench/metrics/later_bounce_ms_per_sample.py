"""later_bounce_ms_per_sample: device time of the ops launched under the
program's vx::bounce.later span (render/pathtrace.trace_path: each
iteration of the bounce loop after the first, its legs, NEE, escape and
scatter over the whole wavefront), per frame of the staged windows
(vxbench/stages.py). Only frames of more than one bounce have it; a
program without the span gives None."""

from vxbench import stages

UNIT, LAYER, MOVES, SOURCE = "ms", "path tracer in PyTorch", "ms_per_sample", "program_span"


def read(run):
    staged = stages.of(run)
    if not stages.frames(staged) or not stages.under(staged, "vx::bounce.later"):
        return None
    return stages.ms_per_frame(staged, "vx::bounce.later")
