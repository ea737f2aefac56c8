"""later_bounce_launches_per_sample: kernels (copies and sets left out)
launched under the program's vx::bounce.later span (each iteration of the
path tracer's bounce loop after the first), per frame of the staged
windows (vxbench/stages.py). Only frames of more than one bounce have it;
a program without the span gives None."""

from vxbench import stages

UNIT, LAYER, MOVES, SOURCE = "kernels", "path tracer in PyTorch", "ms_per_sample", "program_span"


def read(run):
    staged = stages.of(run)
    if not stages.frames(staged) or not stages.under(staged, "vx::bounce.later"):
        return None
    return sum(o.kernel for o in stages.under(staged, "vx::bounce.later")) / stages.frames(staged)
