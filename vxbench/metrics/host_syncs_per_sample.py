"""host_syncs_per_sample: blocking CUDA runtime calls (stream, device and
event synchronizations, synchronous copies) made inside the program's
vx::render_frame span, per frame of the staged windows
(vxbench/stages.py). The harness's own fence after each frame lies
outside the span."""

from vxbench import stages

UNIT, LAYER, MOVES, SOURCE = "calls", "facade", "ms_per_sample", "program_span"


def read(run):
    staged = stages.of(run)
    n = stages.frames(staged)
    if not n:
        return None
    return sum("vx::render_frame" in chain for w in staged.windows for _, chain in w.syncs) / n
