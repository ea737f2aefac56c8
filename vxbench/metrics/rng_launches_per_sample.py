"""rng_launches_per_sample: kernels (copies and sets left out) launched under
the program's vx::rng span, per frame of the staged windows
(vxbench/stages.py)."""

from vxbench import stages

UNIT, LAYER, MOVES, SOURCE = "kernels", "path tracer in PyTorch", "ms_per_sample", "program_span"


def read(run):
    staged = stages.of(run)
    n = stages.frames(staged)
    return sum(o.kernel for o in stages.under(staged, "vx::rng")) / n if n else None
