"""uploads_per_sample: host-to-device copies (Memcpy HtoD device ops)
launched inside the program's vx::render_frame span, per frame of the
staged windows (vxbench/stages.py): the per-frame uploads that stand in
the way of a captured graph."""

from vxbench import stages

UNIT, LAYER, MOVES, SOURCE = "copies", "facade", "ms_per_sample", "program_span"


def read(run):
    staged = stages.of(run)
    n = stages.frames(staged)
    if not n:
        return None
    return sum(o.name.startswith("Memcpy HtoD") for o in stages.under(staged, "vx::render_frame")) / n
