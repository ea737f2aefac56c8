"""ms_per_sample: the measured window's wall time over the progressive
samples completed in it, every frame fenced by torch.cuda.synchronize():
time to a clean image. Read from the harness's host clock."""

from vxbench import stats

UNIT, LAYER, MOVES, SOURCE = "ms", "facade", None, "host_clock"


def read(run):
    return stats.ms_per_sample(run.window_s, len(run.frames)) if run.frames else None
