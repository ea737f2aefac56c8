"""sample_ms_p95: the 95th percentile of the fenced time of every frame
of the window, from the call of render_frame() to the return of
torch.cuda.synchronize(): the stutter a viewer sees. Host clock."""

from vxbench import stats

UNIT, LAYER, MOVES, SOURCE = "ms", "facade", None, "host_clock"


def read(run):
    return stats.p95_ms([f.frame_s for f in run.frames]) if run.frames else None
