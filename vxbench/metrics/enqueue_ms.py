"""enqueue_ms: host time from the call of Renderer.render_frame() to its
return, before the fence, over the window's frames before its first
profiled one: the host's share of a sample (api/renderer.py and everything
it enqueues). Host clock."""

from vxbench import stats

UNIT, LAYER, MOVES, SOURCE = "ms", "facade", "ms_per_sample", "host_clock"


def read(run):
    times = [f.enqueue_s for f in stats.before_profiling(run.frames)]
    return 1000.0 * sum(times) / len(times) if times else None
