"""idle_share: the share of a frame's wall time in which no device op
runs, in %: 100 x (1 - device-busy seconds a frame / fenced seconds a
frame). The busy seconds are the union of the device ops' intervals in
the traced windows that recorded the device's activity alone, over their
frames. The fenced seconds are each mode's mean time from the call of
render_frame() to the return of torch.cuda.synchronize() over the
window's frames before its first profiled one (a profiler slows the host
that enqueues the work, during its window and after, so the traced
windows' own wall time reads idle too high), weighted by the traced
frames of that mode, so that both sides hold the same mix of modes.
Device trace and host clock."""

from vxbench import stats

UNIT, LAYER, MOVES, SOURCE = "%", "device", "ms_per_sample", "device_trace"


def read(run):
    windows = [w for w in run.windows if not w.host_ops]
    traced = [rec.mode for w in windows for rec in w.frames]
    untraced: dict = {}
    for f in stats.before_profiling(run.frames):
        untraced.setdefault(f.mode, []).append(f.frame_s)
    if not traced or any(mode not in untraced for mode in traced):
        return None
    busy = sum(w.busy_s() for w in windows) / len(traced)
    fenced = sum(sum(untraced[mode]) / len(untraced[mode]) for mode in traced) / len(traced)
    return 100.0 * (1.0 - busy / fenced)
