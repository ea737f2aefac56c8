"""launches_per_sample: device kernels in the traced frames, of every
origin (copies and sets left out), per frame: an exact count of the
launches a sample costs. Device trace, the device's activity alone."""

UNIT, LAYER, MOVES, SOURCE = "kernels", "path tracer in PyTorch", "ms_per_sample", "device_trace"


def read(run):
    windows = [w for w in run.windows if not w.host_ops]
    frames = sum(len(w.frames) for w in windows)
    if not frames:
        return None
    return sum(1 for w in windows for o in w.ops if o.kernel) / frames
