"""kernel_ms_per_sample: device time of the kernels not launched under an
aten:: op, that is the program's own kernels (render/ddaleg.py,
trackleg.py, tilemarch.py, gather.py, pallas_ops.py; csrc/), whatever
they are written in, per traced frame. Device trace."""

UNIT, LAYER, MOVES, SOURCE = "ms", "legs and kernels", "ms_per_sample", "device_trace"


def read(run):
    windows = [w for w in run.windows if w.host_ops]  # the windows that know who launched what
    frames = sum(len(w.frames) for w in windows)
    if not frames:
        return None
    return 1000.0 * sum((o.end - o.start) / 1e6 for w in windows for o in w.ops
                        if o.kernel and not o.aten) / frames
