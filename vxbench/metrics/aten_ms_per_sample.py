"""aten_ms_per_sample: device time of the kernels launched under an
aten:: op (the path tracer written in PyTorch: render/pathtrace.py,
sampling.py, rng.py, shading.py, rays.py, scene/environment.py), summed
over the traced frames and divided by them. Device trace."""

UNIT, LAYER, MOVES, SOURCE = "ms", "path tracer in PyTorch", "ms_per_sample", "device_trace"


def read(run):
    windows = [w for w in run.windows if w.host_ops]  # the windows that know who launched what
    frames = sum(len(w.frames) for w in windows)
    if not frames:
        return None
    return 1000.0 * sum((o.end - o.start) / 1e6 for w in windows for o in w.ops if o.aten) / frames
