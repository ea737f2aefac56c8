"""camera_leg_roofline: the least time the camera calls of the mode's
sample leg could take over the traced frames, over the time those calls
took, in %.

The bound counts bytes only, at HBM3's published 3.35 TB/s (NVIDIA H100
SXM; a card below its 700 W limit is slower). A frame's camera call is
its first call of the leg's kernel (the later ones trace the bounces):
every camera ray inside the volume's box reads its lane inputs and
writes its outputs once, at the widths below, the call reads the
transfer LUT once, and it reads once each brick of the field that its
rays can reach (the harness counts them from the camera, the box and, in
the default mode, the majorant pyramid). A ray ends at its first
collision and leaves the bricks behind it unread, so the count is a bound
on what a call could need, not what it read. Device trace."""

UNIT, LAYER, MOVES, SOURCE = "%", "legs and kernels", "ms_per_sample", "device_trace"
HBM_BYTES_PER_S = 3.35e12
LUT_BYTES = 128 * 16
# the camera leg kernel of each mode, and a running lane's bytes in and out:
# default: ipos, idir (12 each), far, t, tau, mip (4 each), the four 32-bit
#   random words (16), running (1); out: the words, hit (1), t (4), rgb (12)
# no_dda: the same without tau and mip; raymarch: start, dt, far and the
#   tau target in place of far, t, tau and mip
KERNELS = {"default": ("dda_leg_sample_kernel", 57 + 33), "no_dda": ("track_leg_sample_kernel", 49 + 33),
           "raymarch": ("tile_march_sample_kernel", 57 + 33)}


def read(run):
    bound_s = measured_s = 0.0
    for w in (w for w in run.windows if not w.host_ops):
        frames = w.frames
        modes = {rec.mode for rec in frames}
        if len(modes) != 1 or not frames:
            continue
        symbol, width = KERNELS[frames[0].mode]
        calls = sorted((o for o in w.ops if symbol in o.name), key=lambda o: o.start)
        per_frame, rest = divmod(len(calls), len(frames))
        if not per_frame or rest:
            continue  # the calls cannot be told apart by frame
        for rec, call in zip(frames, calls[::per_frame]):
            field = run.field_bytes.get(rec.mode)
            if field is None or rec.index not in run.in_box:
                continue
            bound_s += (run.in_box[rec.index] * width + LUT_BYTES + field) / HBM_BYTES_PER_S
            measured_s += (call.end - call.start) / 1e6
    if measured_s <= 0:
        return None
    return 100.0 * bound_s / measured_s
