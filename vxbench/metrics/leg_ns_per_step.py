"""leg_ns_per_step: device ns of the counted legs' kernels over the march
steps and tracking events their lanes took, in the staged windows
(vxbench/stages.py). The program counts each call of the DDA and
tracking legs (render/modes._leg: the steps or events each lane took of
its cap, from the leg's own budget or events left) under its launch
counter's name; the raymarch legs are not counted, and their kernels are
left out here."""

from vxbench import stages, trace

UNIT, LAYER, MOVES, SOURCE = "ns", "legs and kernels", "ms_per_sample", "program_counter"


def read(run):
    staged = stages.of(run)
    if not stages.frames(staged):
        return None
    ns = steps = 0.0
    for w in staged.windows:
        for key, counted in w.counters.items():
            symbol = trace.SYMBOLS.get(key, key + "_kernel")
            ns += 1000.0 * sum(o.end - o.start for o in w.ops if symbol in o.name and "vx::leg" in o.spans)
            steps += counted["steps"]
    return ns / steps if steps else None
