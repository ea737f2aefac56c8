"""Registers and SASS sizes of the render legs' kernels in two csrc trees, on the card's toolchain.

    python examples/leg_sass.py PARENT_CSRC [CSRC]

Builds csrc/dda_leg.cu, csrc/track_leg.cu and csrc/tile_march.cu of each
tree (CSRC defaults to this checkout's volxel_tpu_torch/csrc) to a cubin
with the port's flags and `-Xptxas -v`, reads each kernel's registers
(ptxas's report) and its SASS (cuobjdump -sass: the instructions of its own
code, of its own code and the out-of-line functions it calls, and for the
raymarch step loops the SASS of one step, chip_smoke.step_loop), and prints
one line per kernel, the two trees side by side. Kernels are matched by
name, without the anonymous namespace's per-file hash. The last line says
whether every kernel that both trees have is the same in both. Needs
nvcc; the parent tree is a `git archive` of the parent commit unpacked
into the git-ignored scratch/.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from volxel_tpu_torch import kernels  # noqa: E402

SOURCES = ("dda_leg.cu", "track_leg.cu", "tile_march.cu")


def report(csrc: Path) -> dict:
    """{kernel: (registers, own SASS, all SASS, SASS a step or None)}."""
    nvcc = kernels._nvcc()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in SOURCES:
            src = csrc / name
            cubin = str(Path(tmp) / f"{src.stem}.cubin")
            built = subprocess.run([nvcc, *kernels._flags(src), "-Xptxas", "-v", "-cubin", "-o", cubin, str(src)],
                                   capture_output=True, text=True)
            if built.returncode:
                raise SystemExit(f"nvcc failed on {src}:\n{built.stderr}")
            sass = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", cubin], capture_output=True,
                                  text=True, check=True).stdout
            registers = chip_smoke.ptxas_registers(built.stderr)
            bodies = chip_smoke.sass_functions(sass)
            for fn, counts in chip_smoke.sass_counts(sass).items():
                loop = chip_smoke.step_loop(bodies[fn]) if name == "tile_march.cu" else None
                key = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", fn)
                out[key] = (registers.get(fn), counts["own"][2], sum(c[2] for c in counts.values()),
                            loop and loop["per_step"])
    return out


def main() -> int:
    parent = Path(sys.argv[1])
    this = Path(sys.argv[2]) if len(sys.argv) > 2 else kernels.CSRC
    a, b = report(parent), report(this)
    same = True
    for fn in sorted(set(a) | set(b)):
        if fn in a and fn in b:
            tag = "same" if a[fn] == b[fn] else "DIFFERS"
            same = same and a[fn] == b[fn]
        else:
            tag = "parent only" if fn in a else "new"
        print(f"{tag:12s} {fn}: (registers, own SASS, all SASS, SASS a step) parent {a.get(fn)} this {b.get(fn)}")
    print(f"every kernel of both trees the same: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
