"""1D RGBA transfer-function LUTs.

Parity with utils/data.ts: `generate_transfer_function` reproduces
generateTransferFunction (data.ts:21-60) including its quirks (zero fill
before the first stop unless it covers position 0, hold after the last
stop, step-skip when crossing a stop), and `parse_transfer_function`
reproduces the `r g b density` text format (data.ts:1-14).

The device lookup is NEAREST sampling (the viewer creates the transfer
texture with NEAREST filters, viewer.ts:386-387) with the sample-range
rejection from sampling/common.glsl:78-83 — implemented in
volxel_tpu_torch.render.sampling.
"""

from __future__ import annotations

import numpy as np

DEFAULT_COLOR_STOPS = [
    {"color": [1.0, 1.0, 1.0, 0.0], "stop": 0.0},
    {"color": [1.0, 1.0, 1.0, 1.0], "stop": 1.0},
]


def parse_transfer_function(text: str) -> list[list[float]]:
    """Parse `r g b density` lines (data.ts:1-14)."""
    rows = []
    for line in text.split("\n"):
        parts = [p for p in line.split(" ") if p != ""]
        vals = []
        for p in parts:
            try:
                vals.append(float(p))
            except ValueError:
                vals = []
                break
        if len(vals) == 4:
            rows.append(vals)
    return rows


def generate_transfer_function(
    colors: list[dict], generated_steps: int = 128
) -> np.ndarray:
    """Piecewise-linear LUT from color stops -> (steps, 4) float32.

    Faithful to data.ts:21-60 including the `continue` that emits the next
    stop's color exactly at crossings.
    """
    if len(colors) < 1:
        raise ValueError("At least one color stop required")
    stops = sorted(colors, key=lambda c: c["stop"])
    if any(s["stop"] < 0.0 or s["stop"] > 1.0 for s in stops):
        raise ValueError("ColorStop outside stop range")

    current = -1
    out = []
    i = 0
    while i < generated_steps:
        position = i / generated_steps
        if current < 0:
            if stops[0]["stop"] >= position:
                current = 0
                out.append(list(stops[0]["color"]))
            else:
                out.append([0.0, 0.0, 0.0, 0.0])
        else:
            nxt = stops[current + 1] if current + 1 < len(stops) else None
            if nxt is None:
                out.append(list(stops[current]["color"]))
            else:
                span = nxt["stop"] - stops[current]["stop"]
                progress = (position - stops[current]["stop"]) / span if span else 1.0
                if progress >= 1.0:
                    out.append(list(nxt["color"]))
                    current += 1
                    i += 1
                    continue
                a = np.asarray(stops[current]["color"], dtype=np.float64)
                b = np.asarray(nxt["color"], dtype=np.float64)
                out.append(((1 - progress) * a + progress * b).tolist())
        i += 1
    return np.asarray(out, dtype=np.float32)
