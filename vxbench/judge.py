"""The comparison that decides `correct`.

After the window the program's accumulated framebuffer is read at a
sample of pixels drawn from the seed, and the reference traces every
sample that the window's frames folded into those pixels (reference.py)
and averages them as the viewer does. The displayed image is judged
through the tonemap: the reference maps the program's own framebuffer and
the program's image must equal that, pixel by pixel.

Numbers compared, each against the limit the workload file gives:

  fb_off_share  share of the sampled pixels whose worst channel differs
                from the reference by more than 1e-3 of it (+1e-3): an
                ulp-level flip of one stochastic compare changes a whole
                sample, so a few pixels of a sound run differ.
  fb_mean_gap   |mean of the program's sampled pixels - the reference's|
                over the reference's mean: a bias that moves all pixels a
                little.
  image_gap     the largest |image - tonemap(framebuffer)| over every
                pixel of the displayed image.
"""

from __future__ import annotations

import numpy as np
import torch

from vxbench import reference


def sample_pixels(seed: int, width: int, height: int, count: int) -> torch.Tensor:
    """`count` distinct pixel indices (GL order, row 0 at the bottom) drawn from the seed."""
    gen = torch.Generator()
    gen.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + 0x5EED) & 0x7FFF_FFFF_FFFF_FFFF)
    return torch.randperm(width * height, generator=gen)[:count].sort().values


def fb_numbers(ours: np.ndarray, theirs: np.ndarray) -> dict:
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    if not np.isfinite(ours).all():
        return {"fb_off_share": float("inf"), "fb_mean_gap": float("inf")}
    rel = np.abs(ours - theirs) / (np.abs(theirs) + 1e-3)
    mean_ref = float(theirs.mean())
    return {"fb_off_share": float((rel.max(axis=-1) > 1e-3).mean()),
            "fb_mean_gap": abs(float(ours.mean()) - mean_ref) / max(abs(mean_ref), 1e-3)}


def image_gap(image: np.ndarray, framebuffer: torch.Tensor, exposure: float, gamma: float, width: int,
              height: int) -> float:
    """The program's displayed image (height, width, 3), row 0 at the top,
    against the reference's tonemap of the program's framebuffer."""
    mapped = reference.tonemap(framebuffer.to(torch.float32), exposure, gamma).cpu().numpy()
    mapped = mapped.reshape(height, width, 3)[::-1]
    image = np.asarray(image, np.float64)
    if image.shape != mapped.shape or not np.isfinite(image).all():
        return float("inf")
    return float(np.abs(image - mapped).max())


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, lines): every number at or under its limit."""
    lines, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, float("inf"))
        good = bool(np.isfinite(value)) and value <= limit
        ok &= good
        lines.append(f"check {name}: {value!r} limit {limit!r} {'ok' if good else 'FAIL'}")
    return ok, lines
