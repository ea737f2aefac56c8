"""Clip-box wireframe overlay (the reference's clipping cube pass).

The reference rasterizes the clipped AABB as a translucent cube with the
hovered/held face highlighted (viewer.ts:1267-1288, clipVertex.vert /
clipFragment.frag). Here the overlay is drawn host-side onto the
tonemapped image: corners projected with the camera matrices, edges drawn
with Bresenham, the selected face's outline brightened (drag state encoded
by sign, matching the u_selected_face convention, clipVertex.vert:27-33).
"""

from __future__ import annotations

import numpy as np

# 12 edges as corner-index pairs; corners indexed by (x, y, z) bit flags
_EDGES = [
    (0b000, 0b001), (0b010, 0b011), (0b100, 0b101), (0b110, 0b111),  # x
    (0b000, 0b010), (0b001, 0b011), (0b100, 0b110), (0b101, 0b111),  # y
    (0b000, 0b100), (0b001, 0b101), (0b010, 0b110), (0b011, 0b111),  # z
]

# face index (interaction.py convention) -> corner predicate
_FACE_CORNERS = {
    0: lambda c: c & 0b100,  # +z front
    1: lambda c: not (c & 0b100),  # -z back
    2: lambda c: not (c & 0b001),  # -x left
    3: lambda c: c & 0b001,  # +x right
    4: lambda c: c & 0b010,  # +y top
    5: lambda c: not (c & 0b010),  # -y bottom
}


def _project(corners, view, proj, width, height):
    pts = np.concatenate([corners, np.ones((8, 1))], axis=1)
    clip = (proj @ view @ pts.T).T
    w = clip[:, 3:4]
    behind = (w <= 1e-6).ravel()
    ndc = clip[:, :3] / np.where(np.abs(w) > 1e-6, w, 1e-6)
    xs = (ndc[:, 0] * 0.5 + 0.5) * width
    ys = (1.0 - (ndc[:, 1] * 0.5 + 0.5)) * height  # row 0 = top
    return np.stack([xs, ys], axis=1), behind


def _draw_line(img, p0, p1, color, alpha):
    h, w = img.shape[:2]
    x0, y0 = p0
    x1, y1 = p1
    steps = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    if steps > 8 * max(h, w):  # wildly off-screen
        return
    ts = np.linspace(0.0, 1.0, steps + 1)
    xs = np.round(x0 + (x1 - x0) * ts).astype(int)
    ys = np.round(y0 + (y1 - y0) * ts).astype(int)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = (
        (1 - alpha) * img[ys[keep], xs[keep]] + alpha * np.asarray(color)
    )


def draw_clip_box(
    image: np.ndarray,
    aabb_lo,
    aabb_hi,
    view: np.ndarray,
    proj: np.ndarray,
    selected_face: int | None = None,
    adjusting: bool = False,
) -> np.ndarray:
    """Blend the clip-box wireframe into (H, W, 3) image (row 0 = top)."""
    img = np.array(image, dtype=np.float32, copy=True)
    h, w = img.shape[:2]
    lo = np.asarray(aabb_lo, np.float64)
    hi = np.asarray(aabb_hi, np.float64)
    corners = np.array(
        [[hi[0] if c & 1 else lo[0], hi[1] if c & 2 else lo[1], hi[2] if c & 4 else lo[2]] for c in range(8)]
    )
    pts, behind = _project(corners, np.asarray(view, np.float64), np.asarray(proj, np.float64), w, h)

    base_color = np.array([0.8, 0.8, 0.8], np.float32)
    # held faces glow stronger than hovered ones (clipFragment.frag:19-26)
    hi_color = np.array([1.0, 0.85, 0.2] if not adjusting else [1.0, 0.4, 0.1], np.float32)
    on_face = _FACE_CORNERS.get(selected_face) if selected_face is not None else None
    for a, b in _EDGES:
        if behind[a] or behind[b]:
            continue
        selected = on_face is not None and on_face(a) and on_face(b)
        _draw_line(
            img,
            pts[a],
            pts[b],
            hi_color if selected else base_color,
            0.9 if selected else 0.45,
        )
    return img
