"""Camera / projection / shading math shared by host (numpy) and device (jnp).

Matches the conventions of the reference viewer (math.gl right-handed,
OpenGL clip space): lookAt view matrix and perspective projection with
fovy=pi/3, near=0.1, far=1000 (reference: representation/scene.ts:58-72),
plus the shading helpers from shaders/utils.glsl (luma weights, power
heuristic, Henyey-Greenstein phase function).

All matrix helpers return numpy float32 arrays in **row-vector-on-the-right**
convention: `world = M @ [x, y, z, 1]`.
"""

from __future__ import annotations

import numpy as np

M_PI = float(np.pi)
INV_4PI = 1.0 / (4.0 * M_PI)

# Rec.709 luma weights (reference: shaders/utils.glsl:100)
LUMA_WEIGHTS = np.array([0.212671, 0.715160, 0.072169], dtype=np.float32)


def look_at(eye, center, up) -> np.ndarray:
    """Right-handed view matrix (camera looks down -Z in view space)."""
    eye = np.asarray(eye, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m.astype(np.float32)


def perspective(fovy: float, aspect: float, near: float, far: float) -> np.ndarray:
    """OpenGL-style perspective projection (clip z in [-1, 1])."""
    f = 1.0 / np.tan(fovy / 2.0)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = (2.0 * far * near) / (near - far)
    m[3, 2] = -1.0
    return m.astype(np.float32)


def scale_matrix(s) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def translate_matrix(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


def transform_point(m: np.ndarray, p) -> np.ndarray:
    p = np.asarray(p, dtype=np.float32)
    h = m @ np.append(p, 1.0).astype(np.float32)
    return h[:3] / h[3]


def transform_dir(m: np.ndarray, d) -> np.ndarray:
    d = np.asarray(d, dtype=np.float32)
    return (m[:3, :3] @ d).astype(np.float32)


def div_round_up(num: int, denom: int) -> int:
    return -(-int(num) // int(denom))
