"""Headless AR overlay: plane detection and a virtual cube.

Copy of ``slam_dynamic_tpu/viz/ar.py`` (host numpy), the analog of the
reference's monocular AR demo (Examples/ROS/ORB_SLAM2/src/AR/ViewerAR:
DetectPlane RANSACs a dominant plane from the tracked map points, then a
virtual cube is drawn on it in every frame through the live camera
pose). With no display, the cube's wireframe is rasterized into each
frame's gray image (PNG files), with the same insert-once /
track-every-frame split. No device work: it reads the exported map and
the packets' poses.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class ARPlane:
    """Dominant plane (n, d with n.x + d = 0) + an anchor point on it."""

    def __init__(self, normal: np.ndarray, origin: np.ndarray):
        self.normal = normal / max(np.linalg.norm(normal), 1e-12)
        self.origin = origin

    def basis(self) -> Tuple[np.ndarray, np.ndarray]:
        n = self.normal
        seed = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else \
            np.array([0, 1.0, 0])
        e1 = seed - n * seed.dot(n)
        e1 /= max(np.linalg.norm(e1), 1e-12)
        return e1, np.cross(n, e1)


def detect_plane(lm_pos: np.ndarray, lm_valid: np.ndarray,
                 iterations: int = 50, thresh: float = 0.02,
                 rng: Optional[np.random.Generator] = None
                 ) -> Optional[ARPlane]:
    """RANSAC a dominant plane from valid landmarks (ViewerAR::
    DetectPlane parity: 3-point hypotheses, inlier-count vote, least-
    squares refit on inliers; anchored at the inlier centroid)."""
    pts = lm_pos[lm_valid]
    if len(pts) < 30:
        return None
    rng = rng or np.random.default_rng(0)
    best_inl = None
    best_n = 0
    for _ in range(iterations):
        i = rng.choice(len(pts), 3, replace=False)
        a, b, c = pts[i]
        n = np.cross(b - a, c - a)
        nn = np.linalg.norm(n)
        if nn < 1e-9:
            continue
        n = n / nn
        d = np.abs((pts - a) @ n)
        inl = d < thresh
        if inl.sum() > best_n:
            best_n, best_inl = int(inl.sum()), inl
    if best_inl is None or best_n < 20:
        return None
    sel = pts[best_inl]
    c = sel.mean(0)
    # least-squares normal: smallest eigvec of the centered scatter
    _, _, vt = np.linalg.svd(sel - c, full_matrices=False)
    return ARPlane(vt[-1], c)


def cube_vertices(plane: ARPlane, size: float = 0.3) -> np.ndarray:
    """[8, 3] world-frame cube corners sitting ON the plane."""
    e1, e2 = plane.basis()
    n = plane.normal
    h = size / 2.0
    base = plane.origin
    out = []
    for k in (0.0, size):
        for (u, v) in ((-h, -h), (h, -h), (h, h), (-h, h)):
            out.append(base + u * e1 + v * e2 + k * n)
    return np.stack(out)

CUBE_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
              (4, 5), (5, 6), (6, 7), (7, 4),
              (0, 4), (1, 5), (2, 6), (3, 7)]


def _draw_line(rgb: np.ndarray, p0, p1, color):
    """Integer Bresenham-ish line via dense sampling (numpy, no deps)."""
    h, w = rgb.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) + 1
    xs = np.clip(np.linspace(p0[0], p1[0], n).round().astype(int), 0, w - 1)
    ys = np.clip(np.linspace(p0[1], p1[1], n).round().astype(int), 0, h - 1)
    rgb[ys, xs] = color


def render_cube(gray: np.ndarray, R: np.ndarray, t: np.ndarray,
                fx: float, fy: float, cx: float, cy: float,
                verts_w: np.ndarray,
                color=(60, 255, 80)) -> np.ndarray:
    """Project the cube through the world->camera pose (R, t) and draw
    its wireframe over the frame. Returns an RGB uint8 image."""
    rgb = np.stack([gray] * 3, -1).astype(np.uint8)
    xc = verts_w @ R.T + t
    vis = xc[:, 2] > 0.05
    z = np.maximum(xc[:, 2], 1e-6)
    u = fx * xc[:, 0] / z + cx
    v = fy * xc[:, 1] / z + cy
    for i, j in CUBE_EDGES:
        if vis[i] and vis[j]:
            _draw_line(rgb, (u[i], v[i]), (u[j], v[j]), color)
    return rgb
