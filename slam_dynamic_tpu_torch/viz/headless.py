"""Headless visualization: PNG overlays and PLY map exports.

Copy of ``slam_dynamic_tpu/viz/headless.py`` (host numpy; copied because
the JAX package's ``__init__`` imports jax), in place of the reference's
display stack: the FrameDrawer 2D overlay (``draw_frame``), the Pangolin
MapDrawer's landmarks, keyframe centres and dynamic-object boxes
(``export_map_ply``, ``export_obbs_ply``), a top-down trajectory plot,
and a PNG writer with no dependency. The outputs are byte-equal with the
JAX package's.
"""
from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np


def write_png(path: str, img: np.ndarray):
    """Minimal PNG writer (8-bit gray or RGB), no external deps."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2}[c]
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def _draw_square(rgb, x, y, half, color):
    h, w, _ = rgb.shape
    x0, x1 = max(x - half, 0), min(x + half + 1, w)
    y0, y1 = max(y - half, 0), min(y + half + 1, h)
    rgb[y0:y1, x0:x1] = color


def _draw_rect(rgb, box, color, thick=2):
    h, w, _ = rgb.shape
    x0, y0, x1, y1 = [int(v) for v in box]
    x0, x1 = np.clip([x0, x1], 0, w - 1)
    y0, y1 = np.clip([y0, y1], 0, h - 1)
    rgb[y0:y0 + thick, x0:x1] = color
    rgb[max(y1 - thick, 0):y1, x0:x1] = color
    rgb[y0:y1, x0:x0 + thick] = color
    rgb[y0:y1, max(x1 - thick, 0):x1] = color


def draw_frame(gray: np.ndarray, kp_xy: np.ndarray, kp_valid: np.ndarray,
               tracked_mask: Optional[np.ndarray] = None,
               quarantined_mask: Optional[np.ndarray] = None,
               boxes: Optional[np.ndarray] = None,
               box_status: Optional[np.ndarray] = None,
               state: str = "") -> np.ndarray:
    """FrameDrawer::DrawFrame equivalent: keypoints (green=tracked,
    blue=extracted, red=quarantined) + boxes (red=dynamic, green=static,
    yellow=tentative). Returns an RGB uint8 image."""
    rgb = np.stack([gray] * 3, axis=-1).astype(np.uint8)
    xy = np.asarray(kp_xy).astype(int)
    valid = np.asarray(kp_valid)
    for i in np.nonzero(valid)[0]:
        x, y = xy[i]
        if not (0 <= x < rgb.shape[1] and 0 <= y < rgb.shape[0]):
            continue
        if quarantined_mask is not None and quarantined_mask[i]:
            color = (230, 60, 60)
        elif tracked_mask is not None and tracked_mask[i]:
            color = (60, 220, 60)
        else:
            color = (90, 140, 230)
        _draw_square(rgb, x, y, 1, color)
    if boxes is not None:
        for bi, b in enumerate(boxes):
            st = box_status[bi] if box_status is not None else 0
            color = {0: (240, 220, 60), 1: (60, 220, 60),
                     2: (240, 60, 60)}.get(int(st), (240, 220, 60))
            _draw_rect(rgb, b, color)
    return rgb


def export_map_ply(path: str, lm_pos: np.ndarray, lm_valid: np.ndarray,
                   kf_R: np.ndarray, kf_t: np.ndarray,
                   kf_valid: np.ndarray):
    """MapDrawer equivalent: landmarks (white) + keyframe centres (green
    points) into one PLY."""
    from ..ops.pointcloud import save_ply
    pts = [np.asarray(lm_pos)[np.asarray(lm_valid)]]
    cols = [np.full(pts[0].shape[0], 200.0)]
    kv = np.asarray(kf_valid)
    centers = np.stack([-np.asarray(kf_R)[k].T @ np.asarray(kf_t)[k]
                        for k in np.nonzero(kv)[0]]) if kv.any() else \
        np.zeros((0, 3))
    if len(centers):
        pts.append(centers)
        cols.append(np.full(len(centers), 60.0))
    allp = np.concatenate(pts)
    save_ply(path, allp, np.concatenate(cols), np.ones(len(allp), bool))


def draw_trajectory_topdown(traj_xyz: np.ndarray,
                            gt_xyz: Optional[np.ndarray] = None,
                            size: int = 512) -> np.ndarray:
    """Top-down (x, z) trajectory plot as an RGB image."""
    img = np.full((size, size, 3), 255, np.uint8)
    pts = [traj_xyz] + ([gt_xyz] if gt_xyz is not None else [])
    allp = np.concatenate(pts)
    lo = allp[:, [0, 2]].min(0) - 0.5
    hi = allp[:, [0, 2]].max(0) + 0.5
    scale = (size - 20) / max((hi - lo).max(), 1e-6)

    def to_px(p):
        q = (p[:, [0, 2]] - lo) * scale + 10
        return q.astype(int)

    for arr, color in zip(pts, [(200, 40, 40), (40, 40, 200)]):
        px = to_px(arr)
        for x, y in px:
            if 0 <= x < size and 0 <= y < size:
                img[np.clip(size - 1 - y, 0, size - 1), x] = color
    return img


def export_obbs_ply(path: str, obbs):
    """Dynamic-object 3D boxes as PLY edge clouds (MapDrawer::DrawDynamics
    equivalent, the reference's MapDrawer.cc:181-260): each OBB is
    sampled along its 12 edges."""
    import numpy as np
    pts = []
    for bid, obb in obbs.items():
        c = np.asarray(obb.center)
        A = np.asarray(obb.axes)          # rows = axes
        e = np.asarray(obb.extents)
        corners = []
        for sx in (-1, 1):
            for sy in (-1, 1):
                for sz in (-1, 1):
                    corners.append(c + A.T @ (e * np.array([sx, sy, sz])))
        corners = np.asarray(corners)
        edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
                 (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
        for a, b in edges:
            for t in np.linspace(0, 1, 8):
                pts.append(corners[a] * (1 - t) + corners[b] * t)
    from ..ops.pointcloud import save_ply
    pts = np.asarray(pts) if pts else np.zeros((0, 3))
    save_ply(path, pts)
    return len(pts)
