"""Port copy of ``slam_dynamic_tpu/io/synthetic.py`` (host numpy). It
renders the same images to the bit
(``tests/test_torch_datasets.py``); the one change is that each wall's
texture is computed only on the pixels where that wall is the nearest
so far, which halves the time of a frame.

Synthetic RGB-D / stereo sequence renderer with exact ground truth.

The evaluation environment has no KITTI/TUM data (zero egress), so the
framework ships a deterministic synthetic world: a textured box room
raycast at 640x480 (or any size), a smooth ground-truth trajectory, perfect
depth, optional stereo pair, and an optional moving textured quad (the
"dynamic object") with per-frame ground-truth 2D boxes + masks. This powers
unit/integration tests, ATE benchmarks, and the dynamic-rejection tests —
the same roles the TUM fr3_walking_* and KITTI sequences play for the
reference (SURVEY §6).

Pure numpy; rendering is fully vectorized over pixels (~15 ms/frame).
Camera convention: x right, y down, z forward. Pose stored as (R_wc, t_wc):
x_world = R_wc @ x_cam + t_wc.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np


@dataclass(frozen=True)
class SynthConfig:
    n_frames: int = 60
    width: int = 640
    height: int = 480
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5
    baseline: float = 0.08          # metres (stereo)
    fps: float = 30.0
    seed: int = 0
    # trajectory amplitude
    advance: float = 0.025          # m/frame forward drift
    sway: float = 0.35              # lateral sinusoid amplitude (m)
    yaw_amp: float = 0.06           # rad
    z_start: float = 0.0            # sweep start depth (near the back
    #                                 wall the camera sees ONLY that wall:
    #                                 a planar scene, the PnP degeneracy
    #                                 canary)
    # dynamic object
    dynamic_object: bool = False
    obj_size: float = 1.0           # quad edge length (m)
    obj_depth: float = 4.0          # distance from world origin
    obj_speed: float = 0.06         # m/frame lateral speed
    obj_x0: float = -1.6            # start x (m)
    obj_bob: float = 0.35           # vertical bobbing amplitude (m)
    stereo: bool = False
    texture_cells: float = 2.8      # checker frequency (cells per metre)
    trajectory: str = "sweep"       # "sweep" | "orbit" (closed loop)
    orbit_radius: float = 1.2       # metres (orbit mode)
    orbit_turns: float = 0.0        # >0: revolutions over the sequence
    # (0 keeps the legacy single-circuit parameterization; ~2.2 gives a
    # double loop closure scenario)


class SyntheticSequence(NamedTuple):
    gray: np.ndarray          # [T, H, W] float32 in [0, 255]
    right: Optional[np.ndarray]   # [T, H, W] or None
    depth: np.ndarray         # [T, H, W] float32 metres (z in camera frame)
    R_wc: np.ndarray          # [T, 3, 3]
    t_wc: np.ndarray          # [T, 3]
    timestamps: np.ndarray    # [T]
    boxes: np.ndarray         # [T, 1, 4] float32 (x0,y0,x1,y1), -1 if none
    box_valid: np.ndarray     # [T, 1] bool
    masks: np.ndarray         # [T, H, W] bool (True = dynamic pixel)
    cfg: SynthConfig


# Room: axis-aligned planes (normal axis, offset, inward direction)
_ROOM = [
    (2, 9.0, -1),    # back wall z=9
    (2, -3.0, +1),   # front wall z=-3 (behind start)
    (0, -4.0, +1),   # left wall x=-4
    (0, 4.0, -1),    # right wall x=4
    (1, 2.0, -1),    # floor y=2
    (1, -2.0, +1),   # ceiling y=-2
]


def _texture(u, v, seed, cells):
    """Procedural high-contrast texture: random-intensity checker plus a
    second rotated harmonic layer (rich in FAST corners, no repetition)."""
    rs = np.random.RandomState(seed)
    # hash cell coords to intensities
    iu = np.floor(u * cells).astype(np.int64)
    iv = np.floor(v * cells).astype(np.int64)
    h1 = (iu * 73856093) ^ (iv * 19349663) ^ (seed * 83492791)
    base = ((h1 % 1000) / 1000.0)
    iu2 = np.floor((u + 0.31 * v) * cells * 2.7).astype(np.int64)
    iv2 = np.floor((v - 0.17 * u) * cells * 2.7).astype(np.int64)
    h2 = (iu2 * 2654435761) ^ (iv2 * 40503) ^ ((seed + 1) * 65599)
    fine = ((h2 % 1000) / 1000.0)
    return (40.0 + 150.0 * base + 50.0 * fine).astype(np.float32)


def _trajectory(cfg: SynthConfig):
    T = cfg.n_frames
    t = np.arange(T, dtype=np.float32)
    if cfg.trajectory == "orbit":
        # closed circuit: camera orbits the room centre, yawing with the
        # tangent; final frames overlap the start (loop-closure scenario)
        if cfg.orbit_turns > 0:
            th = 2 * np.pi * cfg.orbit_turns * t / (T - 1)
        else:
            th = 2 * np.pi * t / (T - max(T // 10, 2))
        r = cfg.orbit_radius
        pos = np.stack([r * np.sin(th), 0.05 * np.sin(2 * th) + 0.0,
                        3.0 + r - r * np.cos(th)], axis=1)
        yaw = th
        R = np.zeros((T, 3, 3), np.float32)
        for i in range(T):
            cy_, sy = np.cos(yaw[i]), np.sin(yaw[i])
            R[i] = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]],
                            np.float32)
        return R, pos.astype(np.float32)
    pos = np.stack([
        cfg.sway * np.sin(2 * np.pi * t / 90.0),
        0.15 * np.sin(2 * np.pi * t / 130.0),
        cfg.z_start + cfg.advance * t,
    ], axis=1)
    yaw = cfg.yaw_amp * np.sin(2 * np.pi * t / 70.0)
    pitch = 0.5 * cfg.yaw_amp * np.sin(2 * np.pi * t / 110.0 + 1.0)
    R = np.zeros((T, 3, 3), np.float32)
    for i in range(T):
        cy_, sy = np.cos(yaw[i]), np.sin(yaw[i])
        cp, sp = np.cos(pitch[i]), np.sin(pitch[i])
        Ry = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        R[i] = (Ry @ Rx).astype(np.float32)
    return R, pos.astype(np.float32)


def _render_view(cfg, R_wc, t_wc, obj_center, rs):
    """Raycast one camera. Returns (gray, depth, mask, box)."""
    H, W = cfg.height, cfg.width
    xs = (np.arange(W, dtype=np.float32) - cfg.cx) / cfg.fx
    ys = (np.arange(H, dtype=np.float32) - cfg.cy) / cfg.fy
    dx, dy = np.meshgrid(xs, ys)
    dirs_c = np.stack([dx, dy, np.ones_like(dx)], axis=-1)     # [H,W,3]
    dirs_w = dirs_c @ R_wc.T                                    # [H,W,3]
    origin = t_wc

    best_t = np.full((H, W), np.inf, np.float32)
    color = np.zeros((H, W), np.float32)
    uv_axes = {0: (2, 1), 1: (0, 2), 2: (0, 1)}
    for pi, (axis, off, sign) in enumerate(_ROOM):
        d_axis = dirs_w[..., axis]
        denom = np.where(np.abs(d_axis) < 1e-9, 1e-9, d_axis)
        th = (off - origin[axis]) / denom
        hit = (th > 0.05) & (th < best_t)
        if not hit.any():
            continue
        # the texture only where this plane is the nearest so far: the
        # same per-pixel arithmetic as over the whole image, so the same
        # values, for a fraction of the work
        th_hit = th[hit]
        pt = origin[None, :] + th_hit[:, None] * dirs_w[hit]
        au, av = uv_axes[axis]
        color[hit] = _texture(pt[:, au], pt[:, av], cfg.seed * 31 + pi,
                              cfg.texture_cells)
        best_t[hit] = th_hit

    mask = np.zeros((H, W), bool)
    box = np.full(4, -1.0, np.float32)
    if obj_center is not None:
        # camera-facing textured quad at obj_center
        half = cfg.obj_size / 2
        d_z = dirs_w[..., 2]
        denom = np.where(np.abs(d_z) < 1e-9, 1e-9, d_z)
        th = (obj_center[2] - origin[2]) / denom
        pt = origin[None, None, :] + th[..., None] * dirs_w
        inside = ((th > 0.05) & (np.abs(pt[..., 0] - obj_center[0]) < half)
                  & (np.abs(pt[..., 1] - obj_center[1]) < half))
        hit = inside & (th < best_t)
        if hit.any():
            color[hit] = _texture(pt[hit][:, 0] - obj_center[0],
                                  pt[hit][:, 1] - obj_center[1],
                                  cfg.seed * 77 + 5, cfg.texture_cells * 3.0)
            best_t[hit] = th[hit]
            mask = hit
            ys_h, xs_h = np.nonzero(hit)
            box = np.array([xs_h.min(), ys_h.min(), xs_h.max(), ys_h.max()],
                           np.float32)

    # depth = z-coordinate in camera frame of the hit point
    pt_w = origin[None, None, :] + best_t[..., None] * dirs_w
    pt_c = (pt_w - t_wc) @ R_wc          # R_wc^T applied to rows
    depth = pt_c[..., 2].astype(np.float32)
    depth = np.where(np.isfinite(best_t), depth, 0.0)
    # mild sensor noise for realism
    color = color + rs.normal(0, 1.0, color.shape).astype(np.float32)
    return np.clip(color, 0, 255), depth, mask, box


def generate(cfg: SynthConfig) -> SyntheticSequence:
    rs = np.random.RandomState(cfg.seed)
    R_all, t_all = _trajectory(cfg)
    T = cfg.n_frames
    H, W = cfg.height, cfg.width
    gray = np.zeros((T, H, W), np.float32)
    right = np.zeros((T, H, W), np.float32) if cfg.stereo else None
    depth = np.zeros((T, H, W), np.float32)
    masks = np.zeros((T, H, W), bool)
    boxes = np.full((T, 1, 4), -1.0, np.float32)
    box_valid = np.zeros((T, 1), bool)

    for i in range(T):
        obj = None
        if cfg.dynamic_object:
            obj = np.array([
                cfg.obj_x0 + cfg.obj_speed * i,
                cfg.obj_bob * np.sin(2 * np.pi * i / 50.0),
                cfg.obj_depth + (0.3 if cfg.obj_speed else 0.0)
                * np.sin(2 * np.pi * i / 80.0),
            ], np.float32)
        g, d, m, b = _render_view(cfg, R_all[i], t_all[i], obj, rs)
        gray[i], depth[i], masks[i] = g, d, m
        boxes[i, 0] = b
        box_valid[i, 0] = b[0] >= 0
        if cfg.stereo:
            t_right = t_all[i] + R_all[i] @ np.array(
                [cfg.baseline, 0, 0], np.float32)
            gr, _, _, _ = _render_view(cfg, R_all[i], t_right, obj, rs)
            right[i] = gr

    ts = np.arange(T, dtype=np.float64) / cfg.fps
    return SyntheticSequence(gray, right, depth, R_all, t_all, ts, boxes,
                             box_valid, masks, cfg)
