"""Per-frame feature container and the host-built frame.

Port of ``slam_dynamic_tpu/frontend/frame.py`` (``FrameData`` :25,
``Frame``, ``keypoints_in_boxes`` :73, ``build_frame`` :88,
``empty_frame_data`` :151, ``pad_frame_data`` :163), with
``inside_boxes``, the one in-box test of the port,
``keypoint_depth``, the depth association of every sensor that
``build_frame`` and the fused step share, and
``strided_keypoint_depth``, the fused step's lookup in a strided depth
upload. All N keypoint slots are kept
and ``static_mask`` carries the dynamic-box partition, so shapes stay
fixed. ``build_frame`` serves the frames the tracker builds outside
the fused step (initialization, LOST frames, the ``mask=`` path and mono
with the dynamic-object module), for every sensor: the depth of an RGB-D
depth map, of the stereo matcher on a right image, or none (mono); the
detector's boxes and a dynamic-pixel mask quarantine the keypoints
inside them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..ops.stereo import depth_from_rgbd, match_stereo
from ..utils.camera import Intrinsics, undistort_points
from .extractor import extract


class FrameData(NamedTuple):
    """Device-side per-frame tensors (fixed capacity N)."""

    xy: torch.Tensor          # [N, 2] undistorted pixel coords
    xy_raw: torch.Tensor      # [N, 2] raw (distorted) coords
    level: torch.Tensor       # [N] int32
    angle: torch.Tensor       # [N] float32
    response: torch.Tensor    # [N] float32
    desc: torch.Tensor        # [N, 8] int32 (bit view of uint32 lanes)
    valid: torch.Tensor       # [N] bool
    ur: torch.Tensor          # [N] float32 virtual right u (-1 none)
    depth: torch.Tensor       # [N] float32 (-1 none)
    static_mask: torch.Tensor  # [N] bool (False = quarantined by a box)
    scale: torch.Tensor       # [N] float32 (scale_factor ** level)


@dataclasses.dataclass
class Frame:
    """Host-side frame: device tensors + scalar bookkeeping."""

    data: FrameData
    frame_id: int
    timestamp: float
    R: Optional[torch.Tensor] = None        # world->camera, set by tracking
    t: Optional[torch.Tensor] = None
    obs_lm: Optional[torch.Tensor] = None   # [N] int32 landmark ids (-1)
    np_R: Optional[np.ndarray] = None       # host copies of the pose
    np_t: Optional[np.ndarray] = None
    ref_kf: int = -1                        # reference keyframe at dispatch
    np_Rk: Optional[np.ndarray] = None      # its pose from the packet
    np_tk: Optional[np.ndarray] = None
    ref_gen: int = 0                        # slot generation at dispatch


def inside_boxes(xy: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """[B, N] bool: keypoint n lies inside box b (x0, y0, x1, y1),
    edges included."""
    return ((xy[None, :, 0] >= boxes[:, None, 0])
            & (xy[None, :, 0] <= boxes[:, None, 2])
            & (xy[None, :, 1] >= boxes[:, None, 1])
            & (xy[None, :, 1] <= boxes[:, None, 3]))


def keypoints_in_boxes(xy: torch.Tensor, valid: torch.Tensor, boxes,
                       box_valid) -> torch.Tensor:
    """[N] bool: the keypoint lies inside an active box (host arrays)."""
    if boxes is None or len(boxes) == 0 or not np.asarray(box_valid).any():
        return torch.zeros(xy.shape[0], dtype=torch.bool, device=xy.device)
    b = torch.as_tensor(np.asarray(boxes, np.float32), device=xy.device)
    bv = torch.as_tensor(np.asarray(box_valid, bool), device=xy.device)
    return (inside_boxes(xy, b) & bv[:, None]).any(0) & valid


def keypoint_depth(cam: Intrinsics, image, kp, scale, orb_cfg,
                   scale_factor, right=None, depth_map=None):
    """(u_right, depth) [N] of the keypoints, -1 where unknown: the stereo
    matcher against the ``right`` image (its own extraction), the lookup
    in ``depth_map`` (metres), or none (mono). Images are [H, W] float32
    on the keypoints' device."""
    if right is not None:
        kp_r = extract(right, orb_cfg)
        sm = match_stereo(image, right, kp, kp_r, cam.bf, 0.1, scale,
                          scale_factor ** kp_r.level.to(torch.float32))
    elif depth_map is not None:
        sm = depth_from_rgbd(depth_map, kp.xy, kp.valid, cam.bf)
    else:
        return (torch.full_like(kp.response, -1.0),
                torch.full_like(kp.response, -1.0))
    return sm.u_right, sm.depth


def strided_keypoint_depth(cam: Intrinsics, depth_map, kp, stride: int):
    """(u_right, depth) [N] from a depth map (metres) uploaded at every
    ``stride``-th pixel (``slam_dynamic_tpu/frontend/fused.py:77-85``):
    sampled at the keypoint's low-resolution pixel, with ``u_right`` in
    full-resolution pixels; -1 where there is no depth."""
    hs, ws = depth_map.shape
    xi = torch.round(kp.xy[:, 0] / stride).to(torch.int64).clamp(0, ws - 1)
    yi = torch.round(kp.xy[:, 1] / stride).to(torch.int64).clamp(0, hs - 1)
    d = depth_map[yi, xi]
    ok = kp.valid & (d > 0)
    ur = torch.where(ok, kp.xy[:, 0] - cam.bf / torch.where(d <= 0, 1.0, d),
                     -1.0)
    return ur, torch.where(ok, d, -1.0)


def build_frame(cfg: SystemConfig, cam: Intrinsics, gray: np.ndarray,
                frame_id: int, timestamp: float,
                depth_map: Optional[np.ndarray] = None,
                boxes: Optional[np.ndarray] = None,
                box_valid: Optional[np.ndarray] = None,
                mask: Optional[np.ndarray] = None,
                right: Optional[np.ndarray] = None) -> Frame:
    """Construct a frame from host images: with the ``right`` image, its
    own extraction and the stereo matcher; with a ``depth_map`` (uint16
    is scaled to metres on the host, as the reference's ``build_frame``
    does), the depth lookup; with neither, no depth (mono). Keypoints
    inside an active box [B, 4] or on a pixel of ``mask`` [H, W] (True =
    dynamic, the reference's Mask R-CNN path, Frame.cc:297-403) are
    quarantined (``static_mask`` False)."""
    dev = cam.fx.device
    img = torch.as_tensor(np.asarray(gray, np.float32), device=dev)
    kp = extract(img, cfg.orb)
    xy = undistort_points(cam, kp.xy)
    sf = torch.tensor(cfg.orb.scale_factor, dtype=torch.float32, device=dev)
    scale = sf ** kp.level.to(torch.float32)
    if right is not None:
        right = torch.as_tensor(np.asarray(right, np.float32), device=dev)
    if depth_map is not None:
        depth_map = np.asarray(depth_map)
        if depth_map.dtype == np.uint16:
            depth_map = depth_map.astype(np.float32) \
                / max(cfg.camera.depth_map_factor, 1e-9)
        depth_map = torch.as_tensor(np.asarray(depth_map, np.float32),
                                    device=dev)
    ur, depth = keypoint_depth(cam, img, kp, scale, cfg.orb, sf, right,
                               depth_map)
    static = kp.valid & ~keypoints_in_boxes(xy, kp.valid, boxes, box_valid)
    if mask is not None:
        h, w = img.shape
        mk = torch.as_tensor(np.asarray(mask, bool), device=dev)
        xi = torch.round(kp.xy[:, 0]).to(torch.int64).clamp(0, w - 1)
        yi = torch.round(kp.xy[:, 1]).to(torch.int64).clamp(0, h - 1)
        static = static & ~mk[yi, xi]
    data = FrameData(xy=xy, xy_raw=kp.xy, level=kp.level, angle=kp.angle,
                     response=kp.response, desc=kp.desc, valid=kp.valid,
                     ur=ur, depth=depth, static_mask=static, scale=scale)
    data = pad_frame_data(data, cfg.capacity.max_keypoints)
    return Frame(data=data, frame_id=frame_id, timestamp=timestamp)


def empty_frame_data(n_slots: int, device=None) -> FrameData:
    """All-invalid FrameData (the placeholder reference frame of the fused
    dynamic step before a reference frame exists)."""
    z2 = torch.zeros((n_slots, 2), device=device)
    z1 = torch.zeros(n_slots, device=device)
    return FrameData(
        xy=z2, xy_raw=z2, level=torch.zeros(n_slots, dtype=torch.int32,
                                            device=device),
        angle=z1, response=z1,
        desc=torch.zeros((n_slots, 8), dtype=torch.int32, device=device),
        valid=torch.zeros(n_slots, dtype=torch.bool, device=device),
        ur=z1 - 1.0, depth=z1 - 1.0,
        static_mask=torch.zeros(n_slots, dtype=torch.bool, device=device),
        scale=z1 + 1.0)


def pad_frame_data(fd: FrameData, n_slots: int) -> FrameData:
    """Pad keypoint tensors to the map's slot capacity (padding invalid)."""
    n = fd.xy.shape[0]
    if n == n_slots:
        return fd
    if n > n_slots:
        raise ValueError(f"frame has {n} keypoints > capacity {n_slots}")
    p = n_slots - n

    def pad(a, fill=0):
        return torch.cat([a, torch.full((p,) + tuple(a.shape[1:]), fill,
                                        dtype=a.dtype, device=a.device)])

    return FrameData(
        xy=pad(fd.xy), xy_raw=pad(fd.xy_raw), level=pad(fd.level),
        angle=pad(fd.angle), response=pad(fd.response), desc=pad(fd.desc),
        valid=pad(fd.valid, False), ur=pad(fd.ur, -1.0),
        depth=pad(fd.depth, -1.0), static_mask=pad(fd.static_mask, False),
        scale=pad(fd.scale, 1.0))
