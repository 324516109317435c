"""Frame-to-frame dynamic-box tracking: IoU association with
constant-velocity prediction and ghost boxes for missed detections.

Host-numpy copy of ``slam_dynamic_tpu/frontend/boxtrack.py``
(``BoxTrackerState`` :18, ``iou_matrix`` :37, ``track_boxes`` :53), the
reference's Frame::boxTrack: cost 1 - IoU, greedy assignment, velocity
carry-over and ghost boxes for unmatched previous boxes, fresh ids for
unmatched detections. At most 16 boxes and branchy logic: control plane,
kept on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BoxTrackerState:
    boxes: np.ndarray       # [B, 4] float32
    ids: np.ndarray         # [B] int32
    velocity: np.ndarray    # [B, 4] float32 per-frame box motion
    missed: np.ndarray      # [B] int32 consecutive missed frames
    status: np.ndarray      # [B] int32 0=tentative 1=static 2=dynamic
    dyn_streak: np.ndarray  # [B] int32 consecutive dynamic classifications
    next_id: int = 0

    @staticmethod
    def empty():
        z4 = np.zeros((0, 4), np.float32)
        zi = np.zeros((0,), np.int32)
        return BoxTrackerState(z4.copy(), zi.copy(), z4.copy(), zi.copy(),
                               zi.copy(), zi.copy(), 0)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[A, B] IoU of two box sets (x0, y0, x1, y1)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    x0 = np.maximum(a[:, None, 0], b[None, :, 0])
    y0 = np.maximum(a[:, None, 1], b[None, :, 1])
    x1 = np.minimum(a[:, None, 2], b[None, :, 2])
    y1 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return (inter / np.maximum(union, 1e-9)).astype(np.float32)


def track_boxes(state: BoxTrackerState, detections: np.ndarray,
                iou_threshold: float = 0.3, max_missed: int = 1,
                max_boxes: int = 16) -> BoxTrackerState:
    """Advance the tracker by one frame given current detections [D, 4].

    Greedy IoU matching against velocity-predicted previous boxes (the
    reference's cost loop, Frame.cc:497-516); unmatched old boxes become
    ghosts advanced by their velocity for up to `max_missed` frames
    (:518-535); unmatched detections get new ids (:539-551).
    """
    det = np.asarray(detections, np.float32).reshape(-1, 4)
    pred = state.boxes + state.velocity
    iou = iou_matrix(pred, det)

    matched_prev = np.full(len(pred), -1, np.int64)
    used_det = np.zeros(len(det), bool)
    # greedy: repeatedly take the best remaining pair
    flat = iou.copy()
    while flat.size and flat.max() > iou_threshold:
        i, j = np.unravel_index(np.argmax(flat), flat.shape)
        matched_prev[i] = j
        used_det[j] = True
        flat[i, :] = -1
        flat[:, j] = -1

    boxes, ids, vel, missed, status, streak = [], [], [], [], [], []
    for i in range(len(pred)):
        j = matched_prev[i]
        if j >= 0:
            new_box = det[j]
            boxes.append(new_box)
            ids.append(state.ids[i])
            vel.append(0.5 * state.velocity[i] + 0.5 * (new_box - state.boxes[i]))
            missed.append(0)
            status.append(state.status[i])
            streak.append(state.dyn_streak[i])
        elif state.missed[i] < max_missed:
            boxes.append(pred[i])            # ghost box
            ids.append(state.ids[i])
            vel.append(state.velocity[i])
            missed.append(state.missed[i] + 1)
            status.append(state.status[i])
            streak.append(state.dyn_streak[i])
    next_id = state.next_id
    for j in range(len(det)):
        if not used_det[j] and len(boxes) < max_boxes:
            boxes.append(det[j])
            ids.append(next_id)
            next_id += 1
            vel.append(np.zeros(4, np.float32))
            missed.append(0)
            status.append(0)
            streak.append(0)

    if boxes:
        return BoxTrackerState(
            np.stack(boxes).astype(np.float32),
            np.asarray(ids, np.int32),
            np.stack(vel).astype(np.float32),
            np.asarray(missed, np.int32),
            np.asarray(status, np.int32),
            np.asarray(streak, np.int32), next_id)
    s = BoxTrackerState.empty()
    s.next_id = next_id
    return s
