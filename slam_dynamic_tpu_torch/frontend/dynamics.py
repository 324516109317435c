"""Host half of the dynamic-object module.

Port of ``slam_dynamic_tpu/frontend/dynamics.py`` (``DynamicsModule``
:27: ``pick_ref_fd`` :50, ``push_fd`` :68, ``update_streaks`` :71,
``update_box3d`` :85, ``pre_track`` :131, ``post_track`` :165,
``_pick_reference`` :169): the queues of reference frames (cap 0.3 * fps;
the reference frame is the newest one at least ``ref_frame_age_s``
older), the per-box streaks (``dyn_confirm_frames`` consecutive dynamic
verdicts confirm a box, status 2) and the per-object 3D state, gated and
smoothed on the host. On the fused path the classification runs inside
the fused step (``frontend/fused.py``); on the host-built frames of the
``mask=`` path ``pre_track`` classifies the boxes and reinstates the
keypoints of static ones before the frame is tracked.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..config import SystemConfig
from . import dynamics_ops as dops
from .frame import empty_frame_data


class DynamicsModule:
    def __init__(self, cfg: SystemConfig, device):
        self.cfg = cfg
        self.device = device
        maxq = max(2, int(cfg.tracking.frame_queue_factor * cfg.camera.fps))
        self.queue = collections.deque(maxlen=maxq)      # host-built Frames
        self.fd_queue = collections.deque(maxlen=maxq)   # (ts, FrameData)
        self._dummy = None
        # per-object 3D state, smoothed per frame: box track id -> dict
        # with d, t (camera-frame centre), R (OBB axes rows), ext, ts
        self.obj_state = {}
        self._obj_depth = {}       # box id -> (smoothed depth, ts)

    def pick_ref_fd(self, ts: float, n_slots: int):
        """(FrameData, have_ref device 0./1.) of the reference frame: the
        newest queued frame at least ``ref_frame_age_s`` older, else an
        all-invalid placeholder."""
        if self._dummy is None:
            f32 = dict(dtype=torch.float32, device=self.device)
            self._dummy = (empty_frame_data(n_slots, self.device),
                           torch.tensor(0.0, **f32),
                           torch.tensor(1.0, **f32))
        best = None
        for t0, fd in self.fd_queue:
            if ts - t0 >= self.cfg.tracking.ref_frame_age_s:
                best = fd
        if best is None:
            return self._dummy[0], self._dummy[1]
        return best, self._dummy[2]

    def push_fd(self, ts: float, fd):
        self.fd_queue.append((ts, fd))

    def update_streaks(self, boxes, verdicts):
        """Streaks from fresh verdicts: ``dyn_confirm_frames`` consecutive
        dynamic verdicts confirm (status 2); a static verdict resets the
        streak and marks an unconfirmed box static (status 1); verdict 0
        changes nothing."""
        for i in range(len(boxes.boxes)):
            v = int(verdicts[i]) if i < len(verdicts) else 0
            if v == 2:
                boxes.dyn_streak[i] += 1
                if boxes.dyn_streak[i] >= self.cfg.tracking.dyn_confirm_frames:
                    boxes.status[i] = 2
            elif v == 1:
                boxes.dyn_streak[i] = 0
                if boxes.status[i] != 2:
                    boxes.status[i] = 1

    def update_box3d(self, boxes, box3d, timestamp: float):
        """The per-object 3D state with the reference's gates: confirmed
        boxes (status 2) only, box centre within the middle 60% of the
        width, depth in (0, ``max_object_depth``], jumps over
        ``max_depth_jump`` rejected, weight-3 smoothing keyed by the box's
        track id. ``box3d`` is the raw [B, 16] block of the packet
        (``dynamics_ops.box_3d_state``). Host floats from the config
        only: no device value is read here."""
        if box3d is None or len(boxes.boxes) == 0:
            return
        cam, dc = self.cfg.camera, self.cfg.dynamic
        W = cam.width
        lo, hi = dc.box_center_margin
        for i in range(min(len(boxes.boxes), box3d.shape[0])):
            if boxes.status[i] != 2:
                continue
            cx = (boxes.boxes[i, 0] + boxes.boxes[i, 2]) * 0.5
            if cx < lo * W or cx > hi * W:     # edge depth unreliable
                continue
            d = float(box3d[i, 0])
            if d <= 0 or d > dc.max_object_depth:
                continue
            bid = int(boxes.ids[i])
            last = self._obj_depth.get(bid)
            # a smoothed depth from before an occlusion gap is stale: the
            # reference compares with the previous frame only
            if last is not None and \
                    timestamp - last[1] > 2.0 * self.cfg.tracking.ref_frame_age_s:
                last = None
            if last is not None:
                if abs(last[0] - d) > dc.max_depth_jump:
                    continue
                d = (last[0] + 2.0 * d) / 3.0
            self._obj_depth[bid] = (d, timestamp)
            cy = (boxes.boxes[i, 1] + boxes.boxes[i, 3]) * 0.5
            t = np.array([(cx - cam.cx) / cam.fx * d,
                          (cy - cam.cy) / cam.fy * d, d], np.float32)
            self.obj_state[bid] = dict(
                d=d, t=t, R=np.asarray(box3d[i, 4:13]).reshape(3, 3),
                ext=np.asarray(box3d[i, 13:16]), ts=timestamp)

    # ------------------ host-built frames (the mask= path) -------------
    def pre_track(self, frame, boxes, tracker):
        """Classify every tracked box of ``frame`` against the reference
        frame before the frame is tracked, update the streaks and give the
        keypoints of static boxes (status 1) back, so they take part in
        tracking. One readback of the verdicts."""
        ref = self._pick_reference(frame.timestamp)
        if ref is None or boxes.boxes is None or len(boxes.boxes) == 0:
            return
        dc, dev = self.cfg.dynamic, self.device
        bx = torch.as_tensor(np.asarray(boxes.boxes, np.float32), device=dev)
        result = dops.classify_boxes(
            tracker.cam, ref.data, frame.data, bx,
            torch.ones(len(boxes.boxes), dtype=torch.bool, device=dev),
            n_hyp=dc.ransac_hypotheses, thresh_px=dc.ransac_threshold_px,
            chi2_h=dc.chi2_homography, chi2_f=dc.chi2_fundamental,
            min_pairs=dc.min_pairs_for_model,
            seed=torch.tensor(self.cfg.seed + frame.frame_id, device=dev))
        self.update_streaks(boxes, result.verdict.cpu().numpy())
        static_boxes = boxes.status == 1
        if static_boxes.any():
            frame.data = dops.reinstate_features(
                frame.data, bx, torch.as_tensor(static_boxes, device=dev))

    def post_track(self, frame, boxes, tracker):
        """A tracked host-built frame joins the reference queue."""
        self.queue.append(frame)

    def _pick_reference(self, ts: float):
        """The newest queued frame at least ``ref_frame_age_s`` older, or
        None."""
        best = None
        for f in self.queue:
            if ts - f.timestamp >= self.cfg.tracking.ref_frame_age_s:
                best = f
        return best
