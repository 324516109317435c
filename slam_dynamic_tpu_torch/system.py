"""System facade: the public entry point of the port.

Port of ``slam_dynamic_tpu/system.py:29`` (``System.__init__``),
``_ensure_voc`` :75, ``_on_keyframe`` :99, ``_on_reloc`` :125,
``_relocalize`` :152, the box state (``_maybe_detect`` :164 for
precomputed boxes, ``_advance_boxes`` :188, ``_active_boxes`` :197),
``track_rgbd`` :206 (the fused path and the ``mask=`` path, :250-262),
``track_stereo`` :250, ``track_chunk`` :271 (depth maps, right images,
or None for mono), ``track_mono`` :315, ``_track_common`` :325,
``_dyn_args`` :335, ``_dyn_after`` :377, ``object_states`` :443, the
``trajectory`` property and the trajectory writers. The port's System
tracks and maps RGB-D, stereo and monocular frames (``cfg.sensor``), per
frame or in temporal chunks; on every keyframe it looks for
a loop and verifies and corrects one it finds; a LOST frame is
relocalized, and a relocalization corrects the drift it reveals. With
the detector's boxes (``DetectorConfig.mode = "precomputed"``, the
library default) it runs the dynamic-object module: box tracking, the
fused H/F reclassification of the boxes and the per-object 3D state, or
with a dynamic-pixel ``mask`` the host-built frame's classification. Not
ported yet: the post-loop global BA, localization-only mode, the online
detector and dense mapping.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .backend import loop_closing, relocalization
from .backend.loop_closing import LoopCloser, LoopResult
from .config import SystemConfig
from .frontend.boxtrack import BoxTrackerState, track_boxes
from .frontend.dynamics import DynamicsModule
from .frontend.frame import Frame, build_frame
from .frontend.tracking import Tracker, TrackStats
from .io import trajectory as traj_io
from .models import vocabulary as voc_mod
from .utils.camera import Intrinsics


def intrinsics_from_config(cfg: SystemConfig, device=None) -> Intrinsics:
    c = cfg.camera
    return Intrinsics.create(c.fx, c.fy, c.cx, c.cy, c.k1, c.k2, c.p1, c.p2,
                             c.k3, c.bf, c.width, c.height, device=device)


class System:
    """``System(cfg).track_rgbd(gray_u8, depth_u16, t, detections=)``,
    ``.track_stereo(left_u8, right_u8, t, detections=)``,
    ``.track_mono(gray_u8, t)`` or ``.track_chunk(grays, auxs, ts,
    detections=)`` on the card by default; ``device="cpu"`` runs the
    plain PyTorch path on the CPU."""

    def __init__(self, cfg: SystemConfig, device=None):
        if cfg.detector.mode == "online":
            raise NotImplementedError(
                "the online detector (CenterNet) is not ported yet (ROADMAP "
                "item 18); pass precomputed boxes with "
                "DetectorConfig(mode='precomputed')")
        if cfg.loop.run_global_ba:
            raise NotImplementedError(
                "the post-loop global BA is not ported yet (ROADMAP item "
                "20, with the sharded BA it is built on); use "
                "LoopConfig(run_global_ba=False)")
        path = cfg.vocabulary.path
        if path and not str(path).endswith(".npz"):
            raise NotImplementedError(
                f"vocabulary {path!r}: only .npz vocabularies load in the "
                "port")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cam = intrinsics_from_config(cfg, self.device)
        self.tracker = Tracker(cfg, self.cam)
        self.frame_id = 0
        self.boxes = BoxTrackerState.empty()
        self.dynamics = DynamicsModule(cfg, self.device) \
            if cfg.detector.mode != "off" else None
        self._dyn_consts = None
        # place recognition: the vocabulary is loaded (or trained) at the
        # first keyframe unless a path is configured
        self.voc = None
        self.voc_source = None     # the .npz read, or how it was trained
        self.loop = None
        self.last_loop = None
        self.n_reloc_corrections = 0
        if path:
            self.voc = voc_mod.load(path, self.device)
            self.voc_source = path
        self.tracker.on_keyframe = self._on_keyframe
        self.tracker.relocalizer = self._relocalize
        self.tracker.on_reloc = self._on_reloc
        if self.device.type == "cuda":
            # the first loop closing or relocalization of a process would
            # otherwise stall tracking for seconds (PERF.md, section 5)
            loop_closing.warm_up(cfg, self.cam)

    def _ensure_voc(self):
        if self.voc is None:
            # the shipped vocabulary unless the config opts out
            # (prefer_asset=False), else words trained from keyframe 0
            apath = voc_mod.default_vocab_path() \
                if self.cfg.vocabulary.prefer_asset else None
            if apath is not None:
                self.voc = voc_mod.load(apath, self.device)
                self.voc_source = apath
            else:
                m = self.tracker.map
                desc = m.kf_kp_desc[0][m.kf_kp_valid[0]].cpu().numpy()
                self.voc = voc_mod.train(
                    desc, k=self.cfg.vocabulary.k,
                    levels=min(self.cfg.vocabulary.levels, 3),
                    seed=self.cfg.seed, device=self.device)
                self.voc_source = "trained from keyframe 0"
        if self.loop is None:
            self.loop = LoopCloser(self.cfg, self.cam, self.voc)

    def vocabulary_line(self) -> str:
        """Which vocabulary the loop detector uses: the file and its size,
        or how it was made."""
        if self.voc_source is None:
            return "vocabulary: not loaded (no keyframe yet)"
        if os.path.isfile(self.voc_source):
            return (f"vocabulary: {self.voc_source} "
                    f"({os.path.getsize(self.voc_source)} bytes, "
                    f"{self.voc.n_words} words)")
        return f"vocabulary: {self.voc_source} ({self.voc.n_words} words)"

    def _on_keyframe(self, k: int):
        self._ensure_voc()
        m, result = self.loop.on_keyframe(self.tracker.map, k,
                                          self.tracker.stereo_obs,
                                          seq=self.tracker.kf_seq)
        self.tracker.map = m
        self.last_loop: LoopResult = result

    def _on_reloc(self, k_last: int, cand: int):
        """The drift correction of a successful relocalization (the
        tracker's ``on_reloc`` hook): the loop between the last keyframe
        before the loss and the matched one goes through
        ``LoopCloser.on_relocalization``; a correction moves keyframe
        poses, so the tracker's cached keyframe poses are dropped."""
        if self.loop is None:
            return
        m, result = self.loop.on_relocalization(
            self.tracker.map, k_last, cand, self.tracker.stereo_obs,
            seq=self.tracker.kf_seq)
        if result.closed:
            self.tracker.map = m
            self.tracker._kf_pose_cache.clear()
            self.last_loop = result
            # its own counter: the next keyframe's result replaces last_loop
            self.n_reloc_corrections += 1

    def _relocalize(self, frame):
        """The tracker's relocalizer: BoW candidates from the loop
        closer's keyframe database, PnP and pose polish
        (``backend/relocalization.py``), seeded by the frame id."""
        if self.loop is None:
            return False, None, None, None, -1
        return relocalization.relocalize(
            self.tracker.map, self.loop.db, self.voc, self.cam, frame.data,
            seed=self.cfg.seed + frame.frame_id,
            min_inliers=self.cfg.tracking.min_inliers_after_reloc,
            use_direct_index=self.cfg.vocabulary.use_direct_index,
            di_level=self.cfg.vocabulary.direct_index_level)

    # ------------------------------------------------------------------
    def _advance_boxes(self, detections: Optional[np.ndarray]):
        """Advance the box tracker by one frame's detections [D, 4]
        (precomputed boxes; None is no detection)."""
        if detections is None:
            detections = np.zeros((0, 4), np.float32)
        dc = self.cfg.dynamic
        self.boxes = track_boxes(self.boxes, detections,
                                 iou_threshold=dc.iou_match_threshold,
                                 max_missed=dc.velocity_ghost_frames,
                                 max_boxes=dc.max_boxes)

    def _active_boxes(self):
        """Boxes quarantining keypoints: tentative or confirmed dynamic
        (a box reclassified static, status 1, stops gating)."""
        if len(self.boxes.boxes) == 0:
            return None, None
        return self.boxes.boxes, self.boxes.status != 1

    def _dyn_args(self, timestamp: float, stride: bool = False):
        """Inputs of the fused dynamic step, or None when the module is off
        or tracking is not OK. ``stride`` (the per-frame path): also None
        with no tracked box (the static step runs), and ``classify`` False
        off the ``classify_every`` stride. The box status is uploaded only
        when it changes and the seed is a device constant: the per-frame
        RANSAC variation is derived on the device from the pose."""
        if self.dynamics is None or self.tracker.state != "OK":
            return None
        classify = True
        if stride:
            if len(self.boxes.boxes) == 0:
                return None
            ce = self.cfg.dynamic.classify_every
            classify = not (ce > 1 and self.frame_id % ce != 0)
        B = self.cfg.dynamic.max_boxes
        status = np.zeros(B, np.int32)
        n = min(len(self.boxes.status), B)
        status[:n] = self.boxes.status[:n]
        ref_fd, have_ref = self.dynamics.pick_ref_fd(
            timestamp, self.cfg.capacity.max_keypoints)
        key = status.tobytes()
        if self._dyn_consts is None or self._dyn_consts[0] != key:
            seed = self._dyn_consts[2] if self._dyn_consts else torch.tensor(
                self.cfg.seed, dtype=torch.int32, device=self.device)
            self._dyn_consts = (key, torch.from_numpy(status).to(
                self.device), seed)
        return dict(ref_fd=ref_fd, have_ref=have_ref,
                    box_status=self._dyn_consts[1], seed=self._dyn_consts[2],
                    classify=classify)

    def _dyn_after(self, st: TrackStats, timestamp: float):
        """Streaks and 3D state from the finalized frame's verdicts; the
        frame dispatched last enters the reference queue."""
        if self.dynamics is None:
            return
        if st.verdicts is not None and len(self.boxes.boxes):
            self.dynamics.update_streaks(self.boxes, st.verdicts)
            self.dynamics.update_box3d(self.boxes, st.box3d, timestamp)
        lf = self.tracker.last_frame
        if lf is not None and self.tracker.state == "OK":
            self.dynamics.push_fd(timestamp, lf.data)

    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray,
                   timestamp: float,
                   detections: Optional[np.ndarray] = None,
                   mask: Optional[np.ndarray] = None) -> TrackStats:
        """RGB-D entry (ref System::TrackRGBD): uint8 gray and uint16 (or
        float metres) depth in, one fused device step per tracked frame.
        ``detections`` [D, 4] are this frame's boxes (x0, y0, x1, y1);
        with the dynamic-object module on they are tracked, classified and
        their keypoints quarantined or reinstated in the same step.
        ``mask`` [H, W] (True = dynamic pixel) quarantines the keypoints on
        it; such a frame is built and tracked on the host
        (``_track_common``), its boxes classified before it is tracked."""
        if mask is not None:
            self._advance_boxes(detections)
            boxes, bvalid = self._active_boxes()
            frame = build_frame(self.cfg, self.cam, gray, self.frame_id,
                                timestamp, depth, boxes, bvalid, mask=mask)
            return self._track_common(frame)
        return self._track_fused(gray, depth, timestamp, detections)

    def track_stereo(self, left: np.ndarray, right: np.ndarray,
                     timestamp: float,
                     detections: Optional[np.ndarray] = None) -> TrackStats:
        """Stereo entry (ref System::TrackStereo): rectified uint8 left
        and right images in, one fused device step per tracked frame (two
        extractions and the row-band matcher); ``detections`` as in
        ``track_rgbd``."""
        return self._track_fused(left, right, timestamp, detections)

    def track_mono(self, gray: np.ndarray, timestamp: float) -> TrackStats:
        """Monocular entry (ref System::TrackMonocular): the two-view
        bootstrap, then one fused device step per tracked frame; with the
        dynamic-object module on, the frame is built and tracked on the
        host (``_track_common``)."""
        if self.dynamics is None:
            st = self.tracker.step_images(gray, None, self.frame_id,
                                          timestamp)
            self.frame_id += 1
            return st
        return self._track_common(build_frame(self.cfg, self.cam, gray,
                                              self.frame_id, timestamp))

    def _track_fused(self, gray, aux, timestamp: float, detections):
        """One frame through the fused step (aux: the depth map or the
        right image), with the dynamic-object module's boxes."""
        self._advance_boxes(detections)
        boxes, bvalid = self._active_boxes()
        dyn = self._dyn_args(timestamp, stride=True)
        if dyn is not None:
            # classification sees every box (a static box can turn
            # dynamic); the status gates quarantine inside the step
            boxes = self.boxes.boxes
            bvalid = np.ones(len(boxes), bool)
        st = self.tracker.step_images(gray, aux, self.frame_id, timestamp,
                                      boxes, bvalid, dyn=dyn)
        self._dyn_after(st, timestamp)
        self.frame_id += 1
        return st

    def track_chunk(self, grays, auxs, timestamps,
                    detections: Optional[list] = None) -> list:
        """Temporal chunking: C consecutive frames in one fused call and
        one packed readback (``Tracker.step_images_chunk``). ``auxs``:
        the depth maps (RGB-D), the right images (stereo), or None
        (mono). ``detections``: one box array (or None) per frame; with the
        dynamic-object module on, the chunk classifies its boxes against
        the reference frame picked at its start, and the streaks are
        updated from the verdicts of the chunk finalized in this call.
        Returns the stats of the frames finalized in this call; decisions
        lag up to a chunk."""
        frames = []
        first_id = self.frame_id
        if auxs is None:
            auxs = [None] * len(grays)
        for j, (g, d, ts) in enumerate(zip(grays, auxs, timestamps)):
            self._advance_boxes(detections[j] if detections is not None
                                else None)
            boxes, bvalid = self._active_boxes()
            if self.dynamics is not None and len(self.boxes.boxes):
                boxes = self.boxes.boxes.copy()
                bvalid = np.ones(len(boxes), bool)
            frames.append((g, d, boxes, bvalid, self.frame_id, ts))
            self.frame_id += 1
        sts = self.tracker.step_images_chunk(
            frames, dyn=self._dyn_args(timestamps[0]))
        if self.dynamics is not None:
            # the finalized chunk's verdicts update the streaks now; the
            # frames just dispatched enter the reference queue for later
            # chunks
            for st in sts:
                if st.verdicts is not None and len(self.boxes.boxes):
                    self.dynamics.update_streaks(self.boxes, st.verdicts)
                    self.dynamics.update_box3d(self.boxes, st.box3d,
                                               timestamps[0])
            for fr, _, _ in self.tracker._pending:
                if fr.frame_id >= first_id:
                    self.dynamics.push_fd(fr.timestamp, fr.data)
        return sts

    def _track_common(self, frame: Frame) -> TrackStats:
        """A host-built frame: box classification and reinstatement
        before tracking, the reference queue after it."""
        if self.dynamics is not None:
            self.dynamics.pre_track(frame, self.boxes, self.tracker)
        st = self.tracker.process(frame)
        if self.dynamics is not None and st.state == "OK":
            self.dynamics.post_track(frame, self.boxes, self.tracker)
        self.frame_id += 1
        return st

    @property
    def object_states(self) -> dict:
        """Per-object smoothed 3D state (box track id -> {d, t, R, ext,
        ts}), refreshed on every tracked frame."""
        return {} if self.dynamics is None else self.dynamics.obj_state

    @property
    def trajectory(self):
        """Absolute (timestamp, R_cw, t_cw) per tracked frame, after the
        in-flight frames are finalized."""
        self.tracker.flush()
        return self.tracker.trajectory_poses()

    def save_trajectory_tum(self, path: str):
        traj_io.save_tum(path, self.trajectory)

    def save_trajectory_kitti(self, path: str):
        traj_io.save_kitti(path, self.trajectory)
