"""System facade: the public entry point of the port.

Port of ``slam_dynamic_tpu/system.py:29`` (``System.__init__``, the
online detector :41-53 and the dense map :67-71), ``_ensure_voc`` :75,
``_on_keyframe`` :99, ``_on_reloc`` :125, ``_relocalize`` :152, the box
state (``_maybe_detect`` :164, ``_advance_boxes`` :188,
``_active_boxes`` :197), ``track_rgbd`` :206 (the fused path, the
``mask=`` path, :250-262, and ``prefetch_next`` :218), ``track_stereo``
:250 (with ``prefetch_next`` :257), ``track_chunk`` :271
(depth maps, right images, or None for mono), ``track_mono`` :315,
``_track_common`` :325, ``_dyn_args`` :335, ``_dyn_after`` :377, the
``trajectory`` property and the trajectory writers
(``save_keyframe_trajectory_tum`` :400), the dense map's
``_cache_frame`` :410 and ``_dense_after`` :418, ``object_states`` :443,
``export_object_obbs_ply`` :451, ``save_pcd`` :462, ``save_dense_ply``
:471, ``save_map`` :479, ``load_map`` :490, ``shutdown`` :527, the
localization mode :537-541 and ``reset`` :544. The port's System tracks
and maps RGB-D, stereo and monocular frames (``cfg.sensor``), per frame
or in temporal chunks; on every keyframe it looks for a loop and
verifies and corrects one it finds; a LOST frame is relocalized, and a
relocalization corrects the drift it reveals. With the detector's boxes
(``DetectorConfig.mode`` "precomputed", the library default, or
"online": the port's CenterNet finds them in each frame) it runs the
dynamic-object module: box tracking, the fused H/F reclassification of
the boxes and the per-object 3D state, or with a dynamic-pixel ``mask``
the host-built frame's classification. With ``pointcloud.enabled`` an
RGB-D System keeps a dense map of its keyframes. A map saved by
``save_map`` (either package's) resumes through ``load_map`` in
relocalization. With ``LoopConfig(run_global_ba=True)`` a closed loop (or
a relocalization's drift correction) starts the global BA of
``backend/global_ba.py``, a few GN iterations a tracked frame, merged
into the map when it is done (``_on_keyframe`` :106-112, ``_gba_step``
:114, ``_on_reloc`` :144-149).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .backend import loop_closing, relocalization
from .backend.dense_map import DenseMapper
from .backend.global_ba import AmortizedGBA
from .backend.loop_closing import LoopCloser, LoopResult
from .config import SystemConfig
from .frontend.boxtrack import BoxTrackerState, track_boxes
from .frontend.dynamics import DynamicsModule
from .frontend.frame import Frame, build_frame
from .frontend.tracking import Tracker, TrackStats
from .io import trajectory as traj_io
from .models import vocabulary as voc_mod
from .models.detector import (Detector, default_detector_weights,
                              reshape_boxes_stereo)
from .ops.pointcloud import OBB
from .utils.camera import Intrinsics
from .viz.headless import export_obbs_ply
from .worldmap import checkpoint
from .worldmap import kfdb as kfdb_mod


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
        path = cfg.vocabulary.path
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cam = intrinsics_from_config(cfg, self.device)
        self.tracker = Tracker(cfg, self.cam)
        self.frame_id = 0
        self.boxes = BoxTrackerState.empty()
        self.dynamics = DynamicsModule(cfg, self.device) \
            if cfg.detector.mode != "off" else None
        self._dyn_consts = None
        # the online detector runs in the track entries when no boxes are
        # passed: the configured weights, else the shipped asset
        self.detector = None
        if cfg.detector.mode == "online":
            c, wpath = cfg.camera, (cfg.detector.weights_path
                                    or default_detector_weights())
            self.detector = Detector.from_npz(
                cfg.detector, c.height, c.width, wpath, seed=cfg.seed,
                device=self.device) if wpath else Detector(
                cfg.detector, c.height, c.width, seed=cfg.seed,
                device=self.device)
        # the dense map of the keyframes (RGB-D), fed from the frames
        # cached until their stats are final
        self.dense = None
        self._recent_frames = {}      # frame_id -> (gray, depth, mask)
        self._gba: Optional[AmortizedGBA] = None   # the solve in flight
        if cfg.pointcloud.enabled and cfg.sensor == "rgbd":
            self.dense = DenseMapper(cfg, self.cam)
        # place recognition: the vocabulary is loaded (or trained) at the
        # first keyframe unless a path is configured
        self.voc = None
        self.voc_source = None     # the .npz read, or how it was trained
        self.loop = None
        self.last_loop = None
        self.n_reloc_corrections = 0
        if path:
            # an .npz, as the JAX System reads it (system.py:59-61): any
            # other file raises what np.load raises on it (a DBoW2 text
            # vocabulary goes through vocabulary.load_orbvoc_text first)
            self.voc = voc_mod.load(path, self.device)
            self.voc_source = path
        self._wire(self.tracker)
        if self.device.type == "cuda":
            # the first loop closing or relocalization of a process would
            # otherwise stall tracking for seconds (PERF.md, section 5)
            loop_closing.warm_up(cfg, self.cam)

    def _wire(self, tracker: Tracker):
        tracker.on_keyframe = self._on_keyframe
        tracker.relocalizer = self._relocalize
        tracker.on_reloc = self._on_reloc

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
        if result.closed:
            self._start_gba(m)

    def _start_gba(self, m):
        """A closed loop starts the global BA on the map as it is now
        (when ``run_global_ba`` is on); it replaces one still running."""
        if self.cfg.loop.run_global_ba:
            self._gba = AmortizedGBA(
                m, self.cam, stereo=self.tracker.stereo_obs,
                total_iters=self.cfg.optimizer.global_ba_iters,
                slice_iters=self.cfg.loop.gba_slice_iters,
                scale_factor=self.cfg.orb.scale_factor)

    def _gba_step(self):
        """One slice of the global BA in flight, and its merge into the
        map once it is done (the reference's GBA thread and its merge);
        the merge moves keyframe poses, so the tracker's cached ones are
        dropped."""
        if self._gba is None:
            return
        self._gba.step()
        if self._gba.done:
            self.tracker.map = self._gba.merge(self.tracker.map)
            self.tracker._kf_pose_cache.clear()
            self._gba = None

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
            self._start_gba(m)

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
    def _maybe_detect(self, image: np.ndarray,
                      detections: Optional[np.ndarray],
                      stereo: bool = False) -> Optional[np.ndarray]:
        """The online detector's boxes [D, 4] of ``image`` when no boxes
        were passed (None when it finds none), each grown by
        ``quarantine_pad``; on the stereo entry reshaped as the
        reference's ``rectCenterScale`` does. One readback."""
        if detections is not None or self.detector is None:
            return detections
        det = self.detector.detect(image)
        both = torch.cat([det.boxes, det.valid[:, None].to(torch.float32)],
                         1).cpu().numpy()
        v = both[:, 4] > 0
        if not v.any():
            return None
        boxes = both[v, :4]
        pad = self.cfg.detector.quarantine_pad
        if pad > 0:
            cx = (boxes[:, 0] + boxes[:, 2]) / 2
            cy = (boxes[:, 1] + boxes[:, 3]) / 2
            hw = (boxes[:, 2] - boxes[:, 0]) / 2 * (1 + pad)
            hh = (boxes[:, 3] - boxes[:, 1]) / 2 * (1 + pad)
            boxes = np.stack([cx - hw, cy - hh, cx + hw, cy + hh], 1)
        if stereo:
            boxes = reshape_boxes_stereo(boxes)
        return boxes

    def _advance_boxes(self, detections: Optional[np.ndarray]):
        """Advance the box tracker by one frame's detections [D, 4]
        (None is no detection)."""
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
                   mask: Optional[np.ndarray] = None,
                   prefetch_next: Optional[tuple] = None) -> TrackStats:
        """RGB-D entry (ref System::TrackRGBD): uint8 gray and uint16 (or
        float metres) depth in, one fused device step per tracked frame.
        ``detections`` [D, 4] are this frame's boxes (x0, y0, x1, y1);
        with the dynamic-object module on they are tracked, classified and
        their keypoints quarantined or reinstated in the same step.
        ``mask`` [H, W] (True = dynamic pixel) quarantines the keypoints on
        it; such a frame is built and tracked on the host
        (``_track_common``), its boxes classified before it is tracked.
        Without ``detections`` the online detector, if configured, finds
        them. A keyframe enters the dense map once its stats are final.
        ``prefetch_next``: the NEXT frame's (gray, depth), staged while
        this one runs (``Tracker.prefetch``; pass the same arrays to the
        next call)."""
        detections = self._maybe_detect(gray, detections)
        self._prefetch(prefetch_next)
        if self.dense is not None:
            self._cache_frame(self.frame_id, gray, depth, mask)
        if mask is not None:
            self._advance_boxes(detections)
            boxes, bvalid = self._active_boxes()
            frame = build_frame(self.cfg, self.cam, gray, self.frame_id,
                                timestamp, depth, boxes, bvalid, mask=mask)
            st = self._track_common(frame)
        else:
            st = self._track_fused(gray, depth, timestamp, detections)
        self._dense_after(st)
        return st

    def track_stereo(self, left: np.ndarray, right: np.ndarray,
                     timestamp: float,
                     detections: Optional[np.ndarray] = None,
                     prefetch_next: Optional[tuple] = None) -> TrackStats:
        """Stereo entry (ref System::TrackStereo): rectified uint8 left
        and right images in, one fused device step per tracked frame (two
        extractions and the row-band matcher); ``detections`` and
        ``prefetch_next`` (the next (left, right)) as in ``track_rgbd``
        (the online detector's boxes reshaped for stereo)."""
        detections = self._maybe_detect(left, detections, stereo=True)
        self._prefetch(prefetch_next)
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

    def _prefetch(self, prefetch_next):
        """Stage the next frame while tracking is OK (``system.py``
        :219, :258 of the reference)."""
        if prefetch_next is not None and self.tracker.state == "OK":
            self.tracker.prefetch(*prefetch_next)

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
        self._gba_step()
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
            # the online detector per frame, as the JAX package's chunk
            # runs it (its boxes are not reshaped for stereo there)
            self._advance_boxes(self._maybe_detect(
                g, detections[j] if detections is not None else None))
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
        self._gba_step()
        return sts

    def _track_common(self, frame: Frame) -> TrackStats:
        """A host-built frame: box classification and reinstatement
        before tracking, the reference queue after it."""
        if self.dynamics is not None:
            self.dynamics.pre_track(frame, self.boxes, self.tracker)
        st = self.tracker.process(frame)
        if self.dynamics is not None and st.state == "OK":
            self.dynamics.post_track(frame, self.boxes, self.tracker)
        self._gba_step()
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
        in-flight frames are finalized and a global BA in flight merged."""
        self.shutdown()
        return self.tracker.trajectory_poses()

    def save_trajectory_tum(self, path: str):
        traj_io.save_tum(path, self.trajectory)

    def save_trajectory_kitti(self, path: str):
        traj_io.save_kitti(path, self.trajectory)

    def save_keyframe_trajectory_tum(self, path: str):
        """The keyframes' poses in TUM format (the map as it stands)."""
        m = self.tracker.map
        n = int(m.n_kf)
        ts = m.kf_timestamp.cpu().numpy()
        kf_R, kf_t = m.kf_R.cpu().numpy(), m.kf_t.cpu().numpy()
        valid = m.kf_valid.cpu().numpy()
        traj_io.save_tum(path, [(float(ts[k]), kf_R[k], kf_t[k])
                                for k in range(n) if valid[k]])

    # ------------------------------------------------------------------
    def _cache_frame(self, frame_id: int, gray, depth, mask):
        """Keep the last frames' pixels until their stats are final (a
        keyframe's stats lag by the frames in flight)."""
        self._recent_frames[frame_id] = (gray, depth, mask)
        for k in list(self._recent_frames):
            if k < frame_id - 4:
                del self._recent_frames[k]

    def _dense_after(self, st: TrackStats):
        """A finalized keyframe into the dense map (the reference's
        PointCloudMapping::insertKeyFrame), its boxes confirmed dynamic
        left out of the cloud."""
        if self.dense is None or not st.is_keyframe or st.np_R is None:
            return
        cached = self._recent_frames.get(st.frame_id)
        if cached is None:
            return
        gray, depth, mask = cached
        depth = np.asarray(depth)
        if depth.dtype == np.uint16:
            depth = depth.astype(np.float32) \
                / max(self.cfg.camera.depth_map_factor, 1e-9)
        boxes = box_ids = box_dyn = None
        if len(self.boxes.boxes):
            boxes = self.boxes.boxes
            box_ids = self.boxes.ids
            box_dyn = self.boxes.status == 2
        self.dense.insert_keyframe(
            np.asarray(gray, np.float32), depth, st.np_R, st.np_t,
            dyn_mask=mask, boxes=boxes, box_ids=box_ids,
            box_dynamic=box_dyn)

    def export_object_obbs_ply(self, path: str) -> int:
        """The dynamic objects' boxes as a PLY edge cloud (the reference's
        MapDrawer::DrawDynamics, headless); returns the point count."""
        obbs = {bid: OBB(np.asarray(s["t"]), np.asarray(s["R"]),
                         np.asarray(s["ext"]), True)
                for bid, s in self.object_states.items()}
        return export_obbs_ply(path, obbs)

    def _dense_or_raise(self) -> DenseMapper:
        if self.dense is None:
            raise RuntimeError("pointcloud.enabled is off (or sensor is "
                               "not rgbd); no dense map to save")
        self.tracker.flush()
        return self.dense

    def save_pcd(self, path: str) -> int:
        """The dense cloud as PCD (the reference's System::SavePCD);
        needs ``pointcloud.enabled``. Returns the point count."""
        return self._dense_or_raise().save_pcd(path)

    def save_dense_ply(self, path: str) -> int:
        return self._dense_or_raise().save_ply(path)

    # ------------------------------------------------------------------
    def save_map(self, path: str):
        """The sparse map as an npz checkpoint in the JAX package's format
        (the reference declares SaveMap and never implements it)."""
        self.tracker.flush()
        checkpoint.save_map(path, self.tracker.map)

    def load_map(self, path: str):
        """Resume from a checkpoint (this package's or the JAX package's):
        the tracker has no last frame, so it starts LOST and relocalizes
        against the loaded keyframes on the next frame; the keyframe
        database is rebuilt from their descriptors."""
        m = checkpoint.load_map(path, self.device)
        t = self.tracker
        t.flush()
        t.map = m
        t.n_kf_host = int(m.n_kf)
        t.kf_seq = t.n_kf_host
        t.last_kf_id = t.n_kf_host - 1
        t.last_frame = None
        t._kf_pose_cache.clear()       # poses of the map it replaces
        t.state = "LOST" if t.n_kf_host > 0 else "NOT_INITIALIZED"
        if t.n_kf_host == 0:
            return
        self._ensure_voc()
        db = kfdb_mod.KFDatabase.empty(
            self.cfg.capacity.max_keyframes,
            min(kfdb_mod.TOP_WORDS, self.voc.n_words), device=self.device)
        valid = m.kf_valid.cpu().numpy()
        for k in range(t.n_kf_host):
            if not valid[k]:
                continue
            bv = voc_mod.transform(self.voc, m.kf_kp_desc[k],
                                   m.kf_kp_valid[k])
            db = kfdb_mod.add(db, k,
                              voc_mod.sparse_bow(bv, top_w=db.word.shape[1]))
        self.loop.db = db

    def shutdown(self):
        """Drain the frames in flight and run a global BA in flight to its
        merge (the reference's System::Shutdown joins its threads), and
        end the prefetch worker; the System stays queryable."""
        self.tracker.flush()
        while self._gba is not None:
            self._gba_step()
        self.tracker.close()

    def activate_localization_mode(self):
        """Track only, against the map as it stands (the reference's
        ActivateLocalizationMode)."""
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False

    def reset(self):
        """A fresh tracker and map (the loop closer, box state and dense
        map too); the configuration and vocabulary stay."""
        self.tracker = Tracker(self.cfg, self.cam)
        self._wire(self.tracker)
        if self.loop is not None:
            self.loop = LoopCloser(self.cfg, self.cam, self.voc)
        self.boxes = BoxTrackerState.empty()
        self.frame_id = 0
        self._gba = None
        self._recent_frames = {}
        if self.dense is not None:
            self.dense = DenseMapper(self.cfg, self.cam)
