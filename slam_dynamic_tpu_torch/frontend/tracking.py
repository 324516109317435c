"""The tracking state machine, for every sensor.

Port of ``slam_dynamic_tpu/frontend/tracking.py:131`` (``Tracker``):
``step_images`` :193 with its pipelined branch (:276-307) and its
host-built-frame route in a non-OK state (:202-209),
``step_images_chunk`` :315 (temporal chunking, with the
``chunk_eager_finalize`` and ``chunk_eager_upload_first`` branches; a
non-OK state takes the per-frame route, :329-331, and in-flight frames
are dropped after a LOST finalize, :346-350, :442-451),
``_ChunkPacket`` and ``_PacketRow`` :82-108, ``_finalize_one`` :494,
``_finalize_pending`` :516 and ``flush`` :583 (one ``flush`` here),
``_bookkeep_pipelined`` :547 (``_record_pose``), ``_stage_inputs`` :589
(with ``_zero_aux`` :624 for mono), ``process`` :632, ``_bookkeep`` :644
(with the host velocity), ``_initialize`` :723 (depth sensors) and
``_initialize_mono`` :760 (the two-view bootstrap),
``_relocalize_then_track`` :833 (the ``relocalizer`` and ``on_reloc``
hooks :157-164, and the young-map and ``max_lost_frames`` reset policy
:858-883), ``_predict_pose`` :916, ``_track`` :926 (a host-built frame
through ``fused_track_prebuilt``), ``_post_track`` :975 (with
``_split_dyn_packet`` :507), the keyframe decision
``_need_keyframe_counts`` :1055, ``_create_keyframe`` :1070 and the BoW
fallback (``_bow_recover`` :55, ``_bow_fallback``). The branchy control
stays on the host; per frame the device sees one fused step and the host
reads one packet ([28] floats, [28 + 17 B] with the dynamic-scene ``dyn``
argument; one [C, ...] packet per chunk). The sensor (``cfg.sensor``)
picks the frame's depth: the RGB-D depth map, the stereo matcher on the
right image, or none (mono, which tracks with (u, v) residuals,
``stereo_obs`` False, and makes its landmarks by triangulation).
Keyframe frames add one mapping-stage call and the keyframe hook (loop
closing, wired by the System); a LOST frame calls the relocalizer and,
on success, the drift-correction hook.

Localization-only mode (``localization_only``, the reference's
ActivateLocalizationMode) tracks against a frozen map: no keyframe is
made (:1046), a relocalization corrects no drift (:852) and no loss
resets the map (:866, :878); while the local map yields fewer than
``vo_mode_inliers`` inliers (``vo_mode``, the reference's mbVO) each
tracked frame is also relocalized and the relocalized pose preferred
(:1026-1045), per frame and in a chunk's finalize alike.

Not ported yet: the adaptive pipeline depth.
States: NOT_INITIALIZED -> OK <-> LOST.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..backend.local_mapping import local_ba
from ..backend.mapping_stage import insert_keyframe_stage
from ..backend.relocalization import _match_frame_kf
from ..backend.triangulation import create_new_landmarks
from ..config import SystemConfig
from ..optim.pose_opt import optimize_pose
from ..utils.camera import Intrinsics, undistorted_bounds
from ..worldmap.keyframe_ops import make_keyframe
from ..worldmap.state import (MapState, add_landmarks, empty_map,
                              insert_keyframe, next_kf_slot)
from .frame import Frame, FrameData, build_frame
from .fused import (fused_track_chunk, fused_track_chunk_dyn,
                    fused_track_prebuilt, fused_track_step,
                    fused_track_step_dyn, stereo_residuals)
from .initializer import try_initialize


@dataclasses.dataclass
class TrackStats:
    state: str
    n_inliers_mm: int = 0
    n_inliers_map: int = 0
    is_keyframe: bool = False
    verdicts: object = None   # [B] box verdicts (dynamic scenes)
    box3d: object = None      # [B, 16] per-box 3D state, raw (camera frame)
    frame_id: int = -1
    np_R: object = None       # camera pose (host numpy)
    np_t: object = None


class _ChunkPacket:
    """One readback shared by a chunk's frames (a single frame is a chunk
    of one): the [C, 28] packet is copied to the host on first access
    (counted on ``owner``) and kept for the other rows."""

    def __init__(self, dev: torch.Tensor, owner):
        self.dev = dev
        self.owner = owner
        self._np = None

    def get(self) -> np.ndarray:
        if self._np is None:
            self._np = self.dev.cpu().numpy()
            self.owner.packet_reads += 1
        return self._np


class _PacketRow:
    """A frame's row of its chunk's shared packet."""

    def __init__(self, shared: _ChunkPacket, j: int):
        self._shared = shared
        self._j = j

    def numpy(self) -> np.ndarray:
        return self._shared.get()[self._j]


def _slot_probe(m: MapState) -> np.ndarray:
    """[slot, ok, R_old (9), t_old (3)] of the next keyframe insertion
    (read back only at capacity)."""
    slot, ok = next_kf_slot(m)
    s = slot.long()
    return torch.cat([torch.stack([slot.to(torch.float32),
                                   ok.to(torch.float32)]),
                      m.kf_R[s].reshape(-1), m.kf_t[s]]).cpu().numpy()


def _bow_recover(m: MapState, cam, fd: FrameData, k, R0, t0):
    """TrackReferenceKeyFrame analog: match the frame against the
    reference keyframe's landmark keypoints with no projection gate, then
    re-optimize the pose. Returns (R, t, obs [N], packed [14])."""
    lm = _match_frame_kf(fd.desc, fd.valid & fd.static_mask,
                         m.kf_kp_desc[k], m.kf_kp_valid[k], m.kf_obs_lm[k])
    L = m.lm_pos.shape[0]
    lmc = lm.clamp(0, L - 1).long()
    ok = (lm >= 0) & m.lm_valid[lmc]
    res = optimize_pose(cam, R0, t0, m.lm_pos[lmc], fd.xy,
                        1.0 / (fd.scale ** 2), ok, stereo=False,
                        rounds=4, iters=10)
    inl = res.inliers & ok
    packed = torch.cat([torch.stack([inl.sum().to(torch.float32),
                                     ok.sum().to(torch.float32)]),
                        res.R.reshape(-1), res.t])
    return res.R, res.t, torch.where(inl, lm, -1).to(torch.int32), packed


class Tracker:
    def __init__(self, cfg: SystemConfig, cam: Intrinsics):
        if cfg.tracking.adaptive_pipeline or cfg.tracking.depth_stride != 1:
            raise NotImplementedError(
                "the adaptive pipeline depth and strided depth are not "
                "ported yet")
        self.cfg = cfg
        self.cam = cam
        self.device = cam.fx.device
        self.bounds = undistorted_bounds(cam)
        self.map: MapState = empty_map(cfg.capacity, self.device)
        self.state = "NOT_INITIALIZED"
        self.last_frame: Optional[Frame] = None
        self.last_kf_id = -1
        self.frames_since_kf = 0
        self.last_kf_inliers = 0
        self.n_kf_host = 0        # host mirror of map.n_kf
        self.kf_seq = 0           # monotonic keyframe insertion count
        self.trajectory: List[tuple] = []
        self._traj_by_slot = {}   # kf slot -> trajectory indices
        self._slot_gen = {}       # kf slot -> recycle generation
        # keyframe hook: k -> None, called after keyframe slot k is
        # inserted (loop closing, wired by the System)
        self.on_keyframe: Optional[Callable[[int], None]] = None
        # relocalizer: frame -> (ok, R, t, obs_lm[, cand_slot]) (wired by
        # the System; a 4-tuple is accepted, as the reference does)
        self.relocalizer: Optional[Callable] = None
        # drift-correction hook (k_last_slot, cand_slot) -> None, called on
        # a successful relocalization before tracking resumes, so the
        # corrected local map is what the frame is tracked against
        self.on_reloc: Optional[Callable[[int, int], None]] = None
        # T_cur T_last^-1 of the last two per-frame bookkept frames (host
        # numpy), the motion model of a host-built frame's track
        self.velocity: Optional[Tuple[np.ndarray, np.ndarray]] = None
        # pipelined and chunked modes: (frame, out, dyn) awaiting readback
        self._pending = collections.deque()
        # fused tracking dispatches (one per frame or chunk) and the
        # device-to-host copies of their packets: equal once flushed
        self.dispatches = 0
        self.packet_reads = 0
        self._sf = float(cfg.orb.scale_factor)
        self._kf_pose_cache = {}
        self._dev_consts = None
        self._ref_kf_dev = None
        self._prev2_pose = None
        self._lost_streak = 0
        self._init_ref: Optional[Frame] = None   # mono: the first view
        # mono bootstrap draws: (seed, match mask) -> (idx_h, idx_f)
        # replaces try_initialize's H and F minimal sets (the parity
        # tests feed JAX's)
        self.init_sample_fn: Optional[Callable] = None
        self._zero_aux_cache = None
        # localization-only mode: track against the map, make no keyframe
        self.localization_only = False
        # its VO mode: set after a frame with few local-map inliers; the
        # next frame is also relocalized and the relocalization preferred
        self.vo_mode = False

    @property
    def stereo_obs(self) -> bool:
        """(u, v, u_right) residuals: the depth sensors; mono (u, v)."""
        return stereo_residuals(self.cfg.sensor)

    # ------------------------------------------------------------------
    def _scalar_consts(self):
        if self._dev_consts is None:
            cfg, dev = self.cfg, self.device
            B = cfg.dynamic.max_boxes

            def f32(v):
                return torch.tensor(v, dtype=torch.float32, device=dev)

            self._dev_consts = {
                "bx_empty": torch.full((B, 4), -1.0, device=dev),
                "ba_empty": torch.zeros(B, dtype=torch.bool, device=dev),
                "mm_radius": f32(cfg.tracking.motion_model_radius),
                "local_radius": f32(cfg.tracking.local_map_radius),
                "depth_th": f32(cfg.camera.th_depth
                                * float(self.cam.baseline)),
                "sf": f32(self._sf),
                "min_tr": torch.tensor(cfg.tracking.min_inliers_track,
                                       dtype=torch.int32, device=dev),
                "vel0": f32(0.0), "vel1": f32(1.0),
                "depth_scale": f32(1.0 / max(cfg.camera.depth_map_factor,
                                             1e-9)),
                "kf_redundancy": f32(cfg.mapping.kf_redundancy_ratio),
            }
        return self._dev_consts

    def _stage_inputs(self, gray, aux):
        """Host->device copy of one frame (or a chunk's stack) in
        camera-native dtypes, cast on the device: uint8 gray, the aux as
        it comes (a uint8 right image, float depth), uint16 RGB-D depth
        as its int16 bit view with the depth scale. ``aux`` None (mono)
        passes a cached zero image. Returns (gray, aux, depth_scale)."""
        g = torch.from_numpy(np.ascontiguousarray(gray)).to(self.device)
        if aux is None:
            return g, self._zero_aux(tuple(gray.shape)), None
        aux = np.ascontiguousarray(aux)
        if self.cfg.sensor == "rgbd" and aux.dtype == np.uint16:
            # uint16 travels as its int16 bit view and widens on the device
            d = torch.from_numpy(aux.view(np.int16))
            d = d.to(self.device).to(torch.int32) & 0xFFFF
            return g, d, self._scalar_consts()["depth_scale"]
        return g, torch.from_numpy(aux).to(self.device), None

    def _zero_aux(self, shape):
        z = self._zero_aux_cache
        if z is None or tuple(z.shape) != shape:
            z = self._zero_aux_cache = torch.zeros(shape, device=self.device)
        return z

    def _ref_kf_const(self):
        """Device int64 of the reference-KF index, rebuilt only when it
        changes (a per-frame host copy would stall the queue)."""
        k = max(self.last_kf_id, 0)
        if self._ref_kf_dev is None or self._ref_kf_dev[0] != k:
            self._ref_kf_dev = (k, torch.full((), k, dtype=torch.int64,
                                              device=self.device))
        return self._ref_kf_dev[1]

    # ------------------------------------------------------------------
    def _chain_inputs(self):
        """The device state a dispatch chains on: the last frame's
        landmark ids and pose, and the pose two frames back (or the last
        pose with has_vel 0)."""
        dc = self._scalar_consts()
        R_last, t_last = self.last_frame.R, self.last_frame.t
        if self._prev2_pose is None:
            return (self.last_frame.obs_lm, R_last, t_last, R_last, t_last,
                    dc["vel0"])
        R_prev2, t_prev2 = self._prev2_pose
        return (self.last_frame.obs_lm, R_last, t_last, R_prev2, t_prev2,
                dc["vel1"])

    def _stage_kwargs(self):
        """The tracking stages' arguments (``fused.py:_track_stages``)."""
        cfg, dc = self.cfg, self._scalar_consts()
        return dict(
            mm_radius=dc["mm_radius"], local_radius=dc["local_radius"],
            depth_th=dc["depth_th"], scale_factor=dc["sf"],
            min_inliers_track=dc["min_tr"],
            max_kf=cfg.capacity.local_ba_keyframes,
            max_lm=cfg.capacity.local_ba_landmarks, n_levels=cfg.orb.n_levels,
            sensor=cfg.sensor)

    def _track_kwargs(self):
        """The fused steps' arguments: the stages' and the frame build's."""
        return dict(orb_cfg=self.cfg.orb,
                    n_slots=self.cfg.capacity.max_keypoints,
                    **self._stage_kwargs())

    def _ref_at_dispatch(self):
        """(reference keyframe slot, its recycle generation) as the fused
        step sees them: its packet carries that slot's pose."""
        ref_k = max(self.last_kf_id, 0)
        return ref_k, self._slot_gen.get(ref_k, 0)

    @staticmethod
    def _new_frame(out, frame_id: int, timestamp: float, ref) -> Frame:
        return Frame(data=out.fd, frame_id=frame_id, timestamp=timestamp,
                     ref_kf=ref[0], ref_gen=ref[1])

    def _upload_boxes(self, boxes, box_active, C=None):
        """Boxes [B, 4] and their active flags [B] (or C frames' of them)
        on the device in one copy; the cached empty set when no frame has
        a box."""
        B = self.cfg.dynamic.max_boxes
        per = [(boxes, box_active)] if C is None else list(
            zip(boxes, box_active))
        if not any(bx is not None and len(bx) for bx, _ in per):
            dc = self._scalar_consts()
            if C is None:
                return dc["bx_empty"], dc["ba_empty"]
            return self._chunk_empty_boxes(C)
        pk = np.full((len(per), B, 5), -1.0, np.float32)
        pk[:, :, 4] = 0.0
        for j, (bx, ba) in enumerate(per):
            if bx is None or not len(bx):
                continue
            nb = min(len(bx), B)
            pk[j, :nb, :4] = bx[:nb]
            pk[j, :nb, 4] = (ba[:nb] if ba is not None else np.ones(nb))
        arr = torch.from_numpy(pk if C is not None else pk[0]).to(
            self.device)
        return arr[..., :4], arr[..., 4] > 0

    def step_images(self, gray: np.ndarray, aux: Optional[np.ndarray],
                    frame_id: int, timestamp: float, boxes=None,
                    box_active=None, dyn: Optional[dict] = None
                    ) -> TrackStats:
        """Raw images in, one fused device step, one packed readback.
        ``aux`` is the depth map (RGB-D), the right image (stereo) or None
        (mono). Only valid while tracking is OK; other states build the
        frame on the host (initialization, LOST). With ``pipeline_depth``
        > 0 the frame's readback waits until that many newer frames were
        dispatched, and the stats returned are the oldest frame's.
        ``boxes`` [B, 4] with ``box_active`` [B] quarantine keypoints;
        ``dyn`` {ref_fd, have_ref, box_status, seed, classify} switches to
        the dynamic-scene step (verdicts and per-box 3D state come back in
        ``TrackStats.verdicts`` / ``box3d``)."""
        if self.state != "OK":
            # finalize the frames in flight (one may recover tracking),
            # then track this frame built on the host
            self.flush()
            sensor = self.cfg.sensor
            return self.process(build_frame(
                self.cfg, self.cam, gray, frame_id, timestamp,
                depth_map=aux if sensor == "rgbd" else None,
                right=aux if sensor == "stereo" else None, boxes=boxes,
                box_valid=box_active))
        chain = self._chain_inputs()
        g_arr, d_arr, depth_scale = self._stage_inputs(gray, aux)
        bx, ba = self._upload_boxes(boxes, box_active)
        if dyn is None:
            out = fused_track_step(
                self.map, self.cam, self.bounds, g_arr, d_arr, bx, ba,
                *chain, self._ref_kf_const(), depth_scale=depth_scale,
                **self._track_kwargs())
        else:
            out = fused_track_step_dyn(
                self.map, self.cam, self.bounds, g_arr, d_arr, bx, ba,
                dyn["box_status"], dyn["ref_fd"], dyn["have_ref"], *chain,
                self._ref_kf_const(), seed=dyn["seed"],
                n_hyp=self.cfg.dynamic.ransac_hypotheses,
                depth_scale=depth_scale, classify=dyn.get("classify", True),
                **self._track_kwargs())
        self.dispatches += 1
        out = out._replace(packed=_PacketRow(
            _ChunkPacket(out.packed[None], self), 0))
        self._prev2_pose = chain[1:3]
        frame = self._new_frame(out, frame_id, timestamp,
                                self._ref_at_dispatch())
        depth_n = self.cfg.tracking.pipeline_depth
        if depth_n > 0:
            # finalize the oldest in-flight frame(s) while this one runs:
            # decisions lag depth_n frames
            frame.R, frame.t, frame.obs_lm = out.R, out.t, out.obs_lm
            st_prev = None
            while len(self._pending) >= depth_n:
                st_prev = self._finalize_one()
            self._pending.append((frame, out, dyn is not None))
            self.last_frame = frame
            return st_prev if st_prev is not None else TrackStats("OK")
        st = self._post_track(frame, out, dyn is not None)
        self._bookkeep(frame)
        return st

    def step_images_chunk(self, frames, dyn: Optional[dict] = None
                          ) -> List[TrackStats]:
        """Temporal chunking: C consecutive frames in one fused call and
        one [C, 28] packet readback. ``frames``: list of (gray, aux,
        boxes, box_active, frame_id, timestamp), aux as ``step_images``
        takes it. Frames chain on the
        device; the map snapshot is fixed for the chunk, so keyframe and
        LOST decisions lag. ``dyn`` {ref_fd, have_ref, box_status, seed}
        switches to the dynamic-scene chunk (classification on every
        ``classify_every_chunked``-th frame, a [C, 28 + 17 B] packet).
        Returns the stats of the frames finalized in this call: with
        ``pipeline_depth`` > 0 the previous chunk's, finalized while this
        one runs; with ``chunk_eager_finalize`` the previous chunk's,
        before this one is dispatched; else this chunk's."""
        if self.state != "OK" or len(frames) == 1:
            return [self.step_images(g, d, fid, ts, bx, ba, dyn=dyn)
                    for g, d, bx, ba, fid, ts in frames]
        cfg = self.cfg
        sts = []
        eager = cfg.tracking.chunk_eager_finalize
        upload_first = eager and cfg.tracking.chunk_eager_upload_first

        def finalize_all():
            # False when a finalized frame went LOST: the frames chained
            # after it on the device are dropped
            while self._pending:
                sts.append(self._finalize_one())
                if self.state != "OK":
                    self._pending.clear()
                    return False
            return True

        if eager and not upload_first and not finalize_all():
            return sts
        C = len(frames)
        g_arr, d_arr, depth_scale = self._stage_inputs(
            np.stack([f[0] for f in frames]),
            None if frames[0][1] is None else np.stack([f[1] for f in frames]))
        bx, ba = self._upload_boxes([f[2] for f in frames],
                                    [f[3] for f in frames], C)
        if upload_first and not finalize_all():
            # the images went up first; the map and chain are read after
            # the finalize, as in plain eager mode
            return sts
        chain = self._chain_inputs()
        ref = self._ref_at_dispatch()
        if dyn is None:
            outs, packed_dev = fused_track_chunk(
                self.map, self.cam, self.bounds, g_arr, d_arr, bx, ba,
                *chain, self._ref_kf_const(), depth_scale=depth_scale,
                **self._track_kwargs())
        else:
            outs, packed_dev = fused_track_chunk_dyn(
                self.map, self.cam, self.bounds, g_arr, d_arr, bx, ba,
                dyn["box_status"], dyn["ref_fd"], dyn["have_ref"], *chain,
                self._ref_kf_const(), seed=dyn["seed"],
                n_hyp=cfg.dynamic.ransac_hypotheses,
                classify_every=cfg.dynamic.classify_every_chunked,
                depth_scale=depth_scale, **self._track_kwargs())
        self.dispatches += 1
        if not finalize_all():       # overlapped: the previous chunk
            return sts
        shared = _ChunkPacket(packed_dev, self)
        for j, (_, _, _, _, fid, ts) in enumerate(frames):
            out = outs[j]._replace(packed=_PacketRow(shared, j))
            fr = self._new_frame(out, fid, ts, ref)
            fr.R, fr.t, fr.obs_lm = out.R, out.t, out.obs_lm
            self._pending.append((fr, out, dyn is not None))
        self._prev2_pose = (outs[-2].R, outs[-2].t)
        self.last_frame = self._pending[-1][0]
        if cfg.tracking.pipeline_depth == 0:
            finalize_all()
        return sts

    def _chunk_empty_boxes(self, C: int):
        dc = self._scalar_consts()
        key = ("chunk_empty_boxes", C)
        if key not in dc:
            B = self.cfg.dynamic.max_boxes
            dc[key] = (torch.full((C, B, 4), -1.0, device=self.device),
                       torch.zeros((C, B), dtype=torch.bool,
                                   device=self.device))
        return dc[key]

    def _finalize_one(self) -> TrackStats:
        """Read back and bookkeep the oldest in-flight frame."""
        frame, out, was_dyn = self._pending.popleft()
        saved_last = self.last_frame
        st = self._post_track(frame, out, was_dyn)
        # the frame dispatched last stays the one the next dispatch
        # chains on
        self._record_pose(frame)
        self.last_frame = saved_last
        return st

    def flush(self) -> List[TrackStats]:
        """Drain the in-flight frames (before reading the trajectory or
        switching modes; the reference's ``_finalize_pending`` and
        ``flush``); returns their stats, oldest first."""
        sts = []
        while self._pending:
            sts.append(self._finalize_one())
        return sts

    # ------------------------------------------------------------------
    def process(self, frame: Frame) -> TrackStats:
        """A frame built on the host: initialization, tracking (OK) or
        relocalization (LOST), then the per-frame bookkeeping."""
        if self.state == "NOT_INITIALIZED":
            st = self._initialize(frame)
        elif self.state == "OK":
            st = self._track(frame)
        else:
            st = self._relocalize_then_track(frame)
        self._bookkeep(frame)
        return st

    def _bookkeep(self, frame: Frame):
        """The per-frame bookkeeping: trajectory entry and host velocity
        (the pose comes from the packet, no extra device read)."""
        if frame.R is not None:
            self._record_pose(frame)
            last = self.last_frame
            if last is not None and last.R is not None:
                Rl = last.np_R if last.np_R is not None \
                    else last.R.cpu().numpy()
                tl = last.np_t if last.np_t is not None \
                    else last.t.cpu().numpy()
                Rv = frame.np_R @ Rl.T
                self.velocity = (Rv, frame.np_t - Rv @ tl)
        self.last_frame = frame

    def _record_pose(self, frame: Frame):
        """Trajectory bookkeeping on the host. Poses are stored relative
        to the reference keyframe so later map corrections reach the
        exported trajectory; a frame whose reference slot was recycled
        while it was in flight is stored absolute."""
        if frame.R is None:
            return
        R = frame.np_R if frame.np_R is not None else frame.R.cpu().numpy()
        t = frame.np_t if frame.np_t is not None else frame.t.cpu().numpy()
        if self._ref_slot_recycled(frame):
            self.trajectory.append((frame.timestamp, -1, R, t))
        else:
            k, Rk, tk = self._ref_kf_pose(frame)
            R_rel = R @ Rk.T
            self._traj_by_slot.setdefault(k, []).append(len(self.trajectory))
            self.trajectory.append((frame.timestamp, k, R_rel,
                                    t - R_rel @ tk))
        frame.np_R, frame.np_t = R, t

    def _ref_slot_recycled(self, frame: Frame) -> bool:
        return (frame.ref_kf >= 0 and
                self._slot_gen.get(frame.ref_kf, 0) != frame.ref_gen)

    def _ref_kf_pose(self, frame: Frame):
        """(k, R_k, t_k) of the reference keyframe: from the frame's packet
        when it has one, else a cached map read."""
        if frame.np_Rk is not None and frame.ref_kf >= 0:
            return frame.ref_kf, frame.np_Rk, frame.np_tk
        k = max(self.last_kf_id, 0)
        Rk, tk = self._kf_pose_np(k)
        return k, Rk, tk

    def _kf_pose_np(self, k: int):
        cached = self._kf_pose_cache.get(k)
        if cached is None:
            cached = (self.map.kf_R[k].cpu().numpy(),
                      self.map.kf_t[k].cpu().numpy())
            self._kf_pose_cache[k] = cached
        return cached

    def trajectory_poses(self) -> List[Tuple[float, np.ndarray, np.ndarray]]:
        """Absolute (Tcw) per-frame trajectory composed against the current
        keyframe poses."""
        kf_R = self.map.kf_R.cpu().numpy()
        kf_t = self.map.kf_t.cpu().numpy()
        out = []
        for ts, k, R_rel, t_rel in self.trajectory:
            if k < 0:
                out.append((ts, R_rel, t_rel))
            else:
                out.append((ts, R_rel @ kf_R[k], R_rel @ kf_t[k] + t_rel))
        return out

    def _materialize_slot_trajectory(self, k: int, old_R, old_t):
        """Turn trajectory entries relative to slot k absolute, with the
        old tenant's pose, before the slot is recycled."""
        for idx in self._traj_by_slot.pop(k, []):
            ts, kk, R_rel, t_rel = self.trajectory[idx]
            if kk == k:
                self.trajectory[idx] = (ts, -1, R_rel @ old_R,
                                        R_rel @ old_t + t_rel)

    # ------------------------------------------------------------------
    def _initialize(self, frame: Frame) -> TrackStats:
        """StereoInitialization: >= 300 features with depth; first keyframe
        at identity with landmarks from all depth-valid keypoints. Mono
        takes the two-view bootstrap."""
        if self.cfg.sensor == "mono":
            return self._initialize_mono(frame)
        d = frame.data
        n = int((d.valid & d.static_mask & (d.depth > 0)).sum())
        if n < 300:
            return TrackStats("NOT_INITIALIZED")
        dev = self.device
        R0 = torch.eye(3, device=dev)
        t0 = torch.zeros(3, device=dev)
        frame.R, frame.t = R0, t0
        no_obs = torch.full((d.xy.shape[0],), -1, dtype=torch.int32,
                            device=dev)
        depth_th = float(self.cfg.camera.th_depth * self.cam.baseline)
        sf = torch.tensor(self._sf, dtype=torch.float32, device=dev)
        self.map, _ = make_keyframe(
            self.map, self.cam, d, R0, t0, frame.frame_id, frame.timestamp,
            no_obs, depth_th, sf, n_levels=self.cfg.orb.n_levels)
        self.n_kf_host += 1
        self.kf_seq += 1
        k = self.n_kf_host - 1
        frame.obs_lm = self.map.kf_obs_lm[k]
        self.state = "OK"
        self.last_kf_id = k
        self.frames_since_kf = 0
        self.last_kf_inliers = n
        if self.on_keyframe:
            self.on_keyframe(k)
        return TrackStats("OK", is_keyframe=True, frame_id=frame.frame_id,
                          np_R=np.eye(3, dtype=np.float32),
                          np_t=np.zeros(3, np.float32))

    def _initialize_mono(self, frame: Frame) -> TrackStats:
        """MonocularInitialization: hold a reference frame with >= 100
        features, then try the two-view bootstrap against each later
        frame; too few matches restart from the current frame. On success
        keyframe 0 is the reference at identity, keyframe 1 the current
        frame, the good points become landmarks at the reference's slots,
        bound at their matched slots in keyframe 1, and a BA over the two
        views refines them (the reference's initial global BA)."""
        cfg = self.cfg
        d = frame.data
        if int((d.valid & d.static_mask).sum()) < 100:
            self._init_ref = None
            return TrackStats("NOT_INITIALIZED")
        ref = self._init_ref
        if ref is None:
            self._init_ref = frame
            return TrackStats("NOT_INITIALIZED")
        min_m = min(cfg.tracking.mono_init_min_matches,
                    max(cfg.orb.n_features // 8, 40))
        seed = cfg.seed + frame.frame_id
        sample_fn = None if self.init_sample_fn is None else \
            functools.partial(self.init_sample_fn, seed)
        init = try_initialize(self.cam, ref.data, d, seed=seed,
                              min_matches=min_m, sample_fn=sample_fn)
        n_matches, ok = (int(v) for v in torch.stack(
            [init.n_matches.to(torch.int64),
             init.ok.to(torch.int64)]).cpu())
        if n_matches < min_m:
            self._init_ref = frame        # restart from this frame
            return TrackStats("NOT_INITIALIZED")
        if not ok:
            return TrackStats("NOT_INITIALIZED")
        dev = self.device
        N = d.xy.shape[0]
        no_obs = torch.full((N,), -1, dtype=torch.int32, device=dev)
        r = ref.data
        m = insert_keyframe(self.map, torch.eye(3, device=dev),
                            torch.zeros(3, device=dev), ref.frame_id,
                            ref.timestamp, r.xy, r.level, r.angle, r.desc,
                            r.valid & r.static_mask, r.ur, r.depth, no_obs)
        dist = torch.linalg.norm(init.points, dim=-1)
        normal = init.points / torch.clamp(dist, min=1e-9)[:, None]
        dmax = dist * self._sf ** r.level.to(torch.float32)
        dmin = dmax / (self._sf ** (cfg.orb.n_levels - 1))
        slots = torch.arange(N, dtype=torch.int32, device=dev)
        m = add_landmarks(m, init.points, r.desc, normal, dmin, dmax,
                          torch.zeros_like(slots), slots, init.good)
        new_ids = m.kf_obs_lm[0]
        # keyframe 1 observes them at the matched slots; masked writes go
        # to an extra slot past the end, so no write can clobber slot 0
        wr = init.good & (new_ids >= 0)
        obs1 = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
        obs1[torch.where(wr, init.idx2, N)] = new_ids
        m = insert_keyframe(m, init.R2, init.t2, frame.frame_id,
                            frame.timestamp, d.xy, d.level, d.angle, d.desc,
                            d.valid & d.static_mask, d.ur, d.depth,
                            obs1[:N])
        self.map = local_ba(
            m, self.cam, torch.tensor(1, device=dev),
            torch.tensor(self._sf, dtype=torch.float32, device=dev),
            stereo=False, max_kf=4,
            max_lm=cfg.capacity.local_ba_landmarks)
        frame.R, frame.t = self.map.kf_R[1], self.map.kf_t[1]
        frame.obs_lm = self.map.kf_obs_lm[1]
        self.state = "OK"
        self.n_kf_host = self.kf_seq = 2
        self.last_kf_id = 1
        self.frames_since_kf = 0
        self.last_kf_inliers = int((frame.obs_lm >= 0).sum())
        self._init_ref = None
        if self.on_keyframe:
            self.on_keyframe(0)
            self.on_keyframe(1)
        return TrackStats("OK", is_keyframe=True, frame_id=frame.frame_id,
                          np_R=frame.R.cpu().numpy(),
                          np_t=frame.t.cpu().numpy())

    def _relocalize_then_track(self, frame: Frame) -> TrackStats:
        """A frame while LOST: relocalize it; on success call the
        drift-correction hook (last keyframe before the loss, matched
        keyframe) and track the frame against the corrected local map.
        Otherwise the reset policy: a young map (<= 5 keyframes) is
        rebuilt from a frame with enough features, a loss of
        ``max_lost_frames`` frames resets the map; a near-featureless
        frame never resets."""
        if self.relocalizer is not None:
            ok, R, t, obs, cand = self.relocalizer(frame)
            if ok:
                frame.R, frame.t = R, t
                frame.obs_lm = obs
                self.velocity = None
                self._lost_streak = 0
                if self.on_reloc is not None and cand >= 0 \
                        and self.last_kf_id >= 0 \
                        and not self.localization_only:
                    self.on_reloc(self.last_kf_id, cand)
                self.last_frame = frame
                self.state = "OK"
                return self._track(frame)
        # a frozen map (localization-only mode) is never reset
        n_feat = int(frame.data.valid.sum())
        resettable = n_feat >= 50 and not self.localization_only
        if self.n_kf_host <= 5 and resettable:
            self.reset()
            return TrackStats("NOT_INITIALIZED")
        self._lost_streak += 1
        max_lost = self.cfg.tracking.max_lost_frames
        if max_lost > 0 and self._lost_streak >= max_lost and resettable:
            self.reset()
            return TrackStats("NOT_INITIALIZED")
        frame.R, frame.t = None, None
        frame.obs_lm = torch.full((frame.data.xy.shape[0],), -1,
                                  dtype=torch.int32, device=self.device)
        return TrackStats("LOST")

    def _predict_pose(self):
        """The constant-velocity prediction from the last frame's pose, on
        the host."""
        lf = self.last_frame
        Rl = lf.np_R if lf.np_R is not None else lf.R.cpu().numpy()
        tl = lf.np_t if lf.np_t is not None else lf.t.cpu().numpy()
        if self.velocity is None:
            return Rl, tl
        Rv, tv = self.velocity
        return Rv @ Rl, Rv @ tl + tv

    def _track(self, frame: Frame) -> TrackStats:
        """Track a host-built frame: the tracking stages of the fused step
        (``fused_track_prebuilt``), one packet readback."""
        dev = self.device
        R_pred, t_pred = self._predict_pose()
        lf = self.last_frame
        last_ids = lf.obs_lm if lf.obs_lm is not None else torch.full(
            (frame.data.xy.shape[0],), -1, dtype=torch.int32, device=dev)
        frame.ref_kf, frame.ref_gen = self._ref_at_dispatch()

        def up(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
        out = fused_track_prebuilt(
            self.map, self.cam, self.bounds, frame.data, last_ids,
            up(R_pred), up(t_pred), lf.R, lf.t, self._ref_kf_const(),
            **self._stage_kwargs())
        self.dispatches += 1
        out = out._replace(packed=_PacketRow(
            _ChunkPacket(out.packed[None], self), 0))
        return self._post_track(frame, out)

    def reset(self):
        """Clear map and state; the tracked trajectory is kept as absolute
        poses and the next segment starts a new gauge."""
        kept = [(ts, -1, R, t) for ts, R, t in self.trajectory_poses()]
        self.map = empty_map(self.cfg.capacity, self.device)
        self.state = "NOT_INITIALIZED"
        self.last_frame = None
        self.trajectory = kept
        self._traj_by_slot = {}
        self._slot_gen = {}
        self.last_kf_id = -1
        self.frames_since_kf = 0
        self.last_kf_inliers = 0
        self._kf_pose_cache = {}
        self._ref_kf_dev = None
        self._prev2_pose = None
        self.velocity = None
        self.n_kf_host = 0
        self.kf_seq = 0
        self._lost_streak = 0
        self._init_ref = None
        self._pending.clear()

    # ------------------------------------------------------------------
    def _bow_fallback(self, frame: Frame, np_R, np_t):
        """TrackReferenceKeyFrame recovery before declaring LOST; returns
        (n_inliers, frame) on success, None to go LOST."""
        cfg = self.cfg
        if not cfg.tracking.bow_fallback or self.last_kf_id < 0:
            return None
        dev = self.device
        R, t, obs, packed = _bow_recover(
            self.map, self.cam, frame.data,
            torch.tensor(self.last_kf_id, device=dev),
            torch.from_numpy(np.asarray(np_R, np.float32)).to(dev),
            torch.from_numpy(np.asarray(np_t, np.float32)).to(dev))
        pk = packed.cpu().numpy()
        n_good = int(pk[0])
        if n_good < cfg.tracking.min_inliers_localmap:
            return None
        frame.R, frame.t = R, t
        frame.np_R = pk[2:11].reshape(3, 3)
        frame.np_t = pk[11:14]
        frame.obs_lm = obs
        return n_good, frame

    def _post_track(self, frame: Frame, out, dyn: bool = False
                    ) -> TrackStats:
        """Bookkeep a dispatched frame from its packet. With ``dyn`` the
        packet carries the dynamic step's tail, [28:28+B] verdicts and
        [28+B:28+17B] the per-box 3D state, which go into the stats
        (``_split_dyn_packet`` :507)."""
        cfg = self.cfg
        packed = out.packed.numpy()      # the frame's or chunk's readback
        tail = {}
        if dyn:
            B = cfg.dynamic.max_boxes
            tail = dict(verdicts=packed[28:28 + B].astype(np.int32),
                        box3d=packed[28 + B:28 + 17 * B].reshape(B, 16))
        n_mm, n_map = int(packed[0]), int(packed[1])
        close_bound, close_unbound = int(packed[2]), int(packed[3])
        np_R = packed[4:13].reshape(3, 3)
        np_t = packed[13:16]
        if frame.ref_kf >= 0:
            frame.np_Rk = packed[16:25].reshape(3, 3)
            frame.np_tk = packed[25:28]
        self.map = self.map._replace(lm_visible=out.lm_visible,
                                     lm_found=out.lm_found)
        if n_mm < cfg.tracking.min_inliers_track or \
                n_map < cfg.tracking.min_inliers_localmap:
            rec = self._bow_fallback(frame, np_R, np_t)
            if rec is None:
                self.state = "LOST"
                frame.R, frame.t = out.R, out.t
                frame.np_R, frame.np_t = np_R, np_t
                frame.obs_lm = out.obs_lm
                return TrackStats("LOST", n_inliers_mm=n_mm,
                                  n_inliers_map=n_map,
                                  frame_id=frame.frame_id, **tail)
            n_good, frame = rec
            self.state = "OK"
            self.frames_since_kf += 1
            self._prev2_pose = None        # velocity invalid after a jump
            return TrackStats("OK", n_inliers_mm=n_mm, n_inliers_map=n_good,
                              frame_id=frame.frame_id, np_R=frame.np_R,
                              np_t=frame.np_t, **tail)
        frame.R, frame.t = out.R, out.t
        frame.np_R, frame.np_t = np_R, np_t
        frame.obs_lm = out.obs_lm
        self.state = "OK"
        self.frames_since_kf += 1
        self._lost_streak = 0
        st = TrackStats("OK", n_inliers_mm=n_mm, n_inliers_map=n_map,
                        frame_id=frame.frame_id, np_R=np_R, np_t=np_t,
                        **tail)
        if self.localization_only:
            self._vo_arbitrate(frame, st, n_map)
        elif self._need_keyframe_counts(n_map, close_bound, close_unbound):
            before = self.kf_seq
            self._create_keyframe(frame, n_map)
            st.is_keyframe = self.kf_seq > before
        return st

    def _vo_arbitrate(self, frame: Frame, st: TrackStats, n_map: int):
        """Localization-only mode's two hypotheses (the reference's mbVO):
        in VO mode the frame is also relocalized against the frozen map
        (no drift correction) and a relocalized pose replaces the
        tracked one; VO mode holds while the local map yields fewer than
        ``vo_mode_inliers`` inliers and no relocalization succeeded."""
        relocated = False
        if self.vo_mode and self.relocalizer is not None:
            ok, R, t, obs = self.relocalizer(frame)[:4]
            if ok:
                frame.R, frame.t = R, t
                frame.np_R = R.cpu().numpy()
                frame.np_t = t.cpu().numpy()
                if obs is not None:
                    frame.obs_lm = obs
                st.np_R, st.np_t = frame.np_R, frame.np_t
                self._prev2_pose = None     # the velocity is void now
                relocated = True
        self.vo_mode = (not relocated and
                        n_map < self.cfg.tracking.vo_mode_inliers)

    def _need_keyframe_counts(self, n_map: int, close_bound: int,
                              close_unbound: int) -> bool:
        """NeedNewKeyFrame, depth-sensor form: insert when tracking weakens
        against the reference KF or many close points are unbound."""
        cfg = self.cfg
        if self.frames_since_kf < cfg.tracking.min_frames_between_kf + 1:
            return False
        if self.frames_since_kf >= cfg.tracking.max_frames_between_kf:
            return True
        weak = n_map < 0.75 * max(self.last_kf_inliers, 1)
        return bool(weak or (close_bound < 100 and close_unbound > 70))

    def _create_keyframe(self, frame: Frame, n_map: int):
        cfg = self.cfg
        if self.n_kf_host >= cfg.capacity.max_keyframes:
            # at capacity: recycle a culled slot, else force-evict the
            # keyframe least covisible with the current one
            probe = _slot_probe(self.map)
            if probe[1] == 0:
                from ..backend.fusion import evict_if_full
                self.map = evict_if_full(self.map, self._ref_kf_const())
                probe = _slot_probe(self.map)
                if probe[1] == 0:
                    return
            k = int(probe[0])
            self._materialize_slot_trajectory(
                k, probe[2:11].reshape(3, 3), probe[11:14])
            self._kf_pose_cache.pop(k, None)
            self._slot_gen[k] = self._slot_gen.get(k, 0) + 1
        else:
            self.n_kf_host += 1
            k = self.n_kf_host - 1
        self.kf_seq += 1
        dc = self._scalar_consts()
        dev = self.device
        self.map, _ = insert_keyframe_stage(
            self.map, self.cam, frame.data, frame.R, frame.t,
            torch.tensor(frame.frame_id, dtype=torch.int32, device=dev),
            torch.tensor(frame.timestamp, dtype=torch.float32, device=dev),
            frame.obs_lm, dc["depth_th"], dc["sf"], dc["kf_redundancy"],
            n_levels=cfg.orb.n_levels, stereo=self.stereo_obs,
            max_kf=cfg.capacity.local_ba_keyframes,
            max_lm=cfg.capacity.local_ba_landmarks,
            do_ba=(self.kf_seq >= 3),
            do_refresh=((self.kf_seq - 1) % 4 == 3),
            tri_neighbors=(cfg.mapping.stereo_tri_neighbors
                           if self.stereo_obs else 0))
        if not self.stereo_obs:
            # mono: new landmarks come from triangulation, not depth
            self.map = create_new_landmarks(self.map, self.cam, k, self._sf,
                                            n_levels=cfg.orb.n_levels)
        frame.obs_lm = self.map.kf_obs_lm[k]
        self.last_kf_id = k
        self.frames_since_kf = 0
        self.last_kf_inliers = n_map
        if self.on_keyframe:
            self.on_keyframe(k)
        self._kf_pose_cache.clear()
