"""System facade: the public entry point of the port.

Port of ``slam_dynamic_tpu/system.py:29`` (``System.__init__``),
``_ensure_voc`` :75, ``_on_keyframe`` :99, ``track_rgbd`` :206 through its
fused-path branch (:219-239), ``track_chunk`` :271 for a static scene, the
``trajectory`` property and the trajectory writers. The port's System
tracks and maps RGB-D frames, per frame or in temporal chunks, and runs
loop detection on every keyframe. Not ported yet: the Sim3 verification
and correction of a detected loop (a candidate raises), relocalization
(a LOST frame waits for the reset policy), the dynamic-object module,
detectors and dense mapping.
"""
from __future__ import annotations

import os

import numpy as np

from . import resolve_device
from .backend.loop_closing import LoopCloser, LoopResult
from .config import SystemConfig
from .frontend.tracking import Tracker, TrackStats
from .io import trajectory as traj_io
from .models import vocabulary as voc_mod
from .utils.camera import Intrinsics


def intrinsics_from_config(cfg: SystemConfig, device=None) -> Intrinsics:
    c = cfg.camera
    return Intrinsics.create(c.fx, c.fy, c.cx, c.cy, c.k1, c.k2, c.p1, c.p2,
                             c.k3, c.bf, c.width, c.height, device=device)


class System:
    """``System(cfg).track_rgbd(gray_u8, depth_u16, t)`` or
    ``.track_chunk(grays, depths, ts)`` on the card by default;
    ``device="cpu"`` runs the plain PyTorch path on the CPU."""

    def __init__(self, cfg: SystemConfig, device=None):
        if cfg.sensor != "rgbd":
            raise NotImplementedError(
                f"sensor {cfg.sensor!r}: only RGB-D is ported yet")
        if cfg.detector.mode != "off":
            raise NotImplementedError(
                "the dynamic-object module is not ported yet; use "
                "DetectorConfig(mode='off')")
        if cfg.loop.run_global_ba:
            raise NotImplementedError(
                "the post-loop global BA is not ported yet; use "
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
        # place recognition: the vocabulary is loaded (or trained) at the
        # first keyframe unless a path is configured
        self.voc = None
        self.voc_source = None     # the .npz read, or how it was trained
        self.loop = None
        self.last_loop = None
        if path:
            self.voc = voc_mod.load(path, self.device)
            self.voc_source = path
        self.tracker.on_keyframe = self._on_keyframe

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
        m, result = self.loop.on_keyframe(self.tracker.map, k, True,
                                          seq=self.tracker.kf_seq)
        self.tracker.map = m
        self.last_loop: LoopResult = result

    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray,
                   timestamp: float) -> TrackStats:
        """RGB-D entry (ref System::TrackRGBD): uint8 gray and uint16 (or
        float metres) depth in, one fused device step per tracked frame.
        (The reference's ``detections``/``mask`` arguments need the
        dynamic-object module, not ported yet.)"""
        st = self.tracker.step_images(gray, depth, self.frame_id, timestamp)
        self.frame_id += 1
        return st

    def track_chunk(self, grays, depths, timestamps) -> list:
        """Temporal chunking: C consecutive RGB-D frames in one fused call
        and one packed readback (``Tracker.step_images_chunk``). Returns
        the stats of the frames finalized in this call; decisions lag up
        to a chunk."""
        frames = []
        for g, d, ts in zip(grays, depths, timestamps):
            frames.append((g, d, self.frame_id, ts))
            self.frame_id += 1
        return self.tracker.step_images_chunk(frames)

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
