"""The bench world of the port: the synthetic 640x480 RGB-D sequence and
the config ``bench.py`` runs by default (1000 ORB features and the
capacities of ``bench.py:250-261``), in camera-native dtypes; with
``sensor="stereo"`` the stereo pair of ``bench.py --stereo`` (:111-113,
:236-261: uint8 right images, ``bf = fx * baseline``); with
``sensor="mono"`` the images alone, the camera moving as in
``tests/test_e2e_slam.py``'s mono test (0.04 m a frame forward, a 0.5 m
sway: the two-view bootstrap needs the baseline); with
``dynamic`` the moving-object world and precomputed boxes of
``bench.py --dynamic`` (:228-229, :257); with ``trajectory="orbit"`` the
closed circuit of the loop-closure tests (``io/synthetic.py``).
"""
from __future__ import annotations

import numpy as np

from .. import config as C
from .synthetic import SynthConfig, generate


# bench.py:228-229: the moving object of ``--dynamic``
DYNAMIC_OBJECT = dict(dynamic_object=True, obj_size=1.6, obj_depth=3.0,
                      obj_speed=0.06)
# tests/test_e2e_slam.py:86: the mono test's motion
MONO_MOTION = dict(advance=0.04, sway=0.5)


def detections(seq, i: int):
    """Frame i's boxes [D, 4] as ``bench.py`` feeds them (:287-288), or
    None when the object is out of view."""
    return seq.boxes[i][seq.box_valid[i]] if seq.box_valid[i, 0] else None


def bench_world(n_frames: int = 60, seed: int = 0, dynamic: bool = False,
                trajectory: str = "sweep", sensor: str = "rgbd"):
    """(seq, gray uint8 [T,H,W], aux, cfg): aux is the depth in uint16
    millimetres [T,H,W], the uint8 right images (stereo) or None
    (mono)."""
    scfg = SynthConfig(n_frames=n_frames, seed=seed, trajectory=trajectory,
                       stereo=sensor == "stereo",
                       **(DYNAMIC_OBJECT if dynamic else {}),
                       **(MONO_MOTION if sensor == "mono" else {}))
    seq = generate(scfg)
    gray8 = np.clip(seq.gray, 0, 255).astype(np.uint8)
    aux = None
    if sensor == "stereo":
        aux = np.clip(seq.right, 0, 255).astype(np.uint8)
    elif sensor == "rgbd":
        aux = np.clip(seq.depth * 1000.0, 0, 65535).astype(np.uint16)
    cfg = C.SystemConfig(
        camera=C.CameraConfig(fx=scfg.fx, fy=scfg.fy, cx=scfg.cx,
                              cy=scfg.cy, bf=scfg.fx * scfg.baseline,
                              width=scfg.width, height=scfg.height,
                              th_depth=120.0, fps=scfg.fps,
                              depth_map_factor=1000.0),
        orb=C.ORBConfig(n_features=1000),
        detector=C.DetectorConfig(mode="precomputed" if dynamic else "off"),
        capacity=C.CapacityConfig(max_keyframes=128, max_landmarks=32768,
                                  max_keypoints=2048, local_ba_keyframes=8,
                                  local_ba_landmarks=2048),
        sensor=sensor)
    return seq, gray8, aux, cfg
