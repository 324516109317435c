"""The online detector inside the System: ``DetectorConfig(mode=
"online")``, where each frame's boxes come from the System's own
CenterNet (the shipped weights), against the JAX System on the 320x240
moving-object world of ``tests/test_e2e_dynamic.py``, per frame
(``track_rgbd``, 16 frames, no boxes passed; the object is confirmed
dynamic at frame 7 in both). The chunked form is
``tests/test_torch_online_chunk.py``.

The RANSAC samples differ between the packages, so the comparison is by
outcome. Tolerances: every frame OK on both; the same box tracks (ids)
and box statuses after every call, the object confirmed dynamic; the
same keyframe decisions up to the first frame at which the box statuses
differ; ATE within max(1 mm, 20%) of JAX's. ``_maybe_detect`` on the
stereo entry (quarantine padding, then ``rectCenterScale``) equal on the
same detections.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_dynamic_tpu.models.detector import Detections as JDetections
from slam_dynamic_tpu.system import System as JSystem
from slam_dynamic_tpu_torch.models.detector import Detections
from slam_dynamic_tpu_torch.system import System
from torch_port_util import check_online_ate, check_online_boxes, \
    check_online_decisions, dynamic_configs, dynamic_world, run_online

N_FRAMES = 16


@pytest.fixture(scope="module")
def world():
    return dynamic_world("moving", N_FRAMES)


@pytest.fixture(scope="module")
def runs(world):
    return run_online(world, N_FRAMES, chunk=1)


def test_online_frame_boxes_match_jax(runs):
    check_online_boxes(runs)


def test_online_frame_states_and_keyframes_match_jax(runs):
    check_online_decisions(runs)


def test_online_frame_ate_tracks_jax(runs, world):
    check_online_ate(runs, world)


def test_maybe_detect_stereo_matches_jax(world):
    """The stereo entry's boxes from the same detections: each grown by
    ``quarantine_pad`` about its centre, then reshaped (width 0.8x,
    height 1.6x); the mono/RGB-D entry's only grown; no valid detection
    gives None."""
    jcfg, tcfg = dynamic_configs(world[0], detector="online")
    js = JSystem(jcfg.replace(sensor="stereo"))
    ts = System(tcfg.replace(sensor="stereo"), device="cpu")
    rs = np.random.default_rng(3)
    xy = rs.uniform(0, 200, (32, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rs.uniform(5, 80, (32, 2))],
                           1).astype(np.float32)
    scores = rs.uniform(0.5, 1, 32).astype(np.float32)
    classes = np.zeros(32, np.int32)
    img = world[2][0]
    for valid in (rs.uniform(size=32) < 0.4, np.zeros(32, bool)):
        js.detector.detect = lambda img, v=valid: JDetections(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
            jnp.asarray(v))
        ts.detector.detect = lambda img, v=valid: Detections(
            *(torch.from_numpy(a) for a in (boxes, scores, classes, v)))
        for stereo in (True, False):
            bj = js._maybe_detect(img, None, stereo=stereo)
            bt = ts._maybe_detect(img, None, stereo=stereo)
            if not valid.any():
                assert bj is None and bt is None
                continue
            np.testing.assert_array_equal(bt, bj)
            assert bt.dtype == np.float32 and len(bt) == valid.sum()
    # passed boxes bypass the detector
    given = boxes[:2]
    assert ts._maybe_detect(img, given) is given
