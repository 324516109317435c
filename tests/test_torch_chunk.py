"""Temporal chunking with loop detection on: the port's System.track_chunk
against the JAX System's, as shipped (keyframe hook on, so every keyframe
is transformed, added to the keyframe database and, from the 10th on,
scored for a loop), on the 320x240 world at C = 6 with one chunk in
flight (``bench.py``'s default ``pipeline_depth=1``) and a keyframe at
least every 3 frames, past the 12th keyframe.

Tolerances: the same frames, states and keyframe decisions and the same
``_detect`` results and streaks on every keyframe; keyframe-database
rows equal (weights within atol 1e-6) where the keyframe's descriptors
are equal in both maps (torch_port_util.check_kfdb: the extractors agree
on about 99.9% of keypoints); ATE within max(1 mm, 20%) of JAX's;
local-map inliers within max(5, 2%); the fused chunk on one map: poses
within atol 1e-3, inlier counts within 2%."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_dynamic_tpu.frontend import fused as jfused
from slam_dynamic_tpu.io.evo import ate_rmse as jate
from slam_dynamic_tpu.system import System as JSystem
from slam_dynamic_tpu_torch.convert import map_state_from_numpy
from slam_dynamic_tpu_torch.frontend import fused as tfused
from slam_dynamic_tpu_torch.io.evo import ate_rmse
from slam_dynamic_tpu_torch.system import System
from torch_port_util import check_kfdb, configs, decisions, map_arrays, \
    run_pair, small_world, to_t, with_tracking

C = 6
N_FRAMES = 43


def _pair(world, n_frames, **tracking):
    jcfg, tcfg = configs(world[0])
    tracking = dict(max_frames_between_kf=3, **tracking)
    js = JSystem(with_tracking(jcfg, **tracking))
    ts = System(with_tracking(tcfg, **tracking), device="cpu")
    return run_pair(js, ts, world, n_frames)


@pytest.fixture(scope="module")
def world():
    return small_world(n_frames=N_FRAMES)


@pytest.fixture(scope="module")
def runs(world):
    return _pair(world, N_FRAMES, pipeline_depth=1)


def test_chunk_states_and_keyframes_match_jax(runs):
    dj, dt = decisions(runs["jax"]), decisions(runs["port"])
    assert dj == dt
    assert [d[0] for d in dt] == list(range(N_FRAMES))
    assert all(d[1] == "OK" for d in dt)
    tj, tt = runs["jax"]["system"].tracker, runs["port"]["system"].tracker
    assert tt.kf_seq == tj.kf_seq >= 12
    assert tt.n_kf_host == tj.n_kf_host


def test_chunk_ate_and_inliers_track_jax(runs, world):
    gt = world[1].t_wc[:N_FRAMES]
    ate_j = jate(runs["jax"]["est"], gt)
    ate_t = ate_rmse(runs["port"]["est"], gt)
    assert abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), (ate_t, ate_j)
    for a, b in zip(runs["jax"]["stats"][1:], runs["port"]["stats"][1:]):
        assert abs(a.n_inliers_map - b.n_inliers_map) <= max(
            5, 0.02 * a.n_inliers_map)


def test_chunk_keyframe_database_and_detection_match_jax(runs):
    dj, dt = runs["jax"]["detects"], runs["port"]["detects"]
    assert dt == dj
    assert len(dt) >= 2 and [d[1] for d in dt][0] == 10
    check_kfdb(runs["jax"]["system"], runs["port"]["system"])
    n_kf = sum(s.is_keyframe for s in runs["port"]["stats"])
    assert int(runs["port"]["system"].loop.db.valid.sum()) == n_kf \
        == runs["port"]["system"].tracker.kf_seq


def test_chunk_packet_read_once_per_chunk(runs):
    run = runs["port"]
    tracker = run["system"].tracker
    assert run["n_chunks"] == 7
    assert tracker.packet_reads == tracker.dispatches == run["n_chunks"]


def test_fused_track_chunk_matches_jax(runs, world):
    """One fused chunk on the same map (the JAX run's, carried across by
    convert.py), from its last keyframe with no velocity."""
    _, seq, gray8, depth16 = world
    js = runs["jax"]["system"]
    jt = js.tracker
    m = jt.map
    k = jt.last_kf_id
    dc = jt._scalar_consts()
    bx, ba = dc[("chunk_empty_boxes", C)]
    cfg = js.cfg
    frames = slice(N_FRAMES - C, N_FRAMES)
    obs = np.asarray(m.kf_obs_lm[k])
    R, t = np.asarray(m.kf_R[k]), np.asarray(m.kf_t[k])
    common = dict(max_kf=cfg.capacity.local_ba_keyframes,
                  max_lm=cfg.capacity.local_ba_landmarks,
                  n_levels=cfg.orb.n_levels,
                  n_slots=cfg.capacity.max_keypoints)
    outs_j, pk_j = jfused.fused_track_chunk(
        m, js.cam, jt.bounds, jnp.asarray(gray8[frames]),
        jnp.asarray(depth16[frames]), bx, ba, jnp.asarray(obs),
        jnp.asarray(R), jnp.asarray(t), jnp.asarray(R), jnp.asarray(t),
        dc["vel0"], jnp.int32(k), orb_cfg=cfg.orb, height=240, width=320,
        mm_radius=dc["mm_radius"], local_radius=dc["local_radius"],
        depth_th=dc["depth_th"], scale_factor=dc["sf"],
        min_inliers_track=dc["min_tr"], sensor="rgbd",
        depth_scale=dc["depth_scale"], depth_stride=1, chunk=C, **common)
    ts_ = runs["port"]["system"]
    tt = ts_.tracker
    tdc = tt._scalar_consts()
    g, d, depth_scale = tt._stage_inputs(gray8[frames], depth16[frames])
    tbx, tba = tt._chunk_empty_boxes(C)
    outs_t, pk_t = tfused.fused_track_chunk(
        map_state_from_numpy(map_arrays(m), "cpu"), ts_.cam, tt.bounds, g, d,
        tbx, tba, to_t(obs), to_t(R), to_t(t), to_t(R), to_t(t),
        tdc["vel0"], torch.tensor(k), cfg.orb, tdc["mm_radius"],
        tdc["local_radius"], tdc["depth_th"], tdc["sf"], tdc["min_tr"],
        depth_scale=depth_scale, **common)
    pj, pt = np.asarray(pk_j), pk_t.numpy()
    assert pt.shape == pj.shape == (C, 28)
    np.testing.assert_allclose(pt[:, 4:16], pj[:, 4:16], atol=1e-3)
    np.testing.assert_array_equal(pt[:, 16:], pj[:, 16:])
    assert (pj[:, 1] > 100).all()
    assert (np.abs(pt[:, :2] - pj[:, :2]) <= 0.02 * pj[:, :2]).all()
    for oj, ot in zip(outs_j, outs_t):
        agree = (np.asarray(oj.obs_lm) == ot.obs_lm.numpy()).mean()
        assert agree >= 0.98, agree
    np.testing.assert_allclose(outs_t[-1].lm_visible.numpy(),
                               np.asarray(outs_j[-1].lm_visible), atol=2)


@pytest.mark.parametrize("mode", ["in_call", "eager", "eager_upload_first"])
def test_chunk_finalize_modes_match_jax(world, mode):
    """The other finalize orders of step_images_chunk: the chunk finalized
    in its own call (pipeline_depth 0), and the previous chunk finalized
    before the next is dispatched (chunk_eager_finalize, with and without
    the upload first)."""
    kw = dict(in_call=dict(pipeline_depth=0),
              eager=dict(pipeline_depth=1, chunk_eager_finalize=True,
                         chunk_eager_upload_first=False),
              eager_upload_first=dict(pipeline_depth=1,
                                      chunk_eager_finalize=True))[mode]
    n = 13
    runs = _pair(world, n, **kw)
    assert decisions(runs["jax"]) == decisions(runs["port"])
    gt = world[1].t_wc[:n]
    ate_j = jate(runs["jax"]["est"], gt)
    ate_t = ate_rmse(runs["port"]["est"], gt)
    assert abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), (ate_t, ate_j)
