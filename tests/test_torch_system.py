"""System.track_rgbd of the port against the JAX System on the 320x240
synthetic world, and the System's device contract.

Both Systems run with their keyframe hook, so every keyframe goes through
loop detection (vocabulary transform and keyframe database).
Tolerance: no LOST frame in either, and the port's ATE within
max(1 mm, 20%) of the JAX ATE."""
import dataclasses

import numpy as np
import pytest
import torch

from slam_dynamic_tpu.io.evo import ate_rmse as jate
from slam_dynamic_tpu.system import System as JSystem
from slam_dynamic_tpu_torch import resolve_device
from slam_dynamic_tpu_torch.io import trajectory as traj_io
from slam_dynamic_tpu_torch.io.evo import ate_rmse
from slam_dynamic_tpu_torch.system import System
from torch_port_util import configs, small_world

N_FRAMES = 10


def _run(system, gray8, depth16, seq):
    stats = [system.track_rgbd(gray8[i], depth16[i], float(seq.timestamps[i]))
             for i in range(N_FRAMES)]
    while system.tracker._pending:     # pipelined: the frames in flight
        stats.append(system.tracker._finalize_one())
    est = np.stack([-R.T @ t for _, R, t in system.trajectory])
    return stats, est


def _systems(**tracking):
    scfg, seq, gray8, depth16 = small_world(n_frames=N_FRAMES)
    jcfg, tcfg = configs(scfg)
    if tracking:
        jcfg, tcfg = (c.replace(tracking=dataclasses.replace(c.tracking,
                                                             **tracking))
                      for c in (jcfg, tcfg))
    js = JSystem(jcfg)
    return (seq, gray8, depth16), js, System(tcfg, device="cpu")


@pytest.fixture(scope="module")
def runs():
    (seq, gray8, depth16), js, ts = _systems()
    return dict(seq=seq, jax=_run(js, gray8, depth16, seq),
                port=_run(ts, gray8, depth16, seq), system=ts, jsystem=js)


def test_track_rgbd_ate_matches_jax(runs):
    gt = runs["seq"].t_wc[:N_FRAMES]
    (sj, ej), (st, et) = runs["jax"], runs["port"]
    assert all(s.state == "OK" for s in sj)
    assert all(s.state == "OK" for s in st)
    ate_j, ate_t = jate(ej, gt), ate_rmse(et, gt)
    assert abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), (ate_t, ate_j)
    assert ate_t < 0.02
    assert [s.is_keyframe for s in sj] == [s.is_keyframe for s in st]


def test_track_rgbd_inlier_counts_track_jax(runs):
    (sj, _), (st, _) = runs["jax"], runs["port"]
    for a, b in zip(sj[1:], st[1:]):
        assert abs(a.n_inliers_map - b.n_inliers_map) <= max(
            5, 0.02 * a.n_inliers_map)


def test_track_rgbd_keyframes_reach_loop_detection(runs):
    """Every keyframe went through the hook: one database row each, equal
    to JAX's, with the shipped vocabulary."""
    ts, js = runs["system"], runs["jsystem"]
    n_kf = sum(s.is_keyframe for s in runs["port"][0])
    assert int(ts.loop.db.valid.sum()) == n_kf == ts.tracker.kf_seq >= 2
    np.testing.assert_array_equal(ts.loop.db.word.numpy(),
                                  np.asarray(js.loop.db.word))
    assert ts.voc.n_words == js.voc.n_words == 10 ** 5
    assert "vocab_synth_100k.npz" in ts.vocabulary_line()


def test_pipelined_track_rgbd_matches_jax():
    """One frame in flight (pipeline_depth 1, bench.py's default): stats
    arrive a frame late, with the same states and keyframe decisions as
    JAX's, and the ATE within max(1 mm, 20%)."""
    (seq, gray8, depth16), js, ts = _systems(pipeline_depth=1)
    (sj, ej), (st, et) = (_run(s, gray8, depth16, seq) for s in (js, ts))
    assert [(s.frame_id, s.state, s.is_keyframe) for s in st] == \
        [(s.frame_id, s.state, s.is_keyframe) for s in sj]
    # a dispatch that finalizes no frame returns a placeholder (-1)
    assert [s.frame_id for s in st if s.frame_id >= 0] == \
        list(range(N_FRAMES))
    gt = seq.t_wc[:N_FRAMES]
    ate_j, ate_t = jate(ej, gt), ate_rmse(et, gt)
    assert abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), (ate_t, ate_j)


def test_vocabulary_trained_from_keyframe_0_matches_jax():
    """prefer_asset=False: both Systems train their words from keyframe 0's
    descriptors (host numpy, seeded), to the same tree."""
    scfg, seq, gray8, depth16 = small_world(n_frames=1)
    jcfg, tcfg = (c.replace(vocabulary=dataclasses.replace(
        c.vocabulary, prefer_asset=False)) for c in configs(scfg))
    js, ts = JSystem(jcfg), System(tcfg, device="cpu")
    for s in (js, ts):
        assert s.track_rgbd(gray8[0], depth16[0], 0.0).is_keyframe
    assert ts.vocabulary_line().startswith(
        "vocabulary: trained from keyframe 0")
    assert (ts.voc.k, ts.voc.levels) == (js.voc.k, js.voc.levels) == (10, 3)
    for a, b in zip(js.voc.centroids, ts.voc.centroids):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).view(np.int32))
    np.testing.assert_array_equal(ts.voc.weights.numpy(),
                                  np.asarray(js.voc.weights))


def test_vocabulary_path_loads_an_npz():
    from slam_dynamic_tpu_torch.models.vocabulary import default_vocab_path
    scfg, *_ = small_world(n_frames=1)
    tcfg = configs(scfg)[1]
    path = default_vocab_path()
    ts = System(tcfg.replace(vocabulary=dataclasses.replace(
        tcfg.vocabulary, path=path)), device="cpu")
    assert ts.voc.n_words == 10 ** 5 and path in ts.vocabulary_line()


def test_trajectory_files(runs, tmp_path):
    system = runs["system"]
    system.save_trajectory_tum(str(tmp_path / "t.txt"))
    system.save_trajectory_kitti(str(tmp_path / "k.txt"))
    ts, pos, quat = traj_io.load_tum(str(tmp_path / "t.txt"))
    assert pos.shape == (N_FRAMES, 3)
    np.testing.assert_allclose(np.linalg.norm(quat, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(pos, runs["port"][1], atol=1e-5)
    kpos, rot = traj_io.load_kitti(str(tmp_path / "k.txt"))
    np.testing.assert_allclose(kpos, pos, atol=1e-5)


def test_device_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    scfg, *_ = small_world(n_frames=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        System(configs(scfg)[1])
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("make", ["empty_map", "map_state_from_numpy",
                                  "intrinsics_from_config",
                                  "Intrinsics.create"])
def test_public_constructors_default_to_cuda(monkeypatch, make):
    """Every port function that makes device state defaults to the card
    like System does: without one it raises, and device="cpu" is asked
    for explicitly."""
    from slam_dynamic_tpu_torch import convert, system
    from slam_dynamic_tpu_torch.utils.camera import Intrinsics
    from slam_dynamic_tpu_torch.worldmap import state
    scfg, *_ = small_world(n_frames=1)
    tcfg = configs(scfg)[1]
    arrays = convert.map_state_to_numpy(state.empty_map(tcfg.capacity,
                                                        "cpu"))
    call = {
        "empty_map": lambda **kw: state.empty_map(tcfg.capacity, **kw),
        "map_state_from_numpy":
            lambda **kw: convert.map_state_from_numpy(arrays, **kw),
        "intrinsics_from_config":
            lambda **kw: system.intrinsics_from_config(tcfg, **kw),
        "Intrinsics.create":
            lambda **kw: Intrinsics.create(500.0, 500.0, 320.0, 240.0, **kw),
    }[make]
    assert call(device="cpu")[0].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


@pytest.mark.parametrize("change", ["stereo", "detector", "global_ba",
                                    "text_vocabulary", "adaptive_pipeline"])
def test_unported_options_raise(change):
    scfg, *_ = small_world(n_frames=1)
    cfg = configs(scfg)[1]
    if change == "stereo":
        # the stereo sensor is ported (test_torch_stereo.py); an unported
        # option of a stereo System still raises
        cfg = cfg.replace(sensor="stereo", loop=dataclasses.replace(
            cfg.loop, run_global_ba=True))
    elif change == "detector":
        # precomputed boxes and the online detector are ported
        # (test_torch_online_system.py); an unported option of an
        # online-detector System still raises
        cfg = cfg.replace(
            detector=dataclasses.replace(cfg.detector, mode="online"),
            tracking=dataclasses.replace(cfg.tracking, depth_stride=2))
    elif change == "global_ba":
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop,
                                                   run_global_ba=True))
    elif change == "text_vocabulary":
        cfg = cfg.replace(vocabulary=dataclasses.replace(
            cfg.vocabulary, path="ORBvoc.txt"))
    else:
        cfg = cfg.replace(tracking=dataclasses.replace(
            cfg.tracking, pipeline_depth=1, adaptive_pipeline=True))
    with pytest.raises(NotImplementedError,
                       match="item 20" if change in ("global_ba", "stereo")
                       else None):
        System(cfg, device="cpu")

