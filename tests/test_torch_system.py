"""System.track_rgbd of the port against the JAX System on the 320x240
synthetic world, and the System's device contract.

Both Systems run with their keyframe hook, so every keyframe goes through
loop detection (vocabulary transform and keyframe database).
Tolerance: no LOST frame in either, and the port's ATE within
max(1 mm, 20%) of the JAX ATE."""
import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from slam_dynamic_tpu.io.evo import ate_rmse as jate
from slam_dynamic_tpu.system import System as JSystem
from slam_dynamic_tpu_torch import resolve_device
from slam_dynamic_tpu_torch.io import trajectory as traj_io
from slam_dynamic_tpu_torch.io.evo import ate_rmse
from slam_dynamic_tpu_torch.system import System
from torch_port_util import configs, drain, small_world

N_FRAMES = 10


def _run(system, gray8, depth16, seq):
    stats = [system.track_rgbd(gray8[i], depth16[i], float(seq.timestamps[i]))
             for i in range(N_FRAMES)]
    stats += drain(system.tracker)     # pipelined: the frames in flight
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


@pytest.fixture(scope="module")
def pipelined():
    """Both packages with one frame in flight (pipeline_depth 1), the
    frame left in flight at the end finalized by ``Tracker.flush``."""
    (seq, gray8, depth16), js, ts = _systems(pipeline_depth=1)
    out = dict(seq=seq)
    for name, system in (("jax", js), ("port", ts)):
        stats = [system.track_rgbd(gray8[i], depth16[i],
                                   float(seq.timestamps[i]))
                 for i in range(N_FRAMES)]
        flushed = system.tracker.flush()
        est = np.stack([-R.T @ t for _, R, t in system.trajectory])
        out[name] = dict(stats=stats + [flushed], flushed=flushed,
                         again=system.tracker.flush(), est=est)
    return out


def test_pipelined_track_rgbd_matches_jax(pipelined):
    """One frame in flight (pipeline_depth 1, bench.py's default): stats
    arrive a frame late, with the same states and keyframe decisions as
    JAX's, and the ATE within max(1 mm, 20%)."""
    seq = pipelined["seq"]
    (sj, ej), (st, et) = ((pipelined[k]["stats"], pipelined[k]["est"])
                          for k in ("jax", "port"))
    assert [(s.frame_id, s.state, s.is_keyframe) for s in st] == \
        [(s.frame_id, s.state, s.is_keyframe) for s in sj]
    # a dispatch that finalizes no frame returns a placeholder (-1)
    assert [s.frame_id for s in st if s.frame_id >= 0] == \
        list(range(N_FRAMES))
    gt = seq.t_wc[:N_FRAMES]
    ate_j, ate_t = jate(ej, gt), ate_rmse(et, gt)
    assert abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), (ate_t, ate_j)


def test_flush_returns_the_last_frame_like_jax(pipelined):
    """``Tracker.flush`` returns what the JAX Tracker's returns: the last
    drained frame's stats (here the one frame in flight), then None once
    nothing is in flight; ``drain`` returns every drained frame."""
    fj, ft = pipelined["jax"]["flushed"], pipelined["port"]["flushed"]
    assert not isinstance(ft, list)
    assert (ft.frame_id, ft.state, ft.is_keyframe) == \
        (fj.frame_id, fj.state, fj.is_keyframe)
    assert ft.frame_id == N_FRAMES - 1
    for a, b in ((fj.n_inliers_mm, ft.n_inliers_mm),
                 (fj.n_inliers_map, ft.n_inliers_map)):
        assert abs(a - b) <= max(5, 0.02 * a), (a, b)
    assert pipelined["jax"]["again"] is None
    assert pipelined["port"]["again"] is None


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


def test_global_ba_option_constructs():
    """``LoopConfig(run_global_ba=True)`` builds a System with no solve in
    flight (it starts at a closed loop)."""
    scfg, *_ = small_world(n_frames=1)
    cfg = configs(scfg)[1]
    system = System(cfg.replace(loop=dataclasses.replace(
        cfg.loop, run_global_ba=True)), device="cpu")
    assert system._gba is None
    system.shutdown()


def test_device_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    scfg, *_ = small_world(n_frames=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        System(configs(scfg)[1])
    assert resolve_device("cpu").type == "cpu"


def _live_main(monkeypatch, **kw):
    """``python -m slam_dynamic_tpu_torch.io.live`` up to its server (a
    stub that tracks nothing): the System's camera tensors."""
    from slam_dynamic_tpu_torch.io import live
    made = []

    class Stub:
        def __init__(self, system, sensor, port=0):
            made.append(system)
            self.port, self.inbox = port, live.LatestWins()

        def run(self):
            return 0
    monkeypatch.setattr(live, "LiveTracker", Stub)
    argv = ["--port", "0"] + (["--device", kw["device"]] if kw else [])
    with contextlib.redirect_stdout(io.StringIO()):
        live.main(argv)
    return [made[0].cam.fx]


@pytest.mark.parametrize("make", ["empty_map", "map_state_from_numpy",
                                  "intrinsics_from_config",
                                  "Intrinsics.create", "io.live.main"])
def test_public_constructors_default_to_cuda(monkeypatch, make):
    """Every port function that makes device state defaults to the card
    like System does: without one it raises, and device="cpu" is asked
    for explicitly (``--device cpu`` for the live server)."""
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
        "io.live.main": lambda **kw: _live_main(monkeypatch, **kw),
    }[make]
    assert call(device="cpu")[0].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


@pytest.mark.parametrize("change", ["stereo", "detector", "global_ba",
                                    "text_vocabulary", "adaptive_pipeline"])
def test_unported_options_raise(change, tmp_path):
    """The options that raised while item 22 was open now build, and a
    System with each tracks its first frame; a DBoW2 text vocabulary
    path raises in both packages, the same error (each System reads its
    path with ``np.load``)."""
    scfg, seq, gray8, depth16 = small_world(n_frames=1)
    jcfg, cfg = configs(scfg)
    if change == "stereo":
        cfg = cfg.replace(sensor="stereo", tracking=dataclasses.replace(
            cfg.tracking, adaptive_pipeline=True))
    elif change == "detector":
        cfg = cfg.replace(
            detector=dataclasses.replace(cfg.detector, mode="online"),
            tracking=dataclasses.replace(cfg.tracking,
                                         adaptive_pipeline=True))
    elif change == "global_ba":
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop,
                                                   run_global_ba=True),
                          tracking=dataclasses.replace(cfg.tracking,
                                                       adaptive_pipeline=True))
    elif change == "text_vocabulary":
        from slam_dynamic_tpu_torch.models import vocabulary as tvoc
        path = str(tmp_path / "ORBvoc.txt")
        tvoc.save_orbvoc_text(path, tvoc.train(
            np.random.default_rng(0).integers(0, 2**32, (64, 8),
                                              dtype=np.uint32),
            k=2, levels=2, device="cpu"))
        errors = []
        for C, make in ((jcfg, JSystem),
                        (cfg, lambda c: System(c, device="cpu"))):
            with pytest.raises(Exception) as err:
                make(C.replace(vocabulary=dataclasses.replace(
                    C.vocabulary, path=path)))
            errors.append(err.type)
        assert errors[0] is errors[1], errors
        return
    else:
        cfg = cfg.replace(tracking=dataclasses.replace(
            cfg.tracking, pipeline_depth=1, adaptive_pipeline=True))
    system = System(cfg, device="cpu")
    assert system.tracker._adaptive_depth()
    if change == "stereo":
        st = system.track_stereo(gray8[0], gray8[0], 0.0)
    else:
        st = system.track_rgbd(gray8[0], depth16[0], 0.0)
    # (a stereo pair of one image has no depth: it does not initialize)
    assert st.state == ("NOT_INITIALIZED" if change == "stereo" else "OK")


def _ready_schedule(not_ready, calls):
    """A ``Tracker._packet_ready`` that answers False on the calls numbered
    in ``not_ready`` (0-based) and True otherwise, recording its answers
    in ``calls``."""
    def ready(out):
        calls.append(len(calls) not in not_ready)
        return calls[-1]
    return staticmethod(ready)


@pytest.fixture(scope="module")
def adaptive():
    """Both packages with one frame in flight and the adaptive pipeline
    depth, the packets forced not ready on calls 2, 3 and 6 (frames run
    one and two deeper there), the frames left in flight drained."""
    from slam_dynamic_tpu.frontend.tracking import Tracker as JTracker
    from slam_dynamic_tpu_torch.frontend.tracking import Tracker
    (seq, gray8, depth16), js, ts = _systems(pipeline_depth=1,
                                             adaptive_pipeline=True)
    out = dict(seq=seq)
    for name, system, cls in (("jax", js, JTracker), ("port", ts, Tracker)):
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cls, "_packet_ready", _ready_schedule({2, 3, 6},
                                                             calls))
            stats = [system.track_rgbd(gray8[i], depth16[i],
                                       float(seq.timestamps[i]))
                     for i in range(N_FRAMES)]
            stats += drain(system.tracker)
        est = np.stack([-R.T @ t for _, R, t in system.trajectory])
        out[name] = dict(stats=stats, calls=calls, est=est)
    return out


def test_adaptive_pipeline_depth_matches_jax(adaptive):
    """The same readiness answers give the same finalize order, states
    and keyframe decisions in both packages, and poses within 1e-4. (A
    call that finalizes several frames returns the last one's stats, in
    both.)"""
    j, t = adaptive["jax"], adaptive["port"]
    assert t["calls"] == j["calls"]
    assert t["calls"].count(False) == 3          # frames run deeper
    assert [(s.frame_id, s.state, s.is_keyframe) for s in t["stats"]] == \
        [(s.frame_id, s.state, s.is_keyframe) for s in j["stats"]]
    assert len(t["est"]) == N_FRAMES
    np.testing.assert_allclose(t["est"], j["est"], atol=1e-4)


def test_adaptive_pipeline_on_the_cpu_finalizes_like_depth_one():
    """On the CPU a packet is always ready (JAX's answer when its runtime
    cannot tell), so the adaptive depth never runs deeper there: the
    plain one-frame pipeline. ``start_copy`` queues no copy on the
    CPU."""
    from slam_dynamic_tpu_torch.frontend.tracking import (Tracker,
                                                          _ChunkPacket,
                                                          _PacketRow)
    owner = type("Owner", (), {"packet_reads": 0})()
    shared = _ChunkPacket(torch.arange(56.0).reshape(2, 28), owner)
    row = _PacketRow(shared, 1)
    row.start_copy()
    assert Tracker._packet_ready(type("Out", (), {"packed": row})())
    np.testing.assert_array_equal(row.numpy(), np.arange(28.0, 56.0))
    assert owner.packet_reads == 1 and shared.ready()


def test_prefetch_matches_direct_path(runs):
    """``tests/test_e2e_slam.py:195``: ``track_rgbd(prefetch_next=)``
    (the next frame staged on the worker thread) gives the direct path's
    trajectory, here to the bit."""
    scfg, seq, gray8, depth16 = small_world(n_frames=N_FRAMES)
    ts = System(configs(scfg)[1], device="cpu")
    # the same array objects in both calls: frames match by identity
    frames = [(gray8[i], depth16[i]) for i in range(N_FRAMES)] + [None]
    taken = []
    take = ts.tracker._take_prefetched

    def spy(gray, aux):
        staged = take(gray, aux)
        taken.append(staged is not None)
        return staged
    ts.tracker._take_prefetched = spy
    stats = [ts.track_rgbd(*frames[i], float(seq.timestamps[i]),
                           prefetch_next=frames[i + 1])
             for i in range(N_FRAMES)]
    assert all(s.state == "OK" for s in stats)
    # frame 0 initializes on the host; frame 1 was not staged (tracking
    # was not OK when frame 0 came); every later one was
    assert taken == [False] + [True] * (N_FRAMES - 2)
    assert not ts.tracker._prefetch
    np.testing.assert_array_equal(
        np.stack([-R.T @ t for _, R, t in ts.trajectory]), runs["port"][1])
