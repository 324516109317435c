"""The main path's acceptance test: the port's System against the JAX
System on the 640x480 bench world (``io/bench_world.py``: 1000 ORB
features, 2048 keypoint slots, the capacities of ``bench.py:250-261``),
both as shipped with loop detection on, run as ``bench.py``'s chunked
mode runs them: one frame to initialize, then chunks of C = 6 frames with
one chunk in flight and a keyframe at least every 3 frames, far enough
that the loop detector scores keyframes 10 and 11.

Tolerances: the same frames, states and keyframe decisions, the same
``_detect`` results and streaks, keyframe-database rows equal where the
keyframe's descriptors are equal (torch_port_util.check_kfdb); ATE
within max(1 mm, 20%) of JAX's; local-map inliers within max(5, 2%)."""
import dataclasses

import pytest

from slam_dynamic_tpu import config as JC
from slam_dynamic_tpu.io.evo import ate_rmse as jate
from slam_dynamic_tpu.system import System as JSystem
from slam_dynamic_tpu_torch.io.bench_world import bench_world
from slam_dynamic_tpu_torch.io.evo import ate_rmse
from slam_dynamic_tpu_torch.system import System
from torch_port_util import check_kfdb, decisions, run_pair

C = 6
N_FRAMES = 31


def _jax_config(cfg):
    """The port's config tree as the JAX package's dataclasses."""
    if dataclasses.is_dataclass(cfg):
        return getattr(JC, type(cfg).__name__)(**{
            f.name: _jax_config(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)})
    return cfg


@pytest.fixture(scope="module")
def runs():
    seq, gray8, depth16, tcfg = bench_world(N_FRAMES, 0)
    tcfg = tcfg.replace(tracking=dataclasses.replace(
        tcfg.tracking, max_frames_between_kf=3, pipeline_depth=1))
    js = JSystem(_jax_config(tcfg))
    ts = System(tcfg, device="cpu")
    out = run_pair(js, ts, (None, seq, gray8, depth16), N_FRAMES)
    out["seq"] = seq
    return out


def test_bench_world_chunked_matches_jax(runs):
    dj, dt = decisions(runs["jax"]), decisions(runs["port"])
    assert dj == dt
    assert [d[0] for d in dt] == list(range(1 + (N_FRAMES - 1) // C * C))
    assert all(d[1] == "OK" for d in dt)
    assert runs["port"]["n_chunks"] == (N_FRAMES - 1) // C
    gt = runs["seq"].t_wc[:N_FRAMES]
    ate_j = jate(runs["jax"]["est"], gt)
    ate_t = ate_rmse(runs["port"]["est"], gt)
    assert abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), (ate_t, ate_j)
    assert ate_t < 0.03
    for a, b in zip(runs["jax"]["stats"][1:], runs["port"]["stats"][1:]):
        assert abs(a.n_inliers_map - b.n_inliers_map) <= max(
            5, 0.02 * a.n_inliers_map)


def test_bench_world_loop_detection_matches_jax(runs):
    js, ts = runs["jax"]["system"], runs["port"]["system"]
    assert ts.tracker.kf_seq == js.tracker.kf_seq >= 11
    assert runs["port"]["detects"] == runs["jax"]["detects"]
    assert [d[1] for d in runs["port"]["detects"]][:2] == [10, 11]
    check_kfdb(js, ts)
    assert ts.voc.n_words == 10 ** 5
