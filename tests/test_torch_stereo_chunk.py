"""Stereo SLAM on the chunked path with dynamic objects: the port's
System.track_chunk(lefts, rights, ts, detections=) against the JAX
System's on the 320x240 moving-object world of
``tests/test_e2e_dynamic.py`` rendered as a stereo pair (baseline 0.2 m,
``tests/test_stereo_detector_cli.py``), 25 frames, C = 6, one chunk in
flight, the H/F classification on every 2nd chunk frame. JAX on the CPU,
the port with CPU tensors.

The two packages draw their RANSAC samples differently, so the
comparison is by outcome, as tests/test_torch_dynamic_chunk.py's:
every frame OK on both; the same keyframe decisions up to the first
frame at which the box statuses differ; the same final box statuses,
with the object confirmed dynamic; ATE within max(1 mm, 20%) of JAX's."""
import numpy as np
import pytest

from slam_dynamic_tpu.io.evo import ate_rmse as jate
from slam_dynamic_tpu.system import System as JSystem
from slam_dynamic_tpu_torch.io.evo import ate_rmse
from slam_dynamic_tpu_torch.system import System
from torch_port_util import (decisions, dynamic_configs, dynamic_world,
                             first_status_difference, run_dynamic,
                             with_tracking)

C = 6
N_FRAMES = 25


@pytest.fixture(scope="module")
def chunked_runs():
    world = dynamic_world("moving", N_FRAMES, stereo=True, baseline=0.2)
    jcfg, tcfg = (with_tracking(c.replace(sensor="stereo"), pipeline_depth=1)
                  for c in dynamic_configs(world[0]))
    return world, {
        "jax": run_dynamic(JSystem(jcfg), world, N_FRAMES, C),
        "port": run_dynamic(System(tcfg, device="cpu"), world, N_FRAMES, C)}


def test_stereo_chunked_states_and_keyframes_match_jax(chunked_runs):
    _, runs = chunked_runs
    assert runs["port"]["system"].cfg.sensor == "stereo"
    dj, dt = decisions(runs["jax"]), decisions(runs["port"])
    assert [d[0] for d in dt] == [d[0] for d in dj] == list(range(N_FRAMES))
    assert all(d[1] == "OK" for d in dj + dt)
    upto = first_status_difference(runs["jax"], runs["port"])
    assert dt[:upto] == dj[:upto], (upto, dj, dt)
    assert sum(d[2] for d in dt) >= 2


def test_stereo_chunked_box_status_matches_jax(chunked_runs):
    _, runs = chunked_runs
    sj = runs["jax"]["system"].boxes.status
    st = runs["port"]["system"].boxes.status
    np.testing.assert_array_equal(st, sj)
    assert (st == 2).any()


def test_stereo_chunked_ate_tracks_jax(chunked_runs):
    world, runs = chunked_runs
    gt = world[1].t_wc[:N_FRAMES]
    ate_j = jate(runs["jax"]["est"], gt)
    ate_t = ate_rmse(runs["port"]["est"], gt)
    assert abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), (ate_t, ate_j)
