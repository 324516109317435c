"""The batched-over-levels ORB extractor (ops/orb_batched.py,
``ORBConfig(batched_levels=True)``) against the JAX package's batched
path, JAX on the CPU and the port with CPU tensors: one 640x480 bench
frame, and the RGB-D System with the batched extractor on the 320x240
world.

Tolerances: keypoint positions, levels and validity equal; responses to
1e-4 relative and angles to 1e-4 rad (the pyramid's resize sums round
in another order, ROADMAP Queue 3); descriptors equal except where that
rounding moves a rotated sample across a pixel, counted and held under
0.5% of the valid keypoints. The System: every frame OK in both, the
same keyframe decisions, ATE within max(1 mm, 20%) of JAX's."""
import dataclasses

import numpy as np
import torch

from slam_dynamic_tpu.config import ORBConfig as JORB
from slam_dynamic_tpu.frontend.extractor import extract_np
from slam_dynamic_tpu.io.evo import ate_rmse as jate
from slam_dynamic_tpu.system import System as JSystem
from slam_dynamic_tpu_torch.config import ORBConfig
from slam_dynamic_tpu_torch.frontend.extractor import extract
from slam_dynamic_tpu_torch.io.bench_world import bench_world
from slam_dynamic_tpu_torch.io.evo import ate_rmse
from slam_dynamic_tpu_torch.system import System
from torch_port_util import configs, small_world

N_FRAMES = 8


def test_batched_extractor_matches_jax_on_a_bench_frame():
    _, gray8, _, _ = bench_world(1)
    img = gray8[0].astype(np.float32)
    kj = extract_np(img, JORB(n_features=1000, batched_levels=True))
    kt = extract(torch.from_numpy(img),
                 ORBConfig(n_features=1000, batched_levels=True))
    valid = np.asarray(kj.valid)
    assert valid.sum() > 900
    for name in ("xy", "level", "valid"):
        np.testing.assert_array_equal(getattr(kt, name).numpy(),
                                      np.asarray(getattr(kj, name)), name)
    np.testing.assert_allclose(kt.response.numpy(), np.asarray(kj.response),
                               rtol=1e-4)
    np.testing.assert_allclose(kt.angle.numpy(), np.asarray(kj.angle),
                               atol=1e-4)
    differ = (kt.desc.numpy() != np.asarray(kj.desc).view(np.int32)).any(1)
    n_diff = int((differ & valid).sum())
    print(f"batched extractor: {n_diff} of {int(valid.sum())} descriptors "
          "differ from JAX's")
    assert n_diff <= 0.005 * valid.sum()


def test_batched_extractor_system_tracks_jax():
    world = small_world(N_FRAMES)
    seq, gray8, depth16 = world[1:]
    runs = {}
    for name, S, cfg, kw in zip(("jax", "port"), (JSystem, System),
                                configs(world[0]), ({}, {"device": "cpu"})):
        cfg = cfg.replace(orb=dataclasses.replace(cfg.orb,
                                                  batched_levels=True))
        s = S(cfg, **kw)
        st = [s.track_rgbd(gray8[i], depth16[i], float(seq.timestamps[i]))
              for i in range(N_FRAMES)]
        runs[name] = ([(x.state, x.is_keyframe) for x in st],
                      np.stack([-R.T @ t for _, R, t in s.trajectory]))
    assert runs["port"][0] == runs["jax"][0]
    assert all(d[0] == "OK" for d in runs["port"][0])
    gt = seq.t_wc[:N_FRAMES]
    ate_j, ate_t = jate(runs["jax"][1], gt), ate_rmse(runs["port"][1], gt)
    assert abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), (ate_t, ate_j)
