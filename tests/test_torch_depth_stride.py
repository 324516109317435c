"""Strided depth in the port against the JAX package (JAX on the CPU, the
port with CPU tensors): the fused frame build with ``depth_stride=2``
(``fused.py:77-85``: the depth map holds every 2nd pixel of each axis and
is sampled at the keypoint's low-resolution pixel, u_right stays in
full-resolution pixels), the tracker's strided upload, per frame and for
a chunk's stack, and ``System.track_rgbd`` at stride 2 on the 320x240
world in camera-native dtypes, as ``tests/test_e2e_slam.py:134-160``
runs the JAX package.

Tolerances: the frame builds bit-equal in u_right, depth, descriptors
and validity where the two extractions agree (they differ in about one
descriptor in 1000, ROADMAP Queue 3), undistorted xy within 1e-3 px; the
System: every frame OK in both, the port's ATE within max(1 mm, 20%) of
JAX's and under the JAX test's 2 cm."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_dynamic_tpu.frontend import fused as jfused
from slam_dynamic_tpu.io.evo import ate_rmse as jate
from slam_dynamic_tpu.system import System as JSystem
from slam_dynamic_tpu.system import intrinsics_from_config as jintr
from slam_dynamic_tpu_torch.frontend import fused as tfused
from slam_dynamic_tpu_torch.io.evo import ate_rmse
from slam_dynamic_tpu_torch.system import System, intrinsics_from_config
from torch_port_util import configs, small_world, with_tracking

STRIDE = 2
N_FRAMES = 12
SF = np.float32(1.2)


@pytest.fixture(scope="module")
def world():
    return small_world(N_FRAMES)


@pytest.fixture(scope="module")
def stride_configs(world):
    return tuple(with_tracking(c, depth_stride=STRIDE)
                 for c in configs(world[0]))


def test_strided_frame_build_matches_jax(world, stride_configs):
    _, _, gray8, depth16 = world
    jcfg, tcfg = stride_configs
    jcam, tcam = jintr(jcfg), intrinsics_from_config(tcfg, "cpu")
    build = jax.jit(jfused.build_frame_data, static_argnames=(
        "orb_cfg", "height", "width", "sensor", "n_slots", "depth_stride"))
    scale = 1.0 / tcfg.camera.depth_map_factor
    for i in (0, 7):
        low = np.ascontiguousarray(depth16[i][::STRIDE, ::STRIDE])
        fj = build(jcam, jnp.asarray(gray8[i]), jnp.asarray(low),
                   jnp.full((16, 4), -1.0), jnp.zeros(16, bool),
                   orb_cfg=jcfg.orb, height=240, width=320,
                   scale_factor=jnp.float32(SF), sensor="rgbd",
                   n_slots=1024, depth_scale=jnp.float32(scale),
                   depth_stride=STRIDE)
        ft = tfused.build_frame_data(
            tcam, torch.from_numpy(gray8[i]),
            torch.from_numpy(low.view(np.int16)).to(torch.int32) & 0xFFFF,
            torch.full((16, 4), -1.0), torch.zeros(16, dtype=torch.bool),
            tcfg.orb, torch.tensor(SF), "rgbd", n_slots=1024,
            depth_scale=torch.tensor(scale, dtype=torch.float32),
            depth_stride=STRIDE)
        agree = (ft.desc.numpy() == np.asarray(fj.desc).view(np.int32)
                 ).all(1) & (ft.valid.numpy() == np.asarray(fj.valid))
        assert agree.mean() > 0.99, agree.mean()
        for name in ("ur", "depth", "valid", "level"):
            np.testing.assert_array_equal(
                getattr(ft, name).numpy()[agree],
                np.asarray(getattr(fj, name))[agree], name)
        np.testing.assert_allclose(ft.xy.numpy()[agree],
                                   np.asarray(fj.xy)[agree], atol=1e-3)
        # sampled at the low-resolution pixel, in full-resolution u_right
        ok = ft.valid.numpy() & (ft.depth.numpy() > 0)
        assert ok.sum() > 300
        u = ft.xy_raw.numpy()[ok, 0]
        np.testing.assert_allclose(
            ft.ur.numpy()[ok], u - float(tcam.bf) / ft.depth.numpy()[ok],
            rtol=1e-6, atol=1e-3)


def test_strided_upload_per_frame_and_chunk(world, stride_configs):
    _, _, gray8, depth16 = world
    tr = System(stride_configs[1], device="cpu").tracker
    for gray, depth in ((gray8[0], depth16[0]), (gray8[:3], depth16[:3])):
        g, d, scale = tr._stage_inputs(gray, depth)
        assert tuple(g.shape) == gray.shape
        want = depth[..., ::STRIDE, ::STRIDE].astype(np.int32)
        np.testing.assert_array_equal(d.numpy(), want)
        assert float(scale) == pytest.approx(1e-3)


def _run(system, world):
    _, seq, gray8, depth16 = world
    stats = [system.track_rgbd(gray8[i], depth16[i], float(seq.timestamps[i]))
             for i in range(N_FRAMES)]
    est = np.stack([-R.T @ t for _, R, t in system.trajectory])
    return stats, est


def test_strided_system_matches_jax(world, stride_configs):
    jcfg, tcfg = stride_configs
    seq = world[1]
    tsys = System(tcfg, device="cpu")
    (sj, ej), (st, et) = _run(JSystem(jcfg), world), _run(tsys, world)
    assert all(s.state == "OK" for s in sj + st)
    # every frame after the first went through the strided fused step
    assert tsys.tracker.dispatches == N_FRAMES - 1
    gt = seq.t_wc[:N_FRAMES]
    ate_j, ate_t = jate(ej, gt), ate_rmse(et, gt)
    assert abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), (ate_t, ate_j)
    assert ate_t < 0.02, ate_t
