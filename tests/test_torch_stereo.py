"""Stereo SLAM in the port against the JAX package, JAX on the CPU and the
port with CPU tensors: ``match_stereo`` (ops/stereo.py), the stereo
branch of the fused frame build and of the host-built frame, and
``System.track_stereo`` on the 320x240 stereo world of
``tests/test_stereo_detector_cli.py`` (baseline 0.2 m).

Images are uint8, as the System receives them: on uint8-valued images
the SAD sums are exact integers in float32, so given the same keypoints
the matcher is bit-equal. Extraction differs from JAX's in about one
descriptor in 1000 (ROADMAP, Queue 3), so frames are compared on the
slots where both extractions agree, and System runs by their decisions
as the RGB-D tests do. Tolerances: ``match_stereo`` bit-equal on JAX's
keypoints, its depth against the ground truth to
``tests/test_synthetic_stereo.py``'s bounds; the frame builds bit-equal
in u_right, depth, descriptors and validity where the extractions agree
(undistorted xy to 1e-3 px); the System per frame: every frame OK, no
decision flipped in the first half of the run, ATE within max(1 mm, 20%)
of JAX's and under the JAX test's 3 cm. The chunked moving-object scene
is tests/test_torch_stereo_chunk.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_dynamic_tpu.config import ORBConfig as JORB
from slam_dynamic_tpu.frontend import fused as jfused
from slam_dynamic_tpu.frontend.extractor import extract_np
from slam_dynamic_tpu.frontend.frame import build_frame as jbuild_frame
from slam_dynamic_tpu.io.evo import ate_rmse as jate
from slam_dynamic_tpu.io.synthetic import SynthConfig, generate
from slam_dynamic_tpu.ops.stereo import match_stereo as jmatch
from slam_dynamic_tpu.system import System as JSystem
from slam_dynamic_tpu.system import intrinsics_from_config as jintr
from slam_dynamic_tpu_torch.frontend import fused as tfused
from slam_dynamic_tpu_torch.frontend.extractor import Keypoints
from slam_dynamic_tpu_torch.frontend.frame import build_frame
from slam_dynamic_tpu_torch.io.evo import ate_rmse
from slam_dynamic_tpu_torch.ops.stereo import match_stereo
from slam_dynamic_tpu_torch.system import System, intrinsics_from_config
from torch_port_util import SMALL, configs, to_t

N_FRAMES = 18
SF = np.float32(1.2)


def _u8(a):
    return np.clip(a, 0, 255).astype(np.uint8)


def _keypoints(k) -> Keypoints:
    """A JAX Keypoints -> the port's (uint32 descriptors as int32)."""
    return Keypoints(*(to_t(getattr(k, f)) for f in Keypoints._fields))


def test_match_stereo_bit_equal_on_jax_keypoints():
    scfg = SynthConfig(n_frames=1, stereo=True, baseline=0.3)
    seq = generate(scfg)
    left = _u8(seq.gray[0]).astype(np.float32)
    right = _u8(seq.right[0]).astype(np.float32)
    orb = JORB(n_features=800)
    kl, kr = extract_np(left, orb), extract_np(right, orb)
    bf = scfg.baseline * scfg.fx
    sl = jnp.asarray(SF) ** kl.level.astype(jnp.float32)
    sr = jnp.asarray(SF) ** kr.level.astype(jnp.float32)
    sj = jmatch(jnp.asarray(left), jnp.asarray(right), kl, kr, bf, 0.3, sl,
                sr)
    st = match_stereo(to_t(left), to_t(right), _keypoints(kl),
                      _keypoints(kr), bf, 0.3, to_t(sl), to_t(sr))
    for name in ("u_right", "depth", "valid"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)), name)
    ok = st.valid.numpy()
    assert ok.sum() > 150, ok.sum()
    xy = np.asarray(kl.xy)[ok]
    gt = seq.depth[0][np.clip(xy[:, 1].astype(int), 0, 479),
                      np.clip(xy[:, 0].astype(int), 0, 639)]
    rel = np.abs(st.depth.numpy()[ok] - gt) / gt
    assert np.median(rel) < 0.03, np.median(rel)
    assert (rel < 0.1).mean() > 0.8


@pytest.fixture(scope="module")
def stereo_world():
    scfg = SynthConfig(**{**SMALL, "n_frames": N_FRAMES}, stereo=True,
                       baseline=0.2)
    seq = generate(scfg)
    return scfg, seq, _u8(seq.gray), _u8(seq.right)


def _check_frames_agree(fj, ft):
    """Bit-equal depth where both extractions agree; xy to 1e-3 px."""
    dj = np.asarray(fj.desc).view(np.int32)
    agree = ((np.asarray(fj.valid) == ft.valid.numpy())
             & (dj == ft.desc.numpy()).all(1)
             & (np.asarray(fj.xy_raw) == ft.xy_raw.numpy()).all(1)
             & (np.asarray(fj.level) == ft.level.numpy()))
    assert agree.mean() >= 0.99, agree.mean()
    for name in ("ur", "depth", "valid", "static_mask"):
        np.testing.assert_array_equal(getattr(ft, name).numpy()[agree],
                                      np.asarray(getattr(fj, name))[agree],
                                      name)
    np.testing.assert_allclose(ft.xy.numpy()[agree],
                               np.asarray(fj.xy)[agree], atol=1e-3)
    assert (ft.depth.numpy() > 0).sum() > 300


def test_stereo_frame_builds_match_jax(stereo_world):
    scfg, _, gray8, right8 = stereo_world
    jcfg, tcfg = (c.replace(sensor="stereo") for c in configs(scfg))
    jcam, tcam = jintr(jcfg), intrinsics_from_config(tcfg, "cpu")
    build = jax.jit(jfused.build_frame_data, static_argnames=(
        "orb_cfg", "height", "width", "sensor", "n_slots", "depth_stride"))
    for i in (0, 7):
        fj = build(jcam, jnp.asarray(gray8[i]), jnp.asarray(right8[i]),
                   jnp.full((16, 4), -1.0), jnp.zeros(16, bool),
                   orb_cfg=jcfg.orb, height=240, width=320,
                   scale_factor=jnp.float32(SF), sensor="stereo",
                   n_slots=1024)
        ft = tfused.build_frame_data(
            tcam, torch.from_numpy(gray8[i]), torch.from_numpy(right8[i]),
            torch.full((16, 4), -1.0), torch.zeros(16, dtype=torch.bool),
            tcfg.orb, torch.tensor(SF), "stereo", n_slots=1024)
        _check_frames_agree(fj, ft)
        # the host-built frame of a non-OK state
        _check_frames_agree(
            jbuild_frame(jcfg, jcam, gray8[i], i, 0.0, right=right8[i]).data,
            build_frame(tcfg, tcam, gray8[i], i, 0.0, right=right8[i]).data)


def _run_per_frame(system, world):
    _, seq, gray8, right8 = world
    stats = [system.track_stereo(gray8[i], right8[i],
                                 float(seq.timestamps[i]))
             for i in range(N_FRAMES)]
    est = np.stack([-R.T @ t for _, R, t in system.trajectory])
    return stats, est


def _first_flip(dj, dt):
    return next((i for i, (a, b) in enumerate(zip(dj, dt)) if a != b),
                len(dj))


@pytest.fixture(scope="module")
def per_frame_runs(stereo_world):
    scfg = stereo_world[0]
    jcfg, tcfg = (c.replace(sensor="stereo") for c in configs(scfg))
    tsys = System(tcfg, device="cpu")
    return {"jax": _run_per_frame(JSystem(jcfg), stereo_world),
            "port": _run_per_frame(tsys, stereo_world), "system": tsys}


def test_stereo_per_frame_decisions_match_jax(per_frame_runs):
    assert per_frame_runs["system"].tracker.stereo_obs
    dj, dt = ([(s.frame_id, s.state, s.is_keyframe) for s in
               per_frame_runs[k][0]] for k in ("jax", "port"))
    assert all(d[1] == "OK" for d in dj + dt)
    upto = _first_flip(dj, dt)
    assert upto >= N_FRAMES // 2, (upto, dj, dt)
    assert sum(d[2] for d in dt) >= 2


def test_stereo_per_frame_ate_tracks_jax(per_frame_runs, stereo_world):
    gt = stereo_world[1].t_wc[:N_FRAMES]
    ate_j = jate(per_frame_runs["jax"][1], gt)
    ate_t = ate_rmse(per_frame_runs["port"][1], gt)
    assert abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), (ate_t, ate_j)
    assert ate_t < 0.03       # the JAX test's bound
