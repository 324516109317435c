"""Monocular SLAM in the port against the JAX package, JAX on the CPU and
the port with CPU tensors: the two-view reconstruction
(ops/twoview.py), the median of the scale normalization, the bootstrap
``try_initialize`` (frontend/initializer.py), the mono keyframe's
landmark creation (``create_new_landmarks``) and ``System.track_mono``
on the 320x240 world of ``tests/test_e2e_slam.py``'s mono test (30
frames, advance 0.04 m, sway 0.5).

Tolerances. ``reconstruct`` from the same model and inlier mask (JAX's
RANSAC fit of ``tests/test_twoview.py``'s scenes): the same ``ok`` and
good mask, (R, t) within 1e-4, points within 1e-4 relative; the SVDs may
order and sign the candidates differently, so only the chosen motion is
compared. The median of an even count is the mean of the two middle
values, bit-equal with ``jnp.nanmedian``. ``try_initialize`` with JAX's
minimal sets injected: ``ok``, the match count, ``idx2`` and ``good``
equal, R2, t2 and the points within 1e-4. ``create_new_landmarks`` on
the map JAX's run held before each of its mono keyframes' calls: the
same new landmark slots and bindings, positions within 1e-4. The
System, the port's bootstrap drawing JAX's minimal sets: initialized at
the same frame as JAX, at least 25 of 30 frames OK, both Sim3-aligned
ATEs under 0.15 m (the JAX test's bound) and the port's within
max(1 mm, 20%) of JAX's; chunked (``track_chunk`` with no aux, C = 6,
one chunk in flight), the same states in both packages, every frame the
chunks cover OK, and the same ATE bounds."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_dynamic_tpu.backend import triangulation as jtri
from slam_dynamic_tpu.frontend.frame import build_frame as jbuild_frame
from slam_dynamic_tpu.frontend.initializer import try_initialize as jinit
from slam_dynamic_tpu.io.evo import ate_rmse as jate
from slam_dynamic_tpu.io.synthetic import SynthConfig, generate
from slam_dynamic_tpu.ops import ransac as jr
from slam_dynamic_tpu.ops.twoview import reconstruct as jreconstruct
from slam_dynamic_tpu.system import System as JSystem
from slam_dynamic_tpu.system import intrinsics_from_config as jintr
from slam_dynamic_tpu.utils import se3
from slam_dynamic_tpu.utils.camera import Intrinsics as JIntrinsics
from slam_dynamic_tpu.utils.camera import project as jproject
from slam_dynamic_tpu.worldmap.state import MapState as JMapState
from slam_dynamic_tpu_torch.backend.triangulation import create_new_landmarks
from slam_dynamic_tpu_torch.convert import map_state_from_numpy
from slam_dynamic_tpu_torch.frontend.initializer import try_initialize
from slam_dynamic_tpu_torch.io.evo import ate_rmse
from slam_dynamic_tpu_torch.ops.twoview import reconstruct
from slam_dynamic_tpu_torch.system import System, intrinsics_from_config
from slam_dynamic_tpu_torch.utils.camera import Intrinsics
from slam_dynamic_tpu_torch.worldmap.keyframe_ops import nanmedian_last
from torch_port_util import (SMALL, configs, frame_to_t, jax_init_samples,
                             map_arrays, run_chunked, to_t, with_tracking)

N_FRAMES = 30
CAM = dict(fx=400.0, fy=400.0, cx=160.0, cy=120.0, width=320, height=240)


def _views(pts, xi):
    jcam = JIntrinsics.create(**CAM)
    R2, t2 = [np.asarray(v) for v in se3.se3_exp(jnp.asarray(xi))]
    uv1 = np.asarray(jproject(jcam, jnp.asarray(pts)), np.float32)
    uv2 = np.asarray(jproject(jcam, jnp.asarray(pts @ R2.T + t2)),
                     np.float32)
    return uv1, uv2


@pytest.mark.parametrize("homography", [False, True])
def test_reconstruct_matches_jax(rng, homography):
    """tests/test_twoview.py's general (F) and planar (H) scenes."""
    n = 200
    x, y = rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n)
    if homography:
        pts = np.stack([x, y, 5.0 + 0.3 * x - 0.2 * y], 1)
        xi = np.array([0.4, 0.03, 0.02, 0.01, 0.04, 0.0], np.float32)
    else:
        pts = np.stack([x, y, rng.uniform(3, 9, n)], 1)
        xi = np.array([0.4, 0.05, 0.02, 0.01, 0.06, 0.0], np.float32)
    uv1, uv2 = _views(pts.astype(np.float32), xi)
    mask = jnp.ones(n, bool)
    fit = (jr.fit_homography if homography else jr.fit_fundamental)(
        jnp.asarray(uv1), jnp.asarray(uv2), mask, jax.random.PRNGKey(1),
        thresh_px=2.0)
    rj = jreconstruct(JIntrinsics.create(**CAM), fit.M, jnp.asarray(uv1),
                      jnp.asarray(uv2), fit.inliers,
                      use_homography=homography)
    rt = reconstruct(Intrinsics.create(**CAM, device="cpu"), to_t(fit.M),
                     to_t(uv1), to_t(uv2), to_t(fit.inliers),
                     use_homography=homography)
    assert bool(rt.ok) == bool(rj.ok) and bool(rt.ok)
    good = np.asarray(rj.good)
    np.testing.assert_array_equal(rt.good.numpy(), good)
    assert good.sum() > 150
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)
    np.testing.assert_allclose(rt.points.numpy()[good],
                               np.asarray(rj.points)[good], rtol=1e-4,
                               atol=1e-5)


def test_median_of_an_even_count_matches_jax(rng):
    x = rng.normal(1.0, 0.3, (4, 64)).astype(np.float32)
    x[0, ::3] = np.nan          # 42 values left: an even count
    x[1, 1::2] = np.nan         # 32
    x[2, 5:] = np.nan           # 5: an odd count
    x[3] = np.nan               # none
    got = nanmedian_last(to_t(x)).numpy()
    want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(got[:3], want[:3])
    assert np.isnan(got[3]) and np.isnan(want[3])
    # the lower middle value, as torch.nanmedian takes it, differs
    assert got[0] != torch.nanmedian(to_t(x[0])).item()


@pytest.fixture(scope="module")
def mono_world():
    scfg = SynthConfig(**{**SMALL, "n_frames": N_FRAMES}, advance=0.04,
                       sway=0.5)
    seq = generate(scfg)
    return scfg, seq, np.clip(seq.gray, 0, 255).astype(np.uint8)


def test_try_initialize_with_jax_samples_matches_jax(mono_world):
    scfg, _, gray8 = mono_world
    jcfg, tcfg = (c.replace(sensor="mono") for c in configs(scfg))
    jcam, tcam = jintr(jcfg), intrinsics_from_config(tcfg, "cpu")
    ref = jbuild_frame(jcfg, jcam, gray8[0], 0, 0.0).data
    cur = jbuild_frame(jcfg, jcam, gray8[3], 3, 0.1).data
    seed = 7
    ij = jinit(jcam, ref, cur, seed=seed, min_matches=75)
    it = try_initialize(tcam, frame_to_t(ref), frame_to_t(cur), seed=seed,
                        min_matches=75,
                        sample_fn=functools.partial(jax_init_samples, seed))
    assert bool(it.ok) == bool(ij.ok) and bool(it.ok)
    assert int(it.n_matches) == int(ij.n_matches) > 75
    good = np.asarray(ij.good)
    np.testing.assert_array_equal(it.good.numpy(), good)
    assert good.sum() > 50
    np.testing.assert_array_equal(it.idx2.numpy()[good],
                                  np.asarray(ij.idx2)[good])
    np.testing.assert_allclose(it.R2.numpy(), np.asarray(ij.R2), atol=1e-4)
    np.testing.assert_allclose(it.t2.numpy(), np.asarray(ij.t2), atol=1e-4)
    np.testing.assert_allclose(it.points.numpy()[good],
                               np.asarray(ij.points)[good], rtol=1e-4,
                               atol=1e-4)


def _run_mono(system, world, ate_fn):
    """States of the 30 frames and the Sim3-aligned ATE of the frames
    tracked from the first keyframe's on (the reference frame held
    before the bootstrap has no pose)."""
    _, seq, gray8 = world
    states = [system.track_mono(gray8[i], float(seq.timestamps[i])).state
              for i in range(N_FRAMES)]
    traj = system.trajectory
    est = np.stack([-R.T @ t for _, R, t in traj])
    i0 = N_FRAMES - len(traj)
    ate = ate_fn(est, seq.t_wc[i0:i0 + len(est)], with_scale=True)
    return dict(states=states, ate=ate, system=system)


@pytest.fixture(scope="module")
def mono_runs(mono_world):
    """Both Systems on the mono world, the port's bootstrap drawing JAX's
    H and F minimal sets, so both start from the same two-view solution;
    the JAX run keeps the map and slot of each of its
    ``create_new_landmarks`` calls."""
    jcfg, tcfg = (c.replace(sensor="mono") for c in configs(mono_world[0]))
    calls = []
    orig = jtri.create_new_landmarks

    def record(m, cam, k, sf, **kw):
        calls.append((map_arrays(m), k, sf, kw))
        return orig(m, cam, k, sf, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtri, "create_new_landmarks", record)
        rj = _run_mono(JSystem(jcfg), mono_world, jate)
    rj["calls"] = calls
    ts = System(tcfg, device="cpu")
    ts.tracker.init_sample_fn = jax_init_samples
    return {"jax": rj, "port": _run_mono(ts, mono_world, ate_rmse)}


def test_mono_system_tracks_jax(mono_runs):
    sj, st = mono_runs["jax"]["states"], mono_runs["port"]["states"]
    assert not mono_runs["port"]["system"].tracker.stereo_obs
    assert st.index("OK") == sj.index("OK")
    assert st.count("OK") >= 25 and sj.count("OK") >= 25
    ate_j, ate_t = mono_runs["jax"]["ate"], mono_runs["port"]["ate"]
    print(f"mono Sim3-aligned ATE: port {ate_t:.4f} m, JAX {ate_j:.4f} m")
    assert ate_t < 0.15 and ate_j < 0.15, (ate_t, ate_j)
    assert abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), (ate_t, ate_j)


def test_create_new_landmarks_matches_jax(mono_runs, mono_world):
    calls = mono_runs["jax"]["calls"]
    assert calls
    jcfg, tcfg = (c.replace(sensor="mono") for c in configs(mono_world[0]))
    jcam, tcam = jintr(jcfg), intrinsics_from_config(tcfg, "cpu")
    n_new = 0
    for arrays, k, sf, kw in calls:
        mj = jtri.create_new_landmarks(
            JMapState(**{f: jnp.asarray(a) for f, a in arrays.items()}),
            jcam, k, sf, **kw)
        mt = create_new_landmarks(map_state_from_numpy(arrays, "cpu"), tcam,
                                  k, sf, **kw)
        n0, n1 = int(arrays["n_lm"]), int(mj.n_lm)
        assert int(mt.n_lm) == n1
        np.testing.assert_array_equal(mt.kf_obs_lm.numpy(),
                                      np.asarray(mj.kf_obs_lm))
        np.testing.assert_array_equal(mt.lm_valid.numpy(),
                                      np.asarray(mj.lm_valid))
        np.testing.assert_allclose(mt.lm_pos.numpy()[n0:n1],
                                   np.asarray(mj.lm_pos)[n0:n1], rtol=1e-4,
                                   atol=1e-4)
        n_new += n1 - n0
    assert n_new > 50


def test_mono_chunked_tracks(mono_world):
    """track_chunk(grays, None, ts) after the per-frame bootstrap, in both
    packages (the port drawing JAX's bootstrap samples): the same states,
    every frame the chunks cover OK, and the port's Sim3-aligned ATE
    within max(1 mm, 20%) of JAX's, both under 0.15 m."""
    scfg, seq, gray8 = mono_world
    jcfg, tcfg = (with_tracking(c.replace(sensor="mono"), pipeline_depth=1)
                  for c in configs(scfg))
    ts = System(tcfg, device="cpu")
    ts.tracker.init_sample_fn = jax_init_samples
    ates, states = {}, {}
    for name, system, ate_fn in (("jax", JSystem(jcfg), jate),
                                 ("port", ts, ate_rmse)):
        r = run_chunked(system, (scfg, seq, gray8, None), N_FRAMES)
        states[name] = [s.state for s in r["stats"]]
        assert r["n_chunks"] >= 3
        i0 = len(states[name]) - len(r["est"])
        ates[name] = ate_fn(r["est"], seq.t_wc[i0:i0 + len(r["est"])],
                            with_scale=True)
    print(f"mono chunked Sim3-aligned ATE: port {ates['port']:.4f} m, "
          f"JAX {ates['jax']:.4f} m")
    st = states["port"]
    first = st.index("OK")
    assert st == states["jax"] and len(st) >= 25
    assert st[first:] == ["OK"] * (len(st) - first)
    assert ates["port"] < 0.15 and ates["jax"] < 0.15
    assert abs(ates["port"] - ates["jax"]) <= max(1e-3, 0.2 * ates["jax"])
