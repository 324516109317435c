"""Pose optimization and local BA of the port against the JAX package on
the same seeded problems. Tolerance: R and t within atol 1e-4 and equal
inlier masks for optimize_pose (float32 sums in another order); BA poses
and points within atol 1e-3 after 15 damped GN steps. On CPU tensors
optimize_pose is the plain loop, bit for bit; the pose LM's op (kernel
K3) refuses them."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_dynamic_tpu.optim import local_ba as jba
from slam_dynamic_tpu.optim.pose_opt import optimize_pose as jopt
from slam_dynamic_tpu.optim.residuals import reprojection_terms as jterms
from slam_dynamic_tpu.utils import camera as jcam
from slam_dynamic_tpu.utils import se3 as jse3
from slam_dynamic_tpu_torch.kernel_bench import k3_problem
from slam_dynamic_tpu_torch.optim import local_ba as tba
from slam_dynamic_tpu_torch.optim import pose_opt as tpo
from slam_dynamic_tpu_torch.optim.pose_opt import optimize_pose as topt
from slam_dynamic_tpu_torch.optim.residuals import \
    reprojection_terms as tterms
from slam_dynamic_tpu_torch.utils import camera as tcam

KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0, width=640,
          height=480)
JCAM, TCAM = jcam.Intrinsics.create(**KW), tcam.Intrinsics.create(**KW, device="cpu")
T = torch.from_numpy


def _problem(seed, n=300, n_out=60, stereo=False):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                    rng.uniform(4, 12, n)], 1).astype(np.float32)
    xi = np.concatenate([rng.normal(0, 0.3, 3), rng.normal(0, 0.1, 3)])
    R, t = jse3.se3_exp(jnp.asarray(xi, jnp.float32))
    proj = jcam.project_stereo if stereo else jcam.project
    obs = np.array(proj(JCAM, jse3.se3_apply(R, t, jnp.asarray(pts))))
    obs += rng.normal(0, 0.5, obs.shape).astype(np.float32)
    idx = rng.choice(n, n_out, replace=False)
    obs[idx, :2] += rng.uniform(30, 120, (n_out, 2)) * rng.choice(
        [-1, 1], (n_out, 2))
    dxi = np.concatenate([rng.normal(0, 0.15, 3), rng.normal(0, 0.05, 3)])
    R0, t0 = jse3.se3_retract(R, t, jnp.asarray(dxi, jnp.float32))
    inv_s2 = (1.2 ** (-2.0 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.uniform(size=n) < 0.95
    urw = (rng.uniform(size=n) < 0.8).astype(np.float32)
    return (np.array(R0), np.array(t0), pts, obs.astype(np.float32), inv_s2,
            valid, urw)


@pytest.mark.parametrize("stereo", [False, True])
def test_reprojection_terms_match(stereo):
    R0, t0, pts, obs, inv_s2, _, urw = _problem(1, stereo=stereo)
    j = jterms(JCAM, R0, t0, pts, obs, inv_s2, stereo,
               urw if stereo else None)
    t = tterms(TCAM, T(R0), T(t0), T(pts), T(obs), T(inv_s2), stereo,
               T(urw) if stereo else None)
    for a, b in zip(j, t):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("stereo,rounds,iters", [(False, 4, 10),
                                                 (True, 4, 10),
                                                 (True, 2, 6)])
def test_optimize_pose_matches(stereo, rounds, iters):
    R0, t0, pts, obs, inv_s2, valid, urw = _problem(2, stereo=stereo)
    kw = dict(stereo=stereo, rounds=rounds, iters=iters)
    rj = jopt(JCAM, R0, t0, pts, obs, inv_s2, valid,
              ur_weight=urw if stereo else None, **kw)
    rt = topt(TCAM, T(R0), T(t0), T(pts), T(obs), T(inv_s2), T(valid),
              ur_weight=T(urw) if stereo else None, **kw)
    np.testing.assert_allclose(np.asarray(rj.R), rt.R.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(rj.t), rt.t.numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(rj.inliers), rt.inliers.numpy())
    assert int(rj.n_inliers) == int(rt.n_inliers) > 150


@pytest.mark.parametrize("stereo", [False, True])
def test_optimize_pose_on_cpu_is_the_plain_loop(stereo):
    R0, t0, pts, obs, inv_s2, valid, urw = _problem(2, stereo=stereo)
    args = (TCAM, T(R0), T(t0), T(pts), T(obs), T(inv_s2), T(valid))
    kw = dict(stereo=stereo, rounds=2, iters=6,
              ur_weight=T(urw) if stereo else None)
    got, ref = topt(*args, **kw), tpo.optimize_pose_plain(*args, **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("vmapped", [False, True])
def test_pose_lm_op_refuses_cpu_tensors(vmapped):
    """K3's op, alone and through its vmap rule, takes CUDA tensors only:
    on CPU tensors it raises before any build or launch (optimize_pose
    sends those to the plain loop)."""
    p = k3_problem(np.random.default_rng(0), 64, 3, 0.3)
    cam, urw, two_lanes = p[0], p[7], [torch.stack([x, x]) for x in p[1:7]]
    before = tpo.launches
    with pytest.raises(ValueError, match="CUDA"):
        if vmapped:
            torch.func.vmap(
                lambda *a: tpo.pose_lm(cam, *a, urw, 2, 6, 7.815))(*two_lanes)
        else:
            tpo.pose_lm(*p, 2, 6, 7.815)
    assert tpo.launches == before


def test_invert3x3_matches():
    rng = np.random.default_rng(3)
    M = rng.normal(size=(64, 3, 3)).astype(np.float32) + 3 * np.eye(3,
                                                                    dtype=np.float32)
    np.testing.assert_allclose(np.asarray(jba.invert3x3(jnp.asarray(M))),
                               tba.invert3x3(T(M)).numpy(), rtol=1e-5,
                               atol=1e-5)


def _ba_problem(seed, K=4, L=120):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L),
                    rng.uniform(4, 9, L)], 1).astype(np.float32)
    Rs, ts = [], []
    for k in range(K):
        xi = np.concatenate([[0.15 * k, 0.02 * k, 0.0], [0.0, 0.01 * k, 0.0]])
        R, t = jse3.se3_exp(jnp.asarray(xi, jnp.float32))
        Rs.append(np.array(R)); ts.append(np.array(t))
    obs_kf, obs_lm, uv = [], [], []
    for k in range(K):
        p = np.array(jcam.project_stereo(JCAM, jse3.se3_apply(
            Rs[k], ts[k], jnp.asarray(pts))))
        obs_kf += [k] * L
        obs_lm += list(range(L))
        uv.append(p + rng.normal(0, 0.3, p.shape))
    uv = np.concatenate(uv).astype(np.float32)
    O = len(obs_kf)
    kf_R = np.stack(Rs)
    kf_t = np.stack(ts) + rng.normal(0, 0.02, (K, 3)).astype(np.float32)
    kf_t[0] = ts[0]
    arrays = dict(
        kf_R=kf_R, kf_t=kf_t.astype(np.float32),
        kf_fixed=np.arange(K) == 0, kf_valid=np.ones(K, bool),
        points=(pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32),
        lm_valid=np.ones(L, bool), obs_kf=np.array(obs_kf, np.int32),
        obs_lm=np.array(obs_lm, np.int32), obs_uv=uv,
        obs_inv_sigma2=np.ones(O, np.float32),
        obs_valid=rng.uniform(size=O) < 0.95,
        obs_ur_weight=(rng.uniform(size=O) < 0.8).astype(np.float32))
    return arrays


def test_bundle_adjust_matches():
    a = _ba_problem(4)
    pj = jba.BAProblem(**{k: jnp.asarray(v) for k, v in a.items()})
    tp = {k: T(v) for k, v in a.items()}
    tp["obs_kf"] = tp["obs_kf"].long()
    tp["obs_lm"] = tp["obs_lm"].long()
    rj = jba.bundle_adjust(JCAM, pj, stereo=True)
    rt = tba.bundle_adjust(TCAM, tba.BAProblem(**tp), stereo=True)
    np.testing.assert_allclose(np.asarray(rj.kf_R), rt.kf_R.numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(rj.kf_t), rt.kf_t.numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(rj.points), rt.points.numpy(),
                               atol=1e-3)
    agree = (np.asarray(rj.obs_inlier) == rt.obs_inlier.numpy()).mean()
    assert agree >= 0.99, agree
