"""utils/se3.py and utils/camera.py of the port against the JAX package
on the same seeded inputs (atol 1e-5, float32 rounding of the two
frameworks' kernels), small-angle branches included."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_dynamic_tpu.utils import camera as jcam
from slam_dynamic_tpu.utils import se3 as jse3
from slam_dynamic_tpu_torch.utils import camera as tcam
from slam_dynamic_tpu_torch.utils import se3 as tse3

ATOL = 1e-5


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=atol, rtol=0)


def _twists(rng, n, scale):
    xi = np.concatenate([rng.normal(0, 0.5, (n, 3)),
                         rng.normal(0, scale, (n, 3))], 1)
    return xi.astype(np.float32)


SCALES = [1e-6, 1e-3, 0.3, 1.5]    # rotation magnitudes: Taylor + generic


@pytest.mark.parametrize("scale", SCALES)
def test_so3_exp_and_log(scale):
    phi = _twists(np.random.default_rng(0), 64, scale)[:, 3:]
    Rj = jse3.so3_exp(jnp.asarray(phi))
    Rt = tse3.so3_exp(torch.from_numpy(phi))
    _close(Rj, Rt)
    _close(jse3.so3_log(Rj), tse3.so3_log(torch.from_numpy(np.array(Rj))))


@pytest.mark.parametrize("scale", SCALES)
def test_se3_exp_log_retract(scale):
    rng = np.random.default_rng(1)
    xi = _twists(rng, 64, scale)
    Rj, tj = jse3.se3_exp(jnp.asarray(xi))
    Rt, tt = tse3.se3_exp(torch.from_numpy(xi))
    _close(Rj, Rt)
    # just above the 1e-4 Taylor switch, the left Jacobian's
    # (1 - cos t) / t^2 cancels in float32 in both packages, and XLA's and
    # PyTorch's cos round differently there: translations agree to 1e-4
    t_atol = 1e-4 if scale == 1e-3 else ATOL
    _close(tj, tt, atol=t_atol)
    _close(jse3.se3_log(Rj, tj), tse3.se3_log(torch.from_numpy(np.array(
        Rj)), torch.from_numpy(np.array(tj))), atol=1e-4)
    dxi = _twists(rng, 64, scale) * 0.1
    Rj2, tj2 = jse3.se3_retract(Rj, tj, jnp.asarray(dxi))
    Rt2, tt2 = tse3.se3_retract(Rt, tt, torch.from_numpy(dxi))
    _close(Rj2, Rt2)
    _close(tj2, tt2, atol=t_atol)


def test_so3_log_near_pi():
    axis = np.array([[1.0, 2.0, -0.5], [0.0, 0.0, 1.0]], np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    phi = (axis * (np.pi - 1e-5)).astype(np.float32)
    R = np.array(jse3.so3_exp(jnp.asarray(phi)))
    _close(jse3.so3_log(jnp.asarray(R)), tse3.so3_log(torch.from_numpy(R)),
           atol=1e-3)


def test_quaternions_and_orthonormalize():
    rng = np.random.default_rng(2)
    R = np.array(jse3.so3_exp(jnp.asarray(_twists(rng, 64, 1.0)[:, 3:])))
    R_noisy = (R + rng.normal(0, 1e-3, R.shape)).astype(np.float32)
    _close(jse3.quat_from_rot(jnp.asarray(R)),
           tse3.quat_from_rot(torch.from_numpy(R)))
    _close(jse3.orthonormalize(jnp.asarray(R_noisy)),
           tse3.orthonormalize(torch.from_numpy(R_noisy)))
    q = rng.normal(size=(16, 4)).astype(np.float32)
    _close(jse3.rot_from_quat(jnp.asarray(q)),
           tse3.rot_from_quat(torch.from_numpy(q)))


def test_compose_inverse_apply():
    rng = np.random.default_rng(3)
    xi = _twists(rng, 2, 0.4)
    Ra, ta = (np.array(a) for a in jse3.se3_exp(jnp.asarray(xi[0])))
    Rb, tb = (np.array(a) for a in jse3.se3_exp(jnp.asarray(xi[1])))
    x = rng.normal(size=(32, 3)).astype(np.float32)
    T = torch.from_numpy
    for j, t in zip(jse3.se3_compose(Ra, ta, Rb, tb),
                    tse3.se3_compose(T(Ra), T(ta), T(Rb), T(tb))):
        _close(j, t)
    for j, t in zip(jse3.se3_inverse(Ra, ta), tse3.se3_inverse(T(Ra), T(ta))):
        _close(j, t)
    _close(jse3.se3_apply(Ra, ta, x), tse3.se3_apply(T(Ra), T(ta), T(x)))


CAMS = [dict(fx=500.0, fy=505.0, cx=320.0, cy=240.0, bf=40.0),
        dict(fx=500.0, fy=505.0, cx=320.0, cy=240.0, k1=-0.2, k2=0.05,
             p1=1e-3, p2=-5e-4, k3=0.01, bf=40.0)]


@pytest.mark.parametrize("kw", CAMS)
def test_camera_projection_family(kw):
    rng = np.random.default_rng(4)
    cj = jcam.Intrinsics.create(width=640, height=480, **kw)
    ct = tcam.Intrinsics.create(width=640, height=480, device="cpu", **kw)
    xc = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200),
                   rng.uniform(0.5, 8, 200)], 1).astype(np.float32)
    T = torch.from_numpy
    _close(jcam.project(cj, xc), tcam.project(ct, T(xc)), atol=1e-3)
    _close(jcam.project_stereo(cj, xc), tcam.project_stereo(ct, T(xc)),
           atol=1e-3)
    uv = rng.uniform(0, 640, (200, 2)).astype(np.float32)
    d = rng.uniform(0.5, 8, 200).astype(np.float32)
    _close(jcam.backproject(cj, uv, d), tcam.backproject(ct, T(uv), T(d)))
    _close(jcam.undistort_points(cj, uv), tcam.undistort_points(ct, T(uv)),
           atol=1e-3)
    for a, b in zip(jcam.undistorted_bounds(cj),
                    tcam.undistorted_bounds(ct)):
        _close(a, b, atol=1e-3)
    _close(cj.K, ct.K)


@pytest.mark.parametrize("kw", CAMS)
def test_in_frustum_matches_jax(kw):
    """``in_frustum`` on points in front, behind and outside the image:
    the same mask, uv and depth."""
    rng = np.random.default_rng(7)
    cj = jcam.Intrinsics.create(width=640, height=480, **kw)
    ct = tcam.Intrinsics.create(width=640, height=480, device="cpu", **kw)
    xw = np.stack([rng.uniform(-6, 6, 300), rng.uniform(-4, 4, 300),
                   rng.uniform(-3, 9, 300)], 1).astype(np.float32)
    xi = np.array([0.05, -0.1, 0.2, 0.1, -0.05, 0.02], np.float32)
    Rj, tj = jse3.se3_exp(jnp.asarray(xi))
    Rt, tt = tse3.se3_exp(torch.from_numpy(xi))
    okj, uvj, zj = jcam.in_frustum(cj, Rj, tj, xw,
                                   jcam.undistorted_bounds(cj), min_z=0.1)
    okt, uvt, zt = tcam.in_frustum(ct, Rt, tt, torch.from_numpy(xw),
                                   tcam.undistorted_bounds(ct), min_z=0.1)
    _close(zj, zt)
    _close(uvj, uvt, atol=1e-3)
    # a point within the rounding of a bound may fall either side
    edge = np.zeros(300, bool)
    for a, b in ((uvj[:, 0], 0), (uvj[:, 1], 1)):
        lo, hi = (jcam.undistorted_bounds(cj)[2 * b],
                  jcam.undistorted_bounds(cj)[2 * b + 1])
        edge |= (np.abs(np.asarray(a) - float(lo)) < 1e-2) \
            | (np.abs(np.asarray(a) - float(hi)) < 1e-2)
    np.testing.assert_array_equal(okt.numpy()[~edge], np.asarray(okj)[~edge])
    assert 0 < okt.sum() < 300
