"""Pinhole camera model: projection, unprojection, radial-tangential
(un)distortion and frustum checks, batched over leading dimensions.

Port of ``slam_dynamic_tpu/utils/camera.py`` (``Intrinsics`` :16,
``project`` :57, ``project_stereo`` :68, ``backproject`` :78,
``undistort_points`` :95, ``undistorted_bounds`` :114, ``in_frustum``
:125).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device


class Intrinsics(NamedTuple):
    """Pinhole + radial-tangential distortion + stereo baseline.

    Every coefficient is a 0-d float32 tensor on the System's device;
    ``bf`` is baseline*fx (metres*px), 0 for mono.
    """

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    k3: torch.Tensor
    bf: torch.Tensor
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
               bf=0.0, width=640, height=480, device=None):
        device = resolve_device(device)

        def f(v):
            return torch.tensor(float(v), dtype=torch.float32, device=device)
        return Intrinsics(f(fx), f(fy), f(cx), f(cy), f(k1), f(k2), f(p1),
                          f(p2), f(k3), f(bf), int(width), int(height))

    @property
    def K(self):
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, z, self.cx], -1),
            torch.stack([z, self.fy, self.cy], -1),
            torch.stack([z, z, o], -1),
        ], -2)

    @property
    def baseline(self):
        return self.bf / self.fx


def _safe_z(z):
    return torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: Intrinsics, xc):
    """Camera-frame points (..., 3) -> undistorted pixels (..., 2)."""
    zs = _safe_z(xc[..., 2])
    u = cam.fx * xc[..., 0] / zs + cam.cx
    v = cam.fy * xc[..., 1] / zs + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: Intrinsics, xc):
    """(..., 3) -> (u, v, u_right) as in EdgeStereoSE3ProjectXYZ."""
    zs = _safe_z(xc[..., 2])
    u = cam.fx * xc[..., 0] / zs + cam.cx
    v = cam.fy * xc[..., 1] / zs + cam.cy
    return torch.stack([u, v, u - cam.bf / zs], dim=-1)


def backproject(cam: Intrinsics, uv, depth):
    """Pixels (..., 2) + depth (...,) -> camera-frame points (..., 3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def distort_normalized(cam: Intrinsics, xn):
    """Apply radial-tangential distortion to normalized coords (..., 2)."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: Intrinsics, uv, iters: int = 8):
    """Undistort pixel keypoints by a fixed number of fixed-point steps."""
    xd = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    x = xd
    for _ in range(iters):
        x = x + (xd - distort_normalized(cam, x))
    return torch.stack([cam.fx * x[..., 0] + cam.cx,
                        cam.fy * x[..., 1] + cam.cy], dim=-1)


def undistorted_bounds(cam: Intrinsics):
    """Undistorted image bounds (minx, maxx, miny, maxy) from the corners,
    as in Frame::ComputeImageBounds; each a 0-d tensor."""
    corners = torch.tensor(
        [[0.0, 0.0], [cam.width, 0.0], [0.0, cam.height],
         [cam.width, cam.height]], dtype=torch.float32, device=cam.fx.device)
    und = undistort_points(cam, corners)
    return (torch.minimum(und[0, 0], und[2, 0]),
            torch.maximum(und[1, 0], und[3, 0]),
            torch.minimum(und[0, 1], und[1, 1]),
            torch.maximum(und[2, 1], und[3, 1]))


def in_frustum(cam: Intrinsics, R_cw, t_cw, xw, bounds, min_z=0.0):
    """Frustum visibility of world points [..., 3] from the pose (R_cw,
    t_cw): (visible mask, uv, depth). The view-angle and scale checks are
    the caller's (they need each landmark's normal), as the reference's
    Frame::isInFrustum splits them."""
    xc = torch.einsum("ij,...j->...i", R_cw, xw) + t_cw
    z = xc[..., 2]
    uv = project(cam, xc)
    minx, maxx, miny, maxy = bounds
    ok = ((z > min_z) & (uv[..., 0] >= minx) & (uv[..., 0] < maxx)
          & (uv[..., 1] >= miny) & (uv[..., 1] < maxy))
    return ok, uv, z
