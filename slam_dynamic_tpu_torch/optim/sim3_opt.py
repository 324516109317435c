"""Relative Sim3 optimization between a keyframe pair (loop verification).

Port of ``slam_dynamic_tpu/optim/sim3_opt.py`` (``Sim3OptResult``,
``_residuals``, ``optimize_sim3`` :43): bidirectional reprojection edges
on one Sim3 vertex, Huber-weighted Levenberg-Marquardt, an outlier cut
half way. The per-pair Jacobians with respect to a left-multiplied 7-dof
twist come from forward-mode autodiff (``torch.func.jacfwd``, JAX's
``jax.jacfwd``), evaluated in float64 (``utils.sim3.float64``).
Accept/reject and the damping update are device selections: the loop
never waits for the device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import jacfwd

from ..utils import sim3 as s3
from ..utils.camera import Intrinsics, project
from .residuals import huber_weight, robust_cost


class Sim3OptResult(NamedTuple):
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _residuals(cam1, cam2, g, x1, x2, uv1, uv2):
    """[N, 4] stacked reprojection residuals (camera 2, then camera 1)
    and both depths."""
    s, R, t = g
    x2p = s * (x1 @ R.T) + t
    r2 = project(cam2, x2p) - uv2
    si, Ri, ti = s3.sim3_inverse(s, R, t)
    x1p = si * (x2 @ Ri.T) + ti
    r1 = project(cam1, x1p) - uv1
    return torch.cat([r2, r1], dim=-1), x2p[:, 2], x1p[:, 2]


def _chi2(r, inv_sigma2_1, inv_sigma2_2):
    return (r[:, :2] ** 2).sum(-1) * inv_sigma2_2 + \
        (r[:, 2:] ** 2).sum(-1) * inv_sigma2_1


def sim3_jacobian(cam1, cam2, g, x1, x2, uv1, uv2, fix_scale: bool):
    """[N, 4, 7] Jacobian of the residuals at g with respect to a
    left-multiplied twist, at the zero twist (float32 out)."""
    cam1, cam2, g, x1, x2, uv1, uv2 = s3.float64(
        (cam1, cam2, g, x1, x2, uv1, uv2))

    def res_of_xi(xi):
        ds, dR, dt = s3.sim3_exp(xi)
        if fix_scale:
            ds = torch.ones_like(ds)
        return _residuals(cam1, cam2, s3.sim3_compose(ds, dR, dt, *g),
                          x1, x2, uv1, uv2)[0]
    return jacfwd(res_of_xi)(torch.zeros(
        7, dtype=torch.float64, device=x1.device)).to(torch.float32)


def optimize_sim3(cam1: Intrinsics, cam2: Intrinsics, s0, R0, t0, x1, x2,
                  uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid,
                  iters: int = 10, chi2_th: float = 9.21,
                  fix_scale: bool = False) -> Sim3OptResult:
    """Refine T21 = (s0, R0, t0) on matched pairs: iters // 2 LM steps,
    an outlier cut at chi2_th (2 dof, 99%), the remaining steps, and the
    inliers at the result."""
    delta = math.sqrt(chi2_th)
    dev, f32 = x1.device, x1.dtype
    iv = torch.stack([inv_sigma2_2, inv_sigma2_2, inv_sigma2_1,
                      inv_sigma2_1], -1)                       # [N, 4]
    eye7 = torch.eye(7, dtype=f32, device=dev)

    def step(g, lam, inlier):
        r, z2, z1 = _residuals(cam1, cam2, g, x1, x2, uv1, uv2)
        chi2 = _chi2(r, inv_sigma2_1, inv_sigma2_2)
        w = inlier * huber_weight(chi2, delta) * (z1 > 0) * (z2 > 0)
        J = sim3_jacobian(cam1, cam2, g, x1, x2, uv1, uv2, fix_scale)
        Jw = J * (w[:, None, None] * iv[:, :, None])
        H = torch.einsum("ndi,ndj->ij", Jw, J) + 1e-8 * eye7
        b = -torch.einsum("ndi,nd->i", Jw, r)
        H = H + lam * torch.diag(torch.diagonal(H))
        xi = torch.linalg.solve(H, b)
        if fix_scale:
            xi = torch.cat([xi[:6], torch.zeros_like(xi[6:])])
        g_new = s3.sim3_compose(*s3.sim3_exp(xi), *g)
        r_new = _residuals(cam1, cam2, g_new, x1, x2, uv1, uv2)[0]
        e_old = (robust_cost(chi2, delta) * inlier).sum()
        e_new = (robust_cost(_chi2(r_new, inv_sigma2_1, inv_sigma2_2),
                             delta) * inlier).sum()
        good = e_new < e_old
        g = tuple(torch.where(good, b2, a) for a, b2 in zip(g, g_new))
        return g, torch.where(good, lam * 0.5, lam * 4.0)

    def inliers_at(g):
        r, z2, z1 = _residuals(cam1, cam2, g, x1, x2, uv1, uv2)
        chi2 = _chi2(r, inv_sigma2_1, inv_sigma2_2)
        return valid & (chi2 <= chi2_th) & (z1 > 0) & (z2 > 0)

    g = (torch.as_tensor(s0, dtype=f32, device=dev).reshape(()), R0, t0)
    lam0 = torch.tensor(1e-3, dtype=f32, device=dev)
    lam, inlier = lam0, valid.to(f32)
    for _ in range(iters // 2):
        g, lam = step(g, lam, inlier)
    # outlier cut, then the rest of the steps
    lam, inlier = lam0, inliers_at(g).to(f32)
    for _ in range(iters - iters // 2):
        g, lam = step(g, lam, inlier)
    inl = inliers_at(g)
    return Sim3OptResult(g[0], g[1], g[2], inl, inl.sum().to(torch.int32))
