"""Perspective-n-Point by batched-hypothesis RANSAC.

Port of ``slam_dynamic_tpu/ops/pnp.py`` (``PnPResult`` :38, ``_dlt_pose``
:45, ``_homography_pose`` :73, ``ransac_pnp`` :120), the pose solver of
relocalization. All minimal sets of 6 correspondences are drawn at once;
each yields a 6-point DLT pose (the projection matrix's nullspace through
``ops/nullspace.py``, projected onto SO(3)) and a planar-homography pose
(the sample's plane, the plane-to-image homography, decomposed with
majority cheirality), so coplanar scenes, where the DLT degenerates, are
covered; both families are scored together against every correspondence
and the best pose is returned (the caller polishes it).

Samples come from ``ops/ransac.sample_indices`` on stream 2 (the H and F
fits use 0 and 1); ``sample_idx`` [n_hyp, 6] replaces the draw, which is
how the parity tests feed JAX's own samples.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.camera import Intrinsics, project
from ..utils.se3 import orthonormalize
from .nullspace import null_vector, smallest_eigvec
from .ransac import sample_indices

PNP_STREAM = 2


class PnPResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _majority_sign(depths):
    """+1 where the depths' signs sum to >= 0, else -1 ([...])."""
    return torch.where(torch.sign(depths).sum(-1) >= 0, 1.0, -1.0)


def _dlt_pose(xw, uv_norm):
    """[..., 6, 3] world points + [..., 6, 2] normalized image coords ->
    (R, t): the DLT projection matrix, its left 3x3 projected onto SO(3)
    and t rescaled with it."""
    X = torch.cat([xw, torch.ones_like(xw[..., :1])], -1)      # [..., 6, 4]
    u, v = uv_norm[..., 0:1], uv_norm[..., 1:2]
    z = torch.zeros_like(X)
    A = torch.cat([torch.cat([X, z, -u * X], -1),
                   torch.cat([z, X, -v * X], -1)], -2)          # [..., 12, 12]
    P = null_vector(A).reshape(A.shape[:-2] + (3, 4))
    # sign: the majority of points in front
    depths = (X @ P[..., 2, :, None])[..., 0]
    P = P * _majority_sign(depths)[..., None, None]
    M = P[..., :3]
    scale = torch.exp(torch.log(torch.clamp(
        torch.linalg.norm(M, dim=-1), min=1e-12)).mean(-1))
    R = orthonormalize(M / scale[..., None, None])
    return R, P[..., 3] / scale[..., None]


def _homography_pose(xw, uv_norm):
    """[..., 6, 3] world points (about coplanar) + [..., 6, 2] normalized
    coords -> (R, t) by plane-induced homography decomposition: with the
    plane frame (c, e1, e2), X = c + a e1 + b e2 projects [a, b, 1] through
    H = [R e1 | R e2 | R c + t] up to scale."""
    c = xw.mean(-2)
    Xc = xw - c[..., None, :]
    e3 = smallest_eigvec(Xc.transpose(-1, -2) @ Xc)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=xw.dtype, device=xw.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=xw.dtype, device=xw.device)
    seed = torch.where(e3[..., 0:1].abs() < 0.9, ex, ey)
    e1 = seed - e3 * (seed * e3).sum(-1, keepdim=True)
    e1 = e1 / torch.clamp(torch.linalg.norm(e1, dim=-1, keepdim=True),
                          min=1e-12)
    e2 = torch.linalg.cross(e3, e1, dim=-1)
    ab = torch.stack([(Xc * e1[..., None, :]).sum(-1),
                      (Xc * e2[..., None, :]).sum(-1)], -1)     # [..., n, 2]
    A1 = torch.cat([ab, torch.ones_like(ab[..., :1])], -1)
    u, v = uv_norm[..., 0:1], uv_norm[..., 1:2]
    z = torch.zeros_like(A1)
    rows = torch.cat([torch.cat([A1, z, -u * A1], -1),
                      torch.cat([z, A1, -v * A1], -1)], -2)     # [..., 2n, 9]
    H = null_vector(rows).reshape(rows.shape[:-2] + (3, 3))
    s = torch.sqrt(torch.clamp(torch.linalg.norm(H[..., :, 0], dim=-1)
                               * torch.linalg.norm(H[..., :, 1], dim=-1),
                               min=1e-12))
    H = H / s[..., None, None]
    depths = (A1 @ H[..., 2, :, None])[..., 0]
    H = H * _majority_sign(depths)[..., None, None]
    r1, r2 = H[..., :, 0], H[..., :, 1]
    Rp = orthonormalize(torch.stack(
        [r1, r2, torch.linalg.cross(r1, r2, dim=-1)], -1))
    E = torch.stack([e1, e2, e3], -1)                           # columns
    R = Rp @ E.transpose(-1, -2)
    return R, H[..., :, 2] - (R @ c[..., None])[..., 0]


def ransac_pnp(cam: Intrinsics, xw, uv, mask,
               seed: Optional[torch.Tensor] = None, n_hyp: int = 128,
               thresh_px: float = 5.0,
               sample_idx: Optional[torch.Tensor] = None) -> PnPResult:
    """xw [N, 3] world points, uv [N, 2] pixels, mask [N] valid pairs;
    ``seed`` an integer tensor, or ``sample_idx`` [n_hyp, 6]. Returns the
    best of the 2 n_hyp hypotheses (DLT first, then homography; the first
    maximum wins)."""
    uv_norm = torch.stack([(uv[:, 0] - cam.cx) / cam.fx,
                           (uv[:, 1] - cam.cy) / cam.fy], dim=1)
    idx = sample_idx if sample_idx is not None else \
        sample_indices(seed, PNP_STREAM, n_hyp, 6, mask)
    idx = idx.long()
    xs, us = xw[idx], uv_norm[idx]
    Rd, td = _dlt_pose(xs, us)
    Rh, th = _homography_pose(xs, us)
    Rs = torch.cat([Rd, Rh])
    ts = torch.cat([td, th])
    xc = torch.einsum("hij,nj->hni", Rs, xw) + ts[:, None, :]
    e = ((project(cam, xc) - uv[None]) ** 2).sum(-1)
    inls = (e < thresh_px * thresh_px) & (xc[..., 2] > 0.05) & mask[None]
    counts = inls.sum(-1)
    best = torch.argmax(counts).view(1)
    return PnPResult(Rs.index_select(0, best)[0], ts.index_select(0, best)[0],
                     inls.index_select(0, best)[0],
                     counts.index_select(0, best)[0].to(torch.int32))
