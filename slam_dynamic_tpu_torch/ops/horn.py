"""Closed-form Sim3 from 3D-3D correspondences and its batched RANSAC.

Port of ``slam_dynamic_tpu/ops/horn.py`` (``horn_sim3`` :22, ``Sim3Fit``,
``ransac_sim3`` :55), the Sim3 solver of loop verification: all minimal
sets of 3 pairs are solved at once (the weighted SVD form of Horn's
method), every hypothesis is scored by reprojection in both cameras (the
reference's CheckInliers gates), and the model returned is the refit over
the best hypothesis' inliers.

Samples come from ``ops/ransac.sample_indices`` on stream 3; ``sample_idx``
[n_hyp, 3] replaces the draw (the parity tests feed JAX's samples).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.camera import Intrinsics, project
from .ransac import sample_indices

SIM3_STREAM = 3


def horn_sim3(x1, x2, w, fix_scale: bool = False):
    """Weighted closed-form similarity x2 ~ s R x1 + t, batched over
    leading dimensions: x1, x2 [..., N, 3], w [..., N] (0/1 masks do)."""
    ws = torch.clamp(w.sum(-1), min=1e-9)
    mu1 = (x1 * w[..., None]).sum(-2) / ws[..., None]
    mu2 = (x2 * w[..., None]).sum(-2) / ws[..., None]
    c1 = x1 - mu1[..., None, :]
    c2 = x2 - mu2[..., None, :]
    cov = (c2 * w[..., None]).transpose(-1, -2) @ c1 / ws[..., None, None]
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det),
                     torch.where(det < 0, -1.0, 1.0)], -1)
    R = U @ (d[..., :, None] * Vt)
    var1 = ((c1 ** 2).sum(-1) * w).sum(-1) / ws
    if fix_scale:
        s = torch.ones_like(ws)
    else:
        s = (D * d).sum(-1) / torch.clamp(var1, min=1e-12)
    t = mu2 - s[..., None] * (R @ mu1[..., None])[..., 0]
    return s, R, t


class Sim3Fit(NamedTuple):
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _score(cam1, cam2, s, R, t, x1, x2, uv1, uv2, mask, th2):
    """Inliers [..., N] of Sim3 hypotheses (s [...], R [..., 3, 3],
    t [..., 3]): reprojection below the gate in both cameras, both points
    in front."""
    x2p = s[..., None, None] * (x1 @ R.transpose(-1, -2)) + t[..., None, :]
    e2 = ((project(cam2, x2p) - uv2) ** 2).sum(-1)
    si = 1.0 / s
    Ri = R.transpose(-1, -2)
    ti = -(Ri @ t[..., None])[..., 0] / s[..., None]
    x1p = si[..., None, None] * (x2 @ Ri.transpose(-1, -2)) + ti[..., None, :]
    e1 = ((project(cam1, x1p) - uv1) ** 2).sum(-1)
    return (e1 < th2) & (e2 < th2) & mask & (x2p[..., 2] > 0) \
        & (x1p[..., 2] > 0)


def ransac_sim3(cam1: Intrinsics, cam2: Intrinsics, x1, x2, uv1, uv2, mask,
                seed: Optional[torch.Tensor] = None, n_hyp: int = 128,
                fix_scale: bool = True, th_px: float = 10.0,
                sample_idx: Optional[torch.Tensor] = None) -> Sim3Fit:
    """The Sim3 T21 (x2 = s R x1 + t) aligning camera-1 points x1 [N, 3]
    to camera-2 points x2; uv1/uv2 [N, 2] are the observed pixels of the
    pairs (reprojection gates), mask [N] the valid pairs; ``seed`` an
    integer tensor, or ``sample_idx`` [n_hyp, 3]."""
    idx = sample_idx if sample_idx is not None else \
        sample_indices(seed, SIM3_STREAM, n_hyp, 3, mask)
    idx = idx.long()
    ss, Rs, ts = horn_sim3(x1[idx], x2[idx], torch.ones(
        idx.shape, dtype=x1.dtype, device=x1.device), fix_scale)
    th2 = th_px * th_px
    inls = _score(cam1, cam2, ss, Rs, ts, x1, x2, uv1, uv2, mask[None], th2)
    best = torch.argmax(inls.sum(-1)).view(1)
    w = inls.index_select(0, best)[0].to(x1.dtype)
    s, R, t = horn_sim3(x1, x2, w, fix_scale)
    inl = _score(cam1, cam2, s, R, t, x1, x2, uv1, uv2, mask, th2)
    return Sim3Fit(s, R, t, inl, inl.sum().to(torch.int32))
