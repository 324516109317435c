"""Oriented bounding boxes of keypoint clouds.

Port of the OBB half of ``slam_dynamic_tpu/ops/pointcloud.py`` (``OBB``
:71, ``eigh3x3`` :78, ``obb_from_points`` :132), the PCL
MomentOfInertiaEstimation OBB of the dynamic objects: a PCA of the masked
points by a closed-form symmetric 3x3 eigendecomposition (Cardano
eigenvalues, cross-product eigenvectors), all elementwise arithmetic.
``obb_from_points`` takes a batch of masks over one cloud, the shape the
dynamic step needs (one OBB per box). An empty mask gives NaN centre and
axes as in the reference; callers gate on ``valid`` or the box depth.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class OBB(NamedTuple):
    center: torch.Tensor     # [..., 3]
    axes: torch.Tensor       # [..., 3, 3] rows = principal directions
    extents: torch.Tensor    # [..., 3] half-lengths
    valid: torch.Tensor      # [...] bool


def _det3(M):
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def _unit(v):
    return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True),
                                      min=1e-30))


def eigh3x3(A):
    """Symmetric A [..., 3, 3] -> (evals [..., 3] ascending, evecs
    [..., 3, 3] as columns), like ``torch.linalg.eigh``."""
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    Aq = A - q[..., None, None] * eye
    p = torch.sqrt(torch.clamp((Aq * Aq).sum((-2, -1)) / 6.0, min=1e-30))
    r = torch.clamp(_det3(Aq / p[..., None, None]) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    evals = torch.stack([e_lo, e_mid, e_hi], dim=-1)

    def eigvec(lam):
        # null vector of (A - lam I): the largest cross product of two
        # rows; a coordinate axis where all vanish (repeated eigenvalue)
        M = A - lam[..., None, None] * eye
        cs = torch.stack([torch.linalg.cross(M[..., 0, :], M[..., 1, :]),
                          torch.linalg.cross(M[..., 0, :], M[..., 2, :]),
                          torch.linalg.cross(M[..., 1, :], M[..., 2, :])],
                         dim=-2)
        best = torch.argmax((cs * cs).sum(-1), dim=-1)
        v = torch.gather(cs, -2, best[..., None, None].expand(
            best.shape + (1, 3)))[..., 0, :]
        ok = (v * v).sum(-1, keepdim=True) > 1e-20
        v = torch.where(ok, v, eye[0])
        return _unit(v)

    v_lo = eigvec(e_lo)
    v_hi = eigvec(e_hi)
    # the middle vector from orthogonality: a right-handed orthonormal
    # basis even near degeneracy
    v_mid = _unit(torch.linalg.cross(v_hi, v_lo))
    v_lo = torch.linalg.cross(v_mid, v_hi)
    return evals, torch.stack([v_lo, v_mid, v_hi], dim=-1)


def obb_from_points(points, mask) -> OBB:
    """OBB by PCA of ``points`` [N, 3] under each mask [..., N] (PCL
    MomentOfInertiaEstimation::getOBB); one box per mask."""
    m = mask.to(points.dtype)[..., None]                  # [..., N, 1]
    wsum = torch.clamp(mask.sum(-1), min=1).to(points.dtype)
    mu = (points * m).sum(-2) / wsum[..., None]            # [..., 3]
    c = (points - mu[..., None, :]) * m                    # [..., N, 3]
    cov = c.transpose(-1, -2) @ c / wsum[..., None, None]
    _, evecs = eigh3x3(cov)
    axes = evecs.transpose(-1, -2).flip(-2)    # rows, major axis first
    proj = c @ axes.transpose(-1, -2)                      # [..., N, 3]
    inf = torch.full_like(proj, math.inf)
    lo = torch.where(mask[..., None], proj, inf).amin(-2)
    hi = torch.where(mask[..., None], proj, -inf).amax(-2)
    center = mu + (axes.transpose(-1, -2) @ ((lo + hi) * 0.5)[..., None]
                   )[..., 0]
    return OBB(center, axes, (hi - lo) * 0.5, mask.sum(-1) >= 10)
