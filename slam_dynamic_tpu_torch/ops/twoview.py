"""Two-view relative pose: essential and homography decomposition with
cheirality selection.

Port of ``slam_dynamic_tpu/ops/twoview.py`` (``decompose_essential``
:24, ``decompose_homography`` :40, ``_check_hypothesis`` :99,
``reconstruct`` :122): from a RANSAC model (ops/ransac.py) recover the
(R, t) candidates (4 from E, 8 from H by Faugeras' method), triangulate
every pair under each candidate and keep the one with a dominant count
of good points (in front of both views, with parallax, reprojecting
within 2 px).

The SVDs fix U and V only up to signs and, for E's two equal singular
values, a rotation in that plane, and LAPACK, cuSOLVER and XLA resolve
that freedom differently: the candidates may come in another order and
with other signs than the reference's. Cheirality picks the same motion
from either set, so what is compared with the reference is the chosen
(R, t), its good mask and its points.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..backend.triangulation import triangulate_dlt
from ..utils.camera import Intrinsics, project


def decompose_essential(E):
    """E -> 4 candidates (R [4, 3, 3], t [4, 3]), |t| = 1."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def decompose_homography(H, cam: Intrinsics):
    """Faugeras' SVD decomposition of a homography into 8 motion
    hypotheses (R [8, 3, 3], t [8, 3] unit, n [8, 3])."""
    K = cam.K
    A = torch.linalg.inv_ex(K)[0] @ H @ K
    U, D, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = D[0], D[1], D[2]
    V = Vt.T
    den = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den, min=0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den, min=0))
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                  min=0))
    z, o = torch.zeros_like(d1), torch.ones_like(d1)
    Rs, ts, ns = [], [], []
    # d' = d2 (positive), then d' = -d2
    for plus in (True, False):
        if plus:
            q = torch.clamp((d1 + d3) * d2, min=1e-12)
            sin_t, cos_t = root / q, (d2 * d2 + d1 * d3) / q
        else:
            q = torch.clamp((d1 - d3) * d2, min=1e-12)
            sin_t, cos_t = root / q, (d1 * d3 - d2 * d2) / q
        for e1, e3 in ((1.0, 1.0), (-1.0, 1.0), (1.0, -1.0), (-1.0, -1.0)):
            st = e1 * e3 * sin_t
            if plus:
                Rp = torch.stack([torch.stack([cos_t, z, -st]),
                                  torch.stack([z, o, z]),
                                  torch.stack([st, z, cos_t])])
                tp = torch.stack([e1 * x1, z, -e3 * x3]) * (d1 - d3)
            else:
                Rp = torch.stack([torch.stack([cos_t, z, st]),
                                  torch.stack([z, -o, z]),
                                  torch.stack([st, z, -cos_t])])
                tp = torch.stack([e1 * x1, z, e3 * x3]) * (d1 + d3)
            Rs.append(s * U @ Rp @ Vt)
            ts.append(U @ tp)
            ns.append(V @ torch.stack([e1 * x1, z, e3 * x3]))
    ts = torch.stack(ts)
    ts = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True),
                          min=1e-12)
    return torch.stack(Rs), ts, torch.stack(ns)


class Reconstruction(NamedTuple):
    ok: torch.Tensor          # bool: a dominant hypothesis exists
    R: torch.Tensor           # [3, 3] cam2 <- cam1 (frame 1 at identity)
    t: torch.Tensor           # [3] unit baseline
    points: torch.Tensor      # [N, 3] triangulated (frame-1 coordinates)
    good: torch.Tensor        # [N] bool good under the winner


def _check_hypothesis(cam, R, t, uv1, uv2, mask, chi2=4.0):
    """Good points of one (R, t): triangulation and the gates of
    Initializer::CheckRT."""
    eye = torch.eye(3, device=R.device)
    X = triangulate_dlt(cam, eye, torch.zeros_like(t), R, t, uv1, uv2)
    xc2 = X @ R.T + t
    finite = torch.isfinite(X).all(-1)
    r2 = X + R.T @ t                          # X - O2, O2 = -R^T t
    cosp = (X * r2).sum(-1) / torch.clamp(
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(r2, dim=-1),
        min=1e-9)
    e1 = ((project(cam, X) - uv1) ** 2).sum(-1)
    e2 = ((project(cam, xc2) - uv2) ** 2).sum(-1)
    good = (mask & finite & (X[:, 2] > 0) & (xc2[:, 2] > 0)
            & (cosp < 0.99998) & (e1 < chi2) & (e2 < chi2))
    return good, X


def reconstruct(cam: Intrinsics, M, uv1, uv2, mask,
                use_homography: bool = False) -> Reconstruction:
    """The dominant motion hypothesis of model M (F, or H with
    ``use_homography``): the first with the most good points, accepted
    when it explains over 70% of the pairs, at least 50, and the
    runner-up has under 80% of its count."""
    if use_homography:
        Rs, ts, _ = decompose_homography(M, cam)
    else:
        Rs, ts = decompose_essential(cam.K.T @ M @ cam.K)
    goods, Xs = zip(*(_check_hypothesis(cam, R, t, uv1, uv2, mask)
                      for R, t in zip(Rs, ts)))
    goods, Xs = torch.stack(goods), torch.stack(Xs)
    counts = goods.sum(1)
    n_best = counts.max()
    # the first maximum, as jnp.argmax
    best = torch.where(counts == n_best,
                       torch.arange(counts.shape[0], device=counts.device),
                       counts.shape[0]).min()
    second = torch.sort(counts, descending=True)[0][1]
    ok = (n_best > 0.7 * mask.sum()) & (second < 0.8 * n_best) & \
        (n_best >= 50)
    return Reconstruction(ok, Rs[best], ts[best], Xs[best], goods[best])
