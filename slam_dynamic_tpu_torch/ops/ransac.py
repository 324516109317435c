"""Batched-hypothesis RANSAC for the homography and the fundamental matrix.

Port of ``slam_dynamic_tpu/ops/ransac.py`` (``ModelFit`` :36,
``_hartley`` :43, ``_h_design`` :74, ``_f_design`` :89, ``_solve_h`` :100,
``_solve_f`` :113, ``h_transfer_errors`` :122, ``f_epipolar_errors`` :142,
``fit_homography`` :160, ``fit_fundamental`` :184): all ``n_hyp`` minimal
sets are drawn at once, solved batched through ``ops/nullspace.py``,
scored against every correspondence in one [n_hyp, P] pass, and the
least-squares refit over the best hypothesis' inliers is the model
returned. Fixed trip counts, no host sync.

Sampling. The reference draws its minimal sets by Gumbel top-k from
JAX's threefry PRNG (:65-71), which torch cannot reproduce. The port
draws its own Gumbel noise from a counter-based integer hash of (seed,
stream, hypothesis, point), so a seed that lives on the device (derived
from the pose, ``frontend/fused.py``) needs no readback, and the draws
are the same on the CPU and on the card. Every fit also takes an
optional ``sample_idx`` [n_hyp, k] that replaces the draw; the parity
tests feed it JAX's own samples.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .nullspace import inv3, null_vector, rank2_project

_M32 = 0xFFFFFFFF


class ModelFit(NamedTuple):
    M: torch.Tensor          # [3, 3] best model
    inliers: torch.Tensor    # [P] bool
    n_inliers: torch.Tensor  # int32
    score: torch.Tensor      # float32 (inlier count of the model)


def _hartley(x, w):
    """Hartley normalization of x [..., k, 2] with weights w [..., k]:
    zero mean, mean distance sqrt(2). Returns (xn, T, Tinv) with
    xh_n = T xh."""
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    mu = (x * w[..., None]).sum(-2) / wsum                        # [..., 2]
    d = torch.sqrt(((x - mu[..., None, :]) ** 2).sum(-1) + 1e-12)
    md = (d * w).sum(-1) / wsum[..., 0]
    s = math.sqrt(2.0) / torch.clamp(md, min=1e-9)                # [...]
    xn = (x - mu[..., None, :]) * s[..., None, None]
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, z, -s * mu[..., 0]], -1),
        torch.stack([z, s, -s * mu[..., 1]], -1),
        torch.stack([z, z, o], -1)], -2)
    si = 1.0 / s
    Tinv = torch.stack([
        torch.stack([si, z, mu[..., 0]], -1),
        torch.stack([z, si, mu[..., 1]], -1),
        torch.stack([z, z, o], -1)], -2)
    return xn, T, Tinv


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finalizer on int64 holding values in [0, 2^32):
    every product stays below 2^59."""
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    return (x >> 16) ^ x


def gumbel_noise(seed: torch.Tensor, stream: int, n_hyp: int,
                 n_points: int) -> torch.Tensor:
    """[n_hyp, n_points] float32 Gumbel noise hashed from (seed, stream,
    hypothesis, point); ``seed`` is an integer tensor (any device)."""
    dev = seed.device
    s = _mix32((seed.to(torch.int64) & _M32) ^ stream)
    s = _mix32(s ^ (torch.arange(n_hyp, device=dev) * 0x9E3779B1 & _M32))
    x = _mix32(s[:, None] ^ (torch.arange(n_points, device=dev)[None, :]
                             * 0x85EBCA6B & _M32))
    u = ((x >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # (0, 1)
    return -torch.log(-torch.log(u))


def sample_indices(seed: torch.Tensor, stream: int, n_hyp: int, k: int,
                   mask: torch.Tensor) -> torch.Tensor:
    """[n_hyp, k] int64 distinct indices per hypothesis, drawn among the
    masked-in points (Gumbel top-k; ties, as the masked -inf entries when
    fewer than k points are valid, keep the lowest index)."""
    g = gumbel_noise(seed, stream, n_hyp, mask.shape[0])
    g = torch.where(mask[None, :], g, torch.full_like(g, -math.inf))
    return torch.sort(g, dim=1, descending=True, stable=True)[1][:, :k]


def _h_design(p1, p2, w=None):
    """Homography DLT rows from pairs [..., k, 2] -> A [..., 2k, 9]."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    if w is not None:
        r1 = r1 * w[..., None]
        r2 = r2 * w[..., None]
    return torch.cat([r1, r2], -2)


def _f_design(p1, p2, w=None):
    """Fundamental-matrix rows from pairs [..., k, 2] -> A [..., k, 9]."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y,
                     torch.ones_like(x)], -1)
    if w is not None:
        A = A * w[..., None]
    return A


def _solve_h(p1, p2, w):
    """Weighted normalized DLT homography, batched: pairs [..., k, 2] +
    weights [..., k] -> H [..., 3, 3] (denormalized, H[2,2]-scaled)."""
    p1n, T1, _ = _hartley(p1, w)
    p2n, _, T2i = _hartley(p2, w)
    h = null_vector(_h_design(p1n, p2n, w))
    H = T2i @ h.reshape(h.shape[:-1] + (3, 3)) @ T1
    den = H[..., 2:3, 2:3]
    return H / torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12),
                           den)


def _solve_f(p1, p2, w):
    """Weighted normalized 8-point fundamental matrix, batched + rank-2."""
    p1n, T1, _ = _hartley(p1, w)
    p2n, T2, _ = _hartley(p2, w)
    f = null_vector(_f_design(p1n, p2n, w))
    F = rank2_project(f.reshape(f.shape[:-1] + (3, 3)))
    return T2.transpose(-1, -2) @ F @ T1


def _homog(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _dehomog(x):
    den = x[..., 2:]
    return x[..., :2] / torch.where(den.abs() < 1e-9,
                                    torch.full_like(den, 1e-9), den)


def h_transfer_errors(H, p1, p2):
    """Symmetric transfer squared errors of a homography.
    H: [..., 3, 3]; p1/p2: [P, 2] -> errors [..., P] each way."""
    x1, x2 = _homog(p1), _homog(p2)
    e_fw = ((_dehomog(x1 @ H.transpose(-1, -2)) - p2) ** 2).sum(-1)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    Hinv = inv3(H + 1e-12 * eye)
    e_bw = ((_dehomog(x2 @ Hinv.transpose(-1, -2)) - p1) ** 2).sum(-1)
    return e_fw, e_bw


def f_epipolar_errors(F, p1, p2):
    """Squared point-to-epiline distances, both directions.
    F: [..., 3, 3]; p1/p2: [P, 2] -> (d1, d2) [..., P]."""
    x1, x2 = _homog(p1), _homog(p2)
    l2 = x1 @ F.transpose(-1, -2)          # epilines in image 2
    l1 = x2 @ F                            # epilines in image 1
    d2 = (x2 * l2).sum(-1) ** 2 / torch.clamp(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = (x1 * l1).sum(-1) ** 2 / torch.clamp(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    return d1, d2


def _fit(p1, p2, mask, idx, solve, errors, thresh_px):
    w = torch.ones(idx.shape, dtype=p1.dtype, device=p1.device)
    Ms = solve(p1[idx], p2[idx], w)                         # [Hyp, 3, 3]
    th2 = thresh_px * thresh_px
    e1, e2 = errors(Ms, p1, p2)                             # [Hyp, P]
    inls = (e1 < th2) & (e2 < th2) & mask[None, :]
    best = torch.argmax(inls.sum(-1))        # the first maximum
    # the least-squares refit over the best hypothesis' inliers is always
    # the model returned (index_select: a device scalar as an index would
    # wait for the device)
    M = solve(p1, p2, inls.index_select(0, best.view(1))[0].to(p1.dtype))
    e1, e2 = errors(M, p1, p2)
    inl = (e1 < th2) & (e2 < th2) & mask
    n = inl.sum().to(torch.int32)
    return ModelFit(M, inl, n, n.to(torch.float32))


def fit_homography(p1, p2, mask, seed: Optional[torch.Tensor] = None,
                   n_hyp: int = 256, thresh_px: float = 3.0,
                   sample_idx: Optional[torch.Tensor] = None) -> ModelFit:
    """p1 -> p2 homography: batched RANSAC + weighted-DLT inlier refit.
    ``sample_idx`` [n_hyp, 4] replaces the draw from ``seed``."""
    idx = sample_idx if sample_idx is not None else \
        sample_indices(seed, 0, n_hyp, 4, mask)
    return _fit(p1, p2, mask, idx.long(), _solve_h, h_transfer_errors,
                thresh_px)


def fit_fundamental(p1, p2, mask, seed: Optional[torch.Tensor] = None,
                    n_hyp: int = 256, thresh_px: float = 3.0,
                    sample_idx: Optional[torch.Tensor] = None) -> ModelFit:
    """p1 -> p2 fundamental matrix by batched 8-point RANSAC + refit.
    ``sample_idx`` [n_hyp, 8] replaces the draw from ``seed``."""
    idx = sample_idx if sample_idx is not None else \
        sample_indices(seed, 1, n_hyp, 8, mask)
    return _fit(p1, p2, mask, idx.long(), _solve_f, f_epipolar_errors,
                thresh_px)
