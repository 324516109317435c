"""Pure-matmul nullspace solve for batches of small systems.

Port of ``slam_dynamic_tpu/ops/nullspace.py`` (``inv_newton_schulz``,
``smallest_eigvec``, ``null_vector``, ``inv3`` :119, ``rank2_project``
:138), the batched DLT solves of triangulation, of the H/F RANSAC and of
the PnP hypotheses: the least right-singular
vector of A from its Gram matrix by Newton-Schulz inversion, repeated
squaring (inverse power iteration) and iterative refinement against A
itself; the closed-form 3x3 inverse and the SVD-free rank-2 projection.
Fixed trip counts, float32 throughout.
"""
from __future__ import annotations

import torch


def inv_newton_schulz(M: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """Approximate inverse of SPD M [..., n, n] by X <- X (2I - M X),
    starting from I / ||M||_inf (a polynomial in M: same eigenvectors)."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    r = M.abs().sum(-1).amax(-1)
    X = eye / torch.clamp(r, min=1e-30)[..., None, None]
    for _ in range(iters):
        X = X @ (2.0 * eye - M @ X)
    return X


def _extract_smallest(X: torch.Tensor, squarings: int) -> torch.Tensor:
    """Dominant eigenvector of X by repeated squaring + argmax-diagonal
    column extraction."""
    n = X.shape[-1]
    for _ in range(squarings):
        nrm = X.abs().amax(dim=(-2, -1), keepdim=True)
        X = X / torch.clamp(nrm, min=1e-30)
        X = X @ X
    j = torch.argmax(torch.diagonal(X, dim1=-2, dim2=-1), dim=-1)
    v = torch.gather(X, -1, j[..., None, None].expand(X.shape[:-1] + (1,)))
    v = v[..., 0]
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-30)


def smallest_eigvec(M: torch.Tensor, shift_rel: float = 1e-5,
                    ns_iters: int = 20, squarings: int = 3) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric PSD
    M [..., n, n] -> [..., n] (the sign is arbitrary, as an SVD's)."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    eps = shift_rel * tr + 1e-30
    X = inv_newton_schulz(M + eps[..., None, None] * eye, ns_iters)
    return _extract_smallest(X, squarings)


def null_vector(A: torch.Tensor, shift_rel: float = 1e-5,
                ns_iters: int = 20, squarings: int = 3,
                refine: int = 2) -> torch.Tensor:
    """Least right-singular vector of A [..., m, n] -> [..., n]."""
    G = A.transpose(-1, -2) @ A
    n = G.shape[-1]
    eye = torch.eye(n, dtype=G.dtype, device=G.device)
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    eps = shift_rel * tr + 1e-30
    X = inv_newton_schulz(G + eps[..., None, None] * eye, ns_iters)
    v = _extract_smallest(X, squarings)
    for _ in range(refine):
        Av = (A @ v[..., None])[..., 0]
        g = (A.transpose(-1, -2) @ Av[..., None])[..., 0]
        w = v - (X @ g[..., None])[..., 0]
        v = w / torch.clamp(torch.linalg.norm(w, dim=-1, keepdim=True),
                            min=1e-30)
    return v


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of M [..., 3, 3] (no LU)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(det.abs() < 1e-30,
                                torch.full_like(det, 1e-30), det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), (b * f - c * e)], dim=-1),
        torch.stack([B, (a * i - c * g), -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), (a * e - b * d)], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def rank2_project(F: torch.Tensor) -> torch.Tensor:
    """Nearest rank-2 matrix to F [..., 3, 3] without an SVD:
    F - (u3^T F v3) u3 v3^T, with u3 / v3 the least singular vectors
    (refined null vectors of F^T and F)."""
    v3 = null_vector(F, ns_iters=16, squarings=3, refine=2)
    u3 = null_vector(F.transpose(-1, -2), ns_iters=16, squarings=3,
                     refine=2)
    s3 = (u3[..., None, :] @ F @ v3[..., :, None])[..., 0, 0]
    return F - s3[..., None, None] * u3[..., :, None] * v3[..., None, :]
