"""Sim(3) similarity transforms: (s, R, t) with x' = s R x + t.

Port of ``slam_dynamic_tpu/utils/sim3.py:15-103`` (``sim3_identity``,
``sim3_apply``, ``sim3_compose``, ``sim3_inverse``, ``_sim3_W``,
``sim3_exp``, ``sim3_log``), used by loop closing: the Sim3 solver, the
relative Sim3 optimization and the essential-graph edges. Twists are
``[rho (3), phi (3), sigma (1)]`` with s = exp(sigma), as g2o's. The
small-angle and small-sigma branches of ``_sim3_W`` are ``torch.where``
selections, so nothing here waits for the device and every function
composes under ``torch.func``. Forward-mode Jacobians of these functions
are taken in float64 (``float64``): under ``torch.func.jacfwd`` the
tangent of a 0-d float32 result of a Python-scalar operation comes out
float64 and the next float32 matrix product rejects it.
"""
from __future__ import annotations

import torch

from ..ops.nullspace import inv3
from .se3 import hat, safe_norm, so3_exp, so3_log


def float64(tree):
    """Tensors (nested in tuples, or the fields of an ``Intrinsics``) cast
    to float64; everything else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.float64) if tree.is_floating_point() else tree
    if isinstance(tree, tuple):
        out = [float64(x) for x in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return tree


def sim3_identity(dtype=torch.float32, device=None):
    return (torch.ones((), dtype=dtype, device=device),
            torch.eye(3, dtype=dtype, device=device),
            torch.zeros(3, dtype=dtype, device=device))


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def sim3_apply(s, R, t, x):
    return s[..., None] * _mv(R, x) + t


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """(sa, Ra, ta) o (sb, Rb, tb)."""
    return sa * sb, Ra @ Rb, sa[..., None] * _mv(Ra, tb) + ta


def sim3_inverse(s, R, t):
    Rt = R.transpose(-1, -2)
    si = 1.0 / s
    return si, Rt, -si[..., None] * _mv(Rt, t)


def _sim3_W(phi, sigma):
    """The W matrix of the Sim(3) exponential (t = W rho), closed form
    with Taylor limits at theta -> 0 and sigma -> 0 (any sigma in the
    theta limit). B and C use the true sigma: they never divide by it."""
    theta = safe_norm(phi, dim=-1)
    s = torch.exp(sigma)
    K = hat(phi)
    I = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)

    sig_small = sigma.abs() < 1e-5
    one = torch.ones_like(sigma)
    sig_safe = torch.where(sig_small, one, sigma)
    A_c = torch.where(sig_small, 1.0 + sigma / 2.0, (s - 1.0) / sig_safe)

    th_small = theta < 1e-5
    th_safe = torch.where(th_small, torch.ones_like(theta), theta)
    th2 = th_safe * th_safe
    denom = sigma * sigma + th2
    a = s * torch.sin(th_safe)
    b = s * torch.cos(th_safe)
    B_gen = (a * sigma + (1.0 - b) * th_safe) / (th_safe * denom)
    C_gen = (A_c - ((b - 1.0) * sigma + a * th_safe) / denom) / th2
    B_th0 = torch.where(sig_small, 0.5 + sigma / 3.0,
                        (s * sig_safe - s + 1.0) / (sig_safe * sig_safe))
    C_th0 = torch.where(
        sig_small, 1.0 / 6.0 + sigma / 8.0,
        (s * sig_safe * sig_safe / 2.0 - s * sig_safe + s - 1.0)
        / (sig_safe * sig_safe * sig_safe))
    B = torch.where(th_small, B_th0, B_gen)
    C = torch.where(th_small, C_th0, C_gen)
    return (A_c[..., None, None] * I + B[..., None, None] * K
            + C[..., None, None] * (K @ K))


def sim3_exp(xi):
    """(..., 7) twist [rho, phi, sigma] -> (s, R, t)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return (torch.exp(sigma), so3_exp(phi),
            _mv(_sim3_W(phi, sigma), rho))


def sim3_log(s, R, t):
    """(s, R, t) -> (..., 7) twist."""
    sigma = torch.log(s)
    phi = so3_log(R)
    # the closed-form 3x3 inverse: torch.linalg.solve's forward-mode
    # derivative is wrong under torch.func.vmap
    rho = _mv(inv3(_sim3_W(phi, sigma)), t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
