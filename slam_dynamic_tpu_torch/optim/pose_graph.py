"""Essential-graph (pose-graph) optimization over Sim3 keyframe poses.

Port of ``slam_dynamic_tpu/optim/pose_graph.py`` (``PoseGraphProblem``,
``edge_residual`` :40, ``optimize_pose_graph`` :52): vertices are
world->camera Sim3 poses, edges (spanning tree, strong covisibility, loop)
carry relative-Sim3 measurements, and the residual of edge (i, j) is
log(S_ji o S_i o S_j^-1), as g2o's EdgeSim3. Each edge's two 7x7 Jacobian
blocks come from forward-mode autodiff (``torch.func.vmap`` over edges of
``torch.func.jacfwd``, in float64: ``utils.sim3.float64``), are
scatter-added into the dense [7K, 7K] normal
equations (duplicate edges sum; on the card the order of the sums is not
fixed, so a card result is held by tolerance) and the damped Gauss-Newton
step is one ``torch.linalg.solve``. Accept/reject is a device selection:
the iterations never wait for the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..utils import sim3 as s3


class PoseGraphProblem(NamedTuple):
    # vertices
    s: torch.Tensor          # [K] scale of the world->camera Sim3
    R: torch.Tensor          # [K, 3, 3]
    t: torch.Tensor          # [K, 3]
    fixed: torch.Tensor      # [K] bool
    valid: torch.Tensor      # [K] bool
    # edges (padded)
    e_i: torch.Tensor        # [E] int
    e_j: torch.Tensor        # [E] int
    e_s: torch.Tensor        # [E] measured S_ji scale
    e_R: torch.Tensor        # [E, 3, 3]
    e_t: torch.Tensor        # [E, 3]
    e_valid: torch.Tensor    # [E] bool
    e_weight: torch.Tensor   # [E] float32 information scale


def edge_residual(g_i, g_j, meas):
    """r = log_sim3(S_ji o S_i o S_j^-1), [..., 7]."""
    rel = s3.sim3_compose(*g_i, *s3.sim3_inverse(*g_j))
    return s3.sim3_log(*s3.sim3_compose(*meas, *rel))


def _res_perturbed(xi_i, xi_j, g_i, g_j, meas):
    gi = s3.sim3_compose(*s3.sim3_exp(xi_i), *g_i)
    gj = s3.sim3_compose(*s3.sim3_exp(xi_j), *g_j)
    return edge_residual(gi, gj, meas)


def edge_jacobians(g_i, g_j, meas):
    """([E, 7, 7], [E, 7, 7]) Jacobians of each edge's residual with
    respect to left twists on its two vertices, at the zero twists
    (float32 out)."""
    dtype = g_i[1].dtype
    g_i, g_j, meas = s3.float64((g_i, g_j, meas))
    z7 = torch.zeros(7, dtype=torch.float64, device=g_i[1].device)
    Ji, Jj = vmap(jacfwd(_res_perturbed, argnums=(0, 1)),
                  in_dims=(None, None, 0, 0, 0))(z7, z7, g_i, g_j, meas)
    return Ji.to(dtype), Jj.to(dtype)


def _gather(s, R, t, idx):
    return s[idx], R[idx], t[idx]


def normal_equations(problem: PoseGraphProblem, s, R, t):
    """(H [7K, 7K], b [7K], weighted error) of the graph at (s, R, t):
    the per-edge blocks scatter-added over the flat system."""
    K = s.shape[0]
    ei, ej = problem.e_i.long(), problem.e_j.long()
    g_i, g_j = _gather(s, R, t, ei), _gather(s, R, t, ej)
    meas = (problem.e_s, problem.e_R, problem.e_t)
    r = edge_residual(g_i, g_j, meas)
    Ji, Jj = edge_jacobians(g_i, g_j, meas)
    w = problem.e_valid.to(r.dtype) * problem.e_weight
    JiW, JjW = Ji * w[:, None, None], Jj * w[:, None, None]
    blocks = torch.stack([torch.einsum("edi,edj->eij", JiW, Ji),
                          torch.einsum("edi,edj->eij", JjW, Jj),
                          torch.einsum("edi,edj->eij", JiW, Jj)])
    blocks = torch.cat([blocks, blocks[2:].transpose(-1, -2)])   # Hji
    a = torch.arange(7, device=s.device)
    rows_v = torch.stack([ei, ej, ei, ej])                   # [4, E]
    cols_v = torch.stack([ei, ej, ej, ei])
    rows = (rows_v[:, :, None, None] * 7 + a[:, None]).expand(blocks.shape)
    cols = (cols_v[:, :, None, None] * 7 + a[None, :]).expand(blocks.shape)
    H = torch.zeros((K * 7, K * 7), dtype=r.dtype, device=s.device)
    H.index_put_((rows.reshape(-1), cols.reshape(-1)), blocks.reshape(-1),
                 accumulate=True)
    bi = -torch.einsum("edi,ed->ei", JiW, r)
    bj = -torch.einsum("edi,ed->ei", JjW, r)
    b = torch.zeros(K * 7, dtype=r.dtype, device=s.device)
    b.index_put_(((ei[:, None] * 7 + a).reshape(-1),), bi.reshape(-1),
                 accumulate=True)
    b.index_put_(((ej[:, None] * 7 + a).reshape(-1),), bj.reshape(-1),
                 accumulate=True)
    return H, b, ((r ** 2).sum(-1) * w).sum()


def edge_error(problem: PoseGraphProblem, s, R, t):
    """The weighted squared residual summed over the graph's edges."""
    ei, ej = problem.e_i.long(), problem.e_j.long()
    r = edge_residual(_gather(s, R, t, ei), _gather(s, R, t, ej),
                      (problem.e_s, problem.e_R, problem.e_t))
    w = problem.e_valid.to(r.dtype) * problem.e_weight
    return ((r ** 2).sum(-1) * w).sum()


def damped_gn(problem: PoseGraphProblem, iters: int, fix_scale: bool,
              system, error):
    """The damped Gauss-Newton loop on the vertices of ``problem``:
    ``system(s, R, t)`` gives (H [7K, 7K], b [7K], error) and
    ``error(s, R, t)`` the error after a step (the edge-sharded solver
    sums both across its shards). Fixed and invalid vertices keep their
    poses."""
    K = problem.s.shape[0]
    dev = problem.s.device
    free = (problem.valid & ~problem.fixed).to(problem.s.dtype)
    free7 = free.repeat_interleave(7)
    s, R, t = problem.s, problem.R, problem.t
    lam = torch.tensor(1e-4, dtype=s.dtype, device=dev)
    for _ in range(iters):
        H, b, e_old = system(s, R, t)
        H = H * (free7[:, None] * free7[None, :])
        # LM damping on each block's diagonal; fixed and invalid vertices
        # get an identity block
        H = H + torch.diag(lam * torch.diagonal(H) + (1.0 - free7) + 1e-6)
        dx = torch.linalg.solve(H, b * free7).reshape(K, 7)
        if fix_scale:
            dx = torch.cat([dx[:, :6], torch.zeros_like(dx[:, 6:])], 1)
        dx = dx * free[:, None]
        s2, R2, t2 = s3.sim3_compose(*s3.sim3_exp(dx), s, R, t)
        good = error(s2, R2, t2) < e_old
        s = torch.where(good, s2, s)
        R = torch.where(good, R2, R)
        t = torch.where(good, t2, t)
        lam = torch.where(good, lam * 0.5, lam * 4.0)
    return s, R, t


def optimize_pose_graph(problem: PoseGraphProblem, iters: int = 20,
                        fix_scale: bool = True):
    """Damped Gauss-Newton on the essential graph. Returns (s, R, t) per
    keyframe; fixed and invalid vertices keep their poses."""
    return damped_gn(
        problem, iters, fix_scale,
        lambda s, R, t: normal_equations(problem, s, R, t),
        lambda s, R, t: edge_error(problem, s, R, t))
