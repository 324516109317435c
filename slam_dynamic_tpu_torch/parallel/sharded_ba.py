"""Landmark-sharded bundle adjustment: the Schur-reduced Gauss-Newton
solve of the global BA, in one process or across processes.

Port of ``slam_dynamic_tpu/parallel/sharded_ba.py`` (``ShardedBAProblem``
:39, ``_gn_step_shard`` :61, ``make_sharded_ba`` :121,
``partition_obs_by_landmark`` :188). The landmark axis is cut into
``n_shards`` contiguous blocks, and every observation sits in the shard
that owns its landmark, so the landmark blocks (Hpp, W) and the landmark
back-substitution are local to a shard. Each shard forms its partial
reduced camera system ``S_d = Hcc_d - W_d Hpp_d^-1 W_d^T`` and the partial
right-hand side; ``reduce`` sums them into the global system, and the
dense [6K, 6K] camera solve is then the same everywhere.

The layout comes from a shard count or a ``Mesh`` (``parallel/mesh.py``).
A process runs the shards it owns one after the other, on the problem's
device: all of them for a shard count or a mesh of this process, one per
rank for ``distributed.global_mesh()``. ``reduce`` sums the process's own
shards, in shard order, and then, on a mesh over processes, runs ONE
``torch.distributed.all_reduce`` of the tuple flattened into one buffer
(JAX's ``psum`` over the "lm" axis). A GN iteration reduces twice, as
the JAX solver does: the system with the error before the step (:93),
then the error after it (:154). One shard is the plain single-device
solve.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..optim.local_ba import ba_blocks, invert3x3
from ..optim.pose_opt import f32
from ..optim.residuals import huber_weight, reprojection_terms, robust_cost
from ..utils.camera import Intrinsics
from ..utils.se3 import se3_retract
from .mesh import Mesh


class ShardedBAProblem(NamedTuple):
    """Global BA problem in the landmark-sharded layout.

    L (landmark capacity) and O (observation capacity) are multiples of
    the shard count; the observations of shard s's landmarks, the block
    [s L/n, (s+1) L/n), sit in its slice [s O/n, (s+1) O/n) of the
    observation arrays, and ``obs_lm`` holds global landmark indices.
    """

    kf_R: torch.Tensor            # [K, 3, 3]
    kf_t: torch.Tensor            # [K, 3]
    kf_fixed: torch.Tensor        # [K] bool
    kf_valid: torch.Tensor        # [K] bool
    points: torch.Tensor          # [L, 3]
    lm_valid: torch.Tensor        # [L] bool
    obs_kf: torch.Tensor          # [O] int64
    obs_lm: torch.Tensor          # [O] int64, global landmark ids
    obs_uv: torch.Tensor          # [O, 2|3]
    obs_inv_sigma2: torch.Tensor  # [O]
    obs_valid: torch.Tensor       # [O] bool
    obs_ur_weight: torch.Tensor   # [O]


def reduce(parts: Sequence[tuple], group=None) -> tuple:
    """The sum over shards of each shard's tuple of partial tensors: this
    process's shards summed in shard order, then, with a process
    ``group``, one all-reduce of the tuple flattened into one buffer."""
    out = parts[0]
    for p in parts[1:]:
        out = tuple(a + b for a, b in zip(out, p))
    if group is None:
        return out
    flat = torch.cat([x.reshape(-1) for x in out])
    dist.all_reduce(flat, group=group)
    sizes = [x.numel() for x in out]
    return tuple(v.reshape(x.shape)
                 for v, x in zip(torch.split(flat, sizes), out))


def layout(mesh, axis: str = "lm"):
    """(shard count, the shards this process runs, process group) of a
    shard count or a ``Mesh``."""
    if isinstance(mesh, Mesh):
        return mesh.shape[axis], mesh.local_shards(axis), mesh.group
    return int(mesh), range(int(mesh)), None


def assemble(block: torch.Tensor, start: int, total: int, group):
    """The rows [start, start + len(block)) of a [total, ...] tensor whose
    other rows the other ranks hold: summed into place across the
    group (one all-reduce; every rank then holds the whole)."""
    full = block.new_zeros((total, *block.shape[1:]))
    full[start:start + block.shape[0]] = block
    dist.all_reduce(full, group=group)
    return full


def _shard_views(shards: range, Lb: int, Ob: int, pts, lmv, obs_kf,
                 obs_lm, obs_uv, w2, obs_urw):
    """The slices of each shard of ``shards`` (the arrays hold those
    shards' blocks, from ``shards[0]`` on), its observations' landmark
    ids made local to its block."""
    out = []
    for i, s in enumerate(shards):
        lo, oo = slice(i * Lb, (i + 1) * Lb), slice(i * Ob, (i + 1) * Ob)
        out.append((pts[lo], lmv[lo], obs_kf[oo],
                    torch.clamp(obs_lm[oo] - s * Lb, 0, Lb - 1),
                    obs_uv[oo], w2[oo], obs_urw[oo]))
    return out


def _shard_error(cam, stereo, delta, kf_R, kf_t, pts, obs_kf, obs_lm_local,
                 obs_uv, w2, obs_urw):
    """One shard's summed robust cost times the observation weight and the
    in-front mask (what the accept/reject test compares)."""
    terms = reprojection_terms(cam, kf_R[obs_kf], kf_t[obs_kf],
                               pts[obs_lm_local], obs_uv, w2, stereo,
                               obs_urw if stereo else None)
    return (robust_cost(terms.chi2, delta) * w2 * (terms.depth > 1e-3)).sum()


def _gn_step_shard(cam: Intrinsics, stereo: bool, chi2_th, kf_R, kf_t,
                   kf_fixed, kf_valid, shards, lam, group=None):
    """One damped GN step over this process's shards: each shard's
    partial system (``_gn_step_shard`` :61-99 of the reference), one
    ``reduce`` of (S, b, Hcc, bc, err), the Jacobi-preconditioned dense
    camera solve, then each shard's landmark back-substitution. Returns
    (dxc [K, 6], [dxp per shard], the summed error before the step)."""
    K = kf_R.shape[0]
    dev = kf_R.device
    delta = torch.sqrt(chi2_th)
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)
    parts, local = [], []
    for pts, _, obs_kf, obs_lm, obs_uv, w2, obs_urw in shards:
        terms = reprojection_terms(cam, kf_R[obs_kf], kf_t[obs_kf],
                                   pts[obs_lm], obs_uv, w2, stereo,
                                   obs_urw if stereo else None)
        front = terms.depth > 1e-3
        w = w2 * front * huber_weight(terms.chi2, delta)
        Hcc, Hpp, Wlk, bc, bp = ba_blocks(terms, w, obs_kf, obs_lm, K,
                                          pts.shape[0])
        Hpp_inv = invert3x3(Hpp + lam * Hpp * eye3 + 1e-6 * eye3)
        V = torch.einsum("lkij,ljm->lkim", Wlk, Hpp_inv)
        S_part = torch.einsum("lkim,lqnm->kiqn", V, Wlk)
        b_part = torch.einsum("lkim,lm->ki", V, bp)
        # the error with the robust cost, the observation weight and the
        # in-front mask: the same measure as after the step, or every
        # step is rejected
        err = (robust_cost(terms.chi2, delta) * w2 * front).sum()
        parts.append((S_part, b_part, Hcc, bc, err))
        local.append((Hpp_inv, Wlk, bp))
    S_sub, b_sub, Hcc, bc, err = reduce(parts, group)

    ar = torch.arange(K, device=dev)
    S = -S_sub
    S[ar, :, ar, :] += Hcc + lam * Hcc * eye6 + 1e-6 * eye6
    b_red = bc - b_sub
    free_f = (kf_valid & ~kf_fixed).to(S.dtype)
    S = S * (free_f[:, None, None, None] * free_f[None, None, :, None])
    S[ar, :, ar, :] += (1.0 - free_f)[:, None, None] * eye6
    b_red = b_red * free_f[:, None]
    # Jacobi scaling: long keyframe chains leave S badly conditioned
    # (kappa of 1e6 and more), and a raw float32 solve then makes steps
    # that the accept/reject test refuses forever. solve_ex does not read
    # its status back, so a step stays one dispatch with no host sync.
    Sm = S.reshape(K * 6, K * 6)
    d = torch.rsqrt(torch.clamp(torch.diagonal(Sm), min=1e-12))
    x = torch.linalg.solve_ex(d[:, None] * Sm * d[None, :],
                              d * b_red.reshape(K * 6))[0]
    dxc = (d * x).reshape(K, 6) * free_f[:, None]

    dxp = []
    for (_, lmv, *_), (Hpp_inv, Wlk, bp) in zip(shards, local):
        rhs = bp - torch.einsum("lkim,ki->lm", Wlk, dxc)
        dxp.append(torch.einsum("lij,lj->li", Hpp_inv, rhs) * lmv[:, None])
    return dxc, dxp, err


def make_sharded_ba(mesh, cam: Intrinsics, K: int, L: int, O: int,
                    stereo: bool = True, iters: int = 10,
                    chi2: float = 7.815, axis: str = "lm"):
    """The GBA solve at the given capacities over ``mesh``: a shard count
    (every shard in this process) or a ``Mesh`` (its ``axis``; on a mesh
    over processes each rank runs its own shards). Returns
    fn(problem: ShardedBAProblem) -> (kf_R, kf_t, points): ``iters``
    damped GN iterations, each step kept when the summed robust error
    falls (lambda halved) and refused otherwise (lambda x4).

    The problem holds every shard (points [L], observations [O]; a rank
    reads its own slices) or only this process's shards (its landmark and
    observation blocks, as ``distributed.host_sharded_array`` gives
    them), and the points come back in the same layout: the whole
    array is then gathered across the ranks once, after the iterations.
    The call queues its work on the problem's device and, within one
    process, returns without waiting for it."""
    n_shards, shards, group = layout(mesh, axis)
    assert L % n_shards == 0 and O % n_shards == 0
    Lb, Ob = L // n_shards, O // n_shards
    nl, no = len(shards) * Lb, len(shards) * Ob

    def run(p: ShardedBAProblem):
        whole = p.points.shape[0] == L
        if not whole and p.points.shape[0] != nl:
            raise ValueError(f"points {tuple(p.points.shape)}: neither the "
                             f"{L} landmarks nor this process's {nl}")
        l0, o0 = (shards[0] * Lb, shards[0] * Ob) if whole else (0, 0)

        def mine_l(x):
            return x[l0:l0 + nl]

        def mine_o(x):
            return x[o0:o0 + no]
        chi2_th = f32(chi2, p.kf_R)
        delta = torch.sqrt(chi2_th)
        lmv = mine_l(p.lm_valid)
        obs = [mine_o(x) for x in (p.obs_kf, p.obs_lm, p.obs_uv)]
        w2 = mine_o(p.obs_inv_sigma2 * p.obs_valid)
        urw = mine_o(p.obs_ur_weight)
        kR, kt, pts = p.kf_R, p.kf_t, mine_l(p.points)
        lam = f32(1e-4, kR)
        for _ in range(iters):
            views = _shard_views(shards, Lb, Ob, pts, lmv, *obs, w2, urw)
            dxc, dxp, err = _gn_step_shard(cam, stereo, chi2_th, kR, kt,
                                           p.kf_fixed, p.kf_valid, views,
                                           lam, group)
            kR2, kt2 = se3_retract(kR, kt, dxc)
            p2 = pts + torch.cat(dxp)
            (err_new,) = reduce([
                (_shard_error(cam, stereo, delta, kR2, kt2, s_pts, *rest),)
                for s_pts, _, *rest in _shard_views(
                    shards, Lb, Ob, p2, lmv, *obs, w2, urw)], group)
            good = err_new < err
            kR = torch.where(good, kR2, kR)
            kt = torch.where(good, kt2, kt)
            pts = torch.where(good, p2, pts)
            lam = torch.where(good, lam * 0.5, lam * 4.0)
        if whole and nl != L:
            pts = assemble(pts, l0, L, group)
        return kR, kt, pts

    return run


def partition_obs_by_landmark(obs_lm, obs_valid, n_shards: int, L: int,
                              O: int):
    """Host helper: the permutation that places each valid observation in
    the shard owning its landmark, in file order, the invalid and the
    overflowing ones filling the holes left (their weight is zero).

    Returns (perm [O], valid_out [O], ok): apply perm to every observation
    array and use valid_out (already permuted) as ``obs_valid``; it clears
    the valid observations that overflowed their shard's slice, which
    ``ok`` False reports. The same permutation as the reference's loop
    (:188-226), computed with array operations.
    """
    obs_lm = np.asarray(obs_lm)
    obs_valid = np.asarray(obs_valid)
    per = O // n_shards
    block = L // n_shards
    valid = np.flatnonzero(obs_valid)
    owner = np.clip(obs_lm[valid] // block, 0, n_shards - 1)
    order = np.argsort(owner, kind="stable")
    vs, own = valid[order], owner[order]
    rank = np.arange(len(vs)) - np.searchsorted(own, own, side="left")
    placed = rank < per
    perm = np.full(O, -1, np.int64)
    perm[own[placed] * per + rank[placed]] = vs[placed]
    spilled = ~obs_valid.astype(bool)
    spilled[vs[~placed]] = True
    holes = np.flatnonzero(perm < 0)
    perm[holes] = np.flatnonzero(spilled)
    valid_out = obs_valid[perm].copy()
    valid_out[holes] = False
    return perm, valid_out, bool(placed.all())
