"""Motion-only pose optimization (the per-frame optimizer): kernel K3.

Port of ``slam_dynamic_tpu/optim/pose_opt.py:43`` ``optimize_pose``:
rounds x iterations of Levenberg-Marquardt on one SE3 pose; between rounds
the edges are relabelled inlier/outlier by a chi2 gate (5.991 mono, 7.815
stereo) and the Huber kernel is dropped after round 2. Step acceptance is
a ``torch.where`` on device, so the loop never waits for the card.

``optimize_pose_plain`` is that loop in PyTorch ops. On the card it is
about 80 launches per evaluation of the terms, some 17k a tracked frame,
so ``optimize_pose`` runs each call as ONE launch of kernel K3
(``csrc/kernels.cu``; it replaces no Pallas kernel: the JAX package left
the loop to XLA's fusion) through the ``torch.library`` custom op
``pose_lm``, whose vmap rule makes the lanes of the batched tracking step
(``frontend/fused.py:fused_track_step_batch``) one launch of K3 with a
lane axis (``launch_k3``). On CPU tensors ``optimize_pose`` is the
plain loop.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import kernels
from ..utils import profiling
from ..utils.camera import Intrinsics
from ..utils.se3 import orthonormalize, se3_retract
from .residuals import huber_weight, reprojection_terms, robust_cost

# Launches of kernel K3: one per call of pose_lm, one per batched launch
# (the batched ones are also counted in batched_launches).
launches = 0
batched_launches = 0


class PoseOptResult(NamedTuple):
    R: torch.Tensor         # [3,3] optimized pose (world->camera)
    t: torch.Tensor         # [3]
    inliers: torch.Tensor   # [N] bool final inlier labels
    n_inliers: torch.Tensor  # int32
    chi2: torch.Tensor      # [N] final chi2 per observation


def _normal_equations(terms, w):
    JW = terms.J_pose * w[:, None, None]                # [N, D, 6]
    H = torch.einsum("ndi,ndj->ij", JW, terms.J_pose)
    b = -torch.einsum("ndi,nd->i", JW, terms.r)
    return H, b


def f32(v, like: torch.Tensor) -> torch.Tensor:
    """0-d float32 tensor on ``like``'s device (a traced constant in JAX),
    filled on the device rather than copied from the host."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def optimize_pose_plain(cam: Intrinsics, R0, t0, xw, obs, inv_sigma2, valid,
                        stereo: bool = False, rounds: int = 4,
                        iters: int = 10, chi2_mono: float = 5.991,
                        chi2_stereo: float = 7.815, ur_weight=None
                        ) -> PoseOptResult:
    """Plain version of K3: LM pose refinement with chi2 relabelling
    between rounds, in PyTorch ops.

    xw [N,3], obs [N,2|3], inv_sigma2 [N], valid [N] bool; ur_weight
    optional [N] row mask for observations without stereo depth.
    """
    chi2_th = f32(chi2_stereo if stereo else chi2_mono, R0)
    delta = torch.sqrt(chi2_th)
    eye6 = torch.eye(6, dtype=R0.dtype, device=R0.device)

    def terms_at(R, t):
        return reprojection_terms(cam, R, t, xw, obs, inv_sigma2, stereo,
                                  ur_weight)

    def lm_round(R, t, inlier_mask, use_huber):
        lam = f32(1e-3, R0)
        mask_w = inlier_mask * (inv_sigma2 > 0)
        for _ in range(iters):
            terms = terms_at(R, t)
            w = inv_sigma2 * inlier_mask
            w = w * (terms.depth > 1e-3)
            if use_huber:
                w = w * huber_weight(terms.chi2, delta)
            H, b = _normal_equations(terms, w)
            Hd = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye6
            dx = torch.linalg.solve_ex(Hd, b)[0]
            R_new, t_new = se3_retract(R, t, dx)
            terms_new = terms_at(R_new, t_new)
            err_old = (robust_cost(terms.chi2, delta) * mask_w).sum()
            err_new = (robust_cost(terms_new.chi2, delta) * mask_w).sum()
            good = err_new < err_old
            R = torch.where(good, R_new, R)
            t = torch.where(good, t_new, t)
            lam = torch.where(good, lam * 0.5, lam * 4.0)
        return R, t

    R, t = R0, t0
    inlier = valid.to(torch.float32)
    for rnd in range(rounds):
        R, t = lm_round(R, t, inlier, rnd < 2)
        terms = terms_at(R, t)
        ok = (terms.chi2 <= chi2_th) & (terms.depth > 1e-3) & valid
        inlier = ok.to(torch.float32)
    R = orthonormalize(R)
    terms = terms_at(R, t)
    inl = inlier.bool()
    return PoseOptResult(R, t, inl, inl.sum().to(torch.int32), terms.chi2)


def optimize_pose(cam: Intrinsics, R0, t0, xw, obs, inv_sigma2, valid,
                  stereo: bool = False, rounds: int = 4, iters: int = 10,
                  chi2_mono: float = 5.991, chi2_stereo: float = 7.815,
                  ur_weight=None) -> PoseOptResult:
    """LM pose refinement with chi2 relabelling between rounds.

    xw [N,3], obs [N,2|3] (3 iff ``stereo``), inv_sigma2 [N], valid [N]
    bool; ur_weight optional [N] row mask for observations without stereo
    depth. The plain loop on CPU tensors; on CUDA tensors one launch of
    K3 (under ``torch.func.vmap``, one for all lanes).
    """
    if R0.device.type == "cpu":
        return optimize_pose_plain(cam, R0, t0, xw, obs, inv_sigma2, valid,
                                   stereo, rounds, iters, chi2_mono,
                                   chi2_stereo, ur_weight)
    if stereo != (obs.shape[-1] == 3):
        raise ValueError(f"obs {tuple(obs.shape)}: stereo={stereo} takes "
                         f"{3 if stereo else 2} values per observation")
    if ur_weight is None:
        ur_weight = torch.ones_like(inv_sigma2)
    cam5 = torch.stack([cam.fx, cam.fy, cam.cx, cam.cy, cam.bf])
    return PoseOptResult(*pose_lm(
        cam5, R0.contiguous(), t0.contiguous(), xw.contiguous(),
        obs.contiguous(), inv_sigma2.contiguous(), valid.contiguous(),
        ur_weight.contiguous(), rounds, iters,
        chi2_stereo if stereo else chi2_mono))


def pose_lm_plain(cam, R0, t0, xw, obs, inv_sigma2, valid, ur_weight,
                  rounds: int, iters: int, chi2_th: float) -> PoseOptResult:
    """Plain version of ``pose_lm``: ``optimize_pose_plain`` on its
    arguments."""
    z = cam.new_zeros(())
    intr = Intrinsics(cam[0], cam[1], cam[2], cam[3], z, z, z, z, z, cam[4],
                      0, 0)
    return optimize_pose_plain(intr, R0, t0, xw, obs, inv_sigma2, valid,
                               obs.shape[-1] == 3, rounds, iters, chi2_th,
                               chi2_th, ur_weight)


def pose_lm(cam, R0, t0, xw, obs, inv_sigma2, valid, ur_weight,
            rounds: int, iters: int, chi2_th: float):
    """One ``optimize_pose`` call on flat CUDA tensors, one launch of K3:
    cam [5] float32 (fx, fy, cx, cy, bf), R0 [3, 3], t0 [3], xw [N, 3],
    obs [N, D] (D = 2 mono, 3 stereo), inv_sigma2 [N], valid [N] bool,
    ur_weight [N] (ones where none), each contiguous; the chi2 gate
    ``chi2_th``. Returns (R, t, inliers, n_inliers, chi2) as
    ``PoseOptResult`` orders them. Under ``torch.func.vmap`` the lanes go
    to one launch of K3 with a lane axis."""
    return _pose_lm_op(cam, R0, t0, xw, obs, inv_sigma2, valid, ur_weight,
                       int(rounds), int(iters), float(chi2_th))


@torch.library.custom_op("slam_dynamic_tpu_torch::pose_lm", mutates_args=())
def _pose_lm_op(cam: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor,
                xw: torch.Tensor, obs: torch.Tensor, inv_sigma2: torch.Tensor,
                valid: torch.Tensor, ur_weight: torch.Tensor, rounds: int,
                iters: int, chi2_th: float
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
    return launch_k3(cam, R0, t0, xw, obs, inv_sigma2, valid, ur_weight,
                     rounds, iters, chi2_th)


def _pose_lm_vmap(info, in_dims, *args):
    """vmap rule of the op: the lanes' calls as one launch of K3 with a
    lane axis (first; an unbatched argument is shared by every lane)."""
    tensors = [kernels.lane_major(a, d, info.batch_size)
               for a, d in zip(args[:8], in_dims)]
    return launch_k3(*tensors, *args[8:]), (0,) * 5


torch.library.register_vmap("slam_dynamic_tpu_torch::pose_lm", _pose_lm_vmap)


def launch_k3(cam, R0, t0, xw, obs, inv_sigma2, valid, ur_weight,
              rounds: int, iters: int, chi2_th: float):
    """One launch of K3's batched entry point on CUDA tensors: one problem
    (``pose_lm``'s arguments, B = 1) or B lanes (each argument with a
    leading [B] axis, the same N and D in every lane). Returns (R, t,
    inliers, n_inliers, chi2), with the lane axis if the arguments have
    one."""
    global launches, batched_launches
    dev = R0.device
    lanes = tuple(R0.shape[:-2])
    if dev.type != "cuda":
        raise ValueError(f"pose_lm: R0 on {dev}: kernel K3 takes CUDA "
                         f"tensors (optimize_pose_plain is the CPU's loop)")
    if len(lanes) > 1 or obs.dim() < 2 or obs.shape[-1] not in (2, 3):
        raise ValueError(f"pose_lm: R0 {tuple(R0.shape)} and obs "
                         f"{tuple(obs.shape)}: expected [B?, 3, 3] and "
                         f"[B?, N, 2 | 3]")
    n, d = obs.shape[-2], obs.shape[-1]
    f = torch.float32
    args = [("cam", cam, f, (5,)), ("R0", R0, f, (3, 3)),
            ("t0", t0, f, (3,)), ("xw", xw, f, (n, 3)),
            ("obs", obs, f, (n, d)), ("inv_sigma2", inv_sigma2, f, (n,)),
            ("valid", valid, torch.bool, (n,)),
            ("ur_weight", ur_weight, f, (n,))]
    for name, t, dtype, shape in args:
        kernels.require(t, name, dtype, lanes + shape, dev)
    R = torch.empty(lanes + (3, 3), dtype=f, device=dev)
    t = torch.empty(lanes + (3,), dtype=f, device=dev)
    inliers = torch.empty(lanes + (n,), dtype=torch.bool, device=dev)
    n_inliers = torch.empty(lanes, dtype=torch.int32, device=dev)
    chi2 = torch.empty(lanes + (n,), dtype=f, device=dev)
    ptrs = [a[1].data_ptr() for a in args] + [
        x.data_ptr() for x in (R, t, inliers, n_inliers, chi2)]
    status = kernels.lib().slam_pose_lm_batched(
        *ptrs, lanes[0] if lanes else 1, n, d, rounds, iters, chi2_th,
        kernels.stream_handle(dev))
    kernels.check(status, "pose_lm")
    launches += 1
    batched_launches += bool(lanes)
    profiling.count("pose_lm_launches", 1)
    return R, t, inliers, n_inliers, chi2
