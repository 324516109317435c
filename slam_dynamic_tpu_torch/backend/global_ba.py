"""Full-map (global) bundle adjustment from a MapState, and its amortized
post-loop form.

Port of ``slam_dynamic_tpu/backend/global_ba.py`` (``_build_problem`` :24,
``global_bundle_adjust`` :91, ``AmortizedGBA`` :107 with ``step`` :139
and ``merge`` :148), the reference's Optimizer::GlobalBundleAdjustemnt
and the merge of LoopClosing::RunGlobalBundleAdjustment. The solve is
the landmark-sharded GN of ``parallel/sharded_ba.py``: one shard unless
``n_devices`` asks for the multi-shard layout, which then runs shard
after shard on the map's device, or ``mesh`` lays the shards out over a
``Mesh`` (where JAX's ``_build_problem`` :29 calls ``make_mesh``): over
``distributed.global_mesh()`` every rank, holding the same map, solves
its own landmarks and the ranks sum their systems by all-reduce.
Everything runs on the device of the map it is given.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..parallel import sharded_ba as sba
from ..parallel.mesh import Mesh
from ..utils.camera import Intrinsics
from ..worldmap.state import MapState


def _build_problem(m: MapState, cam: Intrinsics, stereo: bool,
                   n_devices: Optional[int], scale_factor: float,
                   mesh: Optional[Mesh] = None):
    """The map at this instant as a landmark-sharded BA problem over
    ``mesh`` (else ``n_devices`` shards, else one). Its one readback (the
    observation table, for the host partition) is the only wait for the
    device."""
    dev = m.kf_R.device
    K, N = m.kf_obs_lm.shape
    L = m.lm_pos.shape[0]
    n_shards = (mesh.shape["lm"] if mesh is not None
                else 1 if n_devices is None else n_devices)
    Lp = -(-L // n_shards) * n_shards
    O = K * N
    Oc = -(-O // n_shards) * n_shards

    # one readback: landmark id, validity, x, y, u_right and level of
    # every keypoint slot (ids and levels are exact in float32)
    valid_d = (m.kf_obs_lm >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    host = torch.stack([m.kf_obs_lm.to(torch.float32),
                        valid_d.to(torch.float32), m.kf_kp_xy[..., 0],
                        m.kf_kp_xy[..., 1], m.kf_kp_ur,
                        m.kf_kp_level.to(torch.float32)],
                       -1).reshape(O, 6).cpu().numpy()
    valid = host[:, 1] > 0
    olm = np.where(valid, host[:, 0], 0).astype(np.int32)
    okf = np.repeat(np.arange(K, dtype=np.int32), N)
    xy, ur = host[:, 2:4], host[:, 4]
    inv_s2 = 1.0 / (scale_factor ** (2.0 * host[:, 5]))
    pad = Oc - O

    def padv(a, fill=0):
        return np.concatenate(
            [a, np.full((pad,) + a.shape[1:], fill, a.dtype)])

    uv = np.concatenate([xy, ur[:, None]], 1) if stereo else xy
    urw = (ur > 0).astype(np.float32)
    perm, valid_out, _ok = sba.partition_obs_by_landmark(
        padv(olm), padv(valid), n_shards, Lp, Oc)
    # a shard that overflowed drops the observations past its slice

    def up(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t if dtype is None else t.to(dtype)

    fixed = torch.zeros(K, dtype=torch.bool, device=dev)
    fixed[0] = True
    pts = torch.zeros((Lp, 3), dtype=torch.float32, device=dev)
    pts[:L] = m.lm_pos
    lmv = torch.zeros(Lp, dtype=torch.bool, device=dev)
    lmv[:L] = m.lm_valid
    problem = sba.ShardedBAProblem(
        kf_R=m.kf_R, kf_t=m.kf_t, kf_fixed=fixed, kf_valid=m.kf_valid,
        points=pts, lm_valid=lmv,
        obs_kf=up(padv(okf)[perm], torch.int64),
        obs_lm=up(padv(olm)[perm], torch.int64),
        obs_uv=up(padv(uv.astype(np.float32))[perm]),
        obs_inv_sigma2=up(padv(inv_s2.astype(np.float32))[perm]),
        obs_valid=up(valid_out),
        obs_ur_weight=up(padv(urw)[perm]))
    return problem, n_shards, K, L, Lp, Oc


def global_bundle_adjust(m: MapState, cam: Intrinsics, stereo: bool = True,
                         iters: int = 15, n_devices: Optional[int] = None,
                         scale_factor: float = 1.2,
                         mesh: Optional[Mesh] = None) -> MapState:
    """Global BA over every valid keyframe and landmark, written back."""
    problem, n_shards, K, L, Lp, Oc = _build_problem(
        m, cam, stereo, n_devices, scale_factor, mesh)
    run = sba.make_sharded_ba(n_shards if mesh is None else mesh, cam, K=K,
                              L=Lp, O=Oc, stereo=stereo, iters=iters)
    kf_R, kf_t, pts = run(problem)
    return m._replace(
        kf_R=torch.where(m.kf_valid[:, None, None], kf_R, m.kf_R),
        kf_t=torch.where(m.kf_valid[:, None], kf_t, m.kf_t),
        lm_pos=torch.where(m.lm_valid[:, None], pts[:L], m.lm_pos))


class AmortizedGBA:
    """The post-loop global BA, spread over the frames that follow.

    The reference runs its GBA in a detached thread and merges when it
    finishes (LoopClosing::RunGlobalBundleAdjustment): keyframes inserted
    during the solve are corrected through their parent, landmarks through
    their reference keyframe. Here the problem snapshotted at the loop
    advances ``slice_iters`` GN iterations per tracked frame, each slice
    queued on the device without waiting for it, and ``merge`` applies
    the same propagation rules to the map as it stands then.
    """

    def __init__(self, m: MapState, cam: Intrinsics, stereo: bool,
                 total_iters: int = 15, slice_iters: int = 3,
                 n_devices: Optional[int] = None,
                 scale_factor: float = 1.2, mesh: Optional[Mesh] = None):
        self.cam = cam
        self.problem, n_shards, K, L, Lp, Oc = _build_problem(
            m, cam, stereo, n_devices, scale_factor, mesh)
        self.run = sba.make_sharded_ba(n_shards if mesh is None else mesh,
                                       cam, K=K, L=Lp, O=Oc, stereo=stereo,
                                       iters=slice_iters)
        self.L = L
        self.remaining = total_iters
        self.slice_iters = slice_iters
        # snapshot membership, for the merge's propagation
        self.snap_kf_valid = m.kf_valid
        self.snap_lm_valid = m.lm_valid

    @property
    def done(self) -> bool:
        return self.remaining <= 0

    def step(self):
        """Queue one slice of GN iterations on the device."""
        if self.done:
            return
        kf_R, kf_t, pts = self.run(self.problem)
        self.problem = self.problem._replace(kf_R=kf_R, kf_t=kf_t,
                                             points=pts)
        self.remaining -= self.slice_iters

    def merge(self, m: MapState) -> MapState:
        """The solve written into the current map ``m``, carried to the
        keyframes and landmarks made since the snapshot (the reference's
        merge, LoopClosing.cc:698-748)."""
        K = m.kf_valid.shape[0]
        L = self.L
        R_opt, t_opt = self.problem.kf_R, self.problem.kf_t
        in_snap = self.snap_kf_valid
        # a new keyframe follows its strongest covisible keyframe of the
        # snapshot (ties to the lowest index) and keeps its current
        # transform relative to it (the reference's Tchild_parent *
        # TcorrectedParent)
        covis_snap = torch.where(in_snap[None, :], m.covis,
                                 torch.full_like(m.covis, -1))
        parent = torch.argmax(covis_snap, dim=1)
        has_par = covis_snap.gather(1, parent[:, None])[:, 0] > 0
        Rp_old, tp_old = m.kf_R[parent], m.kf_t[parent]
        R_rel = torch.einsum("kij,kpj->kip", m.kf_R, Rp_old)    # R_k R_p^T
        t_rel = m.kf_t - torch.einsum("kij,kj->ki", R_rel, tp_old)
        R_prop = torch.einsum("kij,kjl->kil", R_rel, R_opt[parent])
        t_prop = torch.einsum("kij,kj->ki", R_rel, t_opt[parent]) + t_rel
        new_kf = m.kf_valid & ~in_snap & has_par
        kf_R = torch.where(in_snap[:, None, None], R_opt,
                           torch.where(new_kf[:, None, None], R_prop, m.kf_R))
        kf_t = torch.where(in_snap[:, None], t_opt,
                           torch.where(new_kf[:, None], t_prop, m.kf_t))
        # landmarks of the snapshot take the solved positions; newer ones
        # move with their reference keyframe's pose change (the
        # reference's mTcwBefGBA path)
        pts_opt = self.problem.points[:L]
        ref = torch.clamp(m.lm_first_kf, 0, K - 1).long()
        x_cam = torch.einsum("lij,lj->li", m.kf_R[ref], m.lm_pos) \
            + m.kf_t[ref]
        x_prop = torch.einsum("lji,lj->li", kf_R[ref], x_cam - kf_t[ref])
        Lm = m.lm_pos.shape[0]
        in_snap_lm = self.snap_lm_valid & (
            torch.arange(Lm, device=m.lm_pos.device) < L)
        lm_pos = torch.where(
            (m.lm_valid & in_snap_lm)[:, None], pts_opt,
            torch.where(m.lm_valid[:, None], x_prop, m.lm_pos))
        return m._replace(kf_R=kf_R, kf_t=kf_t, lm_pos=lm_pos)
