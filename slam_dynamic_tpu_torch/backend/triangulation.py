"""New-landmark creation by two-view triangulation between covisible
keyframes.

Port of ``slam_dynamic_tpu/backend/triangulation.py``
(``fundamental_from_poses``, ``triangulate_dlt``, ``triangulate_between``
:59, ``create_new_landmarks`` :176 (mono), ``_insert_triangulated``,
``triangulate_with_neighbors`` :234): for
the new keyframe and each of its best earlier covisible neighbours, match
unbound keypoints under the epipolar and octave gates (the Hamming matrix
is kernel K2 on the card), triangulate by DLT or take the stereo depth
(the reference's stereo arbitration), and keep the points that pass the
parallax, depth, reprojection and scale checks.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import hamming as hm
from ..ops.nullspace import null_vector
from ..ops.orb import topk_stable
from ..utils.camera import Intrinsics, backproject, project
from ..utils.scatter import set_last
from ..worldmap.state import MapState, add_landmarks


def fundamental_from_poses(cam: Intrinsics, R1, t1, R2, t2):
    """F with x1^T F x2 = 0 for world->camera poses (ComputeF12)."""
    R12 = R1 @ R2.T
    t12 = t1 - R12 @ t2
    z = torch.zeros_like(t12[0])
    tx = torch.stack([torch.stack([z, -t12[2], t12[1]]),
                      torch.stack([t12[2], z, -t12[0]]),
                      torch.stack([-t12[1], t12[0], z])])
    Kinv = torch.linalg.inv_ex(cam.K)[0]
    return Kinv.T @ tx @ R12 @ Kinv


def triangulate_dlt(cam: Intrinsics, R1, t1, R2, t2, uv1, uv2):
    """Batched two-view DLT triangulation -> world points [N, 3]."""
    P1 = cam.K @ torch.cat([R1, t1[:, None]], dim=1)
    P2 = cam.K @ torch.cat([R2, t2[:, None]], dim=1)
    A = torch.stack([uv1[:, 0, None] * P1[2] - P1[0],
                     uv1[:, 1, None] * P1[2] - P1[1],
                     uv2[:, 0, None] * P2[2] - P2[0],
                     uv2[:, 1, None] * P2[2] - P2[1]], dim=1)   # [N, 4, 4]
    X = null_vector(A)
    w = X[:, 3:]
    return X[:, :3] / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12),
                                  w)


class TriangulationOut(NamedTuple):
    points: torch.Tensor    # [N, 3] world positions (kf1 keypoint slots)
    idx2: torch.Tensor      # [N] matched keypoint slot in kf2
    ok: torch.Tensor        # [N] bool passed all checks


def _rays(cam, R, uv):
    ones = torch.ones(uv.shape[0], device=uv.device)
    return backproject(cam, uv, ones) @ R        # R^T x, row-wise


def triangulate_between(cam: Intrinsics, scale_factor,
                        kp1_xy, kp1_desc, kp1_valid, kp1_level, kp1_angle,
                        kp1_unbound, R1, t1,
                        kp2_xy, kp2_desc, kp2_valid, kp2_level, kp2_angle,
                        kp2_unbound, R2, t2,
                        n_levels: int = 8, epipolar_th: float = 3.84,
                        chi2_mono: float = 5.991,
                        kp1_depth=None, kp1_ur=None,
                        kp2_depth=None, kp2_ur=None,
                        chi2_stereo: float = 7.8) -> TriangulationOut:
    """Triangulate unbound keypoints of KF1 against unbound of KF2 (with
    the stereo arbitration when depths are given)."""
    F12 = fundamental_from_poses(cam, R1, t1, R2, t2)
    dev = kp1_xy.device
    x1h = torch.cat([kp1_xy, torch.ones(kp1_xy.shape[0], 1, device=dev)], 1)
    x2h = torch.cat([kp2_xy, torch.ones(kp2_xy.shape[0], 1, device=dev)], 1)
    lines2 = x1h @ F12
    num = (lines2 @ x2h.T) ** 2
    den = torch.clamp(lines2[:, 0] ** 2 + lines2[:, 1] ** 2, min=1e-12)
    sigma2_2 = scale_factor ** (2.0 * kp2_level.to(torch.float32))
    epi_ok = num / den[:, None] < epipolar_th * sigma2_2[None, :]

    lvl_ok = hm.level_pair_mask(kp1_level, kp2_level, -1, 1)
    dist = hm.masked_hamming_matrix(
        kp1_desc, kp1_valid & kp1_unbound, kp2_desc,
        kp2_valid & kp2_unbound, pair_mask=epi_ok & lvl_ok)
    idx2, _, ok = hm.match_nn(dist, max_dist=50, ratio=0.9, mutual=True)
    ok = hm.rotation_consistency(kp1_angle, kp2_angle, idx2, ok)

    idx2c = idx2.clamp(0, kp2_xy.shape[0] - 1)
    uv2 = kp2_xy[idx2c]
    X = triangulate_dlt(cam, R1, t1, R2, t2, kp1_xy, uv2)

    O1 = -R1.T @ t1
    O2 = -R2.T @ t2
    ray1 = _rays(cam, R1, kp1_xy)
    ray2 = _rays(cam, R2, uv2)
    cosp = (ray1 * ray2).sum(-1) / torch.clamp(
        torch.linalg.norm(ray1, dim=-1) * torch.linalg.norm(ray2, dim=-1),
        min=1e-9)

    if kp1_depth is not None:
        b = cam.baseline
        d2g = kp2_depth[idx2c]
        two = torch.full_like(kp1_depth, 2.0)
        cs1 = torch.where(kp1_depth > 0, torch.cos(
            2.0 * torch.atan2(b / 2.0, kp1_depth)), two)
        cs2 = torch.where(d2g > 0, torch.cos(
            2.0 * torch.atan2(b / 2.0, d2g)), two)
        cos_stereo = torch.minimum(cs1, cs2)
        good_dlt = (cosp > 0) & (cosp < 0.9998) & (cosp < cos_stereo)
        use_s1 = ~good_dlt & (kp1_depth > 0) & (cs1 <= cs2)
        use_s2 = ~good_dlt & ~use_s1 & (d2g > 0)
        xw1 = (backproject(cam, kp1_xy, kp1_depth) - t1[None, :]) @ R1
        xw2 = (backproject(cam, uv2, d2g) - t2[None, :]) @ R2
        X = torch.where(good_dlt[:, None], X,
                        torch.where(use_s1[:, None], xw1, xw2))
        ok = ok & (good_dlt | use_s1 | use_s2)
    else:
        ok = ok & (cosp > 0) & (cosp < 0.9998)

    xc1 = X @ R1.T + t1
    xc2 = X @ R2.T + t2
    ok = ok & (xc1[:, 2] > 0.05) & (xc2[:, 2] > 0.05)
    r1 = X - O1
    r2 = X - O2
    e1 = ((project(cam, xc1) - kp1_xy) ** 2).sum(-1)
    e2 = ((project(cam, xc2) - uv2) ** 2).sum(-1)
    s21 = scale_factor ** (2.0 * kp1_level.to(torch.float32))
    s22 = (scale_factor ** (2.0 * kp2_level.to(torch.float32)))[idx2c]
    if kp1_depth is not None:
        z1 = torch.clamp(xc1[:, 2], min=1e-9)
        z2 = torch.clamp(xc2[:, 2], min=1e-9)
        ur1_pred = project(cam, xc1)[:, 0] - cam.bf / z1
        ur2_pred = project(cam, xc2)[:, 0] - cam.bf / z2
        ur2g = kp2_ur[idx2c]
        e1s = e1 + (ur1_pred - kp1_ur) ** 2
        e2s = e2 + (ur2_pred - ur2g) ** 2
        ok1 = torch.where(kp1_ur >= 0, e1s < chi2_stereo * s21,
                          e1 < chi2_mono * s21)
        ok2 = torch.where(ur2g >= 0, e2s < chi2_stereo * s22,
                          e2 < chi2_mono * s22)
        ok = ok & ok1 & ok2
    else:
        ok = ok & (e1 < chi2_mono * s21) & (e2 < chi2_mono * s22)
    d1 = torch.linalg.norm(r1, dim=-1)
    d2 = torch.linalg.norm(r2, dim=-1)
    ratio_d = d1 / torch.clamp(d2, min=1e-9)
    lvl2 = kp2_level[idx2c]
    ratio_o = scale_factor ** (kp1_level - lvl2).to(torch.float32)
    rf = scale_factor * 1.5
    ok = ok & (ratio_d < ratio_o * rf) & (ratio_d > ratio_o / rf)
    return TriangulationOut(X, idx2, ok)


def create_new_landmarks(m: MapState, cam: Intrinsics, k: int,
                         scale_factor: float, n_neighbors: int = 5,
                         n_levels: int = 8) -> MapState:
    """Mono keyframes: triangulate keyframe k against its best earlier
    covisible neighbours (weight >= 15) and insert the new landmarks. The
    neighbours are ordered on a host copy by ``np.argsort`` as the
    reference orders them (a torch sort breaks ties otherwise); one
    readback per keyframe."""
    covis = m.covis[k].cpu().numpy().copy()
    covis[int(k):] = 0                     # only earlier keyframes
    order = np.argsort(-covis)[:n_neighbors]
    dev = m.kf_R.device
    sf = torch.tensor(scale_factor, dtype=torch.float32, device=dev)
    for k2 in order:
        if covis[k2] < 15:
            break
        k2 = int(k2)
        out = triangulate_between(
            cam, sf,
            m.kf_kp_xy[k], m.kf_kp_desc[k], m.kf_kp_valid[k],
            m.kf_kp_level[k], m.kf_kp_angle[k], m.kf_obs_lm[k] < 0,
            m.kf_R[k], m.kf_t[k],
            m.kf_kp_xy[k2], m.kf_kp_desc[k2], m.kf_kp_valid[k2],
            m.kf_kp_level[k2], m.kf_kp_angle[k2], m.kf_obs_lm[k2] < 0,
            m.kf_R[k2], m.kf_t[k2], n_levels=n_levels)
        m = _insert_triangulated(m, k, torch.tensor(k2, device=dev), out,
                                 sf, n_levels)
    return m


def _insert_triangulated(m: MapState, k, k2, out: TriangulationOut,
                         scale_factor, n_levels: int) -> MapState:
    N = out.points.shape[0]
    Ow = -(m.kf_t[k] @ m.kf_R[k])
    po = out.points - Ow
    dist = torch.linalg.norm(po, dim=-1)
    normal = po / torch.clamp(dist, min=1e-9)[:, None]
    dmax = dist * scale_factor ** m.kf_kp_level[k].to(torch.float32)
    dmin = dmax / (scale_factor ** (n_levels - 1))
    slots = torch.arange(N, dtype=torch.int32, device=dist.device)
    m = add_landmarks(m, out.points, m.kf_kp_desc[k], normal, dmin, dmax,
                      torch.zeros_like(slots) + k, slots, out.ok)
    # bind the second observation in kf2 (masked writes go to a sink slot)
    new_ids = m.kf_obs_lm[k]
    write = out.ok & (new_ids >= 0)
    Nk = m.kf_obs_lm.shape[1]
    row_ext = torch.cat([m.kf_obs_lm[k2], new_ids.new_full((1,), -1)])
    row = set_last(row_ext, torch.where(write, out.idx2, Nk), new_ids)[:Nk]
    return m._replace(kf_obs_lm=m.kf_obs_lm.index_copy(
        0, k2.reshape(1).long(), row[None]))


def triangulate_with_neighbors(m: MapState, cam: Intrinsics, k,
                               scale_factor, *, n_neighbors: int,
                               n_levels: int, stereo: bool) -> MapState:
    """CreateNewMapPoints as device work: keyframe k against its top
    ``n_neighbors`` earlier covisible keyframes (weight >= 15 as a mask)."""
    K = m.kf_R.shape[0]
    ar = torch.arange(K, device=m.kf_R.device)
    row = torch.where((ar < k) & m.kf_valid, m.covis[k], 0)
    _, nbrs = topk_stable(row, n_neighbors)
    for i in range(n_neighbors):
        k2 = nbrs[i]
        w_ok = row[k2] >= 15
        unbound1 = m.kf_obs_lm[k] < 0
        unbound2 = m.kf_obs_lm[k2] < 0
        kw = dict(n_levels=n_levels)
        if stereo:
            kw.update(kp1_depth=m.kf_kp_depth[k], kp1_ur=m.kf_kp_ur[k],
                      kp2_depth=m.kf_kp_depth[k2], kp2_ur=m.kf_kp_ur[k2])
        out = triangulate_between(
            cam, scale_factor,
            m.kf_kp_xy[k], m.kf_kp_desc[k], m.kf_kp_valid[k],
            m.kf_kp_level[k], m.kf_kp_angle[k], unbound1,
            m.kf_R[k], m.kf_t[k],
            m.kf_kp_xy[k2], m.kf_kp_desc[k2], m.kf_kp_valid[k2],
            m.kf_kp_level[k2], m.kf_kp_angle[k2], unbound2,
            m.kf_R[k2], m.kf_t[k2], **kw)
        out = out._replace(ok=out.ok & w_ok)
        m = _insert_triangulated(m, k, k2, out, scale_factor, n_levels)
    return m
