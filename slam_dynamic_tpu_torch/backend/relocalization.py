"""Relocalization: BoW candidates -> PnP RANSAC -> pose polish.

Port of ``slam_dynamic_tpu/backend/relocalization.py`` (``_widen_matches``
:27, ``_match_frame_kf`` :61, ``relocalize`` :87), the reference's
Tracking::Relocalization: the keyframe database proposes up to
``max_candidates`` keyframes by BoW score; each is matched by descriptor
against the frame (at least 15 matches, optionally restricted to a shared
direct-index node), solved by PnP RANSAC (at least 10 inliers), polished
by the pose optimizer, widened by projection search at 10 px and then
3 px while the polished pose has fewer than ``min_inliers`` inliers, and
accepted at ``min_inliers``. Runs only for a LOST frame, so its readbacks
(one per gate) stay off the tracking path. The Hamming matrices of the
matching are kernel K2 on the card.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..models import vocabulary as voc_mod
from ..ops import hamming as hm
from ..ops.pnp import ransac_pnp
from ..optim.pose_opt import optimize_pose
from ..utils.camera import project
from ..utils.scatter import mark, set_last
from ..worldmap import kfdb as kfdb_mod
from ..worldmap.state import MapState


def _widen_matches(m: MapState, cam, k, R, t, fd, cur_lm, radius_px):
    """Projection search of keyframe k's landmarks around the pose (R, t)
    into the frame's unmatched static keypoints, within radius_px times the
    keypoint's scale (the reference's SearchByProjection retry rounds).
    Returns the merged per-slot landmark ids [N]."""
    L = m.lm_pos.shape[0]
    N = cur_lm.shape[0]
    ids = m.kf_obs_lm[k]
    idc = ids.clamp(0, L - 1).long()
    ok = m.kf_kp_valid[k] & (ids >= 0) & m.lm_valid[idc]
    # landmarks already found are skipped (ref sFound)
    used = mark(L + 1, torch.where(cur_lm >= 0, cur_lm, L))[:L]
    ok = ok & ~used[idc]
    xc = m.lm_pos[idc] @ R.T + t
    uv = project(cam, xc)
    ok = ok & (xc[:, 2] > 0.1)
    # the radius is the keypoint's: the gate is the transposed one
    pair = hm.radius_pair_mask(fd.xy, uv, radius_px * fd.scale).T
    free = fd.valid & fd.static_mask & (cur_lm < 0)
    dist = hm.masked_hamming_matrix(m.lm_desc[idc], ok, fd.desc, free,
                                    pair_mask=pair)
    lm_kp, _, mok = hm.match_nn(dist, max_dist=50)
    ext = torch.cat([cur_lm, cur_lm.new_full((1,), -1)])
    return set_last(ext, torch.where(mok, lm_kp, N),
                    torch.where(mok, ids, -1).to(ext.dtype))[:N]


def _match_frame_kf(frame_desc, frame_valid, kf_desc, kf_valid, kf_obs,
                    frame_node=None, kf_node=None):
    """Descriptor match frame -> keyframe restricted to keypoints with a
    landmark: per frame slot the landmark id, or -1. With the direct-index
    node ids of both (``vocabulary.transform``), pairs must also share a
    node (the reference's FeatureVector walk in SearchByBoW)."""
    has_lm = kf_valid & (kf_obs >= 0)
    pair = None
    if frame_node is not None:
        pair = (frame_node[:, None] == kf_node[None, :]) \
            & (frame_node[:, None] >= 0)
    dist = hm.masked_hamming_matrix(frame_desc, frame_valid, kf_desc, has_lm,
                                    pair_mask=pair)
    idx, _, ok = hm.match_nn(dist, max_dist=50, ratio=0.75, mutual=True)
    return torch.where(ok, kf_obs[idx.clamp(0, kf_obs.shape[0] - 1)], -1)


def relocalize(m: MapState, db: kfdb_mod.KFDatabase, voc, cam, frame_data,
               seed: int = 0, max_candidates: int = 5,
               min_inliers: int = 50, use_direct_index: bool = False,
               di_level: int = 2,
               sample_fn: Optional[Callable] = None):
    """Try to relocalize a lost frame. Returns (ok, R, t, obs_lm [N],
    cand_slot): cand_slot is the keyframe the accepted candidate was (-1
    on failure), a verified loop observation for
    ``LoopCloser.on_relocalization``. Candidate number ``rank`` draws its
    PnP samples from ``seed + rank``, or from ``sample_fn(rank, mask)``
    when given (the parity tests pass JAX's draws)."""
    fd = frame_data
    bv = voc_mod.transform(voc, fd.desc, fd.valid, di_level=di_level)
    hist = voc_mod.sparse_bow(bv, top_w=db.word.shape[1])
    # culled keyframes keep their database rows but are excluded
    cand = kfdb_mod.query(db, hist, m.covis, ~m.kf_valid)
    scores = cand.score.cpu().numpy()
    order = np.argsort(-scores)[:max_candidates]
    L = m.lm_pos.shape[0]
    inv_s2 = 1.0 / (fd.scale ** 2)
    for rank, k in enumerate(order):
        if scores[k] <= 0:
            break
        fn = kn = None
        if use_direct_index:
            kf_bv = voc_mod.transform(voc, m.kf_kp_desc[k], m.kf_kp_valid[k],
                                      di_level=di_level)
            fn, kn = bv.node, kf_bv.node
        lm = _match_frame_kf(fd.desc, fd.valid & fd.static_mask,
                             m.kf_kp_desc[k], m.kf_kp_valid[k],
                             m.kf_obs_lm[k], fn, kn)
        if int((lm >= 0).sum()) < 15:               # ref :2265
            continue
        lmc = lm.clamp(0, L - 1).long()
        xw = m.lm_pos[lmc]
        ok_lm = (lm >= 0) & m.lm_valid[lmc]
        if sample_fn is not None:
            fit = ransac_pnp(cam, xw, fd.xy, ok_lm,
                             sample_idx=sample_fn(rank, ok_lm))
        else:
            fit = ransac_pnp(cam, xw, fd.xy, ok_lm, seed=torch.tensor(
                seed + rank, dtype=torch.int64, device=xw.device))
        if int(fit.n_inliers) < 10:                 # ref :2310
            continue
        res = optimize_pose(cam, fit.R, fit.t, xw, fd.xy, inv_s2,
                            ok_lm & fit.inliers, stereo=False)
        n_good = int(res.n_inliers)
        # widening rounds (ref Tracking.cc:2320-2366)
        for radius in (10.0, 3.0):
            if n_good >= min_inliers or n_good < 10:
                break
            obs0 = torch.where(res.inliers & ok_lm, lm, -1).to(torch.int32)
            lm = _widen_matches(m, cam, k, res.R, res.t, fd, obs0, radius)
            lmc = lm.clamp(0, L - 1).long()
            ok_lm = (lm >= 0) & m.lm_valid[lmc]
            xw = m.lm_pos[lmc]
            res = optimize_pose(cam, res.R, res.t, xw, fd.xy, inv_s2, ok_lm,
                                stereo=False)
            n_good = int(res.n_inliers)
        if n_good >= min_inliers:
            obs = torch.where(res.inliers & ok_lm, lm, -1).to(torch.int32)
            return True, res.R, res.t, obs, int(k)
    return False, None, None, None, -1
