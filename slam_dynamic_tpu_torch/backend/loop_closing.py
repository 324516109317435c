"""Loop closing: detection, Sim3 verification and essential-graph
correction, on keyframes and on relocalization.

Port of ``slam_dynamic_tpu/backend/loop_closing.py`` (the reference's
LoopClosing thread): ``_detect_device`` :37, the pair matchers
``_match_kf_pair`` :63 and ``_match_kf_pair_any`` :73, ``_depth_pairs``
:82, ``_sim3_widen`` :106, ``_loop_landmark_set`` :158,
``_loop_projection_count`` :178, ``LoopResult`` :207 and ``LoopCloser``
:214 (``on_keyframe`` :230, ``on_relocalization`` :260, ``_detect`` :337,
``_sim3_pairs`` :371, ``_compute_sim3_depth`` :395, ``_compute_sim3``
:430, ``_correct`` :476, ``_search_and_fuse`` :623).

Every keyframe's BoW vector goes into the keyframe database; from the
10th keyframe on, each one is scored against the database, and a
candidate seen in ``covisibility_consistency_th`` consecutive keyframes
is verified: BoW matches, Sim3 RANSAC, guided widening through the
estimate, Sim3 optimization (at least ``sim3_min_inliers``) and the
loop-neighbourhood projection count (at least ``sim3_total_matches``).
A verified loop corrects the map: the essential graph (spanning tree,
strong covisibility, the new and every persistent loop edge, padded to
``max_pose_graph_edges``) is optimized, landmarks follow their first
keyframe, and the loop side's landmarks are fused into the current side.
A successful relocalization runs the same verification between the last
keyframe before the loss and the matched keyframe, with a depth-based
Sim3 as fallback and a noise gate (``on_relocalization``).

The host reads back at each gate, as the reference does; that happens
only on keyframes with a candidate and after a relocalization. The
Hamming matrices are kernel K2 on the card. RANSAC samples come from
``ops/ransac.sample_indices``, seeded from the keyframe slot as the
reference keys its PRNG (1234 + k, 4321 + k for the depth Sim3);
``LoopCloser.sample_fn`` replaces them (the parity tests pass JAX's).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..models import vocabulary as voc_mod
from ..ops import hamming as hm
from ..ops.horn import ransac_sim3
from ..optim.pose_graph import PoseGraphProblem, optimize_pose_graph
from ..optim.sim3_opt import optimize_sim3
from ..utils import sim3 as s3
from ..utils.camera import Intrinsics, backproject, project
from ..utils.scatter import mark
from ..worldmap import kfdb as kfdb_mod
from ..worldmap.state import MapState, add_loop_edge
from .fusion import fuse_into_keyframe


def _detect_device(db: kfdb_mod.KFDatabase, hist, covis, kf_valid, k: int):
    """The loop-detection scoring as one device packet: [best candidate,
    its score, covisibility row of the best (K 0/1 floats)]. The query's
    covisible keyframes and culled keyframes are excluded, and the least
    score among its strong covisibles (>= 15 shared landmarks) is the
    candidates' minimum score."""
    covis_row = covis[k]
    exclude = (covis_row > 0) | ~kf_valid
    exclude[k] = True
    strong = (covis_row >= 15) & db.valid & kf_valid
    sims, _ = kfdb_mod.scores(db, hist)
    min_score = torch.where(strong, sims, float("inf")).min()
    min_score = torch.where(torch.isfinite(min_score), min_score, 0.0)
    cand = kfdb_mod.query(db, hist, covis, exclude, min_score=min_score)
    # the first index at the maximum, as jnp.argmax
    best = torch.where(cand.score == cand.score.max(),
                       torch.arange(cand.score.shape[0], device=covis.device),
                       cand.score.shape[0]).min()
    return torch.cat([torch.stack([best.to(torch.float32), cand.score[best]]),
                      (covis[best] > 0).to(torch.float32)])


def _match_kf_pair(desc_a, valid_a, obs_a, desc_b, valid_b, obs_b):
    """Mutual nearest-neighbour match of two keyframes' keypoints that
    have landmarks: (idx_b [N], ok [N])."""
    dist = hm.masked_hamming_matrix(desc_a, valid_a & (obs_a >= 0), desc_b,
                                    valid_b & (obs_b >= 0))
    idx, _, ok = hm.match_nn(dist, max_dist=50, ratio=0.75, mutual=True)
    return idx, ok


def _match_kf_pair_any(desc_a, valid_a, desc_b, valid_b):
    """The same over all valid keypoints (the depth-based Sim3)."""
    dist = hm.masked_hamming_matrix(desc_a, valid_a, desc_b, valid_b)
    idx, _, ok = hm.match_nn(dist, max_dist=50, ratio=0.75, mutual=True)
    return idx, ok


def _depth_pairs(m: MapState, cam: Intrinsics, k, c, idx, ok, scale_factor):
    """(x1, x2, uv1, uv2, ok, inv1, inv2) of matched keypoints of (k, c)
    with 3D from each keyframe's own measured depth: both sides are local
    geometry, so their Sim3 is the true relative pose whatever the map's
    drift."""
    N = m.kf_obs_lm.shape[1]
    idx_c = idx.clamp(0, N - 1).long()
    z1 = m.kf_kp_depth[k]
    z2 = m.kf_kp_depth[c][idx_c]
    ok = ok & (z1 > 0) & (z2 > 0)
    uv1 = m.kf_kp_xy[k]
    uv2 = m.kf_kp_xy[c][idx_c]
    lvl1 = m.kf_kp_level[k].to(torch.float32)
    lvl2 = m.kf_kp_level[c].to(torch.float32)[idx_c]
    return (backproject(cam, uv1, z1), backproject(cam, uv2, z2), uv1, uv2,
            ok, 1.0 / (scale_factor ** (2 * lvl1)),
            1.0 / (scale_factor ** (2 * lvl2)))


def _sim3_widen(m: MapState, cam: Intrinsics, k, c, s, R, t, idx_bow, ok_bow,
                scale_factor):
    """Guided Sim3 widening (ref SearchBySim3): each side's landmarks are
    projected into the other image through S_ck (x_c = s R x_k + t) or its
    inverse, matched inside 7.5 px times the keypoint's scale, and the
    mutually agreeing pairs are united with the BoW matches. Returns
    (idx, ok) per k-slot into c's slots."""
    L = m.lm_pos.shape[0]
    lm_k, lm_c = m.kf_obs_lm[k], m.kf_obs_lm[c]
    ik, ic = lm_k.clamp(0, L - 1).long(), lm_c.clamp(0, L - 1).long()
    has_k = m.kf_kp_valid[k] & (lm_k >= 0) & m.lm_valid[ik]
    has_c = m.kf_kp_valid[c] & (lm_c >= 0) & m.lm_valid[ic]
    xk = m.lm_pos[ik] @ m.kf_R[k].T + m.kf_t[k]
    xc = m.lm_pos[ic] @ m.kf_R[c].T + m.kf_t[c]

    def guided(x_src, has_src, desc_src, dst):
        uv = project(cam, x_src)
        ok = has_src & (x_src[:, 2] > 0.1)
        radius = 7.5 * scale_factor ** m.kf_kp_level[dst].to(torch.float32)
        pair = hm.radius_pair_mask(m.kf_kp_xy[dst], uv, radius).T
        dist = hm.masked_hamming_matrix(desc_src, ok, m.kf_kp_desc[dst],
                                        m.kf_kp_valid[dst], pair_mask=pair)
        idx, _, mok = hm.match_nn(dist, max_dist=75)
        return idx, mok

    s_i, R_i, t_i = s3.sim3_inverse(s, R, t)
    m1, ok1 = guided(s * (xk @ R.T) + t, has_k, m.lm_desc[ik], c)
    m2, ok2 = guided(s_i * (xc @ R_i.T) + t_i, has_c, m.lm_desc[ic], k)
    N = lm_k.shape[0]
    m1c = m1.clamp(0, N - 1)
    agree = ok1 & ok2[m1c] & (m2[m1c] == torch.arange(N, device=m1.device))
    agree = agree & has_c[m1c]
    return torch.where(ok_bow, idx_bow, m1), ok_bow | agree


def _loop_landmark_set(m: MapState, c, n_neigh: int = 5, cap: int = 4096):
    """Deduplicated landmark ids observed by keyframe c and its n_neigh
    most covisible keyframes (ref mvpLoopMapPoints), first occurrence
    kept: (ids [cap], mask [cap]). Ties keep the lower index, as
    ``jax.lax.top_k``."""
    L = m.lm_pos.shape[0]
    w = m.covis[c] * m.kf_valid
    nb = torch.sort(w, descending=True, stable=True)[1][:n_neigh]
    rows = torch.cat([torch.as_tensor([c], device=nb.device), nb])
    ids = m.kf_obs_lm[rows].reshape(-1)
    valid = m.kf_kp_valid[rows].reshape(-1) & (ids >= 0) \
        & m.lm_valid[ids.clamp(0, L - 1).long()]
    order = torch.arange(ids.shape[0], device=ids.device)
    idsL = torch.where(valid, ids, L).long()
    first = torch.full((L + 1,), 1 << 30, dtype=torch.int64,
                       device=ids.device).scatter_reduce(
        0, idsL, order, "amin")
    keep = valid & (first[idsL] == order)
    vals, sel = torch.sort(keep.to(torch.int32), descending=True, stable=True)
    vals, sel = vals[:cap], sel[:cap]
    return torch.where(keep, ids, 0)[sel], vals > 0


def _loop_projection_count(m: MapState, cam: Intrinsics, k, c, s, R, t, ids,
                           mask, sim3_slot_ok, scale_factor):
    """SearchByProjection with the verified Sim3 (ref LoopClosing.cc:
    354-368): the loop-neighbourhood landmarks projected into keyframe k
    through S_ck^-1 o T_cw(c), matched within 10 px times the keypoint's
    scale; the matched slots united with the Sim3 inlier slots, counted
    (a device scalar: the reference's nTotalMatches)."""
    L = m.lm_pos.shape[0]
    idc = ids.clamp(0, L - 1).long()
    x_c = m.lm_pos[idc] @ m.kf_R[c].T + m.kf_t[c]
    s_i, R_i, t_i = s3.sim3_inverse(s, R, t)
    x_k = s_i * (x_c @ R_i.T) + t_i
    uv = project(cam, x_k)
    ok = mask & (x_k[:, 2] > 0.1)
    radius = 10.0 * scale_factor ** m.kf_kp_level[k].to(torch.float32)
    pair = hm.radius_pair_mask(m.kf_kp_xy[k], uv, radius).T
    dist = hm.masked_hamming_matrix(m.lm_desc[idc], ok, m.kf_kp_desc[k],
                                    m.kf_kp_valid[k], pair_mask=pair)
    lm_kp, _, mok = hm.match_nn(dist, max_dist=50)
    N = m.kf_kp_valid.shape[1]
    slot_hit = mark(N + 1, torch.where(mok, lm_kp, N))[:N]
    return (slot_hit | sim3_slot_ok).sum()


@dataclasses.dataclass
class LoopResult:
    closed: bool = False
    matched_kf: int = -1
    n_inliers: int = 0
    n_total: int = 0


def _scalar(v, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(v, dtype=dtype, device=like.device)


def warm_up(cfg: SystemConfig, cam: Intrinsics):
    """Run the numerics of loop closing and relocalization once on
    synthetic inputs at the configured sizes, on the camera's device:
    the Sim3 RANSAC and optimization (both scale modes used), the PnP
    RANSAC and one pose-graph step over ``max_keyframes`` vertices and
    ``max_pose_graph_edges`` edges. Their first call in a process loads
    libraries and kernels and builds the forward-mode Jacobians' op
    decompositions, seconds on the card; the System runs this at
    construction so that the first loop or relocalization does not stall
    tracking. Kernels K1 and K2 are not launched; nothing is kept."""
    from ..ops.pnp import ransac_pnp
    dev = cam.fx.device
    n = cfg.capacity.max_keypoints
    g = torch.Generator().manual_seed(0)
    x1 = (torch.rand(n, 3, generator=g) - 0.5) * torch.tensor([2.0, 2.0, 1.0])
    x1 = (x1 + torch.tensor([0.0, 0.0, 2.5])).to(dev)
    x2 = x1 + torch.tensor([0.02, -0.01, 0.03], device=dev)
    uv1, uv2 = project(cam, x1), project(cam, x2)
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    inv = torch.ones(n, device=dev)
    seed = torch.tensor(0, dtype=torch.int64, device=dev)
    for fix_scale in sorted({cfg.loop.fix_scale, True}):
        fit = ransac_sim3(cam, cam, x1, x2, uv1, uv2, ok, seed=seed,
                          fix_scale=fix_scale)
        optimize_sim3(cam, cam, fit.s, fit.R, fit.t, x1, x2, uv1, uv2, inv,
                      inv, ok, fix_scale=fix_scale)
    ransac_pnp(cam, x1, uv2, ok, seed=seed)
    K, E = cfg.capacity.max_keyframes, cfg.capacity.max_pose_graph_edges
    eye = torch.eye(3, device=dev)
    e_ij = torch.zeros(E, dtype=torch.int32, device=dev)
    e_ij[0] = 1
    optimize_pose_graph(PoseGraphProblem(
        s=torch.ones(K, device=dev), R=eye.expand(K, 3, 3).clone(),
        t=torch.zeros(K, 3, device=dev),
        fixed=torch.arange(K, device=dev) == 0,
        valid=torch.arange(K, device=dev) < 2,
        e_i=torch.zeros(E, dtype=torch.int32, device=dev), e_j=e_ij,
        e_s=torch.ones(E, device=dev), e_R=eye.expand(E, 3, 3).clone(),
        e_t=torch.full((E, 3), 0.01, device=dev),
        e_valid=torch.arange(E, device=dev) == 0,
        e_weight=torch.ones(E, device=dev)), iters=1,
        fix_scale=cfg.loop.fix_scale)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class LoopCloser:
    """Host orchestration of loop closing; the numerics are torch ops on
    the map's device."""

    def __init__(self, cfg: SystemConfig, cam: Intrinsics,
                 voc: voc_mod.Vocabulary):
        self.cfg = cfg
        self.cam = cam
        self.voc = voc
        self.db = kfdb_mod.KFDatabase.empty(
            cfg.capacity.max_keyframes, min(kfdb_mod.TOP_WORDS, voc.n_words),
            device=voc.weights.device)
        self.streaks = {}                  # candidate kf -> consecutive count
        self.last_loop_kf = -1000
        self._last_detect_kf = -1000       # streaks hold only consecutively
        self.n_detect = 0                  # _detect calls, candidates and
        self.n_candidates = 0              # loops closed (on keyframes)
        self.n_closed = 0
        self._last_sim3_fail = ""          # the gate the last Sim3 failed
        # (kind, k, mask) -> [n_hyp, 3] RANSAC samples, kind "sim3" or
        # "depth"; None draws from the slot's seed
        self.sample_fn: Optional[Callable] = None

    # ------------------------------------------------------------------
    def on_keyframe(self, m: MapState, k: int, stereo: bool,
                    seq: int = None) -> tuple[MapState, LoopResult]:
        """Keyframe slot k was inserted: look for a loop from the 10th
        keyframe on, verify and correct a candidate, and add k's BoW
        vector to the database. ``seq`` is the monotonic insertion count
        (slot ids stop being temporal order once slots recycle at
        capacity); it defaults to k."""
        if seq is None:
            seq = k
        bv = voc_mod.transform(self.voc, m.kf_kp_desc[k], m.kf_kp_valid[k])
        hist = voc_mod.sparse_bow(bv, top_w=self.db.word.shape[1])
        result = LoopResult()
        cfg = self.cfg.loop
        if cfg.enabled and seq - self.last_loop_kf > cfg.kf_gap \
                and seq >= 10:
            cand_k = self._detect(m, k, hist, seq)
            self.n_detect += 1
            if cand_k >= 0:
                self.n_candidates += 1
                ok, s_rel, R_rel, t_rel, n_inl, n_total = \
                    self._compute_sim3(m, k, cand_k, stereo)
                if ok:
                    m = self._correct(m, k, cand_k, s_rel, R_rel, t_rel)
                    m = self._search_and_fuse(m, k, cand_k)
                    self.last_loop_kf = seq
                    self.n_closed += 1
                    result = LoopResult(True, cand_k, n_inl, n_total)
        self.db = kfdb_mod.add(self.db, k, hist)
        return m, result

    def on_relocalization(self, m: MapState, k_last: int, cand: int,
                          stereo: bool, seq: int = None
                          ) -> tuple[MapState, LoopResult]:
        """Drift correction after a relocalization: the lost tracker
        matched old keyframe ``cand``, a verified loop observation against
        the last keyframe before the loss, ``k_last``. Their Sim3 is
        solved with the loop machinery (landmarks, then measured depth on
        both sides as fallback), and the essential-graph correction and
        the fuse run unless the measurement agrees with the current
        estimates within the solver's noise (the noise gate). Returns m
        unchanged when verification fails or the gate holds."""
        result = LoopResult()
        cfg = self.cfg.loop
        if not (cfg.enabled and cfg.reloc_correction) or k_last < 0 \
                or cand < 0 or cand == k_last:
            return m, result
        valid = m.kf_valid.cpu().numpy()
        if not valid[k_last] or not valid[cand]:
            return m, result
        ok, s_rel, R_rel, t_rel, n_inl, n_total = self._compute_sim3(
            m, k_last, cand, stereo)
        if not ok and stereo:
            # the drifted keyframe's observations may have been culled:
            # measured depth on both sides, with the stricter inlier bar
            ok, s_rel, R_rel, t_rel, n_inl, n_total = \
                self._compute_sim3_depth(m, k_last, cand)
        if not ok:
            return m, result
        kR = m.kf_R.cpu().numpy()
        kt = m.kf_t.cpu().numpy()
        R_cur = kR[cand] @ kR[k_last].T
        t_cur = kt[cand] - R_cur @ kt[k_last]
        s_h = float(s_rel)
        dR = R_rel.cpu().numpy() @ R_cur.T
        ang = float(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        dt = float(np.linalg.norm(t_rel.cpu().numpy() / max(s_h, 1e-9)
                                  - t_cur))
        if ang < cfg.reloc_correction_min_rad \
                and dt < cfg.reloc_correction_min_t \
                and abs(s_h - 1.0) < cfg.reloc_correction_min_scale:
            return m, result
        m = self._correct(m, k_last, cand, s_rel, R_rel, t_rel)
        m = self._search_and_fuse(m, k_last, cand)
        if seq is not None:
            self.last_loop_kf = seq
        return m, LoopResult(True, cand, n_inl, n_total)

    # ------------------------------------------------------------------
    def _detect(self, m: MapState, k: int, hist, seq: int = None) -> int:
        """The best BoW candidate that is not covisible with k, once it (or
        its covisible group) was seen in ``covisibility_consistency_th``
        consecutive keyframes; else -1. One device packet, one readback."""
        if seq is None:
            seq = k
        # a streak means consecutive keyframes: a skipped one resets them
        if seq != self._last_detect_kf + 1:
            self.streaks = {}
        self._last_detect_kf = seq
        packet = _detect_device(self.db, hist, m.covis, m.kf_valid,
                                k).cpu().numpy()
        best = int(packet[0])
        if float(packet[1]) <= 0:
            self.streaks = {}
            return -1
        group = set(np.nonzero(packet[2:] > 0)[0].tolist())
        group.add(best)
        hit = max(self.streaks.get(g, 0) for g in group)
        self.streaks = {g: hit + 1 for g in group}
        if hit + 1 >= self.cfg.loop.covisibility_consistency_th:
            return best
        return -1

    # ------------------------------------------------------------------
    def _ransac(self, kind: str, k: int, x1, x2, uv1, uv2, mask,
                fix_scale: bool):
        if self.sample_fn is not None:
            return ransac_sim3(self.cam, self.cam, x1, x2, uv1, uv2, mask,
                               fix_scale=fix_scale,
                               sample_idx=self.sample_fn(kind, k, mask))
        base = 1234 if kind == "sim3" else 4321
        return ransac_sim3(self.cam, self.cam, x1, x2, uv1, uv2, mask,
                           seed=_scalar(base + k, x1, torch.int64),
                           fix_scale=fix_scale)

    def _sim3_pairs(self, m: MapState, k: int, cand: int, idx, ok):
        """(x1, x2, uv1, uv2, ok, inv1, inv2) of a k-slot -> cand-slot match
        set: the landmarks in each camera's frame and the observed
        pixels."""
        L = m.lm_pos.shape[0]
        N = m.kf_obs_lm.shape[1]
        idc = idx.clamp(0, N - 1).long()
        lm_k = m.kf_obs_lm[k]
        lm_c = m.kf_obs_lm[cand][idc]
        ik, ic = lm_k.clamp(0, L - 1).long(), lm_c.clamp(0, L - 1).long()
        ok = ok & (lm_k >= 0) & (lm_c >= 0) & m.lm_valid[ik] & m.lm_valid[ic]
        x1 = m.lm_pos[ik] @ m.kf_R[k].T + m.kf_t[k]
        x2 = m.lm_pos[ic] @ m.kf_R[cand].T + m.kf_t[cand]
        sf = self.cfg.orb.scale_factor
        lvl_k = m.kf_kp_level[k].to(torch.float32)
        lvl_c = m.kf_kp_level[cand].to(torch.float32)[idc]
        return (x1, x2, m.kf_kp_xy[k], m.kf_kp_xy[cand][idc], ok,
                1.0 / (sf ** (2 * lvl_k)), 1.0 / (sf ** (2 * lvl_c)))

    def _fail(self, why: str):
        self._last_sim3_fail = why
        return False, None, None, None, 0, 0

    def _compute_sim3_depth(self, m: MapState, k: int, cand: int):
        """The relocalization-only Sim3: matches over all valid keypoints,
        3D from each keyframe's own measured depth, scale fixed; the
        projection-count gate cannot apply, so the optimized inliers must
        reach ``sim3_total_matches``."""
        cfg = self.cfg.loop
        idx, ok = _match_kf_pair_any(m.kf_kp_desc[k], m.kf_kp_valid[k],
                                     m.kf_kp_desc[cand], m.kf_kp_valid[cand])
        sf = _scalar(self.cfg.orb.scale_factor, m.kf_t)
        x1, x2, uv1, uv2, okp, inv1, inv2 = _depth_pairs(
            m, self.cam, k, cand, idx, ok, sf)
        n = int(okp.sum())
        if n < cfg.sim3_min_inliers:
            return self._fail(f"depth_matches {n}")
        fit = self._ransac("depth", k, x1, x2, uv1, uv2, okp, True)
        if int(fit.n_inliers) < cfg.sim3_min_inliers:
            return self._fail(f"depth_ransac_inliers {int(fit.n_inliers)}")
        res = optimize_sim3(self.cam, self.cam, fit.s, fit.R, fit.t, x1, x2,
                            uv1, uv2, inv1, inv2, okp, fix_scale=True)
        n_inl = int(res.n_inliers)
        if n_inl < cfg.sim3_total_matches:
            return self._fail(f"depth_opt_inliers {n_inl}")
        return True, res.s, res.R, res.t, n_inl, n_inl

    def _compute_sim3(self, m: MapState, k: int, cand: int, stereo: bool):
        """The relative Sim3 cam_cand <- cam_k from the landmarks of (k,
        cand) (ref ComputeSim3): BoW matches, Sim3 RANSAC, guided widening,
        Sim3 optimization with at least ``sim3_min_inliers`` inliers, and
        the loop-neighbourhood projection count of at least
        ``sim3_total_matches``. Returns (ok, s, R, t, inliers, total)."""
        cfg = self.cfg.loop
        idx, ok = _match_kf_pair(
            m.kf_kp_desc[k], m.kf_kp_valid[k], m.kf_obs_lm[k],
            m.kf_kp_desc[cand], m.kf_kp_valid[cand], m.kf_obs_lm[cand])
        n = int(ok.sum())
        if n < cfg.sim3_min_inliers:
            return self._fail(f"bow_matches {n}")
        x1, x2, uv1, uv2, okp, inv1, inv2 = self._sim3_pairs(m, k, cand, idx,
                                                             ok)
        fit = self._ransac("sim3", k, x1, x2, uv1, uv2, okp, cfg.fix_scale)
        if int(fit.n_inliers) < cfg.sim3_min_inliers:
            return self._fail(f"ransac_inliers {int(fit.n_inliers)}")
        sf = _scalar(self.cfg.orb.scale_factor, m.kf_t)
        idx_w, ok_w = _sim3_widen(m, self.cam, k, cand, fit.s, fit.R, fit.t,
                                  idx, ok, sf)
        x1, x2, uv1, uv2, okp, inv1, inv2 = self._sim3_pairs(m, k, cand,
                                                             idx_w, ok_w)
        res = optimize_sim3(self.cam, self.cam, fit.s, fit.R, fit.t, x1, x2,
                            uv1, uv2, inv1, inv2, okp,
                            fix_scale=cfg.fix_scale)
        n_inl = int(res.n_inliers)
        if n_inl < cfg.sim3_min_inliers:
            return self._fail(f"opt_inliers {n_inl}")
        ids, mask = _loop_landmark_set(m, cand)
        total = int(_loop_projection_count(
            m, self.cam, k, cand, res.s, res.R, res.t, ids, mask,
            okp & res.inliers, sf))
        if total < cfg.sim3_total_matches:
            return self._fail(f"total_matches {total}")
        return True, res.s, res.R, res.t, n_inl, total

    # ------------------------------------------------------------------
    def essential_graph(self, m: MapState, k: int, cand: int, s_rel, R_rel,
                        t_rel) -> PoseGraphProblem:
        """The essential graph of the map as host lists padded to
        ``max_pose_graph_edges``: a spanning edge from every keyframe (by
        frame id) to its strongest earlier covisible one (else the
        previous keyframe), strong covisibility edges (>= 100), the loop
        edge (k, cand) with weight 10 and every persistent loop edge,
        remeasured from the current estimates. On overflow covisibility
        edges go first; keyframe 0 and cand are fixed."""
        K = m.kf_valid.shape[0]
        n_kf = int(m.n_kf)
        valid = m.kf_valid.cpu().numpy()
        covis = m.covis.cpu().numpy()
        fids = m.kf_frame_id.cpu().numpy()
        kR = m.kf_R.cpu().numpy()
        kt = m.kf_t.cpu().numpy()
        edges = []                 # (i, j, s, R, t, weight, essential)

        def add_edge(i, j, w, meas=None, essential=False):
            if meas is None:
                Rm = kR[j] @ kR[i].T
                meas = (1.0, Rm, kt[j] - Rm @ kt[i])
            edges.append((i, j, float(meas[0]), meas[1], meas[2], w,
                          essential))

        slots = sorted((int(s) for s in np.nonzero(valid[:n_kf])[0]),
                       key=lambda s: int(fids[s]))
        for rank, i in enumerate(slots[1:], start=1):
            earlier = covis[i] * (valid & (fids < fids[i]))
            parent = int(np.argmax(earlier)) if earlier.max() > 0 \
                else slots[rank - 1]
            add_edge(i, parent, 1.0, essential=True)
            for j in np.nonzero(earlier >= 100)[0]:
                if j != parent:
                    add_edge(i, int(j), 1.0)
        add_edge(k, cand, 10.0, (float(s_rel), R_rel.cpu().numpy(),
                                 t_rel.cpu().numpy()), essential=True)
        loop_valid = m.loop_valid.cpu().numpy()
        loop_i, loop_j = m.loop_i.cpu().numpy(), m.loop_j.cpu().numpy()
        for e in range(int(m.n_loop)):
            li, lj = int(loop_i[e]), int(loop_j[e])
            if loop_valid[e] and valid[li] and valid[lj]:
                add_edge(li, lj, 10.0, essential=True)
        E_cap = self.cfg.capacity.max_pose_graph_edges
        if len(edges) > E_cap:
            keep = sorted(range(len(edges)),
                          key=lambda x: (not edges[x][6], x))[:E_cap]
            edges = [edges[x] for x in sorted(keep)]
        E = len(edges)
        ei = np.zeros(E_cap, np.int64)
        ej = np.zeros(E_cap, np.int64)
        es = np.ones(E_cap, np.float32)
        eR = np.tile(np.eye(3, dtype=np.float32), (E_cap, 1, 1))
        et = np.zeros((E_cap, 3), np.float32)
        ew = np.zeros(E_cap, np.float32)
        ev = np.zeros(E_cap, bool)
        if E:
            ei[:E], ej[:E] = [e[0] for e in edges], [e[1] for e in edges]
            es[:E] = [e[2] for e in edges]
            eR[:E] = np.stack([e[3] for e in edges]).astype(np.float32)
            et[:E] = np.stack([e[4] for e in edges]).astype(np.float32)
            ew[:E] = [e[5] for e in edges]
            ev[:E] = True
        fixed = np.zeros(K, bool)
        fixed[cand] = True
        fixed[0] = True
        dev = m.kf_t.device

        def up(a):
            return torch.from_numpy(a).to(dev)

        return PoseGraphProblem(
            s=torch.ones(K, dtype=torch.float32, device=dev), R=m.kf_R,
            t=m.kf_t, fixed=up(fixed), valid=m.kf_valid, e_i=up(ei),
            e_j=up(ej), e_s=up(es), e_R=up(eR), e_t=up(et), e_valid=up(ev),
            e_weight=up(ew))

    def _correct(self, m: MapState, k: int, cand: int, s_rel, R_rel,
                 t_rel) -> MapState:
        """Essential-graph correction (ref CorrectLoop and
        OptimizeEssentialGraph): optimize the graph, move every landmark
        with its first keyframe (x' = S_new^-1 S_old x), write the poses
        back as SE3 (t / s) and record the loop edge."""
        K = m.kf_valid.shape[0]
        problem = self.essential_graph(m, k, cand, s_rel, R_rel, t_rel)
        s_new, R_new, t_new = optimize_pose_graph(
            problem, iters=self.cfg.optimizer.essential_graph_iters,
            fix_scale=self.cfg.loop.fix_scale)
        ref = m.lm_first_kf.clamp(0, K - 1).long()
        x_cam = torch.einsum("lij,lj->li", m.kf_R[ref], m.lm_pos) + m.kf_t[ref]
        x_new = torch.einsum(
            "lji,lj->li", R_new[ref],
            (x_cam - t_new[ref]) / torch.clamp(s_new[ref][:, None], min=1e-9))
        lm_pos = torch.where(m.lm_valid[:, None], x_new, m.lm_pos)
        t_se3 = t_new / torch.clamp(s_new[:, None], min=1e-9)
        m = m._replace(
            kf_R=torch.where(m.kf_valid[:, None, None], R_new, m.kf_R),
            kf_t=torch.where(m.kf_valid[:, None], t_se3, m.kf_t),
            lm_pos=lm_pos)
        # the constraint stays in the graph of later corrections
        return add_loop_edge(m, k, cand, s_rel, R_rel, t_rel)

    def _search_and_fuse(self, m: MapState, k: int, cand: int) -> MapState:
        """SearchAndFuse (ref LoopClosing.cc:588-645): with the poses
        corrected, the loop side's landmark set (cand and its covisible
        keyframes) is fused into k and its 5 most covisible keyframes, so
        landmarks duplicated across the loop collapse to one."""
        ids, mask = _loop_landmark_set(m, cand)
        covis = m.covis[k].cpu().numpy()
        valid = m.kf_valid.cpu().numpy()
        neigh = np.argsort(-covis)[:5]
        targets = [k] + [int(j) for j in neigh
                         if valid[j] and covis[j] > 0 and int(j) != k]
        sf = _scalar(self.cfg.orb.scale_factor, m.kf_t)
        for kf in targets:
            m = fuse_into_keyframe(m, self.cam, _scalar(kf, m.kf_t,
                                                        torch.int64),
                                   ids, mask, sf, radius_px=4.0)
        return m
