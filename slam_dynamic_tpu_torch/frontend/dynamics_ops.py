"""Device half of the dynamic-object reclassifier.

Port of ``slam_dynamic_tpu/frontend/dynamics_ops.py`` (``BoxVerdict`` :33,
``_match_from`` :41, ``classify_boxes`` :53, ``box_3d_state`` :125,
``reinstate_features`` :165), the reference's TrackHomo -> Separate ->
classifyH / classifyF chain:

  1. background pairs: static features of the reference and the current
     frame, mutual nearest neighbours with the rotation-consistency
     filter, from ONE [N, N] Hamming matrix (kernel K2 on the card);
  2. the background model: H and F by batched RANSAC (``ops/ransac.py``),
     the one with more inliers;
  3. in-box pairs: the current frame's keypoints inside each box against
     the reference's keypoints near it (the box grown by 25%), matched on
     the transpose of the same matrix;
  4. chi2 tests under the background model and a verdict per box:
     0 unknown, 1 static, 2 dynamic, by the share that passes.

``reinstate_features`` flips the quarantined keypoints of boxes found
static back into ``static_mask`` (Frame::UpdateFrame).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import hamming as hm
from ..ops import ransac
from ..ops.hamming import hamming_matrix
from ..ops.pointcloud import obb_from_points
from ..utils.camera import Intrinsics, backproject
from .frame import FrameData, inside_boxes


class BoxVerdict(NamedTuple):
    verdict: torch.Tensor          # [B] int32: 0 unknown, 1 static, 2 dyn
    n_pass: torch.Tensor           # [B] int32
    n_fail: torch.Tensor           # [B] int32
    used_homography: torch.Tensor  # bool
    n_bg_inliers: torch.Tensor     # int32


def _match_from(dist, mask_a, mask_b, ang_a, ang_b, max_dist, ratio):
    """Mutual nearest neighbours a -> b from a raw [A, B] Hamming matrix
    (or a transposed view of one), under the two row/column masks."""
    d = torch.where(mask_a[:, None] & mask_b[None, :], dist, hm.INVALID)
    idx, _, ok = hm.match_nn(d, max_dist=max_dist, ratio=ratio, mutual=True)
    return idx, hm.rotation_consistency(ang_a, ang_b, idx, ok)


def classify_boxes(cam: Intrinsics, ref: FrameData, cur: FrameData,
                   boxes, box_valid, n_hyp: int = 256,
                   thresh_px: float = 3.0, chi2_h: float = 5.991,
                   chi2_f: float = 5.841, min_pairs: int = 20,
                   seed: Optional[torch.Tensor] = None,
                   sample_idx=None) -> BoxVerdict:
    """Verdicts for boxes [B, 4] (``box_valid`` [B]) of ``cur`` against
    ``ref``. ``seed`` is an integer tensor the RANSAC draws hash from;
    ``sample_idx`` = (idx_h [n_hyp, 4], idx_f [n_hyp, 8]) replaces the
    draws."""
    # one ref x cur Hamming matrix serves both matchers
    dist_rc = hamming_matrix(ref.desc.contiguous(), cur.desc.contiguous())

    # 1. background pairs (static features of both frames)
    idx, ok = _match_from(dist_rc, ref.valid & ref.static_mask,
                          cur.valid & cur.static_mask, ref.angle, cur.angle,
                          max_dist=64, ratio=0.8)
    p1 = ref.xy
    p2 = cur.xy[idx.clamp(0, cur.xy.shape[0] - 1)]

    # 2. the background model: H or F by inlier count
    sh, sf = (None, None) if sample_idx is None else sample_idx
    fit_h = ransac.fit_homography(p1, p2, ok, seed, n_hyp=n_hyp,
                                  thresh_px=thresh_px, sample_idx=sh)
    fit_f = ransac.fit_fundamental(p1, p2, ok, seed, n_hyp=n_hyp,
                                   thresh_px=thresh_px, sample_idx=sf)
    use_h = fit_h.n_inliers >= fit_f.n_inliers
    n_bg = torch.maximum(fit_h.n_inliers, fit_f.n_inliers)
    enough_bg = n_bg >= min_pairs

    # 3. in-box pairs: current keypoints in the box against reference
    # keypoints near it (the box grown by 25%: boxes move between frames)
    bx = boxes
    cx = (bx[:, 0] + bx[:, 2]) * 0.5
    cy = (bx[:, 1] + bx[:, 3]) * 0.5
    hw = (bx[:, 2] - bx[:, 0]) * 0.625
    hh = (bx[:, 3] - bx[:, 1]) * 0.625
    in_box_cur = inside_boxes(cur.xy, bx)                         # [B, N]
    near_box_ref = (((ref.xy[None, :, 0] - cx[:, None]).abs() <= hw[:, None])
                    & ((ref.xy[None, :, 1] - cy[:, None]).abs()
                       <= hh[:, None]))
    any_box_cur = (in_box_cur & box_valid[:, None]).any(0)
    any_box_ref = (near_box_ref & box_valid[:, None]).any(0)
    bidx, bok = _match_from(dist_rc.t(), cur.valid & any_box_cur,
                            ref.valid & any_box_ref, cur.angle, ref.angle,
                            max_dist=64, ratio=0.9)
    q2 = cur.xy
    q1 = ref.xy[bidx.clamp(0, ref.xy.shape[0] - 1)]

    # 4. chi2 tests under the background model (sigma 1 px)
    eh_f, eh_b = ransac.h_transfer_errors(fit_h.M, q1, q2)
    pass_h = (eh_f < chi2_h) & (eh_b < chi2_h)
    ef_1, ef_2 = ransac.f_epipolar_errors(fit_f.M, q1, q2)
    pass_f = (ef_1 < chi2_f) & (ef_2 < chi2_f)
    passes = torch.where(use_h, pass_h, pass_f) & bok

    per_box = in_box_cur & bok[None, :] & box_valid[:, None]
    n_pass = (per_box & passes[None, :]).sum(1).to(torch.int32)
    n_tot = per_box.sum(1).to(torch.int32)
    enough = (n_tot >= 8) & enough_bg
    frac = n_pass.to(torch.float32) / torch.clamp(n_tot, min=1)
    verdict = torch.where(enough, torch.where(frac >= 0.5, 1, 2), 0)
    verdict = torch.where(box_valid, verdict, 0).to(torch.int32)
    return BoxVerdict(verdict, n_pass, n_tot - n_pass, use_h, n_bg)


def box_3d_state(cam: Intrinsics, fd: FrameData, boxes, box_active):
    """Per-box 3D state from the depth keypoints inside each box, as
    [B, 16] float32: [depth of the keypoint nearest the box centre, OBB
    centre xyz, OBB axes (rows) flat, OBB half-extents xyz], camera frame.
    The depth is -1 (and the OBB NaN) for a box with no depth keypoint;
    the gating and smoothing are host logic (``dynamics.update_box3d``)."""
    mask = inside_boxes(fd.xy, boxes) & box_active[:, None] \
        & (fd.valid & (fd.depth > 0))[None, :]                    # [B, N]
    cx = (boxes[:, 0] + boxes[:, 2]) * 0.5
    cy = (boxes[:, 1] + boxes[:, 3]) * 0.5
    d2 = ((fd.xy[None, :, 0] - cx[:, None]) ** 2
          + (fd.xy[None, :, 1] - cy[:, None]) ** 2)
    d2 = torch.where(mask, d2, torch.full_like(d2, float("inf")))
    best = d2.min(1)[0]
    # the first keypoint at the minimum, as jnp.argmin
    cols = torch.arange(d2.shape[1], device=d2.device)
    j = torch.where(d2 == best[:, None], cols, d2.shape[1]).min(1)[0]
    j = j.clamp(0, d2.shape[1] - 1)
    d = torch.where(torch.isfinite(best), fd.depth[j],
                    torch.full_like(best, -1.0))
    obb = obb_from_points(backproject(cam, fd.xy, fd.depth), mask)
    B = boxes.shape[0]
    return torch.cat([d[:, None], obb.center, obb.axes.reshape(B, 9),
                      obb.extents], dim=1)


def reinstate_features(fd: FrameData, boxes, static_boxes) -> FrameData:
    """Quarantined keypoints inside boxes found static become static again
    (Frame::UpdateFrame: there array surgery, here a mask OR)."""
    back = ((inside_boxes(fd.xy, boxes) & static_boxes[:, None]).any(0)
            & fd.valid)
    return fd._replace(static_mask=fd.static_mask | back)
