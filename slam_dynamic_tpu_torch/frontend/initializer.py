"""Monocular two-view bootstrap.

Port of ``slam_dynamic_tpu/frontend/initializer.py`` (``MonoInit``,
``try_initialize`` :36): match the reference and current frames (a
100 px window, levels 0-1, ratio 0.9, mutual, rotation-consistent: one
Hamming matrix, kernel K2 on the card), fit H and F by batched RANSAC,
pick H when its share of the two scores exceeds 0.45, recover the motion
with cheirality (ops/twoview.py) and scale the structure to median depth
1. The median of an even count is the mean of the two middle values, as
``jnp.nanmedian`` takes it (``torch.nanmedian`` would take the lower).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops import hamming as hm
from ..ops import ransac
from ..ops.twoview import reconstruct
from ..utils.camera import Intrinsics
from ..worldmap.keyframe_ops import nanmedian_last
from .frame import FrameData


class MonoInit(NamedTuple):
    ok: torch.Tensor
    R2: torch.Tensor          # second-frame pose (first at identity)
    t2: torch.Tensor
    points: torch.Tensor      # [N, 3] world points per ref-frame slot
    good: torch.Tensor        # [N] bool created landmarks
    idx2: torch.Tensor        # [N] matched slot in the current frame
    n_matches: torch.Tensor


def try_initialize(cam: Intrinsics, ref: FrameData, cur: FrameData,
                   seed: int = 0, window_px: float = 100.0,
                   min_matches: int = 100,
                   sample_fn: Optional[Callable] = None) -> MonoInit:
    """One attempt at the two-view initialization (slots of the reference
    frame). The H and F minimal sets are drawn from ``seed``;
    ``sample_fn(ok)`` -> (idx_h [n_hyp, 4], idx_f [n_hyp, 8]) replaces
    the draws given the match mask (the parity tests feed JAX's)."""
    dev = ref.xy.device
    N = ref.xy.shape[0]
    pm = hm.radius_pair_mask(ref.xy, cur.xy,
                             torch.full((N,), window_px, device=dev))
    lvl01 = (ref.level[:, None] <= 1) & (cur.level[None, :] <= 1)
    dist = hm.masked_hamming_matrix(ref.desc, ref.valid & ref.static_mask,
                                    cur.desc, cur.valid & cur.static_mask,
                                    pair_mask=pm & lvl01)
    idx2, _, ok = hm.match_nn(dist, max_dist=50, ratio=0.9, mutual=True)
    ok = hm.rotation_consistency(ref.angle, cur.angle, idx2, ok)
    n = ok.sum()

    uv1 = ref.xy
    uv2 = cur.xy[idx2.clamp(0, cur.xy.shape[0] - 1)]
    idx_h, idx_f = sample_fn(ok) if sample_fn is not None else (None, None)
    s = torch.tensor(seed, dtype=torch.int64, device=dev)
    fit_h = ransac.fit_homography(uv1, uv2, ok, s, thresh_px=2.4,
                                  sample_idx=idx_h)
    fit_f = ransac.fit_fundamental(uv1, uv2, ok, s, thresh_px=1.96,
                                   sample_idx=idx_f)
    # model selection by the inlier share (the reference's score ratio)
    rh = fit_h.score / torch.clamp(fit_h.score + fit_f.score, min=1.0)
    use_h = rh > 0.45
    rec_h = reconstruct(cam, fit_h.M, uv1, uv2, fit_h.inliers,
                        use_homography=True)
    rec_f = reconstruct(cam, fit_f.M, uv1, uv2, fit_f.inliers)
    rec = type(rec_h)(*(torch.where(use_h, a, b)
                        for a, b in zip(rec_h, rec_f)))

    # scale: median depth of the good points = 1
    med = nanmedian_last(torch.where(rec.good, rec.points[:, 2], torch.nan))
    med = torch.nan_to_num(med, nan=1.0)
    scale = 1.0 / torch.clamp(med, min=1e-6)
    ok_total = rec.ok & (n >= min_matches)
    return MonoInit(ok_total, rec.R, rec.t * scale, rec.points * scale,
                    rec.good & ok_total, idx2, n)
