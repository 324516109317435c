"""Stereo depth association: row-banded descriptor matching with SAD
subpixel refinement, and the RGB-D depth lookup.

Port of ``slam_dynamic_tpu/ops/stereo.py`` (``_gather_patches`` :35,
``match_stereo`` :46, ``depth_from_rgbd`` :110). The reference's per-row
candidate lists become one masked Hamming matrix (kernel K2 on the card)
with the row band, the disparity range and the level window as pair
masks; the scalar SAD slide becomes a gather of [N, 11, 21] strips and
an 11-offset SAD over their windows, with parabolic subpixel
interpolation. As in the reference, SAD runs on the level-0 images for
every keypoint. On uint8-valued images the SAD sums are integers below
2^24, exact in float32, so the result does not depend on the order of
the sums.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import hamming as hm

SAD_W = 5       # half window -> 11x11
SAD_R = 5       # +-5 px slide


class StereoMatches(NamedTuple):
    u_right: torch.Tensor   # [N] float32, -1 where unmatched
    depth: torch.Tensor     # [N] float32, -1 where unmatched
    valid: torch.Tensor     # [N] bool


def _gather_patches(img, cx, cy, half_h: int, half_w: int):
    """[N] integer centres -> [N, 2 half_h + 1, 2 half_w + 1] patches,
    coordinates clamped to the image."""
    h, w = img.shape
    dy = torch.arange(-half_h, half_h + 1, device=img.device)
    dx = torch.arange(-half_w, half_w + 1, device=img.device)
    yy = (cy[:, None, None] + dy[None, :, None]).clamp(0, h - 1)
    xx = (cx[:, None, None] + dx[None, None, :]).clamp(0, w - 1)
    return img[yy, xx]


def match_stereo(left_img, right_img, kp_left, kp_right, bf, min_z,
                 scale_factors_l, scale_factors_r, max_disp_px: int = 128):
    """Associate left keypoints with right-image columns.

    left_img/right_img: [H, W] float32 level-0 images; kp_left/kp_right:
    ``Keypoints`` (frontend/extractor.py); scale_factors_l/r: [N] per
    keypoint scale factor (scale_factor ** level); ``bf`` a float or a
    0-d tensor. Returns StereoMatches over the left keypoint slots."""
    xyL, xyR = kp_left.xy, kp_right.xy
    # row band: |vL - vR| <= 2 * the coarser keypoint's scale
    band = 2.0 * torch.maximum(scale_factors_l[:, None],
                               scale_factors_r[None, :])
    row_ok = (xyL[:, 1:2] - xyR[None, :, 1]).abs() <= band
    # disparity in (0.3, max_d), max_d = min(max_disp_px, bf / min_z)
    disp = xyL[:, 0:1] - xyR[None, :, 0]
    # a float32 tensor: ``float / tensor`` would multiply by a reciprocal
    bf = torch.as_tensor(bf, dtype=torch.float32, device=xyL.device)
    max_d = torch.clamp(bf / min_z, max=float(max_disp_px))
    disp_ok = (disp > 0.3) & (disp < max_d)
    lvl_ok = hm.level_pair_mask(kp_left.level, kp_right.level, -1, 1)
    dist = hm.masked_hamming_matrix(
        kp_left.desc, kp_left.valid, kp_right.desc, kp_right.valid,
        pair_mask=row_ok & disp_ok & lvl_ok)
    idx_r, _, ok = hm.match_nn(dist, max_dist=100)

    # SAD subpixel refinement on the level-0 images
    uL, vL = xyL[:, 0], xyL[:, 1]
    cxL = torch.round(uL).to(torch.int64)
    cyL = torch.round(vL).to(torch.int64)
    cxR = torch.round(xyR[idx_r, 0]).to(torch.int64)
    patchL = _gather_patches(left_img, cxL, cyL, SAD_W, SAD_W)  # [N,11,11]
    stripR = _gather_patches(right_img, cxR, cyL, SAD_W, SAD_W + SAD_R)
    patchL = patchL - patchL[:, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]
    # the window at offset o covers strip columns [o, o + 11):
    # [N, 11 rows, 11 offsets, 11 cols] -> [N, 11 offsets, 11, 11]
    winR = stripR.unfold(2, 2 * SAD_W + 1, 1).permute(0, 2, 1, 3)
    winR = winR - winR[:, :, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]
    sad = (patchL[:, None] - winR).abs().sum((-1, -2))          # [N, 11]
    # the first offset at the minimum (argmin's choice on ties is not
    # specified on the card)
    offs = torch.arange(2 * SAD_R + 1, device=sad.device)
    best_o = torch.where(sad == sad.min(1, keepdim=True)[0], offs,
                         2 * SAD_R + 1).min(1)[0]
    s_m1 = sad.gather(1, (best_o - 1).clamp(min=0)[:, None])[:, 0]
    s_0 = sad.gather(1, best_o[:, None])[:, 0]
    s_p1 = sad.gather(1, (best_o + 1).clamp(max=2 * SAD_R)[:, None])[:, 0]
    denom = s_m1 + s_p1 - 2.0 * s_0
    delta = torch.where(
        denom.abs() > 1e-6,
        0.5 * (s_m1 - s_p1) / torch.where(denom == 0, 1.0, denom), 0.0)
    delta = delta.clamp(-1.0, 1.0)
    u_right = cxR.to(torch.float32) + (best_o - SAD_R).to(torch.float32) \
        + delta
    disparity = uL - u_right
    ok = ok & (disparity > 0.3) & (disparity < max_d)
    depth = torch.where(
        ok, bf / torch.where(disparity <= 0.3, 1.0, disparity), -1.0)
    return StereoMatches(torch.where(ok, u_right, -1.0), depth, ok)


def depth_from_rgbd(depth_map, kp_xy, kp_valid, bf, depth_factor=1.0):
    """Sample the depth map at the (distorted) keypoint pixel and
    synthesize the virtual right coordinate (ref Frame.cc:1051-1072).
    ``depth_map`` is [H, W] float32 (metres when depth_factor == 1)."""
    h, w = depth_map.shape
    xi = torch.round(kp_xy[:, 0]).to(torch.int64).clamp(0, w - 1)
    yi = torch.round(kp_xy[:, 1]).to(torch.int64).clamp(0, h - 1)
    d = depth_map[yi, xi] / depth_factor
    ok = kp_valid & (d > 0)
    u_right = torch.where(
        ok, kp_xy[:, 0] - bf / torch.where(d <= 0, torch.ones_like(d), d),
        -1.0)
    return StereoMatches(u_right, torch.where(ok, d, -1.0), ok)
