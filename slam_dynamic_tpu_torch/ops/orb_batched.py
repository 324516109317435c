"""Batched-over-levels ORB extraction: the 8-level pipeline as one stack
of [L, H, W] operations.

Port of ``slam_dynamic_tpu/ops/orb_batched.py`` (``_level_meta`` :29,
``build_level_stack`` :50, ``fast_dual_batched`` :70,
``select_batched`` :121, ``blur_stack`` :167, ``ic_angles_batched``
:174, ``brief_batched`` :190), selected by ``ORBConfig(batched_levels=
True)``. Every level is resized and zero-padded to level 0's size, so
the pixel work is about 3x the per-level pipeline's, but each stage is
one set of launches for all levels instead of one per level, which is
what a launch-bound frame pays for (its launches and host time on the
card: PERF.md, section 5). The
numerics are those of ops/fast.py and ops/orb.py per level (the same
ring test, selection rule and rBRIEF); the cell grid, the clamping of
the descriptor's samples and the order of ties follow level 0's frame,
as in the reference's batched path.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .fast import _ring_stack, fast_response
from .orb import PATCH_RADIUS, _device_constants, pack_bits, topk_stable
from .pyramid import build_pyramid, gaussian_blur, level_shapes


@functools.lru_cache(maxsize=None)
def level_valid_mask(height: int, width: int, n_levels: int,
                     scale_factor: float, border: int,
                     device: torch.device) -> torch.Tensor:
    """[L, H, W] bool: the pixels of level l's own image inside its
    ``border`` (the padding and the border never hold a corner)."""
    valid = np.zeros((n_levels, height, width), bool)
    for l, (h, w) in enumerate(level_shapes(height, width, n_levels,
                                            scale_factor)):
        valid[l, border:h - border, border:w - border] = True
    return torch.from_numpy(valid).to(device)


def build_level_stack(image: torch.Tensor, n_levels: int,
                      scale_factor: float) -> torch.Tensor:
    """[H, W] -> [L, H, W]: each pyramid level zero-padded to H x W."""
    h, w = image.shape
    return torch.stack([
        torch.nn.functional.pad(lv, (0, w - lv.shape[1], 0, h - lv.shape[0]))
        for lv in build_pyramid(image, n_levels, scale_factor)])


def fast_dual_batched(stack: torch.Tensor, valid_mask: torch.Tensor,
                      ini_th: float, min_th: float,
                      cell: int) -> torch.Tensor:
    """Dual-threshold FAST, per-cell fallback and 3x3 NMS on the level
    stack; one ring build serves both thresholds. Returns the score
    [L, H, W] (0 for non-corners)."""
    L, H, W = stack.shape
    ring = _ring_stack(stack)                   # [16, L, H, W]
    c_hi, s_hi = fast_response(stack, ini_th, ring)
    c_lo, s_lo = fast_response(stack, min_th, ring)
    c_hi, c_lo = c_hi & valid_mask, c_lo & valid_mask
    ch, cw = -(-H // cell), -(-W // cell)
    hi_pad = torch.nn.functional.pad(c_hi, (0, cw * cell - W,
                                            0, ch * cell - H))
    cell_has_hi = hi_pad.reshape(L, ch, cell, cw, cell).any(4).any(2)
    full = cell_has_hi[:, :, None, :, None].expand(L, ch, cell, cw, cell)
    full = full.reshape(L, ch * cell, cw * cell)[:, :H, :W]
    corner = torch.where(full, c_hi, c_lo)
    score = torch.where(corner, torch.where(full, s_hi, s_lo), 0.0)
    win = torch.nn.functional.max_pool2d(score[:, None], 3, stride=1,
                                         padding=1)[:, 0]
    return torch.where((score >= win) & corner, score, 0.0)


class BatchedKeypoints(NamedTuple):
    lvl: torch.Tensor    # [N] int32
    x: torch.Tensor      # [N] int64 level-image coordinates
    y: torch.Tensor      # [N] int64
    resp: torch.Tensor   # [N] float32
    valid: torch.Tensor  # [N] bool


@functools.lru_cache(maxsize=None)
def _compaction(budgets: tuple, device: torch.device):
    """(level of slot n, rank of slot n): budgets[l] slots per level,
    level-major."""
    lvl = np.concatenate([np.full(b, l) for l, b in enumerate(budgets)])
    rank = np.concatenate([np.arange(b) for b in budgets])
    return (torch.from_numpy(lvl).to(device), torch.from_numpy(rank).to(
        device), torch.tensor(budgets, device=device))


def select_batched(score: torch.Tensor, budgets: Sequence[int], cell: int,
                   per_cell: int) -> BatchedKeypoints:
    """Per cell the ``per_cell`` strongest corners, then per level the
    ``budgets[l]`` strongest of those; slots are level-major, exactly
    budgets[l] per level (N = sum(budgets))."""
    L, H, W = score.shape
    dev = score.device
    ch, cw = -(-H // cell), -(-W // cell)
    pad = torch.nn.functional.pad(score, (0, cw * cell - W, 0, ch * cell - H))
    cells = pad.reshape(L, ch, cell, cw, cell).permute(0, 1, 3, 2, 4)
    v, idx = topk_stable(cells.reshape(L, ch * cw, cell * cell), per_cell)
    cid = torch.arange(ch * cw, device=dev)[None, :, None]
    ys = ((cid // cw) * cell + idx // cell).reshape(L, -1)
    xs = ((cid % cw) * cell + idx % cell).reshape(L, -1)
    budgets = tuple(int(b) for b in budgets)
    gv, gidx = topk_stable(v.reshape(L, -1), max(budgets))  # [L, k_max]
    gy, gx = ys.gather(1, gidx), xs.gather(1, gidx)
    lvl, rank, b = _compaction(budgets, dev)
    ok = (gv > 0.0) & (torch.arange(gv.shape[1], device=dev)[None, :]
                       < b[:, None])
    return BatchedKeypoints(lvl.to(torch.int32), gx[lvl, rank],
                            gy[lvl, rank], gv[lvl, rank], ok[lvl, rank])


def ic_angles_batched(stack: torch.Tensor,
                      kp: BatchedKeypoints) -> torch.Tensor:
    """IC angles of all keypoints: one patch gather over the level stack
    (coordinates clamped, as the reference's gather clamps)."""
    kx, ky = _device_constants(stack.device)[:2]
    r = PATCH_RADIUS
    padded = torch.nn.functional.pad(stack, (r, r, r, r))
    d = torch.arange(2 * r + 1, device=stack.device)
    rows = (kp.y[:, None, None] + d[None, :, None]).clamp(
        0, padded.shape[1] - 1)
    cols = (kp.x[:, None, None] + d[None, None, :]).clamp(
        0, padded.shape[2] - 1)
    patches = padded[kp.lvl.long()[:, None, None], rows, cols]  # [N, 31, 31]
    m10 = torch.einsum("nij,ij->n", patches, kx)
    m01 = torch.einsum("nij,ij->n", patches, ky)
    return torch.atan2(m01, m10)


def brief_batched(blurred: torch.Tensor, kp: BatchedKeypoints,
                  angle: torch.Tensor) -> torch.Tensor:
    """rBRIEF of all keypoints from the blurred stack: one flat gather
    -> [N, 8] int32."""
    L, H, W = blurred.shape
    ax, ay = _device_constants(blurred.device)[2:]
    ca, sa = torch.cos(angle), torch.sin(angle)
    ca, sa = ca[:, None, None], sa[:, None, None]
    rx = torch.round(ax[None] * ca - ay[None] * sa)
    ry = torch.round(ax[None] * sa + ay[None] * ca)
    gx = torch.clamp(kp.x[:, None, None] + rx.long(), 0, W - 1)
    gy = torch.clamp(kp.y[:, None, None] + ry.long(), 0, H - 1)
    base = (kp.lvl.long() * (H * W))[:, None, None]
    n = kp.x.shape[0]
    vals = blurred.reshape(-1)[(base + gy * W + gx).reshape(n, -1)]
    vals = vals.reshape(n, 256, 2)
    return pack_bits(vals[..., 0] < vals[..., 1])


def extract_batched(image: torch.Tensor, n_levels: int, scale_factor: float,
                    ini_th: float, min_th: float, border: int, cell: int,
                    budgets: Sequence[int]):
    """The batched pipeline on [H, W] float32 -> (xy [N, 2] level-0
    pixels, response, angle, level, desc [N, 8] int32, valid)."""
    h, w = image.shape
    stack = build_level_stack(image, n_levels, scale_factor)
    valid = level_valid_mask(h, w, n_levels, float(scale_factor), border,
                             image.device)
    score = fast_dual_batched(stack, valid, ini_th, min_th, cell)
    kp = select_batched(score, budgets, cell, per_cell=4)
    ang = ic_angles_batched(stack, kp)
    desc = brief_batched(gaussian_blur(stack), kp, ang)
    # the level scales in float64, rounded once (the reference's
    # _level_meta)
    scales = torch.from_numpy((scale_factor ** np.arange(n_levels)).astype(
        np.float32)).to(image.device)
    sc = scales[kp.lvl.long()]
    xy0 = torch.stack([kp.x.to(torch.float32) * sc,
                       kp.y.to(torch.float32) * sc], dim=-1)
    return xy0, kp.resp, ang, kp.lvl, desc, kp.valid
