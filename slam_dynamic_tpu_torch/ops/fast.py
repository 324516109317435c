"""FAST-9-16 corner detection, vectorized over the image plane.

Port of ``slam_dynamic_tpu/ops/fast.py`` (``fast_response`` :43, ``nms3x3``,
``detect`` :80): the 16 ring comparisons become a 16-bit mask per pixel
and the "9 contiguous" test a logarithmic AND-shift reduction on the
doubled mask. The masks are held in int64, so every shift is exact.
"""
from __future__ import annotations

import numpy as np
import torch

# Bresenham circle of radius 3 (the FAST-16 ring), clockwise from 12 o'clock.
RING_OFFSETS = np.array(
    [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
     (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
     (-1, -3)], dtype=np.int32)  # (dx, dy)


def _ring_stack(img: torch.Tensor) -> torch.Tensor:
    """[16, ..., H, W] ring neighbour values via rolls over the last two
    dims (borders masked later)."""
    return torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(-2, -1))
         for dx, dy in RING_OFFSETS], dim=0)


def _contiguous9(mask16: torch.Tensor) -> torch.Tensor:
    """int64 mask of 16 ring bits -> bool: any 9 contiguous set bits."""
    d = mask16 | (mask16 << 16)
    r2 = d & (d >> 1)
    r4 = r2 & (r2 >> 2)
    r8 = r4 & (r4 >> 4)
    r9 = r8 & (d >> 8)
    return (r9 & 0xFFFF) != 0


def _ring_weights(device, ndim: int):
    w = torch.ones(16, dtype=torch.int64, device=device) \
        << torch.arange(16, dtype=torch.int64, device=device)
    return w.reshape((16,) + (1,) * ndim)


def fast_response(img: torch.Tensor, threshold, ring=None):
    """Segment test + response for every pixel of img [..., H, W].

    Returns (corner [..., H, W] bool, score [..., H, W] float32), score
    being the arc strength sum(max(|ring - p| - t, 0)) over the passing
    direction.
    """
    if ring is None:
        ring = _ring_stack(img)
    p = img[None]
    t = float(threshold)
    brighter = ring > p + t
    darker = ring < p - t
    wts = _ring_weights(img.device, img.dim())
    zero = torch.zeros((), dtype=torch.int64, device=img.device)
    mb = torch.where(brighter, wts, zero).sum(0)
    md = torch.where(darker, wts, zero).sum(0)
    is_b = _contiguous9(mb)
    is_d = _contiguous9(md)
    corner = is_b | is_d
    sb = torch.where(brighter, ring - p - t, 0.0).sum(0)
    sd = torch.where(darker, p - t - ring, 0.0).sum(0)
    score = torch.maximum(torch.where(is_b, sb, 0.0),
                          torch.where(is_d, sd, 0.0))
    return corner, score


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep pixels that are the maximum of their 3x3 neighbourhood."""
    win = torch.nn.functional.max_pool2d(score[None, None], 3, stride=1,
                                         padding=1)[0, 0]
    return score >= win


def detect(img: torch.Tensor, ini_threshold: float, min_threshold: float,
           border: int, cell: int = 32) -> torch.Tensor:
    """Dual-threshold FAST with 3x3 NMS and per-cell fallback: cells where
    the high threshold fired keep only high-threshold corners.

    Returns the score map [H, W] float32, 0 for non-corners.
    """
    h, w = img.shape
    ring = _ring_stack(img)
    c_hi, s_hi = fast_response(img, ini_threshold, ring)
    c_lo, s_lo = fast_response(img, min_threshold, ring)

    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    valid = ((ys >= border) & (ys < h - border) &
             (xs >= border) & (xs < w - border))
    c_hi = c_hi & valid
    c_lo = c_lo & valid

    ch, cw = -(-h // cell), -(-w // cell)
    hi_pad = torch.nn.functional.pad(c_hi, (0, cw * cell - w,
                                            0, ch * cell - h))
    cell_has_hi = hi_pad.reshape(ch, cell, cw, cell).any(3).any(1)
    full = cell_has_hi[:, None, :, None].expand(ch, cell, cw, cell)
    full = full.reshape(ch * cell, cw * cell)[:h, :w]

    corner = torch.where(full, c_hi, c_lo)
    score = torch.where(corner, torch.where(full, s_hi, s_lo), 0.0)
    keep = nms3x3(score) & corner
    return torch.where(keep, score, 0.0)
