"""Non-maximum suppression with a fixed output capacity.

Port of ``slam_dynamic_tpu/ops/nms.py`` (``iou_matrix`` :16, ``nms``
:30), the cv::dnn::NMSBoxes of the reference's detector post-processing:
``max_out`` steps, each picking the highest surviving score (the first
index on ties, as ``jnp.argmax``) and suppressing the boxes that overlap
it. No Pallas kernel in JAX; a few small ops a step here, all on the
boxes' device, with no readback.
"""
from __future__ import annotations

import math

import torch


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[A, B] IoU of (x0, y0, x1, y1) boxes."""
    x0 = torch.maximum(a[:, None, 0], b[None, :, 0])
    y0 = torch.maximum(a[:, None, 1], b[None, :, 1])
    x1 = torch.minimum(a[:, None, 2], b[None, :, 2])
    y1 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = torch.clamp(x1 - x0, min=0) * torch.clamp(y1 - y0, min=0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
        iou_threshold: float = 0.4, max_out: int = 32):
    """Returns (indices [max_out] int32, keep [max_out] bool); a step with
    no surviving box keeps index 0 and False."""
    iou = iou_matrix(boxes, boxes)
    alive = valid & (scores > 0)
    ar = torch.arange(boxes.shape[0], device=boxes.device)
    out_idx, out_ok = [], []
    for _ in range(max_out):
        s = torch.where(alive, scores, -math.inf)
        best = torch.argmax(s)           # the first maximum
        ok = s[best] > -math.inf
        out_idx.append(torch.where(ok, best, 0))
        out_ok.append(ok)
        suppress = (iou[best] > iou_threshold) | (ar == best)
        alive = alive & ~(suppress & ok)
    return (torch.stack(out_idx).to(torch.int32), torch.stack(out_ok))
