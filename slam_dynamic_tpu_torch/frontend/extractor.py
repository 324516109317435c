"""ORB feature extraction: pyramid -> FAST -> uniform selection ->
orientation -> rBRIEF.

Port of ``slam_dynamic_tpu/frontend/extractor.py:35-117``: the per-level
budgets, the unrolled per-level path (``config.py:53``
``batched_levels=False``, the default) and the batched-over-levels path
(``batched_levels=True``, ``ops/orb_batched.py``: one set of launches
for all levels, for about 3x the pixel work). Output is a fixed-capacity
``Keypoints`` struct (n_features slots + validity mask) in level-0
pixels. ``extract_np`` (:114) is the host entry: a numpy image in, on the
card unless ``device="cpu"``.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..config import ORBConfig
from ..ops import fast, orb, orb_batched, pyramid


class Keypoints(NamedTuple):
    xy: torch.Tensor        # [N, 2] float32, level-0 pixels (distorted)
    response: torch.Tensor  # [N] float32
    angle: torch.Tensor     # [N] float32 radians
    level: torch.Tensor     # [N] int32 pyramid level
    desc: torch.Tensor      # [N, 8] int32 packed 256-bit descriptors
    valid: torch.Tensor     # [N] bool


def level_budgets(cfg: ORBConfig) -> List[int]:
    """Geometric per-level feature budget (ref ORBextractor.cc:436-460)."""
    factor = 1.0 / cfg.scale_factor
    n_first = cfg.n_features * (1 - factor) / (1 - factor ** cfg.n_levels)
    budgets, total = [], 0
    for l in range(cfg.n_levels - 1):
        b = int(round(n_first * factor ** l))
        budgets.append(b)
        total += b
    budgets.append(max(cfg.n_features - total, 0))
    return budgets


def extract(image: torch.Tensor, cfg: ORBConfig) -> Keypoints:
    """image: [H, W] float32 grayscale in [0, 255] on any device."""
    budgets = level_budgets(cfg)
    if cfg.batched_levels:
        return Keypoints(*orb_batched.extract_batched(
            image, cfg.n_levels, cfg.scale_factor, cfg.ini_th_fast,
            cfg.min_th_fast, cfg.edge_threshold, cfg.cell_size, budgets))
    scales = pyramid.level_scales(cfg.n_levels, cfg.scale_factor)
    levels = pyramid.build_pyramid(image, cfg.n_levels, cfg.scale_factor)
    parts = []
    for l, (img_l, budget) in enumerate(zip(levels, budgets)):
        score = fast.detect(img_l, cfg.ini_th_fast, cfg.min_th_fast,
                            border=cfg.edge_threshold, cell=cfg.cell_size)
        xy_l, resp, valid = orb.select_topk_cells(
            score, budget, cell=cfg.cell_size, per_cell=4)
        ang = orb.ic_angles(img_l, xy_l)
        desc = orb.brief_descriptors(pyramid.gaussian_blur(img_l), xy_l, ang)
        xy0 = xy_l.to(torch.float32) * float(np.float32(scales[l]))
        parts.append((xy0, resp, ang,
                      torch.full(resp.shape, l, dtype=torch.int32,
                                 device=image.device), desc, valid))
    return Keypoints(*(torch.cat([p[i] for p in parts]) for i in range(6)))


def extract_np(image: np.ndarray, cfg: ORBConfig, device=None) -> Keypoints:
    """Host entry: a uint8 or float [H, W] numpy image, extracted on the
    card unless ``device="cpu"``."""
    img = torch.as_tensor(np.asarray(image, np.float32),
                          device=resolve_device(device))
    return extract(img, cfg)
