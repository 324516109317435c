"""Image pyramid + Gaussian blur.

Port of ``slam_dynamic_tpu/ops/pyramid.py`` (``build_pyramid`` :31,
``gaussian_blur`` :51). The reference resizes with
``jax.image.resize(method="linear")``, which antialiases when it
downsamples (a triangle filter widened by the inverse scale). The port
builds the same separable weight matrices and applies them as two matrix
products, so each level equals the reference's up to float rounding.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


def level_shapes(height: int, width: int, n_levels: int,
                 scale_factor: float) -> List[Tuple[int, int]]:
    return [
        (int(round(height / scale_factor**l)), int(round(width / scale_factor**l)))
        for l in range(n_levels)
    ]


def level_scales(n_levels: int, scale_factor: float) -> np.ndarray:
    return scale_factor ** np.arange(n_levels, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _resize_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 weights of jax.image's antialiased
    triangle kernel (jax/_src/image/scale.py compute_weight_mat), in the
    same float32 arithmetic."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)
               [:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = np.add.reduce(w, axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)),
                 np.float32(0.0)).astype(np.float32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_weights(in_size, out_size, device):
    """The weights on ``device``, copied there once (a per-call copy
    would make the host wait for the queue every frame)."""
    return torch.from_numpy(_resize_weights_np(in_size, out_size)).to(device)


def build_pyramid(image: torch.Tensor, n_levels: int,
                  scale_factor: float) -> List[torch.Tensor]:
    """Grayscale float32 [H, W] -> n_levels images, level l scaled by
    1/scale_factor**l (antialiased linear resize, as jax.image.resize)."""
    h, w = image.shape
    shapes = level_shapes(h, w, n_levels, scale_factor)
    out = [image]
    for l in range(1, n_levels):
        hl, wl = shapes[l]
        wh = _resize_weights(h, hl, image.device)      # [H, hl]
        ww = _resize_weights(w, wl, image.device)      # [W, wl]
        out.append(wh.T @ image @ ww)
    return out


@functools.lru_cache(maxsize=None)
def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(image: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with reflect padding of [..., H, W] float32
    (each image of a stack alone): the same shifted-slice weighted sums,
    in the same order, as the reference."""
    kern = [float(v) for v in _gaussian_kernel(ksize, sigma)]
    r = ksize // 2
    h, w = image.shape[-2:]
    x = torch.nn.functional.pad(image.reshape(-1, 1, h, w), (0, 0, r, r),
                                mode="reflect")
    out = 0
    for i in range(ksize):
        out = out + kern[i] * x[..., i:i + h, :]
    x = torch.nn.functional.pad(out, (r, r, 0, 0), mode="reflect")
    res = 0
    for i in range(ksize):
        res = res + kern[i] * x[..., i:i + w]
    return res.reshape(image.shape)

