"""The online dynamic-object detector: a small CenterNet and its
post-processing.

Port of ``slam_dynamic_tpu/models/detector.py``: ``Detections`` :32,
``ConvBlock`` :39, ``CenterDetector`` :51, ``Detector`` :78 with
``from_npz`` :95, the inference pass ``_infer_impl`` :106, ``detect``
:146, ``save_params`` :149 and ``load_params`` :157,
``default_detector_weights`` :163 and ``reshape_boxes_stereo`` :173 (the
reference's ``rectCenterScale``). The offline boxes' reader is
``io/datasets.load_precomputed_boxes``.

The network is seven 3x3 conv blocks (widths 32, 64, 128; strides 2, 1,
2, 1, 2, 1, 1) and three 1x1 heads at stride 8: the class heatmap, the
box size (``exp(clip(., -3, 4)) * 8`` pixels) and the centre offset.
Its convolutions are XLA convolutions in JAX, no Pallas kernel, and
``F.conv2d`` in float32 here (the package pins TF32 off for cuDNN). Two
details of flax that the port keeps:

- flax's ``GroupNorm`` on the unbatched [H, W, C] input takes H for the
  batch axis: every image row is normalized on its own, over (W, C / g),
  with eps 1e-6. ``_row_group_norm`` runs ``F.group_norm`` with the rows
  as the batch.
- flax's ``SAME`` padding of a stride-2 3x3 conv is (0, 1) on an even
  side and (1, 1) on an odd one: ``_same_pad`` pads by that rule and the
  conv runs unpadded.

Post-processing as the reference's yolo.cc: sigmoid scores, 3x3
local-maximum peaks above ``conf_threshold``, the top ``2 *
max_detections`` of the peak-masked scores in the NHWC flattening order
(ties to the lowest index, as ``jax.lax.top_k``; the class is ``index %
C``), boxes clipped to the image, the dynamic-class filter and NMS.

The weights asset is a pickle of plain dicts of numpy arrays (the flax
params tree); ``load_params`` reads it with an unpickler that admits
numpy's array reconstructor, ``ndarray`` and ``dtype`` and nothing else.
"""
from __future__ import annotations

import io
import pickle
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..config import DetectorConfig
from ..convert import detector_params_from_numpy, detector_params_to_numpy
from ..ops.nms import nms

GN_EPS = 1e-6
STRIDE = 8


class Detections(NamedTuple):
    boxes: torch.Tensor     # [D, 4] x0, y0, x1, y1 (input-image pixels)
    scores: torch.Tensor    # [D]
    classes: torch.Tensor   # [D] int32
    valid: torch.Tensor     # [D] bool


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Pad [N, C, H, W] as XLA's ``SAME`` does: out = ceil(in / stride),
    the total padding split with the smaller half first."""
    pads = []
    for size in (x.shape[3], x.shape[2]):          # W, then H (F.pad order)
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _row_group_norm(x: torch.Tensor, groups: int, weight, bias):
    """flax ``GroupNorm`` on an unbatched [H, W, C] image: each row
    normalized over (W, C / groups). x is [1, C, H, W]."""
    rows = x[0].permute(1, 0, 2)                   # [H, C, W]: H the batch
    rows = F.group_norm(rows, groups, weight, bias, eps=GN_EPS)
    return rows.permute(1, 0, 2)[None]


class ConvBlock(nn.Module):
    def __init__(self, c_in: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.groups = min(8, features)
        self.conv = nn.Conv2d(c_in, features, 3, stride, bias=False)
        self.norm = nn.GroupNorm(self.groups, features, eps=GN_EPS)

    def forward(self, x):
        x = F.conv2d(_same_pad(x, 3, self.stride), self.conv.weight,
                     stride=self.stride)
        x = _row_group_norm(x, self.groups, self.norm.weight, self.norm.bias)
        return F.silu(x)


class CenterDetector(nn.Module):
    """Anchor-free detector on one gray image [1, 1, H, W]: stride-8
    class heatmap [1, C, H/8, W/8], box size [1, 2, ..] (w, h in input
    pixels) and centre offset [1, 2, ..]."""

    def __init__(self, n_classes: int = 80, width: int = 32):
        super().__init__()
        w = width
        plan = [(1, w, 2), (w, w, 1), (w, 2 * w, 2), (2 * w, 2 * w, 1),
                (2 * w, 4 * w, 2), (4 * w, 4 * w, 1), (4 * w, 4 * w, 1)]
        self.blocks = nn.ModuleList(ConvBlock(*p) for p in plan)
        self.heat = nn.Conv2d(4 * w, n_classes, 1)
        self.size = nn.Conv2d(4 * w, 2, 1)
        self.off = nn.Conv2d(4 * w, 2, 1)

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        # log-space size: equal relative gradient for 10 px and 200 px
        size = torch.exp(torch.clamp(self.size(x), -3.0, 4.0)) * 8.0
        return self.heat(x), size, self.off(x)


class _NumpyUnpickler(pickle.Unpickler):
    """Admits numpy's array reconstructor, ``ndarray`` and ``dtype``, under
    the module names numpy 1 and 2 write, and nothing else."""

    _ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "_reconstruct")}

    def find_class(self, module, name):
        if (module, name) not in self._ALLOWED:
            raise pickle.UnpicklingError(
                f"detector weights: global {module}.{name} is not allowed")
        if name == "_reconstruct":
            try:
                from numpy._core import multiarray
            except ImportError:                    # numpy 1
                from numpy.core import multiarray
            return multiarray._reconstruct
        return getattr(np, name)


def load_params(path: str):
    """The params tree of a weights file in the JAX package's format (an
    npz with a pickled tree under ``blob``)."""
    with np.load(path) as z:
        return _NumpyUnpickler(io.BytesIO(z["blob"].tobytes())).load()


def _n_classes(path: str, default: int = 80) -> int:
    with np.load(path) as z:
        return int(z["n_classes"]) if "n_classes" in z.files else default


class Detector:
    """The network's weights on ``device`` and its post-processing:
    ``detect(image [H, W]) -> Detections`` of fixed capacity
    ``cfg.max_detections``. ``params``: a params tree in the JAX
    package's format; without one the network takes torch's
    initialization from ``seed`` (not the JAX package's draws)."""

    def __init__(self, cfg: DetectorConfig, height: int, width: int,
                 params=None, seed: int = 0, n_classes: int = 80,
                 device=None):
        self.cfg = cfg
        self.n_classes = n_classes
        self.h, self.w = height, width
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = CenterDetector(n_classes=n_classes)
        if params is not None:
            self.model.load_state_dict(detector_params_from_numpy(params))
        self.model.to(self.device).eval()
        self._dyn_classes = torch.tensor(cfg.dynamic_classes,
                                         dtype=torch.int32,
                                         device=self.device)
        self._lim = torch.tensor([width - 1, height - 1, width - 1,
                                  height - 1], dtype=torch.float32,
                                 device=self.device)

    @staticmethod
    def from_npz(cfg: DetectorConfig, height: int, width: int, path: str,
                 seed: int = 0, device=None) -> "Detector":
        """With trained weights; the class count rides in the asset."""
        return Detector(cfg, height, width, params=load_params(path),
                        seed=seed, n_classes=_n_classes(path),
                        device=device)

    load_params = staticmethod(load_params)

    @property
    def params(self):
        """The weights as a params tree in the JAX package's format."""
        return detector_params_to_numpy(self.model.state_dict())

    def save_params(self, path: str):
        """Write the weights as the JAX package's ``save_params`` does."""
        np.savez_compressed(path, blob=np.frombuffer(
            pickle.dumps(self.params), dtype=np.uint8),
            n_classes=self.n_classes)

    @torch.no_grad()
    def maps(self, image) -> tuple:
        """The network's raw maps of one image [H, W] (0-255): heat
        [C, h, w], size [2, h, w], offset [2, h, w]."""
        x = torch.as_tensor(np.asarray(image, np.float32)) \
            if not isinstance(image, torch.Tensor) else image
        x = x.to(self.device, torch.float32)[None, None] / 255.0
        heat, size, off = self.model(x)
        return heat[0], size[0], off[0]

    @torch.no_grad()
    def detect(self, image) -> Detections:
        """One image [H, W] (0-255) -> Detections, all on the device."""
        cfg = self.cfg
        heat, size, off = self.maps(image)
        C, hh, ww = heat.shape
        scores = torch.sigmoid(heat)
        pooled = F.max_pool2d(scores[None], 3, stride=1, padding=1)[0]
        peak = (scores >= pooled) & (scores > cfg.conf_threshold)
        # NHWC flattening order, as the JAX package's index % C
        flat = torch.where(peak, scores, 0.0).permute(1, 2, 0).reshape(-1)
        k = cfg.max_detections * 2
        top, idx = torch.sort(flat, descending=True, stable=True)
        top, idx = top[:k], idx[:k]
        cls = (idx % C).to(torch.int32)
        cell = idx // C
        cy = (cell // ww).to(torch.float32)
        cx = (cell % ww).to(torch.float32)
        offs = off.permute(1, 2, 0).reshape(-1, 2)[cell]
        sizes = size.permute(1, 2, 0).reshape(-1, 2)[cell]
        px = (cx + offs[:, 0]) * float(STRIDE)
        py = (cy + offs[:, 1]) * float(STRIDE)
        boxes = torch.stack([px - sizes[:, 0] / 2, py - sizes[:, 1] / 2,
                             px + sizes[:, 0] / 2, py + sizes[:, 1] / 2], -1)
        # clipped to the image: the box tracker lives in clipped pixels
        boxes = torch.minimum(torch.clamp(boxes, min=0.0), self._lim)
        ok = top > cfg.conf_threshold
        ok &= (cls[:, None] == self._dyn_classes[None]).any(1)
        keep_idx, keep = nms(boxes, torch.where(ok, top, 0.0), ok,
                             cfg.nms_threshold, max_out=cfg.max_detections)
        ki = keep_idx.long()
        return Detections(boxes[ki], top[ki], cls[ki], keep)


def default_detector_weights() -> Optional[str]:
    """The JAX package's shipped trained weights, found by file path and
    read in place (not copied), or None."""
    p = Path(__file__).resolve().parents[2] / "slam_dynamic_tpu" / \
        "assets" / "detector_synth.npz"
    return str(p) if p.exists() else None


def reshape_boxes_stereo(boxes: np.ndarray, shrink_w: float = 0.8,
                         grow_h: float = 1.6) -> np.ndarray:
    """``rectCenterScale`` (the reference's yolo.cc:142-149): the width
    shrunk 20% and the height grown 60% about the centre."""
    b = np.asarray(boxes, np.float32).reshape(-1, 4)
    cx = (b[:, 0] + b[:, 2]) / 2
    cy = (b[:, 1] + b[:, 3]) / 2
    hw = (b[:, 2] - b[:, 0]) / 2 * shrink_w
    hh = (b[:, 3] - b[:, 1]) / 2 * grow_h
    return np.stack([cx - hw, cy - hh, cx + hw, cy + hh], 1)
