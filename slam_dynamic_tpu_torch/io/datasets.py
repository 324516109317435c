"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV and the
synthetic world.

Port copy of ``slam_dynamic_tpu/io/datasets.py`` (host numpy only; kept
as a copy because the JAX package's ``__init__`` imports jax), with the
offline detector's box reader (``models/detector.py:186``
``load_precomputed_boxes``) beside it. The JAX package may decode TUM
images with its C++ prefetching loader (``io/native_loader.py``); the
port decodes them with PIL, imported inside the readers, as that
package does without the native loader. Format parity with the reference
drivers:
  - TUM: rgb.txt/depth.txt timestamp association + 16-bit depth PNGs with
    DepthMapFactor scaling, groundtruth.txt in TUM trajectory format;
  - KITTI: sequences/NN/image_0, image_1, times.txt;
  - EuRoC: mav0/cam0 (and cam1) data.csv + PNGs, stereo pre-rectified
    from the yaml's LEFT.*/RIGHT.* blocks (``load_rect_blocks``,
    ``rectify_maps``, ``remap_bilinear``);
  - precomputed per-frame detection txts + mask PNGs.
Frames are yielded in camera-native dtypes (uint8 gray, raw uint16
depth); the System scales depth on the device.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np


def _read_gray(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert("L"), np.float32)


def _read_depth_tum(path: str, factor: float) -> np.ndarray:
    from PIL import Image
    raw = np.asarray(Image.open(path), np.float32)
    return raw / factor


def load_precomputed_boxes(path: str, frame_idx: int) -> np.ndarray:
    """Offline detections: per-frame txt ``cls x0 y0 x1 y1 [score]`` rows
    (the reference's yolov5_2Dbbox files) -> [D, 4] float32."""
    fp = os.path.join(path, f"{frame_idx:06d}.txt")
    if not os.path.exists(fp):
        return np.zeros((0, 4), np.float32)
    rows = np.loadtxt(fp, ndmin=2)
    if rows.size == 0:
        return np.zeros((0, 4), np.float32)
    return rows[:, 1:5].astype(np.float32)


@dataclass
class FramePacket:
    index: int
    timestamp: float
    gray: np.ndarray
    depth: Optional[np.ndarray] = None
    right: Optional[np.ndarray] = None
    detections: Optional[np.ndarray] = None
    mask: Optional[np.ndarray] = None


def _associate(ts_a, ts_b, max_dt=0.02):
    out = []
    for i, ta in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - ta)))
        if abs(ts_b[j] - ta) <= max_dt:
            out.append((i, j))
    return out


class TumRGBD:
    """TUM RGB-D sequence directory (rgb.txt, depth.txt, groundtruth.txt)."""

    def __init__(self, root: str, depth_factor: float = 5000.0,
                 boxes_dir: Optional[str] = None,
                 masks_dir: Optional[str] = None):
        self.root = root
        self.depth_factor = depth_factor
        self.boxes_dir = boxes_dir
        self.masks_dir = masks_dir
        rgb = self._read_list(os.path.join(root, "rgb.txt"))
        dep = self._read_list(os.path.join(root, "depth.txt"))
        pairs = _associate(np.array([t for t, _ in rgb]),
                           np.array([t for t, _ in dep]))
        self.items = [(rgb[i][0], rgb[i][1], dep[j][1]) for i, j in pairs]

    @staticmethod
    def _read_list(path):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, rel = line.split()[:2]
                out.append((float(ts), rel))
        return out

    def __len__(self):
        return len(self.items)

    def __iter__(self) -> Iterator[FramePacket]:
        rgb_it = (_read_gray(os.path.join(self.root, r))
                  for _, r, _ in self.items)
        dep_it = (_read_depth_tum(os.path.join(self.root, d), 1.0)
                  for _, _, d in self.items)
        for i, (ts, rgb_rel, dep_rel) in enumerate(self.items):
            det = None
            if self.boxes_dir:
                det = load_precomputed_boxes(self.boxes_dir, i)
            mask = None
            if self.masks_dir:
                mp = os.path.join(self.masks_dir, f"mask_{i:06d}.png")
                if os.path.exists(mp):
                    mask = _read_gray(mp) > 127
            # camera-native dtypes end to end: uint8 gray + raw uint16
            # depth go to the device unconverted (System scales by
            # camera.depth_map_factor on device — frontend/fused.py)
            dep = np.asarray(next(dep_it))
            if dep.dtype != np.uint16:
                dep = np.clip(dep, 0, 65535).astype(np.uint16)
            gray = np.asarray(next(rgb_it))
            if gray.dtype != np.uint8:
                gray = np.clip(gray, 0, 255).astype(np.uint8)
            yield FramePacket(i, ts, gray, depth=dep, detections=det,
                              mask=mask)

    def groundtruth(self):
        from .trajectory import load_tum
        return load_tum(os.path.join(self.root, "groundtruth.txt"))


class KittiStereo:
    """KITTI odometry sequence dir (image_0/, image_1/, times.txt)."""

    def __init__(self, seq_dir: str, boxes_dir: Optional[str] = None):
        self.dir = seq_dir
        self.boxes_dir = boxes_dir
        with open(os.path.join(seq_dir, "times.txt")) as f:
            self.times = [float(line) for line in f if line.strip()]

    def __len__(self):
        return len(self.times)

    def __iter__(self) -> Iterator[FramePacket]:
        for i, ts in enumerate(self.times):
            det = None
            if self.boxes_dir:
                det = load_precomputed_boxes(self.boxes_dir, i)
            # uint8 passthrough: cast to float happens on device
            left = _read_gray(os.path.join(self.dir, "image_0",
                                           f"{i:06d}.png"))
            right = _read_gray(os.path.join(self.dir, "image_1",
                                            f"{i:06d}.png"))
            yield FramePacket(
                i, ts, np.clip(left, 0, 255).astype(np.uint8),
                right=np.clip(right, 0, 255).astype(np.uint8),
                detections=det)


def load_rect_blocks(yaml_path: str):
    """Parse the LEFT.*/RIGHT.* opencv-matrix rectification blocks of a
    reference-style stereo yaml (format: Examples/Stereo/EuRoC.yaml — the
    `!!opencv-matrix` rows/cols/data records the reference feeds to
    cv::initUndistortRectifyMap, stereo_euroc.cc:78-95). Returns
    {"LEFT.K": (3,3), "LEFT.D": (n,), "LEFT.R": (3,3), "LEFT.P": (3,4),
     ...RIGHT...} or {} when no blocks exist."""
    import re
    with open(yaml_path) as f:
        text = f.read()
    out = {}
    for m in re.finditer(
            r"(LEFT|RIGHT)\.([DKRP])\s*:.*?rows:\s*(\d+).*?cols:\s*(\d+)"
            r".*?data:\s*\[([^\]]*)\]", text, re.S):
        side, name, rows, cols = m.group(1), m.group(2), int(m.group(3)), \
            int(m.group(4))
        vals = np.array([float(x) for x in m.group(5).replace("\n", " ")
                         .split(",") if x.strip()], np.float64)
        arr = vals.reshape(rows, cols) if rows > 1 else vals
        out[f"{side}.{name}"] = arr
    return out


def rectify_maps(K, D, R, P, width: int, height: int):
    """Source-pixel sampling maps for stereo rectification — numpy
    equivalent of cv::initUndistortRectifyMap: for each RECTIFIED pixel,
    back-project through P, rotate by R^-1 into the original camera,
    re-distort with (k1, k2, p1, p2[, k3]) and project through K.
    Returns (map_x, map_y) float32 [H, W]."""
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    x = (u - P[0, 2]) / P[0, 0]
    y = (v - P[1, 2]) / P[1, 1]
    pts = np.stack([x, y, np.ones_like(x)], 0).reshape(3, -1)
    Xc = np.linalg.inv(R) @ pts
    xn = Xc[0] / Xc[2]
    yn = Xc[1] / Xc[2]
    D = np.asarray(D).ravel()
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if D.size > 4 else 0.0
    r2 = xn * xn + yn * yn
    radial = 1.0 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    map_x = (K[0, 0] * xd + K[0, 2]).reshape(height, width)
    map_y = (K[1, 1] * yd + K[1, 2]).reshape(height, width)
    return map_x.astype(np.float32), map_y.astype(np.float32)


def remap_bilinear(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray):
    """Bilinear image remap (numpy equivalent of cv::remap); out-of-range
    samples clamp to the border."""
    h, w = img.shape
    x0 = np.clip(np.floor(map_x).astype(np.int32), 0, w - 2)
    y0 = np.clip(np.floor(map_y).astype(np.int32), 0, h - 2)
    fx = np.clip(map_x - x0, 0.0, 1.0)
    fy = np.clip(map_y - y0, 0.0, 1.0)
    im = img.astype(np.float32)
    top = im[y0, x0] * (1 - fx) + im[y0, x0 + 1] * fx
    bot = im[y0 + 1, x0] * (1 - fx) + im[y0 + 1, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


class EurocDataset:
    """EuRoC MAV sequence (mav0/cam0/data + data.csv; cam1 for stereo).

    Parity: mono_euroc.cc (raw cam0 frames — distortion handled by the
    pipeline's undistort_points via the yaml's Camera.k1..p2) and
    stereo_euroc.cc:58-112 (pre-rectification from the yaml's
    LEFT.*/RIGHT.* blocks; here precomputed numpy maps + bilinear remap
    on the loader thread, uint8 passthrough to device)."""

    def __init__(self, root: str, stereo: bool = False,
                 yaml_path: Optional[str] = None):
        self.root = root
        self.stereo = stereo
        cam0 = os.path.join(root, "cam0", "data.csv")
        self.items = []
        with open(cam0) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts_ns, name = line.split(",")[:2]
                self.items.append((float(ts_ns) * 1e-9, name.strip()))
        self.maps = None
        if stereo:
            if yaml_path is None:
                raise ValueError("stereo EuRoC needs the yaml with "
                                 "LEFT./RIGHT. rectification blocks")
            blk = load_rect_blocks(yaml_path)
            if blk:
                # image size from the first frame
                img0 = _read_gray(self._path("cam0", self.items[0][1]))
                h, w = img0.shape
                self.maps = (
                    rectify_maps(blk["LEFT.K"], blk["LEFT.D"],
                                 blk["LEFT.R"], blk["LEFT.P"], w, h),
                    rectify_maps(blk["RIGHT.K"], blk["RIGHT.D"],
                                 blk["RIGHT.R"], blk["RIGHT.P"], w, h))

    def _path(self, cam, name):
        return os.path.join(self.root, cam, "data", name)

    def __len__(self):
        return len(self.items)

    def __iter__(self) -> Iterator[FramePacket]:
        for i, (ts, name) in enumerate(self.items):
            left = _read_gray(self._path("cam0", name))
            right = None
            if self.stereo:
                right = _read_gray(self._path("cam1", name))
                if self.maps is not None:
                    left = remap_bilinear(left, *self.maps[0])
                    right = remap_bilinear(right, *self.maps[1])
                right = np.clip(right, 0, 255).astype(np.uint8)
            yield FramePacket(
                i, ts, np.clip(left, 0, 255).astype(np.uint8), right=right)


class SyntheticDataset:
    """In-memory synthetic sequence as a dataset (tests/benchmarks)."""

    def __init__(self, seq, use_boxes: bool = False, use_masks: bool = False,
                 stereo: bool = False):
        self.seq = seq
        self.use_boxes = use_boxes
        self.use_masks = use_masks
        self.stereo = stereo

    def __len__(self):
        return self.seq.gray.shape[0]

    def __iter__(self) -> Iterator[FramePacket]:
        s = self.seq
        for i in range(len(self)):
            det = None
            if self.use_boxes and s.box_valid[i].any():
                det = s.boxes[i][s.box_valid[i]]
            yield FramePacket(
                i, float(s.timestamps[i]), s.gray[i],
                depth=None if self.stereo else s.depth[i],
                right=s.right[i] if self.stereo else None,
                detections=det,
                mask=s.masks[i] if self.use_masks else None)
