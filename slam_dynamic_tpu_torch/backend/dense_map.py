"""The dense map: per-keyframe clouds without the dynamic objects, a
voxel-merged global cloud, and an OBB per dynamic object.

Port of ``slam_dynamic_tpu/backend/dense_map.py`` (``DenseMapper`` :21,
``insert_keyframe`` :29, ``global_cloud`` :79, ``save_ply`` :95,
``save_pcd`` :100), the reference's PointCloudMapping thread and the
per-object depth and OBB of its Tracking: a keyframe's pixels are
backprojected on the device (``ops/pointcloud.backproject_dense``) with
the confirmed-dynamic boxes and the dynamic mask left out, and kept on
the host; an object's OBB is the PCA box of its in-box pixels within
0.5 m of their median depth. Output is PLY and PCD files (no viewer).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..ops import pointcloud as pc
from ..utils.camera import Intrinsics


def _clipped_box(b, h: int, w: int):
    return [int(np.clip(v, 0, lim))
            for v, lim in zip(b, [w - 1, h - 1, w - 1, h - 1])]


class DenseMapper:
    def __init__(self, cfg: SystemConfig, cam: Intrinsics):
        self.cfg = cfg
        self.cam = cam
        self.device = cam.fx.device
        self.clouds: List[np.ndarray] = []
        self.intens: List[np.ndarray] = []
        self.obbs: Dict[int, pc.OBB] = {}   # box track id -> latest (numpy)

    def _t(self, a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device,
                                                            dtype)

    def insert_keyframe(self, gray: np.ndarray, depth: np.ndarray,
                        R_cw, t_cw, dyn_mask: Optional[np.ndarray] = None,
                        boxes: Optional[np.ndarray] = None,
                        box_ids: Optional[np.ndarray] = None,
                        box_dynamic: Optional[np.ndarray] = None):
        """Add one keyframe's cloud (dynamic pixels and the boxes confirmed
        dynamic left out) and the OBB of each box confirmed dynamic. gray
        and depth (metres) are host arrays [H, W]; R_cw, t_cw the pose."""
        h, w = depth.shape
        mask = np.zeros((h, w), bool) if dyn_mask is None \
            else np.array(dyn_mask, bool)
        if boxes is not None and box_dynamic is not None:
            for b, dyn in zip(boxes, box_dynamic):
                if dyn:
                    x0, y0, x1, y1 = _clipped_box(b, h, w)
                    mask[y0:y1 + 1, x0:x1 + 1] = True
        p = self.cfg.pointcloud
        pts, inten, ok = pc.backproject_dense(
            self.cam, self._t(gray), self._t(depth), self._t(R_cw),
            self._t(t_cw), self._t(mask, torch.bool), stride=p.stride,
            min_depth=p.min_depth, max_depth=p.max_depth)
        okn = ok.cpu().numpy()
        self.clouds.append(pts.cpu().numpy()[okn])
        self.intens.append(inten.cpu().numpy()[okn])

        if boxes is None or box_dynamic is None:
            return
        cx, cy = float(self.cam.cx), float(self.cam.cy)
        fx, fy = float(self.cam.fx), float(self.cam.fy)
        for b, bid, dyn in zip(boxes, box_ids, box_dynamic):
            if not dyn:
                continue
            x0, y0, x1, y1 = _clipped_box(b, h, w)
            sub_d = depth[y0:y1 + 1, x0:x1 + 1]
            yy, xx = np.mgrid[y0:y1 + 1, x0:x1 + 1]
            good = (sub_d > p.min_depth) & \
                (sub_d < self.cfg.dynamic.max_object_depth)
            if good.sum() < 20:
                continue
            # the median-depth band (background bleed left out)
            med = np.median(sub_d[good])
            good &= np.abs(sub_d - med) < 0.5
            xs = (xx - cx) / fx * sub_d
            ys = (yy - cy) / fy * sub_d
            pts_o = np.stack([xs[good], ys[good], sub_d[good]], axis=1)
            obb = pc.obb_from_points(
                self._t(pts_o), torch.ones(len(pts_o), dtype=torch.bool,
                                           device=self.device))
            if bool(obb.valid):
                self.obbs[int(bid)] = pc.OBB(
                    *(f.cpu().numpy() for f in obb[:3]), True)

    def global_cloud(self, max_points: int = 200_000):
        """The voxel-merged global map: (points [P, 3], intensity [P])."""
        if not self.clouds:
            return np.zeros((0, 3), np.float32), np.zeros(0, np.float32)
        pts = np.concatenate(self.clouds)
        inten = np.concatenate(self.intens)
        if len(pts) == 0:
            return pts, inten
        out_p, out_i, ok = pc.voxel_downsample(
            self._t(pts), self._t(inten),
            torch.ones(len(pts), dtype=torch.bool, device=self.device),
            self.cfg.pointcloud.voxel_resolution,
            max_out=min(max_points, len(pts)))
        okn = ok.cpu().numpy()
        return out_p.cpu().numpy()[okn], out_i.cpu().numpy()[okn]

    def save_ply(self, path: str) -> int:
        pts, inten = self.global_cloud()
        pc.save_ply(path, pts, inten)
        return len(pts)

    def save_pcd(self, path: str) -> int:
        """PCL-compatible export (the reference's SavePCD)."""
        pts, inten = self.global_cloud()
        pc.save_pcd(path, pts, inten)
        return len(pts)
