"""Dense point clouds and oriented bounding boxes.

Port of ``slam_dynamic_tpu/ops/pointcloud.py``: the dense half
(``backproject_dense`` :22, ``voxel_downsample`` :48, ``save_ply`` :149,
``save_pcd`` :176), the reference's PointCloudMapping::generatePointCloud
(strided backprojection without dynamic pixels and out-of-range depths,
the pose transform, a voxel-grid downsample) and its PCD export; and the
OBB half (``OBB`` :71, ``eigh3x3`` :78, ``obb_from_points`` :132), the
PCL MomentOfInertiaEstimation OBB of the dynamic objects: a PCA of the
masked points by a closed-form symmetric 3x3 eigendecomposition (Cardano
eigenvalues, cross-product eigenvectors), all elementwise arithmetic.
``obb_from_points`` takes a batch of masks over one cloud, the shape the
dynamic step needs (one OBB per box). An empty mask gives NaN centre and
axes as in the reference; callers gate on ``valid`` or the box depth.

The voxel hash is the JAX package's int32 hash, whose products wrap:
it is computed in int64 and its low 32 bits kept as a signed int32 (the
low bits of a product depend only on the operands' low bits), so no
signed overflow is relied on. One point per voxel is kept, the first
after a stable sort of the keys, as ``jnp.argsort`` does.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


_NO_KEY = 2 ** 31 - 1


def backproject_dense(cam, gray, depth_map, R_cw, t_cw, dyn_mask,
                      stride: int = 3, min_depth: float = 0.01,
                      max_depth: float = 5.0):
    """The world-frame cloud of one RGB-D keyframe: gray and depth_map
    [H, W], dyn_mask [H, W] bool (True = dynamic, left out). Returns
    (points [M, 3], intensity [M], valid [M]), M = (H // stride) *
    (W // stride)."""
    h, w = depth_map.shape
    dev = depth_map.device
    ys = torch.arange(0, h - (h % stride), stride, device=dev)
    xs = torch.arange(0, w - (w % stride), stride, device=dev)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    d = depth_map[yy, xx]
    ok = (d > min_depth) & (d < max_depth) & ~dyn_mask[yy, xx]
    x = (xx.to(torch.float32) - cam.cx) / cam.fx * d
    y = (yy.to(torch.float32) - cam.cy) / cam.fy * d
    xc = torch.stack([x, y, d], dim=-1).reshape(-1, 3)
    # world: x_w = R^T (x_c - t)
    xw = (xc - t_cw[None, :]) @ R_cw
    return xw, gray[yy, xx].reshape(-1), ok.reshape(-1)


def voxel_hash(points, resolution: float):
    """The JAX package's int32 voxel hash of points [N, 3]."""
    v = torch.floor(points / resolution).to(torch.int32).to(torch.int64)
    key = (v[:, 0] * 73856093) ^ (v[:, 1] * 19349663) ^ (v[:, 2] * 83492791)
    return (((key + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)


def voxel_downsample(points, intensity, valid, resolution: float,
                     max_out: int = 65536):
    """One point per occupied voxel (the first in key order), fixed output
    shape: (points [max_out, 3], intensity [max_out], valid [max_out]).
    Hash collisions merge voxels, as in the JAX package."""
    N = points.shape[0]
    key = voxel_hash(points, resolution)
    key = torch.where(key == _NO_KEY, 0, key)
    key = torch.where(valid, key, _NO_KEY)
    ks, order = torch.sort(key, stable=True)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=key.device),
                       ks[1:] != ks[:-1]]) & (ks < _NO_KEY)
    idx = torch.nonzero(first).flatten()[:max_out]
    idx = torch.cat([idx, idx.new_full((max_out - idx.shape[0],), N)])
    src = order[idx.clamp(0, N - 1)]
    return points[src], intensity[src], idx < N


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_ply(path: str, points, intensity=None, valid=None):
    """An ASCII PLY cloud, gray-coloured by intensity when given (the
    format of the JAX package's ``save_ply``, byte for byte)."""
    pts = _host(points)
    inten = _host(intensity) if intensity is not None else None
    if valid is not None:
        v = _host(valid)
        pts = pts[v]
        inten = inten[v] if inten is not None else None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if inten is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i, p in enumerate(pts):
            if inten is not None:
                g = int(np.clip(inten[i], 0, 255))
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {g} {g} {g}\n")
            else:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def save_pcd(path: str, points, intensity=None, valid=None):
    """ASCII PCD, the format of the reference's pcl::io::savePCDFile
    (intensity is not written, as in the JAX package)."""
    pts = _host(points)
    if valid is not None:
        pts = pts[_host(valid)]
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\n")
        f.write("VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                "COUNT 1 1 1\n")
        f.write(f"WIDTH {len(pts)}\nHEIGHT 1\n")
        f.write("VIEWPOINT 0 0 0 1 0 0 0\n")
        f.write(f"POINTS {len(pts)}\nDATA ascii\n")
        for p in pts:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


class OBB(NamedTuple):
    center: torch.Tensor     # [..., 3]
    axes: torch.Tensor       # [..., 3, 3] rows = principal directions
    extents: torch.Tensor    # [..., 3] half-lengths
    valid: torch.Tensor      # [...] bool


def _det3(M):
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def _unit(v):
    return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True),
                                      min=1e-30))


def eigh3x3(A):
    """Symmetric A [..., 3, 3] -> (evals [..., 3] ascending, evecs
    [..., 3, 3] as columns), like ``torch.linalg.eigh``."""
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    Aq = A - q[..., None, None] * eye
    p = torch.sqrt(torch.clamp((Aq * Aq).sum((-2, -1)) / 6.0, min=1e-30))
    r = torch.clamp(_det3(Aq / p[..., None, None]) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    evals = torch.stack([e_lo, e_mid, e_hi], dim=-1)

    def eigvec(lam):
        # null vector of (A - lam I): the largest cross product of two
        # rows; a coordinate axis where all vanish (repeated eigenvalue)
        M = A - lam[..., None, None] * eye
        cs = torch.stack([torch.linalg.cross(M[..., 0, :], M[..., 1, :]),
                          torch.linalg.cross(M[..., 0, :], M[..., 2, :]),
                          torch.linalg.cross(M[..., 1, :], M[..., 2, :])],
                         dim=-2)
        best = torch.argmax((cs * cs).sum(-1), dim=-1)
        v = torch.gather(cs, -2, best[..., None, None].expand(
            best.shape + (1, 3)))[..., 0, :]
        ok = (v * v).sum(-1, keepdim=True) > 1e-20
        v = torch.where(ok, v, eye[0])
        return _unit(v)

    v_lo = eigvec(e_lo)
    v_hi = eigvec(e_hi)
    # the middle vector from orthogonality: a right-handed orthonormal
    # basis even near degeneracy
    v_mid = _unit(torch.linalg.cross(v_hi, v_lo))
    v_lo = torch.linalg.cross(v_mid, v_hi)
    return evals, torch.stack([v_lo, v_mid, v_hi], dim=-1)


def obb_from_points(points, mask) -> OBB:
    """OBB by PCA of ``points`` [N, 3] under each mask [..., N] (PCL
    MomentOfInertiaEstimation::getOBB); one box per mask."""
    m = mask.to(points.dtype)[..., None]                  # [..., N, 1]
    wsum = torch.clamp(mask.sum(-1), min=1).to(points.dtype)
    mu = (points * m).sum(-2) / wsum[..., None]            # [..., 3]
    c = (points - mu[..., None, :]) * m                    # [..., N, 3]
    cov = c.transpose(-1, -2) @ c / wsum[..., None, None]
    _, evecs = eigh3x3(cov)
    axes = evecs.transpose(-1, -2).flip(-2)    # rows, major axis first
    proj = c @ axes.transpose(-1, -2)                      # [..., N, 3]
    inf = torch.full_like(proj, math.inf)
    lo = torch.where(mask[..., None], proj, inf).amin(-2)
    hi = torch.where(mask[..., None], proj, -inf).amax(-2)
    center = mu + (axes.transpose(-1, -2) @ ((lo + hi) * 0.5)[..., None]
                   )[..., 0]
    return OBB(center, axes, (hi - lo) * 0.5, mask.sum(-1) >= 10)
