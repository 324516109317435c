"""Keyframe insertion with depth-based landmark creation.

Port of ``slam_dynamic_tpu/worldmap/keyframe_ops.py`` (``make_keyframe``
:23, ``bind_observations`` :65, ``refresh_landmark_descriptors`` :78):
keypoints with depth that are not yet bound spawn landmarks (closest
first, at least ``min_create``, all closer than the depth threshold), with
MapPoint-style normal and scale-invariance range.
"""
from __future__ import annotations

import torch

from ..frontend.frame import FrameData
from ..ops.hamming import hamming_pairs
from ..utils.camera import Intrinsics, backproject
from ..utils.scatter import count_at
from .state import MapState, add_landmarks, insert_keyframe, next_kf_slot


def make_keyframe(m: MapState, cam: Intrinsics, fd: FrameData, R, t,
                  frame_id, timestamp, obs_lm, depth_th, scale_factor,
                  min_create: int = 100, n_levels: int = 8):
    """Insert a keyframe and create landmarks for unbound keypoints with
    depth. Returns (map, slot); slot = -1 when full with nothing culled
    (then nothing changes)."""
    k, slot_ok = next_kf_slot(m)
    kp_ok = fd.valid & fd.static_mask
    m = insert_keyframe(m, R, t, frame_id, timestamp, fd.xy, fd.level,
                        fd.angle, fd.desc, kp_ok, fd.ur, fd.depth,
                        torch.where(kp_ok, obs_lm, -1))
    cand = kp_ok & (fd.depth > 0) & (obs_lm < 0)
    key = torch.where(cand, fd.depth, torch.inf)
    order = torch.argsort(key, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    want = cand & ((fd.depth < depth_th) | (rank < min_create))

    xc = backproject(cam, fd.xy, fd.depth)
    xw = (xc - t[None, :]) @ R                   # R^T (xc - t), row-wise
    Ow = -(t @ R)
    po = xw - Ow
    dist = torch.linalg.norm(po, dim=-1)
    normal = po / torch.clamp(dist, min=1e-9)[:, None]
    dmax = dist * scale_factor ** fd.level.to(torch.float32)
    dmin = dmax / (scale_factor ** (n_levels - 1))
    slots = torch.arange(fd.xy.shape[0], dtype=torch.int32,
                         device=fd.xy.device)
    m = add_landmarks(m, xw, fd.desc, normal, dmin, dmax,
                      torch.full_like(slots, 0) + k, slots, want & slot_ok)
    return m, torch.where(slot_ok, k, -1)


def bind_observations(m: MapState, kf_idx, slot_obs_lm) -> MapState:
    """Overwrite one keyframe's kf_obs_lm row and recompute n_obs."""
    obs = m.kf_obs_lm.index_copy(0, kf_idx.reshape(1).long(),
                                 slot_obs_lm[None])
    L = m.lm_pos.shape[0]
    flat = torch.where((obs >= 0) & m.kf_kp_valid, obs, L)
    return m._replace(kf_obs_lm=obs, lm_n_obs=count_at(L + 1, flat)[:L])


def nanmedian_last(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` along the last dim: the mean of the two middle
    values of the non-NaN entries (NaN when there are none)."""
    n = (~torch.isnan(x)).sum(-1)
    s = torch.sort(torch.where(torch.isnan(x), torch.inf, x), dim=-1)[0]
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    a = torch.gather(s, -1, lo[..., None])[..., 0]
    b = torch.gather(s, -1, hi[..., None])[..., 0]
    return torch.where(n > 0, (a + b) / 2, torch.nan)


def refresh_landmark_descriptors(m: MapState) -> MapState:
    """MapPoint::ComputeDistinctiveDescriptors: each landmark takes the
    observation descriptor with the least median Hamming distance to its
    other observations. Up to 8 observing keyframes per landmark, hashed
    into slots by keyframe index (collisions: the last write wins, as in
    the reference's scatter)."""
    K, N = m.kf_obs_lm.shape
    L = m.lm_pos.shape[0]
    MAX_OBS = 8
    dev = m.lm_pos.device
    lm = torch.where((m.kf_obs_lm >= 0) & m.kf_kp_valid
                     & m.kf_valid[:, None], m.kf_obs_lm, L).long()
    flat_lm = lm.reshape(-1)
    flat_slot = (torch.arange(K, device=dev) % MAX_OBS)[:, None].expand(
        K, N).reshape(-1)
    key = flat_lm * MAX_OBS + flat_slot
    pos = torch.arange(key.shape[0], device=dev)
    last = torch.full(((L + 1) * MAX_OBS,), -1, dtype=torch.long,
                      device=dev).scatter_reduce(0, key, pos, "amax")
    have = (last >= 0).reshape(L + 1, MAX_OBS)[:L]
    flat_desc = m.kf_kp_desc.reshape(-1, 8)
    slot = torch.where(have[..., None],
                       flat_desc[last.clamp(min=0)].reshape(L + 1, MAX_OBS,
                                                            8)[:L], 0)
    d = hamming_pairs(slot[:, :, None, :], slot[:, None, :, :])
    pair_ok = have[:, :, None] & have[:, None, :]
    df = torch.where(pair_ok, d.to(torch.float32), torch.nan)
    med = nanmedian_last(df)
    med = torch.where(have & ~torch.isnan(med), med, torch.inf)
    bestj = torch.argmin(med, dim=1)
    best_desc = slot[torch.arange(L, device=dev), bestj]
    any_obs = have.any(dim=1)
    return m._replace(lm_desc=torch.where((m.lm_valid & any_obs)[:, None],
                                          best_desc, m.lm_desc))
