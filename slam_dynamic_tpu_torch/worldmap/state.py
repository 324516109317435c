"""The global map as a fixed-capacity struct of tensors.

Port of ``slam_dynamic_tpu/worldmap/state.py`` (``MapState`` :27,
``empty_map`` :72, ``update_covisibility`` :130, ``next_kf_slot`` :152,
``insert_keyframe`` :168, ``add_landmarks`` :214, ``add_loop_edge`` :113,
``covisible_keyframes`` :262). Keyframes and landmarks
live in padded tensors with validity masks, at the capacities of
``config.CapacityConfig``. Every function returns a new ``MapState`` and
leaves its input untouched (the mapping stage selects between the entry
map and the result), and none of them waits for the device.

Index conventions: keyframe k in [0, K), landmark l in [0, L), keypoint
slot n in [0, N); ``kf_obs_lm[k, n]`` is the landmark observed by keypoint
n of keyframe k, or -1. Descriptors are int32 bit views of uint32 lanes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..config import CapacityConfig
from ..utils.scatter import count_at, mark


class MapState(NamedTuple):
    # --- keyframes ---
    kf_R: torch.Tensor          # [K, 3, 3] world->camera
    kf_t: torch.Tensor          # [K, 3]
    kf_valid: torch.Tensor      # [K] bool
    kf_frame_id: torch.Tensor   # [K] int32
    kf_timestamp: torch.Tensor  # [K] float32
    kf_kp_xy: torch.Tensor      # [K, N, 2] float32 undistorted pixels
    kf_kp_level: torch.Tensor   # [K, N] int32
    kf_kp_angle: torch.Tensor   # [K, N] float32
    kf_kp_desc: torch.Tensor    # [K, N, 8] int32
    kf_kp_valid: torch.Tensor   # [K, N] bool
    kf_kp_ur: torch.Tensor      # [K, N] float32 (-1 if none)
    kf_kp_depth: torch.Tensor   # [K, N] float32 (-1 if none)
    kf_obs_lm: torch.Tensor     # [K, N] int32 (-1 = no landmark)
    covis: torch.Tensor         # [K, K] int32 shared-landmark counts
    # --- landmarks ---
    lm_pos: torch.Tensor        # [L, 3]
    lm_valid: torch.Tensor      # [L] bool
    lm_desc: torch.Tensor       # [L, 8] int32
    lm_normal: torch.Tensor     # [L, 3] mean viewing direction
    lm_dist_min: torch.Tensor   # [L]
    lm_dist_max: torch.Tensor   # [L]
    lm_visible: torch.Tensor    # [L] int32
    lm_found: torch.Tensor      # [L] int32
    lm_first_kf: torch.Tensor   # [L] int32
    lm_n_obs: torch.Tensor      # [L] int32
    # --- persistent loop edges (loop closing keeps every verified S_ji so
    # later essential-graph runs keep past constraints) ---
    loop_i: torch.Tensor        # [E] int32
    loop_j: torch.Tensor        # [E] int32
    loop_s: torch.Tensor        # [E] float32
    loop_R: torch.Tensor        # [E, 3, 3]
    loop_t: torch.Tensor        # [E, 3]
    loop_valid: torch.Tensor    # [E] bool
    # --- allocation cursors (0-d int32 tensors) ---
    n_kf: torch.Tensor
    n_lm: torch.Tensor
    n_loop: torch.Tensor


def empty_map(cap: CapacityConfig, device=None) -> MapState:
    device = resolve_device(device)
    K, N, L = cap.max_keyframes, cap.max_keypoints, cap.max_landmarks
    E = cap.max_loop_edges
    f32, i32 = torch.float32, torch.int32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    eye = torch.eye(3, dtype=f32, device=device)
    return MapState(
        kf_R=eye.repeat(K, 1, 1), kf_t=full((K, 3), 0.0, f32),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), -1, i32), kf_timestamp=full((K,), 0.0, f32),
        kf_kp_xy=full((K, N, 2), 0.0, f32),
        kf_kp_level=full((K, N), 0, i32), kf_kp_angle=full((K, N), 0.0, f32),
        kf_kp_desc=full((K, N, 8), 0, i32),
        kf_kp_valid=full((K, N), False, torch.bool),
        kf_kp_ur=full((K, N), -1.0, f32), kf_kp_depth=full((K, N), -1.0, f32),
        kf_obs_lm=full((K, N), -1, i32), covis=full((K, K), 0, i32),
        lm_pos=full((L, 3), 0.0, f32), lm_valid=full((L,), False, torch.bool),
        lm_desc=full((L, 8), 0, i32), lm_normal=full((L, 3), 0.0, f32),
        lm_dist_min=full((L,), 0.0, f32), lm_dist_max=full((L,), 0.0, f32),
        lm_visible=full((L,), 1, i32), lm_found=full((L,), 1, i32),
        lm_first_kf=full((L,), -1, i32), lm_n_obs=full((L,), 0, i32),
        loop_i=full((E,), -1, i32), loop_j=full((E,), -1, i32),
        loop_s=full((E,), 1.0, f32), loop_R=eye.repeat(E, 1, 1),
        loop_t=full((E, 3), 0.0, f32),
        loop_valid=full((E,), False, torch.bool),
        n_kf=full((), 0, i32), n_lm=full((), 0, i32), n_loop=full((), 0, i32))


def set_row(arr: torch.Tensor, k: torch.Tensor, val, ok=None):
    """Copy of ``arr`` with row k replaced by ``val`` (when ``ok``)."""
    k1 = k.reshape(1).long()
    if isinstance(val, torch.Tensor):
        new = val.to(arr.dtype).expand(arr.shape[1:])
    else:       # a Python scalar: filled on the device, no host copy
        new = torch.full(arr.shape[1:], val, dtype=arr.dtype,
                         device=arr.device)
    if ok is not None:
        new = torch.where(ok, new, arr[k1[0]])
    return arr.index_copy(0, k1, new[None])


def lm_membership(obs_row: torch.Tensor, L: int) -> torch.Tensor:
    """[L + 1] bool: landmarks in ``obs_row`` (entry L, the -1 sink, off)."""
    in_k = mark(L + 1, torch.where(obs_row >= 0, obs_row, L))
    in_k[L] = False
    return in_k


def update_covisibility(m: MapState, k: torch.Tensor) -> MapState:
    """Recompute covisibility row/col of keyframe k (KeyFrame::
    UpdateConnections): landmarks shared between k and every other KF."""
    L = m.lm_pos.shape[0]
    in_k = lm_membership(m.kf_obs_lm[k], L)
    obs = torch.where(m.kf_obs_lm >= 0, m.kf_obs_lm, L).long()
    shared = in_k[obs].sum(1).to(torch.int32) * m.kf_valid
    shared = set_row(shared, k, 0)
    k1 = k.reshape(1).long()
    covis = m.covis.index_copy(0, k1, shared[None])
    covis = covis.index_copy(1, k1, shared[:, None])
    return m._replace(covis=covis)


def next_kf_slot(m: MapState):
    """(slot, ok) the next insert_keyframe uses: the append cursor while
    free slots remain, else the first culled slot; ok=False only when full
    with nothing culled."""
    k = m.n_kf
    K = m.kf_valid.shape[0]
    ar = torch.arange(K, device=k.device)
    free_ok = k < K
    culled = ~m.kf_valid & (ar < k)
    slot = torch.where(free_ok, torch.clamp(k, max=K - 1),
                       torch.argmax(culled.to(torch.int32)).to(torch.int32))
    return slot.to(torch.int32), free_ok | culled.any()


def insert_keyframe(m: MapState, R, t, frame_id, timestamp, kp_xy, kp_level,
                    kp_angle, kp_desc, kp_valid, kp_ur, kp_depth,
                    obs_lm) -> MapState:
    """Write a keyframe snapshot at next_kf_slot (a no-op when full with
    nothing culled) and bump n_obs of the landmarks it observes."""
    k = m.n_kf
    K = m.kf_valid.shape[0]
    kk, ok = next_kf_slot(m)
    m = m._replace(
        kf_R=set_row(m.kf_R, kk, R, ok), kf_t=set_row(m.kf_t, kk, t, ok),
        kf_valid=set_row(m.kf_valid, kk, True, ok),
        kf_frame_id=set_row(m.kf_frame_id, kk, frame_id, ok),
        kf_timestamp=set_row(m.kf_timestamp, kk, timestamp, ok),
        kf_kp_xy=set_row(m.kf_kp_xy, kk, kp_xy, ok),
        kf_kp_level=set_row(m.kf_kp_level, kk, kp_level, ok),
        kf_kp_angle=set_row(m.kf_kp_angle, kk, kp_angle, ok),
        kf_kp_desc=set_row(m.kf_kp_desc, kk, kp_desc, ok),
        kf_kp_valid=set_row(m.kf_kp_valid, kk, kp_valid, ok),
        kf_kp_ur=set_row(m.kf_kp_ur, kk, kp_ur, ok),
        kf_kp_depth=set_row(m.kf_kp_depth, kk, kp_depth, ok),
        kf_obs_lm=set_row(m.kf_obs_lm, kk, obs_lm, ok),
        n_kf=torch.where(ok & (k < K), k + 1, k).to(torch.int32),
    )
    m = update_covisibility(m, kk)
    # a recycled slot invalidates loop edges that named its old tenant
    reused = ok & (k >= K)
    stale = reused & ((m.loop_i == kk) | (m.loop_j == kk))
    m = m._replace(loop_valid=m.loop_valid & ~stale)
    L = m.lm_pos.shape[0]
    obs = torch.where((obs_lm >= 0) & kp_valid, obs_lm, L)
    n_obs = count_at(L + 1, obs)[:L]
    return m._replace(lm_n_obs=m.lm_n_obs + torch.where(ok, n_obs, 0))


def add_landmarks(m: MapState, pos, desc, normal, dist_min, dist_max,
                  src_kf, src_slot, want) -> MapState:
    """Allocate the wanted candidates at the landmark tail (packed to the
    front, written at n_lm + offset) and bind them to their keyframe
    keypoint slots."""
    L = m.lm_pos.shape[0]
    order = torch.argsort((~want).to(torch.int32), stable=True)
    wanto = want[order]
    offs = torch.cumsum(wanto.to(torch.int32), 0) - 1
    dst = torch.where(wanto & (m.n_lm + offs < L), m.n_lm + offs, L).long()

    def put(arr, vals, fill):
        ext = torch.cat([arr, torch.full((1,) + tuple(arr.shape[1:]), fill,
                                         dtype=arr.dtype, device=arr.device)])
        shape = (dst.shape[0],) + tuple(arr.shape[1:])
        ext[dst] = (vals.to(arr.dtype).expand(shape)
                    if isinstance(vals, torch.Tensor) else
                    torch.full(shape, vals, dtype=arr.dtype,
                               device=arr.device))
        return ext[:L]

    kfo, sloto = src_kf[order], src_slot[order]
    created = (dst < L).sum().to(torch.int32)
    valid_write = dst < L
    kfw = torch.where(valid_write, kfo, m.kf_valid.shape[0] - 1).long()
    obs = m.kf_obs_lm.clone()
    obs[kfw, sloto.long()] = torch.where(
        valid_write, dst.to(torch.int32), m.kf_obs_lm[kfw, sloto.long()])
    return m._replace(
        lm_pos=put(m.lm_pos, pos[order], 0.0),
        lm_desc=put(m.lm_desc, desc[order], 0),
        lm_normal=put(m.lm_normal, normal[order], 0.0),
        lm_dist_min=put(m.lm_dist_min, dist_min[order], 0.0),
        lm_dist_max=put(m.lm_dist_max, dist_max[order], 0.0),
        lm_valid=put(m.lm_valid, True, False),
        lm_first_kf=put(m.lm_first_kf, kfo, -1),
        lm_n_obs=put(m.lm_n_obs, 1, 0),
        lm_visible=put(m.lm_visible, 1, 1),
        lm_found=put(m.lm_found, 1, 1),
        kf_obs_lm=obs,
        n_lm=(m.n_lm + created).to(torch.int32))


def add_loop_edge(m: MapState, i: int, j: int, s, R, t) -> MapState:
    """Record a verified loop constraint S_ji (host-side: loops are rare;
    reads the edge cursor back). A full edge table is left unchanged."""
    E = m.loop_valid.shape[0]
    e = int(m.n_loop)
    if e >= E:
        return m
    dev = m.loop_R.device

    def put(arr, val):
        out = arr.clone()
        out[e] = torch.as_tensor(val, dtype=arr.dtype, device=dev)
        return out

    return m._replace(
        loop_i=put(m.loop_i, i), loop_j=put(m.loop_j, j),
        loop_s=put(m.loop_s, float(s)), loop_R=put(m.loop_R, R),
        loop_t=put(m.loop_t, t), loop_valid=put(m.loop_valid, True),
        n_loop=torch.full((), e + 1, dtype=torch.int32, device=dev))


def covisible_keyframes(m: MapState, k, n_best: int, min_weight: int = 15):
    """(ids, weights, strong) of keyframe k's n_best most covisible
    keyframes (KeyFrame::GetBestCovisibilityKeyFrames); ties keep the lower
    slot, as ``jax.lax.top_k``."""
    w = m.covis[k] * m.kf_valid
    vals, idx = torch.sort(w, descending=True, stable=True)
    vals, idx = vals[:n_best], idx[:n_best]
    return idx, vals, vals >= min_weight
