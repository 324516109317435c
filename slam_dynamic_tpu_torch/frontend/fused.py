"""The fused tracking step: one call, one packed readback.

Port of ``slam_dynamic_tpu/frontend/fused.py:54-279``
(``build_frame_data``, ``_predict_inside``, ``_mm_track``,
``_track_stages``, ``fused_track_step``), of temporal chunking
(``fused_track_chunk`` :328 and ``fused_track_chunk_dyn`` :483 through
``_chunk_body`` :400), of lane batching (``fused_track_step_batch`` :287
and ``fused_track_chunk_batch`` :372, ``torch.func.vmap`` where JAX has
``jax.vmap``) and of the dynamic-scene step
(``fused_track_step_dyn`` :536), and of the step on a frame built on the
host (``fused_track_prebuilt`` :518: after a relocalization and on the
``mask=`` path). Per frame:

  extract -> undistort -> depth (RGB-D: the depth map; stereo: a second
  extraction and the row-band matcher; mono: none) -> box quarantine ->
  [dynamic
  scenes: H/F box classification against the reference frame, feature
  reinstatement] -> track against the last frame's landmarks (motion
  model; the narrow pass and the 2x wide fallback both run, the result
  is picked by mask) -> local-map selection -> track against the local
  map -> landmark stat bumps -> keyframe-decision counts [-> per-box 3D
  state]

and everything the host state machine needs comes back as ONE [28]-float
packet (``fused.py:45-51``): 0 n_mm, 1 n_map, 2 close_bound,
3 close_unbound, 4:13 R, 13:16 t, 16:25 reference-KF R, 25:28 its t; a
dynamic step appends the B box verdicts and the [B, 16] per-box 3D state
(28 + 17 B floats). No step in between waits for the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..config import ORBConfig
from ..ops.gated_match import accept_match, gated_match
from ..optim.pose_opt import optimize_pose
from ..utils.camera import Intrinsics, project, undistort_points
from ..worldmap.state import MapState
from . import tracking_ops as tops
from .dynamics_ops import (box_3d_state, classify_boxes,
                           reinstate_features)
from .extractor import extract
from .frame import (FrameData, inside_boxes, keypoint_depth,
                    pad_frame_data, strided_keypoint_depth)


class FusedOut(NamedTuple):
    fd: FrameData
    obs_lm: torch.Tensor      # [N] global landmark ids (-1)
    R: torch.Tensor
    t: torch.Tensor
    lm_visible: torch.Tensor  # updated map counters
    lm_found: torch.Tensor
    packed: torch.Tensor      # [28] float32 host packet (see module doc)


def stereo_residuals(sensor: str) -> bool:
    """Whether a sensor's frames are tracked and mapped with (u, v,
    u_right) residuals: the depth sensors; mono uses (u, v)."""
    return sensor in ("stereo", "rgbd")


def build_frame_data(cam: Intrinsics, image, aux, boxes, box_active,
                     orb_cfg: ORBConfig, scale_factor, sensor: str = "rgbd",
                     n_slots: int = 0, depth_scale=None,
                     depth_stride: int = 1) -> FrameData:
    """Device-side frame construction for every sensor. ``aux`` is the
    depth map (``rgbd``), the right image (``stereo``, its own extraction
    and the row-band matcher) or unused (``mono``: no depth). ``image``
    and ``aux`` arrive in camera-native dtypes (uint8 gray, uint16 depth)
    and are cast here, on the device; ``depth_scale`` converts raw depth
    units to metres. With ``depth_stride`` > 1 the depth map holds every
    ``depth_stride``-th pixel of the image and is sampled at the
    keypoint's low-resolution pixel. ``u_right`` is in full-resolution
    pixels. Keypoints inside an active box [B, 4] are quarantined
    (``static_mask``)."""
    image = image.to(torch.float32)
    kp = extract(image, orb_cfg)
    xy = undistort_points(cam, kp.xy)
    scale = scale_factor ** kp.level.to(torch.float32)
    right = depth_map = None
    if sensor == "stereo":
        right = aux.to(torch.float32)
    elif sensor == "rgbd":
        depth_map = aux.to(torch.float32)
        if depth_scale is not None:
            depth_map = depth_map * depth_scale
    if depth_map is not None and depth_stride > 1:
        ur, depth = strided_keypoint_depth(cam, depth_map, kp, depth_stride)
    else:
        ur, depth = keypoint_depth(cam, image, kp, scale, orb_cfg,
                                   scale_factor, right, depth_map)
    inside = (inside_boxes(xy, boxes) & box_active[:, None]).any(0)
    fd = FrameData(xy=xy, xy_raw=kp.xy, level=kp.level, angle=kp.angle,
                   response=kp.response, desc=kp.desc, valid=kp.valid,
                   ur=ur, depth=depth, static_mask=kp.valid & ~inside,
                   scale=scale)
    return pad_frame_data(fd, n_slots) if n_slots else fd


def _predict_inside(R_last, t_last, R_prev2, t_prev2, has_vel):
    """Constant-velocity prediction on the device: velocity = T_last o
    T_prev2^-1, pred = velocity o T_last; has_vel is 0. or 1."""
    Rv = R_last @ R_prev2.T
    tv = t_last - Rv @ t_prev2
    R_pred = has_vel * (Rv @ R_last) + (1.0 - has_vel) * R_last
    t_pred = has_vel * (Rv @ t_last + tv) + (1.0 - has_vel) * t_last
    return R_pred, t_pred


def _mm_track(cam, R_pred, t_pred, R_last, t_last, lm_pos, lm_desc,
              lm_dmax, lm_mask, fd, mm_radius, scale_factor, min_inliers,
              stereo, n_levels):
    """Motion-model stage: a narrow pass at the predicted pose and a wide
    (2x radius) pass at the last pose, both through kernel K1 with the
    octave gates; the wide result is taken when the narrow one has fewer
    than ``min_inliers`` inliers. Light LM schedule (2 x 6)."""
    kp_ok = fd.valid & fd.static_mask
    inv_s2 = 1.0 / (fd.scale ** 2)

    def match_and_opt(Rp, tp, radius_mult):
        xc = lm_pos @ Rp.T + tp
        uv = project(cam, xc)
        vis = (xc[:, 2] > 0.1) & lm_mask
        Ow = -Rp.T @ tp
        dist_w = torch.sqrt(((lm_pos - Ow) ** 2).sum(-1) + 1e-12)
        lvl = torch.ceil(torch.log(torch.clamp(lm_dmax, min=1e-6)
                                   / torch.clamp(dist_w, min=1e-6))
                         / torch.log(scale_factor)).to(torch.int32)
        lvl = lvl.clamp(0, n_levels - 1)
        radius = mm_radius * radius_mult * \
            scale_factor ** lvl.to(torch.float32)
        kp_lm, best, second = gated_match(
            fd.desc, fd.xy, fd.level, kp_ok, lm_desc, uv.contiguous(),
            radius, lvl, vis)
        ok = accept_match(best, second, 100, 0.9)
        kp_lm = kp_lm.long()
        xw = lm_pos[kp_lm.clamp(0, lm_pos.shape[0] - 1)]
        if stereo:
            obs = torch.cat([fd.xy, fd.ur[:, None]], dim=-1)
            res = optimize_pose(cam, Rp, tp, xw, obs, inv_s2, ok,
                                stereo=True,
                                ur_weight=(fd.ur > 0).to(torch.float32),
                                rounds=2, iters=6)
        else:
            res = optimize_pose(cam, Rp, tp, xw, fd.xy, inv_s2, ok,
                                stereo=False, rounds=2, iters=6)
        inlier = res.inliers & ok
        return (res.R, res.t, inlier.sum().to(torch.int32),
                torch.where(inlier, kp_lm, -1))

    R1, t1, n1, kp1 = match_and_opt(R_pred, t_pred, 1.0)
    R2, t2, n2, kp2 = match_and_opt(R_last, t_last, 2.0)
    wide = n1 < min_inliers
    return (torch.where(wide, R2, R1), torch.where(wide, t2, t1),
            torch.where(wide, n2, n1), torch.where(wide, kp2, kp1))


def _track_stages(m: MapState, cam, bounds, fd: FrameData, last_obs_lm,
                  R_pred, t_pred, R_last, t_last, ref_kf, mm_radius,
                  local_radius, depth_th, scale_factor, min_inliers_track,
                  stereo, max_kf, max_lm, n_levels) -> FusedOut:
    N = fd.xy.shape[0]
    L = m.lm_pos.shape[0]
    with record_function("mm_track"):
        idc = torch.where(last_obs_lm >= 0, last_obs_lm, 0).clamp(
            0, L - 1).long()
        ok_lm = (last_obs_lm >= 0) & m.lm_valid[idc]
        R1, t1, n_mm, kp_lm1 = _mm_track(
            cam, R_pred, t_pred, R_last, t_last, m.lm_pos[idc],
            m.lm_desc[idc], m.lm_dist_max[idc], ok_lm, fd, mm_radius,
            scale_factor, min_inliers_track, stereo, n_levels)
        kp_lm_global = torch.where(kp_lm1 >= 0,
                                   last_obs_lm[kp_lm1.clamp(0, N - 1)], -1)
    with record_function("local_map"):
        local = tops.select_local_map(m.kf_obs_lm, m.kf_valid, kp_lm_global,
                                      L, max_kf=max_kf, max_lm=max_lm)
        idl = torch.where(local.lm_mask, local.lm_ids, 0).clamp(0, L - 1)
        okl = local.lm_mask & m.lm_valid[idl]
    with record_function("local_track"):
        out2 = tops.track_against_landmarks(
            cam, bounds, R1, t1, m.lm_pos[idl], m.lm_desc[idl],
            m.lm_normal[idl], m.lm_dist_min[idl], m.lm_dist_max[idl], okl,
            fd, local_radius, scale_factor, stereo=stereo,
            n_levels=n_levels, use_view_gate=True)
    obs_global = torch.where(
        out2.kp_lm >= 0,
        local.lm_ids[out2.kp_lm.clamp(0, local.lm_ids.shape[0] - 1)],
        -1).to(torch.int32)
    vis, fnd = tops.bump_landmark_stats(m.lm_visible, m.lm_found,
                                        local.lm_ids, local.lm_mask,
                                        out2.visible, out2.found)

    close = (fd.depth > 0) & (fd.depth < depth_th)
    close_bound = (close & (obs_global >= 0)).sum().to(torch.float32)
    close_unbound = (close & fd.static_mask & (obs_global < 0)).sum().to(
        torch.float32)
    rk = ref_kf.clamp(0, m.kf_R.shape[0] - 1)
    packed = torch.cat([
        torch.stack([n_mm.to(torch.float32),
                     out2.n_inliers.to(torch.float32),
                     close_bound, close_unbound]),
        out2.R.reshape(-1), out2.t, m.kf_R[rk].reshape(-1), m.kf_t[rk]])
    return FusedOut(fd, obs_global, out2.R, out2.t, vis, fnd, packed)


def fused_track_step(m: MapState, cam: Intrinsics, bounds, image, aux,
                     boxes, box_active, last_obs_lm, R_last, t_last,
                     R_prev2, t_prev2, has_vel, ref_kf, orb_cfg: ORBConfig,
                     mm_radius, local_radius, depth_th, scale_factor,
                     min_inliers_track, sensor: str = "rgbd",
                     max_kf: int = 16, max_lm: int = 4096,
                     n_levels: int = 8, n_slots: int = 0,
                     depth_scale=None, depth_stride: int = 1) -> FusedOut:
    """The whole per-frame step (``fused.py:255``): aux is the depth map
    (``rgbd``, every ``depth_stride``-th pixel), the right image
    (``stereo``) or unused (``mono``); R_prev2/t_prev2 is the pose two
    frames back and has_vel a 0/1 scalar; ref_kf's pose returns in the
    packet tail. Depth sensors track with stereo residuals (u, v,
    u_right)."""
    with record_function("frame_build"):
        fd = build_frame_data(cam, image, aux, boxes, box_active, orb_cfg,
                              scale_factor, sensor, n_slots=n_slots,
                              depth_scale=depth_scale,
                              depth_stride=depth_stride)
    R_pred, t_pred = _predict_inside(R_last, t_last, R_prev2, t_prev2,
                                     has_vel)
    return _track_stages(m, cam, bounds, fd, last_obs_lm, R_pred, t_pred,
                         R_last, t_last, ref_kf, mm_radius, local_radius,
                         depth_th, scale_factor, min_inliers_track,
                         stereo_residuals(sensor), max_kf, max_lm, n_levels)


def fused_track_prebuilt(m: MapState, cam: Intrinsics, bounds,
                         fd: FrameData, last_obs_lm, R_pred, t_pred, R_last,
                         t_last, ref_kf, mm_radius, local_radius, depth_th,
                         scale_factor, min_inliers_track,
                         sensor: str = "rgbd", max_kf: int = 16,
                         max_lm: int = 4096, n_levels: int = 8) -> FusedOut:
    """The tracking stages on a FrameData built on the host
    (``fused.py:518``), with the motion-model prediction given: K1 runs
    three times, as in the fused step."""
    return _track_stages(m, cam, bounds, fd, last_obs_lm, R_pred, t_pred,
                         R_last, t_last, ref_kf, mm_radius, local_radius,
                         depth_th, scale_factor, min_inliers_track,
                         stereo_residuals(sensor), max_kf, max_lm, n_levels)


def _pose_seed(seed, R_last, t_last):
    """Per-frame RANSAC seed derived on the device from the chained pose
    (``fused.py:573-575``): a fixed device base plus float-to-int32 casts
    of pose sums, so no per-frame seed is uploaded."""
    return (seed + (t_last.abs() * 8388608.0).sum().to(torch.int32)
            + (R_last.abs() * 65536.0).sum().to(torch.int32))


def _classify_and_reinstate(cam, fd, boxes, box_active, dyn, R_last,
                            t_last, classify: bool, extra_seed: int = 0):
    """The dynamic half of a frame: H/F classification of every active box
    against the reference frame (verdict 0 where it is skipped or no
    reference exists), then the keypoints of boxes that are or just became
    static, unless confirmed dynamic by the host, are reinstated.
    Returns (fd, verdict [B] int32)."""
    status = dyn["box_status"]
    if classify:
        with record_function("classify"):
            seed = _pose_seed(dyn["seed"], R_last, t_last) + extra_seed
            v = classify_boxes(cam, dyn["ref_fd"], fd, boxes, box_active,
                               n_hyp=dyn["n_hyp"], seed=seed)
            verdict = torch.where(dyn["have_ref"] > 0, v.verdict,
                                  torch.zeros_like(v.verdict))
    else:
        verdict = torch.zeros_like(status)
    static_now = box_active & (status != 2) & ((status == 1) | (verdict == 1))
    return reinstate_features(fd, boxes, static_now), verdict


def _dyn_packet(cam, out: "FusedOut", verdict, boxes, box_active):
    """Append the verdicts and the per-box 3D state to the packet."""
    with record_function("box3d"):
        b3d = box_3d_state(cam, out.fd, boxes, box_active)
    return out._replace(packed=torch.cat(
        [out.packed, verdict.to(torch.float32), b3d.reshape(-1)]))


def fused_track_step_dyn(m: MapState, cam: Intrinsics, bounds, image, aux,
                         boxes, box_active, box_status, ref_fd: FrameData,
                         have_ref, last_obs_lm, R_last, t_last, R_prev2,
                         t_prev2, has_vel, ref_kf, orb_cfg: ORBConfig,
                         mm_radius, local_radius, depth_th, scale_factor,
                         min_inliers_track, seed, sensor: str = "rgbd",
                         max_kf: int = 16, max_lm: int = 4096,
                         n_levels: int = 8, n_slots: int = 0,
                         n_hyp: int = 256, depth_scale=None,
                         classify: bool = True,
                         depth_stride: int = 1) -> FusedOut:
    """The dynamic-scene step (``fused.py:536``): frame build with the
    boxes quarantining unless the host found them static (status 1), H/F
    classification of every box against ``ref_fd`` (``classify=False``
    on the stride's skipped frames: verdicts 0, no RANSAC), reinstatement,
    tracking and the per-box 3D state, in one call; the packet is
    [28 + B + 16 B]. ``box_status`` [B] int32 is the host's belief and
    ``seed`` a fixed device int32 base."""
    with record_function("frame_build"):
        fd = build_frame_data(cam, image, aux, boxes,
                              box_active & (box_status != 1), orb_cfg,
                              scale_factor, sensor, n_slots=n_slots,
                              depth_scale=depth_scale,
                              depth_stride=depth_stride)
    dyn = dict(box_status=box_status, ref_fd=ref_fd, have_ref=have_ref,
               seed=seed, n_hyp=n_hyp)
    fd, verdict = _classify_and_reinstate(cam, fd, boxes, box_active, dyn,
                                          R_last, t_last, classify)
    R_pred, t_pred = _predict_inside(R_last, t_last, R_prev2, t_prev2,
                                     has_vel)
    out = _track_stages(m, cam, bounds, fd, last_obs_lm, R_pred, t_pred,
                        R_last, t_last, ref_kf, mm_radius, local_radius,
                        depth_th, scale_factor, min_inliers_track,
                        stereo_residuals(sensor), max_kf, max_lm, n_levels)
    return _dyn_packet(cam, out, verdict, boxes, box_active)


def fused_track_chunk(m: MapState, cam: Intrinsics, bounds, images, auxs,
                      boxes, box_active, last_obs_lm, R_last, t_last,
                      R_prev2, t_prev2, has_vel, ref_kf, orb_cfg: ORBConfig,
                      mm_radius, local_radius, depth_th, scale_factor,
                      min_inliers_track, sensor: str = "rgbd",
                      max_kf: int = 16, max_lm: int = 4096,
                      n_levels: int = 8, n_slots: int = 0,
                      depth_scale=None, dyn=None, depth_stride: int = 1):
    """C consecutive frames in one call (``fused.py:328``, through
    ``_chunk_body`` :400). images, auxs [C, H, W] (auxs as
    ``fused_track_step``'s aux); boxes [C, B, 4]; box_active [C, B].

    Frames chain on the device as they do across calls: frame j+1 takes
    frame j's pose as its motion-model base, frame j's landmark ids as its
    last observations, and the landmark visible/found counters carry
    through the chunk. The map snapshot is fixed for the whole chunk.

    ``dyn`` (see ``fused_track_chunk_dyn``) switches on the dynamic-scene
    branch. Returns (the C FusedOut, their packets stacked [C, 28] or
    [C, 28 + 17 B] for one readback)."""
    outs = []
    obs, Rl, tl, Rp2, tp2, hv = (last_obs_lm, R_last, t_last, R_prev2,
                                 t_prev2, has_vel)
    mm = m
    one = torch.ones_like(has_vel)
    for j in range(images.shape[0]):
        quarantine = box_active[j] if dyn is None else \
            box_active[j] & (dyn["box_status"] != 1)
        with record_function("frame_build"):
            fd = build_frame_data(cam, images[j], auxs[j], boxes[j],
                                  quarantine, orb_cfg, scale_factor, sensor,
                                  n_slots=n_slots, depth_scale=depth_scale,
                                  depth_stride=depth_stride)
        if dyn is not None:
            # every chunk frame classifies against the chunk-start
            # reference frame; classification sees every box (a static
            # box can turn dynamic)
            fd, verdict = _classify_and_reinstate(
                cam, fd, boxes[j], box_active[j], dyn, Rl, tl,
                classify=j % dyn["classify_every"] == 0, extra_seed=j)
        R_pred, t_pred = _predict_inside(Rl, tl, Rp2, tp2, hv)
        out = _track_stages(mm, cam, bounds, fd, obs, R_pred, t_pred, Rl, tl,
                            ref_kf, mm_radius, local_radius, depth_th,
                            scale_factor, min_inliers_track,
                            stereo_residuals(sensor), max_kf, max_lm, n_levels)
        if dyn is not None:
            out = _dyn_packet(cam, out, verdict, boxes[j], box_active[j])
        outs.append(out)
        mm = mm._replace(lm_visible=out.lm_visible, lm_found=out.lm_found)
        obs, Rp2, tp2, Rl, tl = out.obs_lm, Rl, tl, out.R, out.t
        hv = one
    return outs, torch.stack([o.packed for o in outs])


def fused_track_chunk_dyn(m: MapState, cam: Intrinsics, bounds, images,
                          auxs, boxes, box_active, box_status,
                          ref_fd: FrameData, have_ref, last_obs_lm, R_last,
                          t_last, R_prev2, t_prev2, has_vel, ref_kf,
                          orb_cfg: ORBConfig, mm_radius, local_radius,
                          depth_th, scale_factor, min_inliers_track, seed,
                          sensor: str = "rgbd", max_kf: int = 16,
                          max_lm: int = 4096, n_levels: int = 8,
                          n_slots: int = 0, n_hyp: int = 256,
                          depth_scale=None, classify_every: int = 1,
                          depth_stride: int = 1):
    """Dynamic-scene chunk (``fused.py:483``): ``fused_track_chunk`` with
    each frame's H/F classification against the chunk-start reference
    frame on every ``classify_every``-th chunk frame (the others emit
    verdict 0), reinstatement by the host's start-of-chunk
    ``box_status``, and the [C, 28 + B + 16 B] packet."""
    dyn = dict(box_status=box_status, ref_fd=ref_fd, have_ref=have_ref,
               seed=seed, n_hyp=n_hyp, classify_every=classify_every)
    return fused_track_chunk(
        m, cam, bounds, images, auxs, boxes, box_active, last_obs_lm,
        R_last, t_last, R_prev2, t_prev2, has_vel, ref_kf, orb_cfg,
        mm_radius, local_radius, depth_th, scale_factor, min_inliers_track,
        sensor=sensor, max_kf=max_kf, max_lm=max_lm, n_levels=n_levels,
        n_slots=n_slots, depth_scale=depth_scale, dyn=dyn,
        depth_stride=depth_stride)


def fused_track_step_batch(m: MapState, cam: Intrinsics, bounds, image, aux,
                           boxes, box_active, last_obs_lm, R_last, t_last,
                           R_prev2, t_prev2, has_vel, ref_kf,
                           orb_cfg: ORBConfig, mm_radius, local_radius,
                           depth_th, scale_factor, min_inliers_track,
                           sensor: str = "rgbd", max_kf: int = 16,
                           max_lm: int = 4096, n_levels: int = 8,
                           n_slots: int = 0, depth_scale=None,
                           depth_stride: int = 1) -> FusedOut:
    """B independent sequences in one batched step (``fused.py:287-322``):
    ``torch.func.vmap`` of ``fused_track_step`` over a leading [B] axis of
    the MapState and of every per-frame and recurrent tensor; the camera,
    bounds and tuning constants are shared. Every op runs once for the B
    lanes, and kernels K1 and K2 through their vmap rules (one launch
    with a lane axis), so a step makes about the launches of one lane's
    frame, not B times them. Returns one FusedOut with a leading [B]
    axis (packet [B, 28])."""
    def one(m1, image1, aux1, bx1, ba1, last1, Rl, tl, Rp2, tp2, hv, rkf):
        return fused_track_step(
            m1, cam, bounds, image1, aux1, bx1, ba1, last1, Rl, tl, Rp2,
            tp2, hv, rkf, orb_cfg, mm_radius, local_radius, depth_th,
            scale_factor, min_inliers_track, sensor=sensor, max_kf=max_kf,
            max_lm=max_lm, n_levels=n_levels, n_slots=n_slots,
            depth_scale=depth_scale, depth_stride=depth_stride)
    return torch.func.vmap(one)(m, image, aux, boxes, box_active,
                                last_obs_lm, R_last, t_last, R_prev2,
                                t_prev2, has_vel, ref_kf)


def fused_track_chunk_batch(m: MapState, cam: Intrinsics, bounds, images,
                            auxs, boxes, box_active, last_obs_lm, R_last,
                            t_last, R_prev2, t_prev2, has_vel, ref_kf,
                            orb_cfg: ORBConfig, mm_radius, local_radius,
                            depth_th, scale_factor, min_inliers_track,
                            sensor: str = "rgbd", max_kf: int = 16,
                            max_lm: int = 4096, n_levels: int = 8,
                            n_slots: int = 0, depth_scale=None,
                            depth_stride: int = 1):
    """B lanes x C consecutive frames in one batched call
    (``fused.py:372-401``): ``torch.func.vmap`` of ``fused_track_chunk``
    (no dynamic branch) over a leading [B] axis; images [B, C, H, W].
    Returns (the C FusedOut, each with a leading [B] axis, and their
    packets [B, C, 28] for one readback)."""
    def one(m1, im, ax, bx1, ba1, last1, Rl, tl, Rp2, tp2, hv, rkf):
        return fused_track_chunk(
            m1, cam, bounds, im, ax, bx1, ba1, last1, Rl, tl, Rp2, tp2, hv,
            rkf, orb_cfg, mm_radius, local_radius, depth_th, scale_factor,
            min_inliers_track, sensor=sensor, max_kf=max_kf, max_lm=max_lm,
            n_levels=n_levels, n_slots=n_slots, depth_scale=depth_scale,
            depth_stride=depth_stride)
    return torch.func.vmap(one)(m, images, auxs, boxes, box_active,
                                last_obs_lm, R_last, t_last, R_prev2,
                                t_prev2, has_vel, ref_kf)
