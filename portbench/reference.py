"""The plain reference that decides ``correct``: plain PyTorch and NumPy,
importing nothing of the program.

- K1 and K2: frozen copies of the plain versions of the gated
  nearest-landmark match and the 256-bit Hamming matrix, run on the
  inputs of calls recorded from the timed window; their outputs must be
  equal to the program's, element for element.
- The trajectory: relative pose error between consecutive frames (Sturm
  et al.'s RPE at a gap of one frame) against the world's exact poses,
  translation in mm and rotation in mrad; the ATE after an SE(3) Umeyama
  alignment is reported beside it.
- Keypoint depths: the program's depth of each valid keypoint against the
  rendered depth at the keypoint's pixel; for a stereo rig also as a
  disparity (bf / depth, pixels), the quantity the row-band matcher
  measures, whose error does not grow with the depth.
- Box statuses: a box the program confirms dynamic must lie on an object
  the world moves.

Each check also gives the reading of its control: the same reference put
in the program's place and computed in the next lower precision (K1's
float gate in bfloat16, K2's distances held in int8, poses and depths in
bfloat16), which the limits must refuse.
"""
from __future__ import annotations

import math

import numpy as np
import torch

INVALID = 1 << 15


# -- K1 and K2 ------------------------------------------------------------
def popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, M] int32 Hamming distances of [N, 8] x [M, 8] int32 words."""
    acc = popcount32(torch.bitwise_xor(a[:, 0, None], b[None, :, 0]))
    for w in range(1, 8):
        acc = acc + popcount32(torch.bitwise_xor(a[:, w, None],
                                                 b[None, :, w]))
    return acc


def top2_min(d: torch.Tensor):
    """(idx, best, second) per row; idx the first column at the minimum."""
    best = d.min(dim=1)[0]
    cols = torch.arange(d.shape[1], device=d.device)
    idx = torch.where(d == best[:, None], cols, d.shape[1]).min(1)[0]
    rest = d.scatter(1, idx[:, None], torch.iinfo(d.dtype).max)
    return idx.to(torch.int32), best, rest.min(dim=1)[0]


def gated_match(kp_desc, kp_xy, kp_level, kp_ok, lm_desc, lm_uv, lm_radius,
                lm_lvl, lm_ok, lvl_min=-1, lvl_max=1, gate_dtype=None):
    """One lane of K1: the dense gated distance matrix and its top-2.
    ``gate_dtype`` (the control) computes the radius test in that type."""
    dt = gate_dtype or torch.float32
    xy, uv = kp_xy.to(dt), lm_uv.to(dt)
    du = xy[:, None, 0] - uv[None, :, 0]
    dv = xy[:, None, 1] - uv[None, :, 1]
    r2 = lm_radius.to(torch.float32).to(dt) ** 2
    in_r = du * du + dv * dv <= r2[None, :]
    dl = kp_level[:, None] - lm_lvl[None, :]
    in_l = (dl >= lvl_min) & (dl <= lvl_max)
    ok = kp_ok[:, None] & lm_ok[None, :]
    d = torch.where(in_r & in_l & ok, hamming_matrix(kp_desc, lm_desc),
                    INVALID)
    if d.shape[1] < 2:
        d = torch.cat([d, d.new_full((d.shape[0], 2 - d.shape[1]), INVALID)],
                      dim=1)
    return top2_min(d)


def k1_mismatches(call, gate_dtype=None) -> int:
    """Elements of a recorded K1 call's (idx, best, second) that differ
    from the reference's; ``call`` = (kp_args, lm_args, lvl_min, lvl_max,
    outputs), one lane or a lane axis first."""
    kp, lm, lo, hi, outs = call
    batched = kp[0].dim() == 3
    lanes = kp[0].shape[0] if batched else 1
    bad = 0
    for b in range(lanes):
        sel = (lambda t: t[b]) if batched else (lambda t: t)
        ref = gated_match(*[sel(t) for t in kp], *[sel(t) for t in lm],
                          lvl_min=lo, lvl_max=hi, gate_dtype=gate_dtype)
        bad += sum(int((r.to(torch.int32) != sel(o).to(torch.int32)).sum())
                   for r, o in zip(ref, outs))
    return bad


def k2_mismatches(call, int8: bool = False) -> int:
    """Elements of a recorded K2 call's matrix that differ from the
    reference's; ``int8`` (the control) holds the distances in int8."""
    a, b, out = call
    batched = a.dim() == 3
    lanes = a.shape[0] if batched else 1
    bad = 0
    for i in range(lanes):
        aa, bb, oo = (a[i], b[i], out[i]) if batched else (a, b, out)
        ref = hamming_matrix(aa, bb)
        if int8:
            ref = ref.clamp(max=127).to(torch.int8).to(torch.int32)
        bad += int((ref != oo).sum())
    return bad


# -- trajectories -----------------------------------------------------------
def bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bfloat16 (the control's precision)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float64).numpy()


def camera_poses(R_cw: np.ndarray, t_cw: np.ndarray):
    """(R_wc, centre) from world-to-camera poses."""
    R_wc = np.transpose(R_cw, (0, 2, 1))
    return R_wc, -np.einsum("nij,nj->ni", R_wc, t_cw)


def rpe(est_R, est_c, gt_R, gt_c, pairs):
    """Per pair (i, j): translation error (m) and rotation error (rad) of
    the relative motion; camera-to-world rotations and centres."""
    terr, rerr = [], []
    for i, j in pairs:
        dE_R = est_R[i].T @ est_R[j]
        dE_t = est_R[i].T @ (est_c[j] - est_c[i])
        dG_R = gt_R[i].T @ gt_R[j]
        dG_t = gt_R[i].T @ (gt_c[j] - gt_c[i])
        terr.append(np.linalg.norm(dE_t - dG_t))
        # the chordal distance, the angle for small errors; it also reads
        # matrices rounded off the rotation group, as the control's are
        rerr.append(np.linalg.norm(dE_R - dG_R) / math.sqrt(2.0))
    return np.asarray(terr), np.asarray(rerr)


def umeyama_se3(src, dst):
    """Least-squares rigid transform dst ~ R src + t."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def ate(est_c, gt_c) -> float:
    """ATE RMSE (m) after an SE(3) alignment."""
    R, t = umeyama_se3(est_c, gt_c)
    err = np.linalg.norm(est_c @ R.T + t - gt_c, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def trajectory_check(lanes):
    """``lanes``: per lane (est_R_cw [n,3,3], est_t_cw [n,3], gt_R_wc,
    gt_t_wc, frame index [n]) of the window's frames, and the true pose
    (R_wc, centre) of the lane's first frame, where the program puts its
    world frame. Returns the
    readings: RPE RMS (mm, mrad) over consecutive frames of every lane,
    its control (the truth, expressed in the program's frame, in
    bfloat16, put in the program's place), the ATE (mm, worst lane), the
    pairs and the frames counted."""
    tr, rr, ctr, crr, ates = [], [], [], [], []
    for R_cw, t_cw, gR, gt, idx, R0, c0 in lanes:
        eR, ec = camera_poses(R_cw, t_cw)
        pairs = [(k, k + 1) for k in range(len(idx) - 1)
                 if idx[k + 1] == idx[k] + 1]
        t, r = rpe(eR, ec, gR, gt, pairs)
        tr.append(t)
        rr.append(r)
        # the truth in the program's frame (its first frame's camera)
        pR = np.einsum("ij,njk->nik", R0.T, gR)
        pc = (gt - c0) @ R0
        t, r = rpe(bf16(pR), bf16(pc), pR, pc, pairs)
        ctr.append(t)
        crr.append(r)
        # a lane with too few frames to align has no ATE: it fails
        ates.append(ate(ec, gt) if len(ec) >= 3 else float("nan"))
    tr, rr = np.concatenate(tr), np.concatenate(rr)
    ctr, crr = np.concatenate(ctr), np.concatenate(crr)

    def rms(x):
        return float(np.sqrt((x ** 2).mean())) if len(x) else float("nan")
    return dict(rpe_mm=rms(tr) * 1e3, rpe_mrad=rms(rr) * 1e3,
                control_rpe_mm=rms(ctr) * 1e3,
                control_rpe_mrad=rms(crr) * 1e3,
                ate_mm=float(np.max(ates)) * 1e3 if ates else float("nan"),
                pairs=int(len(tr)),
                frames_checked=int(sum(len(lane[4]) for lane in lanes)))


# -- keypoint depths --------------------------------------------------------
def depth_check(samples, quantile: float, bf=None,
                disparity_quantile: float = 0.5):
    """``samples``: per sampled frame (xy [N, 2], valid [N], depth [N]
    from the program, rendered depth map [H, W] in metres). The
    ``quantile`` of |program - rendered| (mm) at the keypoint's pixel
    (rounded, as the sensor model samples it) over the valid keypoints
    with a depth, its control (the rendered depth in bfloat16 in the
    program's place) and the keypoints counted. With ``bf`` (a stereo
    rig's baseline times fx, pixel metres) also the ``disparity_quantile``
    of |bf / program - bf / rendered| (pixels) and its control."""
    errs, cerrs, derrs, cderrs = [], [], [], []
    for xy, valid, depth, dmap in samples:
        h, w = dmap.shape
        ok = valid & (depth > 0)
        xi = torch.round(xy[ok, 0]).long().clamp(0, w - 1)
        yi = torch.round(xy[ok, 1]).long().clamp(0, h - 1)
        truth = dmap[yi, xi].double()
        prog = depth[ok].double()
        control = truth.float().to(torch.bfloat16).double()
        errs.append((prog - truth).abs())
        cerrs.append((control - truth).abs())
        if bf is not None:
            seen = truth > 0
            derrs.append((bf / prog[seen] - bf / truth[seen]).abs())
            cderrs.append((bf / control[seen] - bf / truth[seen]).abs())
    e = torch.cat(errs) if errs else torch.zeros(0)
    c = torch.cat(cerrs) if cerrs else torch.zeros(0)
    out = dict(depth_err_mm=float("nan"), control_depth_err_mm=0.0,
               depth_keypoints=int(len(e)))
    if len(e):
        q = torch.tensor(quantile, dtype=torch.float64)
        out.update(
            depth_err_mm=float(torch.quantile(e.cpu(), q)) * 1e3,
            control_depth_err_mm=float(torch.quantile(c.cpu(), q)) * 1e3)
    if bf is not None:
        d = torch.cat(derrs) if derrs else torch.zeros(0)
        cd = torch.cat(cderrs) if cderrs else torch.zeros(0)
        qd = torch.tensor(disparity_quantile, dtype=torch.float64)
        out.update(
            disparity_err_px=float(torch.quantile(d.cpu(), qd))
            if len(d) else float("nan"),
            control_disparity_err_px=float(torch.quantile(cd.cpu(), qd))
            if len(cd) else 0.0)
    return out


# -- box statuses -----------------------------------------------------------
def iou(a: np.ndarray, b: np.ndarray) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) \
        - inter
    return inter / ua if ua > 0 else 0.0


def status_check(snapshots, truth_boxes, truth_valid, moving, min_iou=0.3):
    """``snapshots``: per step (world frame, boxes [n, 4], status [n]) as
    the program's box tracker held them after the step. Counts the boxes
    confirmed dynamic (status 2) that lie on an object the world does not
    move (a box on no object, such as one carried on after its object
    left the view, is not judged), and (reported beside it) the share of
    snapshots in
    which a moving object in view has a confirmed box."""
    wrong, moving_seen, moving_confirmed = 0, 0, 0
    wrong_frames = []
    for w, boxes, status in snapshots:
        on = []
        for box in boxes:
            best, k_best = 0.0, -1
            for k in range(len(moving)):
                if truth_valid[w, k]:
                    o = iou(box, truth_boxes[w, k])
                    if o > best:
                        best, k_best = o, k
            on.append(k_best if best >= min_iou else -1)
        for k_obj, s in zip(on, status):
            if s == 2 and k_obj >= 0 and not moving[k_obj]:
                wrong += 1
                wrong_frames.append(int(w))
        for k in np.nonzero(moving & truth_valid[w])[0]:
            moving_seen += 1
            moving_confirmed += any(ko == k and s == 2
                                    for ko, s in zip(on, status))
    return dict(static_confirmed_dynamic=wrong,
                static_confirmed_frames=wrong_frames[:10],
                moving_confirmed_share=(100.0 * moving_confirmed
                                        / moving_seen if moving_seen
                                        else float("nan")))
