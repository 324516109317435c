"""Gated nearest-landmark descriptor matching: kernel K1.

Port of ``slam_dynamic_tpu/ops/pallas_match.py``: K1 replaces the Pallas
kernel ``_match_kernel`` (:83, called through ``gated_match_pallas``
:143-194), and ``accept_match`` (:76) is carried over as it is. Per
keypoint it finds the landmark with the smallest gated Hamming distance:

  pair allowed iff  kp_ok[n] & lm_ok[m]
                  & (kp_xy[n] - lm_uv[m])^2 <= lm_radius[m]^2   (direct form)
                  & lvl_min <= kp_level[n] - lm_lvl[m] <= lvl_max

A disallowed pair has distance INVALID (1 << 15); ties go to the lowest
landmark index, as ``jax.lax.top_k`` does. It runs three times per frame:
the motion-model narrow and wide passes and the local-map pass. What
bounds it on the H100 and what its design does about that: see
``csrc/kernels.cu``.

``gated_match`` is a ``torch.library`` custom op whose vmap rule is the
counterpart of ``jax.vmap`` over the ``pallas_call`` (a batch axis on the
kernel's grid): under ``torch.func.vmap`` (the batched tracking step,
``frontend/fused.py:fused_track_step_batch``) the B lanes' calls become
ONE launch of K1 with a lane axis (``gated_match_batched``).
"""
from __future__ import annotations

import torch

from . import kernels
from .hamming import INVALID, hamming_matrix_plain, top2_min

# Launches of kernel K1: one per CUDA call of gated_match, one per batched
# launch (the batched ones are also counted in batched_launches).
launches = 0
batched_launches = 0

# K1 packs a landmark index into the low 16 bits of its candidate keys,
# so one launch takes at most this many landmarks; the wrapper splits a
# larger set into ranges and merges their results (``gated_match_ranges``).
MAX_LANDMARKS = 1 << 16


def accept_match(best, second, max_dist, ratio):
    """The accept tests of ``hamming.match_nn`` on kernel output."""
    ok = best <= max_dist
    ok &= best.to(torch.float32) <= ratio * second.to(torch.float32)
    return ok


def gated_match_plain(kp_desc, kp_xy, kp_level, kp_ok,
                      lm_desc, lm_uv, lm_radius, lm_lvl, lm_ok,
                      lvl_min: int = -1, lvl_max: int = 1):
    """Plain PyTorch version of K1: the dense masked [N, M] matrix and its
    first-min top-2. Returns (idx, best, second), each [N] int32."""
    du = kp_xy[:, None, 0] - lm_uv[None, :, 0]
    dv = kp_xy[:, None, 1] - lm_uv[None, :, 1]
    r2 = lm_radius.to(torch.float32) ** 2
    in_r = du * du + dv * dv <= r2[None, :]
    dl = kp_level[:, None] - lm_lvl[None, :]
    in_l = (dl >= lvl_min) & (dl <= lvl_max)
    ok = kp_ok[:, None] & lm_ok[None, :]
    d = torch.where(in_r & in_l & ok, hamming_matrix_plain(kp_desc, lm_desc),
                    INVALID)
    if d.shape[1] < 2:
        # the Pallas kernel pads the landmarks with gated-out ones: with
        # fewer than two, the runner-up (and with none, the best) is INVALID
        d = torch.cat([d, d.new_full((d.shape[0], 2 - d.shape[1]), INVALID)],
                      dim=1)
    idx, best, second = top2_min(d)
    return idx.to(torch.int32), best, second


def merge_top2(first, later):
    """Merge the (idx, best, second) of two landmark ranges, every index of
    ``later`` above every index of ``first``, into the result over both:
    the best is the minimum of (best, idx), so a tie keeps ``first``'s
    lower index, and the runner-up is the minimum of the winning range's
    runner-up and the other range's best. Exact."""
    idx_a, best_a, second_a = first
    idx_b, best_b, second_b = later
    take_b = best_b < best_a
    return (torch.where(take_b, idx_b, idx_a),
            torch.where(take_b, best_b, best_a),
            torch.where(take_b, torch.minimum(second_b, best_a),
                        torch.minimum(second_a, best_b)))


def gated_match_ranges(match, kp_args, lm_args, range_size: int,
                       lvl_min: int = -1, lvl_max: int = 1, dim: int = 0):
    """``match`` (a gated-match function) over consecutive landmark ranges
    of at most ``range_size`` along ``dim`` (1 for the batched form), each
    range's ``idx`` offset to the whole set's and the results merged with
    ``merge_top2``: the same (idx, best, second) as one call over all
    landmarks."""
    m = lm_args[0].shape[dim]
    out = None
    for lo in range(0, m, range_size):
        i, b, s = match(*kp_args,
                        *(a.narrow(dim, lo, min(range_size, m - lo))
                          .contiguous() for a in lm_args),
                        lvl_min=lvl_min, lvl_max=lvl_max)
        part = (i + lo, b, s)
        out = part if out is None else merge_top2(out, part)
    return out


def gated_match(kp_desc, kp_xy, kp_level, kp_ok,
                lm_desc, lm_uv, lm_radius, lm_lvl, lm_ok,
                lvl_min: int = -1, lvl_max: int = 1):
    """Per-keypoint gated NN match against a landmark set.

    kp_desc [N, 8] int32, kp_xy [N, 2] f32, kp_level [N] int32, kp_ok [N]
    bool; lm_desc [M, 8] int32, lm_uv [M, 2] f32, lm_radius [M] f32,
    lm_lvl [M] int32, lm_ok [M] bool. Returns (idx, best, second), each
    [N] int32 (INVALID where no pair passes). Kernel K1 on CUDA tensors,
    the plain version on CPU tensors. Above MAX_LANDMARKS landmarks K1
    runs on equal consecutive ranges of at most MAX_LANDMARKS, one launch
    each, and the results are merged exactly. Under ``torch.func.vmap``
    the lanes go to ``gated_match_batched`` together.
    """
    return _gated_match_op(kp_desc, kp_xy, kp_level, kp_ok, lm_desc, lm_uv,
                           lm_radius, lm_lvl, lm_ok, int(lvl_min),
                           int(lvl_max))


@torch.library.custom_op("slam_dynamic_tpu_torch::gated_match",
                         mutates_args=())
def _gated_match_op(kp_desc: torch.Tensor, kp_xy: torch.Tensor,
                    kp_level: torch.Tensor, kp_ok: torch.Tensor,
                    lm_desc: torch.Tensor, lm_uv: torch.Tensor,
                    lm_radius: torch.Tensor, lm_lvl: torch.Tensor,
                    lm_ok: torch.Tensor, lvl_min: int, lvl_max: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _k1(gated_match_plain, (kp_desc, kp_xy, kp_level, kp_ok),
               (lm_desc, lm_uv, lm_radius, lm_lvl, lm_ok), lvl_min, lvl_max)


def _gated_match_vmap(info, in_dims, *args):
    """vmap rule of the op: the lanes' calls as one ``gated_match_batched``
    (lane axis first; an unbatched argument is shared by every lane)."""
    tensors = [kernels.lane_major(a, d, info.batch_size)
               for a, d in zip(args[:9], in_dims)]
    return gated_match_batched(*tensors, lvl_min=args[9],
                               lvl_max=args[10]), (0, 0, 0)


torch.library.register_vmap("slam_dynamic_tpu_torch::gated_match",
                            _gated_match_vmap)


def gated_match_batched_plain(kp_desc, kp_xy, kp_level, kp_ok,
                              lm_desc, lm_uv, lm_radius, lm_lvl, lm_ok,
                              lvl_min: int = -1, lvl_max: int = 1):
    """Plain version of the batched K1: ``gated_match_plain`` lane by
    lane over the leading axis. Returns (idx, best, second), each
    [B, N] int32."""
    args = (kp_desc, kp_xy, kp_level, kp_ok, lm_desc, lm_uv, lm_radius,
            lm_lvl, lm_ok)
    per_lane = [gated_match_plain(*(a[b] for a in args), lvl_min=lvl_min,
                                  lvl_max=lvl_max)
                for b in range(kp_desc.shape[0])]
    return tuple(torch.stack(x) for x in zip(*per_lane))


def gated_match_batched(kp_desc, kp_xy, kp_level, kp_ok,
                        lm_desc, lm_uv, lm_radius, lm_lvl, lm_ok,
                        lvl_min: int = -1, lvl_max: int = 1):
    """``gated_match`` of B lanes at once: every argument with a leading
    [B] axis (the same N and M in every lane). ONE launch of K1 with a
    lane axis on CUDA tensors (one per range above MAX_LANDMARKS), the
    plain version on CPU tensors. Returns (idx, best, second), each
    [B, N] int32."""
    return _k1(gated_match_batched_plain, (kp_desc, kp_xy, kp_level, kp_ok),
               (lm_desc, lm_uv, lm_radius, lm_lvl, lm_ok), lvl_min, lvl_max)


def _k1(plain, kp_args, lm_args, lvl_min: int, lvl_max: int):
    """``plain`` on CPU tensors; on CUDA tensors K1 (one lane, or a lane
    axis first), one launch per landmark range of at most
    MAX_LANDMARKS."""
    if kp_args[0].device.type == "cpu":
        return plain(*kp_args, *lm_args, lvl_min=lvl_min, lvl_max=lvl_max)
    dim = lm_args[0].dim() - 2          # the landmark axis
    m = lm_args[0].shape[dim]
    if m > MAX_LANDMARKS:
        n_ranges = -(-m // MAX_LANDMARKS)
        return gated_match_ranges(_launch_k1, kp_args, lm_args,
                                  -(-m // n_ranges), lvl_min, lvl_max, dim)
    return _launch_k1(*kp_args, *lm_args, lvl_min=lvl_min, lvl_max=lvl_max)


def _launch_k1(kp_desc, kp_xy, kp_level, kp_ok, lm_desc, lm_uv, lm_radius,
               lm_lvl, lm_ok, lvl_min: int = -1, lvl_max: int = 1):
    """One launch of K1's batched entry point on CUDA tensors, M <=
    MAX_LANDMARKS: one lane ([N, 8] keypoint descriptors, B = 1) or B
    lanes ([B, N, 8])."""
    global launches, batched_launches
    dev = kp_desc.device
    lanes = kp_desc.shape[:-2]
    n, m = kp_desc.shape[-2], lm_desc.shape[-2]
    # the kernel squares the radius in f32, as the reference's wrapper does
    radius = lm_radius.to(torch.float32).contiguous()
    args = [
        ("kp_desc", kp_desc, torch.int32, (n, 8), 8),
        ("kp_xy", kp_xy, torch.float32, (n, 2), 8),
        ("kp_level", kp_level, torch.int32, (n,), 1),
        ("kp_ok", kp_ok, torch.bool, (n,), 1),
        ("lm_desc", lm_desc, torch.int32, (m, 8), 16),
        ("lm_uv", lm_uv, torch.float32, (m, 2), 8),
        ("lm_radius", radius, torch.float32, (m,), 1),
        ("lm_lvl", lm_lvl, torch.int32, (m,), 1),
        ("lm_ok", lm_ok, torch.bool, (m,), 1),
    ]
    for name, t, dtype, shape, align in args:
        kernels.require(t, name, dtype, lanes + shape, dev, align)
    idx = torch.empty(lanes + (n,), dtype=torch.int32, device=dev)
    best = torch.empty_like(idx)
    second = torch.empty_like(idx)
    ptrs = [t.data_ptr() for _, t, _, _, _ in args] + [
        idx.data_ptr(), best.data_ptr(), second.data_ptr()]
    status = kernels.lib().slam_gated_match_batched(
        *ptrs, lanes[0] if lanes else 1, n, m, int(lvl_min), int(lvl_max),
        kernels.stream_handle(dev))
    kernels.check(status, "gated_match")
    launches += 1
    batched_launches += bool(lanes)
    return idx, best, second
