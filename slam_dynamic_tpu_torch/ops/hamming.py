"""256-bit Hamming matching; ``hamming_matrix`` is kernel K2.

Port of ``slam_dynamic_tpu/ops/hamming.py`` (``hamming_matrix`` :54,
``masked_hamming_matrix`` :70, ``match_nn`` :80, ``rotation_consistency``
:103, ``radius_pair_mask`` :122, ``level_pair_mask`` :137).

Kernel K2 replaces the Pallas kernel ``slam_dynamic_tpu/ops/
pallas_hamming.py:42`` (``_hamming_kernel``, called through
``hamming_matrix_pallas`` :67-90). The JAX package runs that kernel only
behind ``use_pallas(True)`` and otherwise forms the same matrix as a
bipolar int8 matmul; the port launches K2 for every Hamming matrix of a
CUDA tensor (fusion and triangulation on keyframes). What bounds it on the
H100 and what its design does about that: see ``csrc/kernels.cu``.
``hamming_matrix`` is a ``torch.library`` custom op whose vmap rule makes
the lanes of a vmapped call (the stereo matcher of the batched tracking
step) ONE launch of K2 with a lane axis (``hamming_matrix_batched``).

Descriptors are [rows, 8] int32, the bit view of the reference's uint32
lanes. ``INVALID = 1 << 15`` marks gated-out pairs; every top-2 here keeps
the lowest index on ties, as ``jax.lax.top_k`` does.
"""
from __future__ import annotations

import math

import torch

from . import kernels

INVALID = 1 << 15

# Launches of kernel K2: one per CUDA call of hamming_matrix, one per
# batched launch (the batched ones are also counted in batched_launches).
launches = 0
batched_launches = 0


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns (SWAR; every shift is
    followed by a mask that clears the sign-extended bits)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rowwise Hamming distance of packed descriptors [..., 8] int32."""
    return popcount32(torch.bitwise_xor(a, b)).sum(-1, dtype=torch.int32)


def hamming_matrix_plain(desc_a: torch.Tensor,
                         desc_b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: [N, M] int32, XOR + popcount per word."""
    acc = popcount32(torch.bitwise_xor(desc_a[:, 0, None], desc_b[None, :, 0]))
    for w in range(1, 8):
        acc = acc + popcount32(torch.bitwise_xor(desc_a[:, w, None],
                                                 desc_b[None, :, w]))
    return acc


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Full [N, M] int32 Hamming matrix of [N, 8] x [M, 8] int32
    descriptors: kernel K2 on a CUDA tensor, its plain version on a CPU
    tensor. Under ``torch.func.vmap`` the lanes go to
    ``hamming_matrix_batched`` together."""
    return _hamming_matrix_op(desc_a, desc_b)


@torch.library.custom_op("slam_dynamic_tpu_torch::hamming_matrix",
                         mutates_args=())
def _hamming_matrix_op(desc_a: torch.Tensor,
                       desc_b: torch.Tensor) -> torch.Tensor:
    if desc_a.device.type == "cpu":
        return hamming_matrix_plain(desc_a, desc_b)
    return _launch_k2(desc_a, desc_b)


def _hamming_matrix_vmap(info, in_dims, desc_a, desc_b):
    """vmap rule of the op: the lanes' calls as one
    ``hamming_matrix_batched`` (an unbatched side shared by every lane)."""
    a, b = (kernels.lane_major(x, d, info.batch_size)
            for x, d in zip((desc_a, desc_b), in_dims))
    return hamming_matrix_batched(a, b), 0


torch.library.register_vmap("slam_dynamic_tpu_torch::hamming_matrix",
                            _hamming_matrix_vmap)


def hamming_matrix_batched_plain(desc_a: torch.Tensor,
                                 desc_b: torch.Tensor) -> torch.Tensor:
    """Plain version of the batched K2: ``hamming_matrix_plain`` lane by
    lane, [B, N, M] int32."""
    return torch.stack([hamming_matrix_plain(a, b)
                        for a, b in zip(desc_a, desc_b)])


def hamming_matrix_batched(desc_a: torch.Tensor,
                           desc_b: torch.Tensor) -> torch.Tensor:
    """[B, N, M] int32 Hamming matrices of [B, N, 8] x [B, M, 8] int32
    descriptors: ONE launch of K2 with a lane axis on CUDA tensors, the
    plain version on CPU tensors."""
    if desc_a.device.type == "cpu":
        return hamming_matrix_batched_plain(desc_a, desc_b)
    return _launch_k2(desc_a, desc_b)


def _launch_k2(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """One launch of K2's batched entry point on CUDA tensors: one lane
    ([N, 8] x [M, 8], B = 1) or B lanes ([B, N, 8] x [B, M, 8])."""
    global launches, batched_launches
    dev = desc_a.device
    lanes = desc_a.shape[:-2]
    n, m = desc_a.shape[-2], desc_b.shape[-2]
    kernels.require(desc_a, "desc_a", torch.int32, lanes + (n, 8), dev, 16)
    kernels.require(desc_b, "desc_b", torch.int32, lanes + (m, 8), dev, 16)
    out = torch.empty(lanes + (n, m), dtype=torch.int32, device=dev)
    status = kernels.lib().slam_hamming_batched(
        desc_a.data_ptr(), desc_b.data_ptr(), out.data_ptr(),
        lanes[0] if lanes else 1, n, m, kernels.stream_handle(dev))
    kernels.check(status, "hamming_matrix")
    launches += 1
    batched_launches += bool(lanes)
    return out


def masked_hamming_matrix(desc_a, valid_a, desc_b, valid_b,
                          pair_mask=None) -> torch.Tensor:
    """Hamming matrix with INVALID on rows/cols/pairs that are masked out."""
    d = hamming_matrix(desc_a.contiguous(), desc_b.contiguous())
    m = valid_a[:, None] & valid_b[None, :]
    if pair_mask is not None:
        m = m & pair_mask
    return torch.where(m, d, INVALID)


def top2_min(dist: torch.Tensor):
    """(idx, best, second) of the two smallest entries per row of [N, M]:
    idx is the first column holding the minimum, second the runner-up of
    the multiset (top-2 of ``-dist`` with lowest-index ties)."""
    best, idx = dist.min(dim=1)
    # argmin's index on ties is not specified for CUDA: take the first
    # column at the minimum explicitly
    cols = torch.arange(dist.shape[1], device=dist.device)
    idx = torch.where(dist == best[:, None], cols, dist.shape[1]).min(1)[0]
    rest = dist.scatter(1, idx[:, None], torch.iinfo(dist.dtype).max)
    return idx, best, rest.min(dim=1)[0]


def match_nn(dist: torch.Tensor, max_dist: int, ratio: float = 1.0,
             mutual: bool = False):
    """Nearest-neighbour matches from a masked distance matrix [N, M].

    Returns (idx_b [N] int64, best_dist [N] int32, ok [N] bool); the ratio
    test compares best and second best in float32.
    """
    idx_b, best, second = top2_min(dist)
    ok = best <= max_dist
    ok &= best.to(torch.float32) <= ratio * second.to(torch.float32)
    if mutual:
        rows = torch.arange(dist.shape[0], device=dist.device)
        colmin = dist.min(dim=0)[0]
        best_for_b = torch.where(dist == colmin[None, :], rows[:, None],
                                 dist.shape[0]).min(0)[0]
        ok &= best_for_b[idx_b] == rows
    return idx_b, best, ok


def rotation_consistency(angle_a, angle_b, idx_b, ok, histo_length: int = 30,
                         keep_top: int = 3):
    """Keep only matches whose angle difference falls in the top-k
    histogram bins (ORBmatcher::ComputeThreeMaxima, with the 10%-of-max
    cut for the secondary bins)."""
    two_pi = 2 * math.pi
    diff = torch.remainder(angle_a - angle_b[idx_b], two_pi)
    bins = torch.floor(diff / two_pi * histo_length).to(torch.int64)
    bins = bins.clamp(0, histo_length - 1)
    counts = torch.zeros(histo_length, dtype=torch.int32,
                         device=angle_a.device)
    counts.index_add_(0, bins, ok.to(torch.int32))
    topv, topi = torch.sort(counts, descending=True, stable=True)
    topv, topi = topv[:keep_top], topi[:keep_top]
    # the first bin needs a count, the others more than 10% of the first
    thr = (topv[0].to(torch.float32) * 0.1).to(torch.int32)
    thr = torch.where(torch.arange(keep_top, device=thr.device) > 0, thr, 0)
    # a scatter, not a Python loop of item assignments: indexing with a
    # device scalar would wait for the device
    keep_bin = torch.zeros(histo_length, dtype=torch.bool,
                           device=angle_a.device).scatter(0, topi, topv > thr)
    return ok & keep_bin[bins]


def radius_pair_mask(uv_a_proj, uv_b, radius_a):
    """Pixel-radius gate [N, M]: |proj(a) - kp_b|^2 <= r_a^2, in the
    reference's |a|^2 + |b|^2 - 2 a.b form."""
    na = (uv_a_proj * uv_a_proj).sum(-1)
    nb = (uv_b * uv_b).sum(-1)
    d2 = na[:, None] + nb[None, :] - 2.0 * (uv_a_proj @ uv_b.T)
    return d2 <= (radius_a[:, None] ** 2)


def level_pair_mask(level_a, level_b, min_delta, max_delta):
    """Scale gate: level_b within [la + min_delta, la + max_delta]."""
    d = level_b[None, :] - level_a[:, None]
    return (d >= min_delta) & (d <= max_delta)
