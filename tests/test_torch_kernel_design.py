"""The arithmetic that kernels K1 and K2 (csrc/kernels.cu) rely on, checked
on the CPU where the kernels themselves cannot run:

- the AND-popcount identity that turns the binary tensor-core product
  into Hamming distances, at edge descriptors;
- K1's split-and-merge reduction over packed (dist << 16) | m keys,
  emulated here with random landmark splits and random merge orders,
  against the plain version and the JAX package's Pallas kernel in
  interpret mode, forced ties included;
- the plain version's edge cases with fewer than two landmarks, against
  the Pallas kernel;
- the least-time bounds that chip_smoke.py reports, the shared problem
  generator at its edges, and the recording of K1's inputs on the path.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_dynamic_tpu.ops.pallas_match import gated_match_pallas
from slam_dynamic_tpu_torch import kernel_bench as kb
from slam_dynamic_tpu_torch.frontend import fused, tracking_ops
from slam_dynamic_tpu_torch.ops import gated_match as gm
from slam_dynamic_tpu_torch.ops import hamming as hm
from torch_port_util import to_t

_problem = kb.k1_problem
INVALID = 1 << 15
KEY_NONE = 0xFFFFFFFF    # no allowed pair: above every candidate key
KEY_BIAS = 256           # keeps popc(b) - 2 popc(a & b) non-negative
U32 = 0xFFFFFFFF


def _and_popc(a, b):
    """[N, M] popc(a & b) of packed [., 8] int32 descriptors."""
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32)
    for w in range(8):
        acc += hm.popcount32(a[:, w, None] & b[None, :, w])
    return acc


def _popc_rows(d):
    return hm.popcount32(d).sum(-1, dtype=torch.int32)


def _edge_descriptors():
    words = [0, -1, 1, -2**31, 0x55555555, -0x55555556, 0x0F0F0F0F, 7]
    rows = [[w] * 8 for w in words]
    rows.append([0, -1] * 4)
    rows.append([-1] + [0] * 7)
    rows.append([0] * 7 + [1])
    return torch.tensor(rows, dtype=torch.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_and_popc_identity_at_edge_descriptors(seed):
    """hamming(a, b) = popc(a) + popc(b) - 2 popc(a & b), bit patterns at
    the edges (all zeros, all ones, sign bit, alternating) and random."""
    rng = np.random.default_rng(seed)
    rand = torch.from_numpy(rng.integers(0, 2**32, (16, 8), dtype=np.uint32)
                            .view(np.int32))
    d = torch.cat([_edge_descriptors(), rand])
    ham = hm.hamming_matrix_plain(d, d)
    ident = _popc_rows(d)[:, None] + _popc_rows(d)[None, :] \
        - 2 * _and_popc(d, d)
    assert torch.equal(ham, ident)
    assert int(ham[0, 1]) == 256 and int(ham.diagonal().abs().max()) == 0


# ---- K1: packed keys, split and merged in any order -------------------


def _keys(kp_desc, kp_xy, kp_level, kp_ok, lm_desc, lm_uv, lm_radius,
          lm_lvl, lm_ok, lvl_min, lvl_max):
    """[N, M] int64 keys as the kernel forms them (uint32 arithmetic),
    KEY_NONE where a pair is not allowed: a gated-out keypoint has
    x = NaN, a gated-out landmark r^2 = -inf, so the radius test alone
    rejects them; the level window is one unsigned compare; a key holds
    the distance less the row's popc(a), plus KEY_BIAS."""
    m = lm_desc.shape[0]
    x = torch.where(kp_ok, kp_xy[:, 0], torch.tensor(float("nan")))
    r2 = torch.where(lm_ok, lm_radius * lm_radius,
                     torch.tensor(float("-inf")))
    du = x[:, None] - lm_uv[None, :, 0]
    dv = kp_xy[:, None, 1] - lm_uv[None, :, 1]
    kl = (kp_level.long() - lvl_min) & U32
    dl = (kl[:, None] - lm_lvl.long()[None, :]) & U32
    allowed = (du * du + dv * dv <= r2[None, :]) \
        & (dl <= ((lvl_max - lvl_min) & U32))
    if lvl_max < lvl_min:           # the kernel leaves before its loop
        allowed &= False
    key = (((KEY_BIAS + _popc_rows(lm_desc).long()) << 16)
           + torch.arange(m, dtype=torch.int64))[None, :]
    keys = (key - (_and_popc(kp_desc, lm_desc).long() << 17)) & U32
    return torch.where(allowed, keys, KEY_NONE)


def _top2(keys):
    """Per row, the two lowest keys (KEY_NONE where a part has fewer)."""
    pad = torch.full((keys.shape[0], 2), KEY_NONE, dtype=torch.int64)
    s = torch.sort(torch.cat([keys, pad], dim=1), dim=1)[0]
    return s[:, 0], s[:, 1]


def _merge(p, q):
    (b1, b2), (o1, o2) = p, q
    return (torch.minimum(b1, o1),
            torch.minimum(torch.minimum(b2, o2), torch.maximum(b1, o1)))


def k1_emulate(args, lvl_min, lvl_max, rng):
    """K1's reduction: the landmarks dealt out to parts (some empty), in
    contiguous runs or 8-landmark tile by tile as the kernel deals them to
    its blocks and warps, a top-2 of keys per part, the parts merged
    pairwise in a random order; then decoded as the kernel decodes."""
    keys = _keys(*args, lvl_min, lvl_max)
    m = keys.shape[1]
    n_parts = int(rng.integers(1, 13))
    if rng.integers(2):
        part = np.sort(rng.integers(0, n_parts, m))
    else:
        part = np.repeat(rng.integers(0, n_parts, (m + 7) // 8), 8)[:m]
    parts = [_top2(keys[:, torch.from_numpy(part == p)])
             for p in range(n_parts)]
    while len(parts) > 1:
        i, j = sorted(rng.choice(len(parts), 2, replace=False).tolist())
        q = parts.pop(j)
        parts[i] = _merge(parts[i], q)
    b1, b2 = parts[0]
    base = _popc_rows(args[0]).long() - KEY_BIAS
    idx = torch.where(b1 == KEY_NONE, 0, b1 & 0xFFFF)
    best = torch.where(b1 == KEY_NONE, INVALID, (b1 >> 16) + base)
    second = torch.where(b2 == KEY_NONE, INVALID, (b2 >> 16) + base)
    return idx.to(torch.int32), best.to(torch.int32), second.to(torch.int32)


def _torch(args):
    return [to_t(a) for a in args]


def _assert_same(got, ref):
    for name, g, r in zip(("idx", "best", "second"), got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r),
                                      err_msg=name)


@pytest.mark.parametrize("n,m,dup,lo,hi", [
    (64, 300, 0.3, -1, 1), (100, 517, 0.3, -1, 1), (33, 64, 0.0, -7, 7),
    (128, 256, 0.9, 0, 0), (17, 3, 0.0, -1, 1)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1_split_merge_emulation_matches_plain_and_pallas(n, m, dup, lo, hi,
                                                           seed):
    rng = np.random.default_rng(1000 * seed + n + m)
    args = _problem(rng, n, m, dup)
    got = k1_emulate(_torch(args), lo, hi, rng)
    _assert_same(got, gm.gated_match_plain(*_torch(args), lvl_min=lo,
                                           lvl_max=hi))
    _assert_same(got, gated_match_pallas(*map(jnp.asarray, args),
                                         lvl_min=lo, lvl_max=hi,
                                         interpret=True))


def test_k1_emulation_tie_across_parts_takes_lowest_index():
    """Copies of each keypoint planted at two landmarks: whatever the
    cuts and the merge order, the lower index wins."""
    rng = np.random.default_rng(4)
    n, m = 32, 200
    args = _problem(rng, n, m)
    args[1] = np.full((n, 2), 320.0, np.float32)
    args[2] = np.zeros(n, np.int32)
    args[3] = np.ones(n, bool)
    args[6] = np.full(m, 1e4, np.float32)
    args[7] = np.zeros(m, np.int32)
    args[8] = np.ones(m, bool)
    for r in range(n):
        args[4][r] = args[4][199 - r] = args[0][r]
    for trial in range(5):
        idx, best, second = k1_emulate(_torch(args), -1, 1, rng)
        assert idx.tolist() == list(range(n))
        assert (best == 0).all() and (second == 0).all()
    _assert_same((idx, best, second), gm.gated_match_plain(*_torch(args)))


@pytest.mark.parametrize("which", [3, 8])
def test_k1_emulation_all_masked(which):
    rng = np.random.default_rng(which)
    args = _problem(rng, 40, 90)
    args[which] = np.zeros_like(args[which])
    got = k1_emulate(_torch(args), -1, 1, rng)
    assert (got[0] == 0).all()
    assert (got[1] == INVALID).all() and (got[2] == INVALID).all()
    _assert_same(got, gm.gated_match_plain(*_torch(args)))


@pytest.mark.parametrize("m", [0, 1, 2])
def test_k1_plain_fewer_than_two_landmarks_equals_pallas(m):
    """With fewer than two landmarks the runner-up is INVALID (and with
    none, the best too, at idx 0), as the Pallas kernel's padding gives."""
    rng = np.random.default_rng(m)
    args = _problem(rng, 9, m)
    if m:
        args[4][0] = args[0][0]
        args[5][0] = args[1][0]
        args[7][0] = args[2][0]
        args[8][0] = True
    args[3][0] = True
    ref = gated_match_pallas(*map(jnp.asarray, args), interpret=True)
    got = gm.gated_match(*_torch(args))          # CPU tensors: plain
    _assert_same(got, ref)
    _assert_same(k1_emulate(_torch(args), -1, 1, rng), ref)
    if m == 1:
        assert int(got[1][0]) == 0 and int(got[2][0]) == INVALID


def test_k1_emulation_level_window_wraps_as_plain():
    """The one-compare level window agrees with the plain version's two
    compares on int32 levels whose difference wraps around, and an empty
    window allows nothing."""
    rng = np.random.default_rng(12)
    args = _problem(rng, 48, 160)
    args[2] = rng.integers(-2**31, 2**31, 48).astype(np.int32)
    args[7] = rng.integers(-2**31, 2**31, 160).astype(np.int32)
    args[7][:80] = args[2][rng.integers(0, 48, 80)] - rng.integers(-2, 3, 80)
    args[6] = np.full(160, 1e4, np.float32)
    for lo, hi in [(-1, 1), (-2**31, 2**31 - 1), (2, -2), (0, 0)]:
        ref = gm.gated_match_plain(*_torch(args), lvl_min=lo, lvl_max=hi)
        _assert_same(k1_emulate(_torch(args), lo, hi, rng), ref)
    assert (ref[1] < INVALID).any()


# ---- bounds, the problem generator, the path's recorded inputs ---------


def test_k2_bound_is_the_output_write():
    ms, by = kb.k2_bound(2048, 2048)
    assert by == "bytes"
    assert ms == pytest.approx((2 * 2048 * 32 + 2048 * 2048 * 4)
                               / 3.35e12 * 1e3)


def test_k1_bound_counts_ok_pairs_on_the_integer_pipe():
    rng = np.random.default_rng(0)
    args = kb.k1_problem(rng, 2048, 2048, 0.3, "cpu")
    ms, by = kb.k1_bound(args)
    pairs = int(args[3].sum()) * int(args[8].sum())
    assert by == "operations"
    assert ms == pytest.approx(6 * pairs / (132 * 64 * 1.98e9) * 1e3)
    half = [a.clone() for a in args]
    half[3][1024:] = False                   # padding at the tail
    mean, _ = kb.k1_calls_bound([(args, -1, 1), (half, -1, 1)])
    assert mean == pytest.approx((ms + kb.k1_bound(half)[0]) / 2)
    assert kb.k1_bound(half)[0] < ms
    args[3] = torch.zeros_like(args[3])      # nothing to compare: bytes
    assert kb.k1_bound(args)[1] == "bytes"


@pytest.mark.parametrize("n,m,dup", [(5, 0, 0.3), (3, 64, 0.9), (1, 1, 0.5),
                                     (64, 64, 0.0)])
def test_k1_problem_shapes_and_planted_copies(n, m, dup):
    args = kb.k1_problem(np.random.default_rng(n + m), n, m, dup)
    assert [a.shape[0] for a in args] == [n] * 4 + [m] * 5
    assert args[0].dtype == args[4].dtype == np.int32
    h = min(max(int(m * dup), 1) // 2, n) if dup and m else 0
    np.testing.assert_array_equal(args[4][:h], args[0][:h])
    on_cpu = kb.k1_problem(np.random.default_rng(n + m), n, m, dup, "cpu")
    for a, t in zip(args, on_cpu):
        np.testing.assert_array_equal(t.numpy(), a)


def test_recording_k1_keeps_the_tracker_calls_inputs():
    """The tracker's K1 calls inside the block are kept and run as they
    would; outside it the tracker calls K1 directly again."""
    rng = np.random.default_rng(6)
    first, second = _torch(_problem(rng, 30, 70)), _torch(_problem(rng, 9, 5))
    calls = []
    with kb.recording_k1(calls):
        got = fused.gated_match(*first)
        tracking_ops.gated_match(*second, lvl_min=0, lvl_max=2)
    assert fused.gated_match is gm.gated_match
    assert tracking_ops.gated_match is gm.gated_match
    _assert_same(got, gm.gated_match_plain(*first))
    assert [(lo, hi) for _, lo, hi in calls] == [(-1, 1), (0, 2)]
    for kept, args in zip([c[0] for c in calls], [first, second]):
        assert all(torch.equal(k, a) for k, a in zip(kept, args))
    kp, lm = kb.ok_shares(calls)
    assert kp == pytest.approx((float(first[3].float().mean())
                                + float(second[3].float().mean())) / 2)
    assert 0 < lm <= 1
