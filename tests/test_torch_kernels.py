"""Kernels K1 (gated match) and K2 (Hamming matrix): their plain PyTorch
versions against the JAX package's Pallas kernels run in interpret mode,
bit for bit. The CUDA kernels themselves are checked against the plain
versions on the card by tests/test_torch_kernels_cuda.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_dynamic_tpu.ops.pallas_hamming import hamming_matrix_pallas
from slam_dynamic_tpu.ops.pallas_match import gated_match_pallas
from slam_dynamic_tpu_torch.kernel_bench import k1_problem as _problem
from slam_dynamic_tpu_torch.ops import gated_match as gm
from slam_dynamic_tpu_torch.ops import hamming as hm

INVALID = 1 << 15


def _torch(args, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(
        a.view(np.int32) if a.dtype == np.uint32 else a)).to(device)
        for a in args]


def _check_k1(ref, got):
    (ij, bj, sj), (it, bt, st) = ref, got
    np.testing.assert_array_equal(bt.cpu().numpy(), np.asarray(bj))
    np.testing.assert_array_equal(st.cpu().numpy(), np.asarray(sj))
    has = np.asarray(bj) < INVALID
    np.testing.assert_array_equal(it.cpu().numpy()[has], np.asarray(ij)[has])


@pytest.mark.parametrize("n,m,dup", [(256, 512, 0.0), (300, 700, 0.1),
                                     (512, 1024, 0.3), (64, 64, 0.0)])
def test_k1_plain_equals_pallas(n, m, dup):
    args = _problem(np.random.default_rng(n + m), n, m, dup)
    ref = gated_match_pallas(*map(jnp.asarray, args), interpret=True)
    got = gm.gated_match(*_torch(args))       # CPU tensors: plain version
    _check_k1(ref, got)


def test_k1_plain_all_masked():
    args = _problem(np.random.default_rng(7), 128, 256)
    args[8] = np.zeros(256, bool)
    ref = gated_match_pallas(*map(jnp.asarray, args), interpret=True)
    got = gm.gated_match(*_torch(args))
    _check_k1(ref, got)
    assert (got[1] == INVALID).all() and (got[2] == INVALID).all()


@pytest.mark.parametrize("lo,hi", [(0, 0), (-7, 7)])
def test_k1_plain_level_window(lo, hi):
    args = _problem(np.random.default_rng(9), 256, 512)
    ref = gated_match_pallas(*map(jnp.asarray, args), lvl_min=lo,
                             lvl_max=hi, interpret=True)
    got = gm.gated_match(*_torch(args), lvl_min=lo, lvl_max=hi)
    _check_k1(ref, got)
    _, b_narrow, _ = gm.gated_match(*_torch(args), lvl_min=0, lvl_max=0)
    assert (got[1] <= b_narrow).all()


@pytest.mark.parametrize("m,range_size", [(256, 64), (300, 7), (257, 128),
                                          (64, 63), (64, 64)])
def test_k1_landmark_ranges_merge_exactly(m, range_size):
    """gated_match_ranges (the wrapper's split above MAX_LANDMARKS, here
    with a small range) against one plain call over all landmarks, bit
    for bit, idx included: copies of each keypoint's descriptor are
    planted on both sides of range boundaries, so best and runner-up tie
    across ranges and the lowest index must win."""
    rng = np.random.default_rng(m + range_size)
    n = 128
    args = _problem(rng, n, m, 0.3)
    args[6] = np.full(m, 1e4, np.float32)      # every radius passes
    args[7] = np.zeros(m, np.int32)
    args[2] = np.zeros(n, np.int32)
    args[3] = np.ones(n, bool)
    args[8] = np.ones(m, bool)
    bounds = list(range(range_size, m, range_size)) or [m // 2]
    for r in range(n):
        b = bounds[r % len(bounds)]
        for j in (b - 1, b, min(b + 1, m - 1)):
            args[4][j] = args[0][r]
    t = _torch(args)
    ref = gm.gated_match_plain(*t)
    got = gm.gated_match_ranges(gm.gated_match_plain, t[:4], t[4:],
                                range_size)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert int((ref[1] == ref[2]).sum()) > 0        # ties were exercised


def test_accept_match_matches_reference():
    from slam_dynamic_tpu.ops.pallas_match import accept_match as jaccept
    rng = np.random.default_rng(3)
    best = rng.integers(0, 300, 500).astype(np.int32)
    second = best + rng.integers(0, 60, 500).astype(np.int32)
    ref = np.asarray(jaccept(jnp.asarray(best), jnp.asarray(second), 100,
                             0.9))
    got = gm.accept_match(torch.from_numpy(best), torch.from_numpy(second),
                          100, 0.9).numpy()
    np.testing.assert_array_equal(got, ref)


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


@pytest.mark.parametrize("n,m", [(256, 256), (300, 170), (1, 1),
                                 (2048, 512)])
def test_k2_plain_equals_pallas(n, m):
    rng = np.random.default_rng(n * 7 + m)
    a, b = _desc(rng, n), _desc(rng, m)
    ref = np.asarray(hamming_matrix_pallas(jnp.asarray(a), jnp.asarray(b),
                                           interpret=True))
    got = hm.hamming_matrix(*_torch([a, b])).numpy()
    np.testing.assert_array_equal(got, ref)


def test_k2_plain_scalar_oracle():
    rng = np.random.default_rng(1)
    a, b = _desc(rng, 64), _desc(rng, 48)
    d = hm.hamming_matrix(*_torch([a, b])).numpy()
    for i, j in rng.integers(0, (64, 48), (20, 2)):
        expect = bin(int.from_bytes(a[i].tobytes(), "little")
                     ^ int.from_bytes(b[j].tobytes(), "little")).count("1")
        assert d[i, j] == expect


def test_cpu_path_does_not_count_launches():
    rng = np.random.default_rng(2)
    before = (gm.launches, hm.launches)
    gm.gated_match(*_torch(_problem(rng, 16, 16)))
    hm.hamming_matrix(*_torch([_desc(rng, 4), _desc(rng, 5)]))
    assert (gm.launches, hm.launches) == before
