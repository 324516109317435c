"""Kernels K1 (gated match) and K2 (Hamming matrix) on the card, bit for
bit against their plain PyTorch versions. Every test here is marked
``cuda`` and skips without a card; this file imports no JAX, so it runs on
the card's machine:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

(``--noconftest``: tests/conftest.py imports JAX for the other tests.)
"""
import numpy as np
import pytest
import torch

from slam_dynamic_tpu_torch.kernel_bench import k1_problem as _problem
from slam_dynamic_tpu_torch.ops import gated_match as gm
from slam_dynamic_tpu_torch.ops import hamming as hm

INVALID = 1 << 15


def _torch(args, device):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in args]


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,dup", [(2048, 2048, 0.3), (300, 700, 0.1),
                                     (1, 5, 0.0)])
def test_k1_kernel_equals_plain_on_card(cuda_device, n, m, dup):
    args = _torch(_problem(np.random.default_rng(n + m), n, m, dup),
                  cuda_device)
    before = gm.launches
    ik, bk, sk = gm.gated_match(*args)
    assert gm.launches == before + 1
    ip, bp, sp = gm.gated_match_plain(*args)
    assert torch.equal(bk, bp) and torch.equal(sk, sp)
    has = bp < INVALID
    assert torch.equal(ik[has], ip[has])


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(2048, 2048), (300, 170), (1, 1)])
def test_k2_kernel_equals_plain_on_card(cuda_device, n, m):
    rng = np.random.default_rng(n + m)
    a, b = _torch([_desc(rng, n), _desc(rng, m)], cuda_device)
    assert torch.equal(hm.hamming_matrix(a, b), hm.hamming_matrix_plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", [(0, 0), (-7, 7), (2, -2)])
def test_k1_kernel_level_window_on_card(cuda_device, lo, hi):
    args = _torch(_problem(np.random.default_rng(9), 2048, 2048),
                  cuda_device)
    _, bk, sk = gm.gated_match(*args, lvl_min=lo, lvl_max=hi)
    _, bp, sp = gm.gated_match_plain(*args, lvl_min=lo, lvl_max=hi)
    assert torch.equal(bk, bp) and torch.equal(sk, sp)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_input(cuda_device):
    a = torch.zeros((4, 8), dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        hm.hamming_matrix(a, a)
    b = torch.zeros((4, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        hm.hamming_matrix(b, b.t().contiguous().t())    # not contiguous


def _check_k1(args, lvl_min=-1, lvl_max=1):
    """Kernel against plain, all three outputs bit-equal (idx included:
    both give 0 where no pair passes)."""
    got = gm.gated_match(*args, lvl_min=lvl_min, lvl_max=lvl_max)
    ref = gm.gated_match_plain(*args, lvl_min=lvl_min, lvl_max=lvl_max)
    for name, k, p in zip(("idx", "best", "second"), got, ref):
        assert torch.equal(k, p), f"{name}: kernel != plain"
    return got


def _open_gates(args):
    """Every pair allowed: all ok, one level, radius over the image."""
    args[2] = torch.zeros_like(args[2])
    args[3] = torch.ones_like(args[3])
    args[6] = torch.full_like(args[6], 1e4)
    args[7] = torch.zeros_like(args[7])
    args[8] = torch.ones_like(args[8])
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(2047, 2049), (17, 4097), (1, 1), (1, 2),
                                 (33, 7), (5, 0)])
def test_k1_kernel_ragged_shapes_on_card(cuda_device, n, m):
    args = _torch(_problem(np.random.default_rng(n * 31 + m), n, m, 0.2),
                  cuda_device)
    _check_k1(args)
    _check_k1(_open_gates(args))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(2047, 2049), (17, 4097), (1, 1), (4, 0),
                                 (0, 4), (129, 130)])
def test_k2_kernel_ragged_shapes_on_card(cuda_device, n, m):
    rng = np.random.default_rng(n * 31 + m)
    a, b = _torch([_desc(rng, n), _desc(rng, m)], cuda_device)
    d = hm.hamming_matrix(a, b)
    assert d.shape == (n, m)
    assert torch.equal(d, hm.hamming_matrix_plain(a, b))


@pytest.mark.cuda
def test_kernels_edge_descriptors_on_card(cuda_device):
    """All-zero against all-ones is 256 apart, identical descriptors 0."""
    zeros = torch.zeros((3, 8), dtype=torch.int32, device=cuda_device)
    ones = torch.full((5, 8), -1, dtype=torch.int32, device=cuda_device)
    both = torch.cat([zeros, ones])
    d = hm.hamming_matrix(both, both)
    expect = torch.full((8, 8), 256, dtype=torch.int32, device=cuda_device)
    expect[:3, :3] = 0
    expect[3:, 3:] = 0
    assert torch.equal(d, expect)
    # K1 with open gates: keypoint 0 is all-zero, 1 all-ones; landmarks
    # alternate all-ones / all-zero, so the best is at distance 0 and the
    # lowest index of its kind, the runner-up 0 as well
    args = _torch(_problem(np.random.default_rng(3), 2, 64), cuda_device)
    args[0] = torch.stack([zeros[0], ones[0]])
    args[4] = torch.stack([ones[0], zeros[0]] * 32)
    idx, best, second = _check_k1(_open_gates(args))
    assert idx.tolist() == [1, 0] and best.tolist() == [0, 0]
    assert second.tolist() == [0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2048, 4097])
def test_k1_kernel_tie_across_splits_on_card(cuda_device, m):
    """A keypoint's exact copy planted at two landmarks, lo < hi: in one
    8-landmark tile (1 apart), in neighbouring tiles, which different
    blocks of the cluster take (8), in the two warps of one block (64), in
    one warp (128) and far apart. The lower index must win."""
    n = 256
    rng = np.random.default_rng(m)
    args = _problem(rng, n, m)
    lo = rng.integers(0, m // 2 - 256, n)
    gap = np.array([1, 8, 64, 128, 0])[np.arange(n) % 5]
    hi = np.where(gap > 0, lo + gap, rng.integers(m // 2, m, n))
    kp, lm = args[0].copy(), args[4].copy()
    for r in range(n):
        lm[hi[r]] = kp[r]
    for r in range(n):
        lm[lo[r]] = kp[r]
    args[0], args[4] = kp, lm
    idx, best, second = _check_k1(_open_gates(_torch(args, cuda_device)))
    # rows whose two copies were not overwritten by another row's plant
    keep = [r for r in range(n) if np.array_equal(lm[lo[r]], kp[r])
            and np.array_equal(lm[hi[r]], kp[r])]
    assert len(keep) > n // 2
    assert (best[keep] == 0).all() and (second[keep] == 0).all()
    assert idx[keep].tolist() == [int(lo[r]) for r in keep]


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["keypoints", "landmarks"])
def test_k1_kernel_all_masked_on_card(cuda_device, which):
    args = _torch(_problem(np.random.default_rng(11), 300, 2048),
                  cuda_device)
    k = 3 if which == "keypoints" else 8
    args[k] = torch.zeros_like(args[k])
    idx, best, second = _check_k1(args)
    assert (idx == 0).all()
    assert (best == INVALID).all() and (second == INVALID).all()


@pytest.mark.cuda
def test_k1_kernel_landmark_limit_on_card(cuda_device):
    """M at the key-packing limit works in one launch, with the best
    planted at the last index; one landmark more is split into two
    launches whose merge is bit-exact with the plain version."""
    n, m = 64, gm.MAX_LANDMARKS
    rng = np.random.default_rng(5)
    args = _problem(rng, n, m)
    args[4][m - 1] = args[0][0]
    args = _open_gates(_torch(args, cuda_device))
    before = gm.launches
    idx, best, _ = _check_k1(args)
    assert gm.launches == before + 1
    assert int(idx[0]) == m - 1 and int(best[0]) == 0
    more = _torch(_problem(rng, n, m + 1), cuda_device)
    before = gm.launches
    got = gm.gated_match(*more)
    assert gm.launches == before + 2
    for k, p in zip(got, gm.gated_match_plain(*more)):
        assert torch.equal(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [gm.MAX_LANDMARKS + 1,
                               2 * gm.MAX_LANDMARKS + 3])
def test_k1_kernel_above_landmark_limit_on_card(cuda_device, m):
    """Above MAX_LANDMARKS the wrapper runs K1 on equal landmark ranges and
    merges them: bit-exact with the plain version, idx included, with
    copies of keypoint descriptors planted on both sides of each range
    boundary so the best and the runner-up tie across ranges."""
    n = 96
    rng = np.random.default_rng(m)
    args = _problem(rng, n, m, 0.1)
    n_ranges = -(-m // gm.MAX_LANDMARKS)
    size = -(-m // n_ranges)
    for r in range(n):
        b = size * (1 + r % (n_ranges - 1 or 1))
        for j in (b - 1, min(b, m - 1)):
            args[4][j] = args[0][r]
    args = _open_gates(_torch(args, cuda_device))
    before = gm.launches
    got = gm.gated_match(*args)
    assert gm.launches == before + n_ranges
    ref = gm.gated_match_plain(*args)
    torch.cuda.synchronize()
    for k, p in zip(got, ref):
        assert torch.equal(k, p)
    assert bool((ref[1] == 0).any() and (ref[2] == 0).any())


@pytest.mark.cuda
def test_kernel_wrapper_rejects_misaligned_descriptors(cuda_device):
    flat = torch.zeros(8 * 5, dtype=torch.int32, device=cuda_device)
    shifted = flat[1:33].view(4, 8)          # 4-byte aligned only
    with pytest.raises(ValueError):
        hm.hamming_matrix(shifted, shifted)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["keypoint_tail", "keypoint_block",
                                  "landmark_tail", "landmark_tiles", "both"])
def test_k1_kernel_skips_gated_out_work_on_card(cuda_device, case):
    """Inputs shaped like the path's: keypoints gated out at the tail (the
    padding of a frame's keypoints) or in one whole block of 32, landmarks
    gated out at the tail or in whole 8-landmark tiles, with single ok
    landmarks left in some tiles. The skipped work must not change a bit."""
    rng = np.random.default_rng(len(case))
    args = _problem(rng, 2048, 2048, 0.2)
    if case in ("keypoint_tail", "both"):
        args[3][1001:] = False
    if case == "keypoint_block":
        args[3][64:96] = False
    if case in ("landmark_tail", "both"):
        args[8][1500:] = False
    if case in ("landmark_tiles", "both"):
        tiles = args[8][:1496].reshape(-1, 8)
        off = rng.uniform(size=len(tiles)) < 0.6
        tiles[off] = False
        single = off & (rng.uniform(size=len(tiles)) < 0.3)
        tiles[single, rng.integers(0, 8, int(single.sum()))] = True
    targs = _torch(args, cuda_device)
    _check_k1(targs)
    # radius and level gates open: the ok flags alone decide
    targs[2] = torch.zeros_like(targs[2])
    targs[6] = torch.full_like(targs[6], 1e4)
    targs[7] = torch.zeros_like(targs[7])
    _check_k1(targs)


def _frame_pair_data(rng, n=2048, n_valid=1000):
    """Reference and current descriptors as a dynamic step sees them:
    ``n_valid`` keypoints then invalid slots (all-zero descriptors, as
    padding and the placeholder reference frame hold), with a share of
    the current frame's keypoints re-observed with a few bits flipped."""
    ref = np.zeros((n, 8), np.int32)
    cur = np.zeros((n, 8), np.int32)
    ref[:n_valid] = _desc(rng, n_valid)
    cur[:n_valid] = _desc(rng, n_valid)
    seen = rng.permutation(n_valid)[:600]
    flips = (rng.random((600, 8, 32)) < 0.03)
    bits = (flips * (1 << np.arange(32, dtype=np.int64))).sum(-1)
    cur[seen] = ref[seen] ^ bits.astype(np.uint32).view(np.int32)
    valid_r = np.zeros(n, bool)
    valid_c = np.zeros(n, bool)
    valid_r[:n_valid] = valid_c[:n_valid] = True
    return ref, cur, valid_r, valid_c


@pytest.mark.cuda
def test_k2_on_a_dynamic_frame_pair_on_card(cuda_device):
    """K2 at [2048, 2048] on a reference/current pair with invalid slots,
    and the placeholder reference of all-zero descriptors."""
    ref, cur, _, _ = _frame_pair_data(np.random.default_rng(7))
    a, b = _torch([ref, cur], cuda_device)
    before = hm.launches
    d = hm.hamming_matrix(a, b)
    assert hm.launches == before + 1
    assert torch.equal(d, hm.hamming_matrix_plain(a, b))
    z = torch.zeros_like(a)
    assert torch.equal(hm.hamming_matrix(z, b), hm.hamming_matrix_plain(z, b))


@pytest.mark.cuda
def test_match_nn_on_transposed_k2_view_on_card(cuda_device):
    """The in-box matcher reads K2's output transposed (current x
    reference): match_nn and the rotation filter on that view give what
    the plain path gives on the CPU."""
    from slam_dynamic_tpu_torch.frontend.dynamics_ops import _match_from
    rng = np.random.default_rng(8)
    ref, cur, vr, vc = _frame_pair_data(rng)
    in_box = rng.random(2048) < 0.3
    ang_r = rng.uniform(0, 6.28, 2048).astype(np.float32)
    ang_c = ang_r + rng.normal(0, 0.05, 2048).astype(np.float32)
    cpu = torch.device("cpu")
    out = {}
    for dev in (cuda_device, cpu):
        a, b, mr, mc, br, ar, ac = _torch(
            [ref, cur, vr, vc & in_box, vr, ang_r, ang_c], dev)
        d = hm.hamming_matrix(a, b)            # [ref, cur]
        out[dev.type] = _match_from(d.t(), mc, mr, ac, ar, max_dist=64,
                                    ratio=0.9)
    idx_k, ok_k = (x.cpu() for x in out["cuda"])
    idx_p, ok_p = out["cpu"]
    assert ok_p.sum() > 100
    assert torch.equal(ok_k, ok_p)
    assert torch.equal(idx_k[ok_p], idx_p[ok_p])


@pytest.mark.cuda
def test_ransac_draws_equal_on_card_and_cpu(cuda_device):
    """The port's hashed RANSAC draws do not depend on the device."""
    from slam_dynamic_tpu_torch.ops.ransac import sample_indices
    mask = torch.from_numpy(np.random.default_rng(9).random(2048) < 0.4)
    seed = torch.tensor(-123456, dtype=torch.int32)
    for k, stream in ((4, 0), (8, 1)):
        c = sample_indices(seed, stream, 256, k, mask)
        g = sample_indices(seed.to(cuda_device), stream, 256, k,
                           mask.to(cuda_device))
        assert torch.equal(c, g.cpu())


@pytest.mark.cuda
def test_pnp_and_sim3_draws_equal_on_card_and_cpu(cuda_device):
    """The PnP (stream 2) and Sim3 (stream 3) samples of relocalization
    and loop verification, drawn from the same seed, do not depend on the
    device."""
    from slam_dynamic_tpu_torch.ops.pnp import PNP_STREAM
    from slam_dynamic_tpu_torch.ops.horn import SIM3_STREAM
    from slam_dynamic_tpu_torch.ops.ransac import sample_indices
    mask = torch.from_numpy(np.random.default_rng(10).random(2048) < 0.1)
    for k, stream, seed in ((6, PNP_STREAM, 7), (3, SIM3_STREAM, 1234 + 17),
                            (3, SIM3_STREAM, 4321 + 17)):
        s = torch.tensor(seed, dtype=torch.int64)
        c = sample_indices(s, stream, 128, k, mask)
        g = sample_indices(s.to(cuda_device), stream, 128, k,
                           mask.to(cuda_device))
        assert torch.equal(c, g.cpu())
        assert bool(mask[c].all())


@pytest.mark.cuda
def test_pose_graph_solve_on_card_matches_cpu(cuda_device):
    """The essential-graph solve at bench capacity (128 keyframes, an
    896 x 896 system, 4096 padded edges with duplicates): the card's
    result within 1e-4 of the CPU's (the scatter-add's order of sums is
    not fixed on the card)."""
    from slam_dynamic_tpu_torch.optim import pose_graph as pg
    from slam_dynamic_tpu_torch.utils import sim3 as s3
    rng = np.random.default_rng(11)
    K, n_kf, E = 128, 100, 4096
    phi = rng.normal(0, 0.3, (K, 3)).astype(np.float32)
    R = s3.so3_exp(torch.from_numpy(phi))
    t = torch.from_numpy(rng.normal(0, 1.0, (K, 3)).astype(np.float32))
    pairs = [(k, k - 1) for k in range(1, n_kf)] + [(n_kf - 1, 0)] * 2
    pairs += [tuple(rng.integers(0, n_kf, 2)) for _ in range(300)]
    e_i = np.zeros(E, np.int64)
    e_j = np.zeros(E, np.int64)
    e_i[:len(pairs)], e_j[:len(pairs)] = zip(*pairs)
    valid_e = np.zeros(E, bool)
    valid_e[:len(pairs)] = e_i[:len(pairs)] != e_j[:len(pairs)]
    # measurements from perturbed poses: the graph has something to fix
    Rm = s3.so3_exp(torch.from_numpy(rng.normal(0, 0.02, (K, 3)).astype(
        np.float32))) @ R
    ei, ej = torch.from_numpy(e_i), torch.from_numpy(e_j)
    meas_R = Rm[ej] @ Rm[ei].transpose(-1, -2)
    meas_t = t[ej] - (meas_R @ t[ei][..., None])[..., 0] + 0.01
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[0] = True
    problem = pg.PoseGraphProblem(
        s=torch.ones(K), R=R, t=t, fixed=fixed,
        valid=torch.arange(K) < n_kf, e_i=ei, e_j=ej, e_s=torch.ones(E),
        e_R=meas_R, e_t=meas_t, e_valid=torch.from_numpy(valid_e),
        e_weight=torch.where(torch.from_numpy(valid_e), 1.0, 0.0))
    cpu = pg.optimize_pose_graph(problem, iters=20, fix_scale=True)
    gpu = pg.optimize_pose_graph(problem._replace(**{
        f: getattr(problem, f).to(cuda_device)
        for f in problem._fields}), iters=20, fix_scale=True)
    for a, b in zip(cpu, gpu):
        assert (a - b.cpu()).abs().max() < 1e-4
    assert (cpu[2] - t).abs().max() > 1e-3          # the graph moved


@pytest.mark.cuda
def test_k2_on_a_loop_projection_pair_on_card(cuda_device):
    """K2 at the loop-projection count's shape: 4096 loop-neighbourhood
    landmark descriptors (rows past the set's end are zero, the padding
    of ``_loop_landmark_set``) against a keyframe's 2048 keypoints with
    invalid slots, bit-equal with its plain version."""
    rng = np.random.default_rng(12)
    lm = _desc(rng, 4096)
    lm[3000:] = 0
    kp = _desc(rng, 2048)
    kp[1700:] = 0
    a, b = _torch([lm, kp], cuda_device)
    before = hm.launches
    d = hm.hamming_matrix(a, b)
    assert hm.launches == before + 1
    assert d.shape == (4096, 2048)
    assert torch.equal(d, hm.hamming_matrix_plain(a, b))


def _gba_map(device, rng):
    """tests/test_sharded_ba.py's perturbed map in the port's own
    functions: 3 keyframes observing 48 landmarks, the later poses and
    every landmark perturbed, then keyframe 3 inserted after the
    snapshot (the live map), covisible with the snapshot's keyframes."""
    from slam_dynamic_tpu_torch.config import CapacityConfig
    from slam_dynamic_tpu_torch.utils import se3
    from slam_dynamic_tpu_torch.utils.camera import Intrinsics, project_stereo
    from slam_dynamic_tpu_torch.worldmap import state
    cam = Intrinsics.create(500.0, 500.0, 320.0, 240.0, bf=50.0, width=640,
                            height=480, device=device)
    m = state.empty_map(CapacityConfig(max_keyframes=8, max_landmarks=64,
                                       max_keypoints=64), device)
    L, f32, i32 = 48, torch.float32, torch.int32
    pts = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                    rng.uniform(4, 9, L)], 1).astype(np.float32)

    def T(a, dt=f32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    slots = T(np.arange(64) < L, torch.bool)
    zeros = torch.zeros(64, dtype=f32, device=device)
    desc = torch.zeros((64, 8), dtype=i32, device=device)
    obs = T(np.where(np.arange(64) < L, np.arange(64), -1), i32)
    rows = []
    for k in range(4):
        xi = T([0.3 * min(k, 2), 0, 0, 0, 0.01 * min(k, 2), 0])
        R, t = se3.se3_exp(xi)
        xc = T(pts) @ R.T + t
        uvr = project_stereo(cam, xc)
        xy = torch.zeros((64, 2), dtype=f32, device=device)
        xy[:L] = uvr[:, :2]
        ur = torch.full((64,), -1.0, dtype=f32, device=device)
        ur[:L] = uvr[:, 2]
        dep = torch.full((64,), -1.0, dtype=f32, device=device)
        dep[:L] = xc[:, 2]
        if k in (1, 2):
            R, t = se3.se3_retract(R, t, T(np.concatenate(
                [rng.normal(0, 0.05, 3), rng.normal(0, 0.01, 3)])))
        if k == 3:
            t = t + T([0.05, 0, 0])
        rows.append((R, t, xy, ur, dep))
    for k, (R, t, xy, ur, dep) in enumerate(rows):
        m = state.insert_keyframe(
            m, R, t, k, 0.1 * k, xy, torch.zeros(64, dtype=i32,
                                                 device=device), zeros,
            desc, slots, ur, dep, obs if k else torch.full_like(obs, -1))
        if k == 0:
            m = state.add_landmarks(
                m, T(pts + rng.normal(0, 0.1, pts.shape)), desc[:L],
                T(np.tile([0.0, 0, 1], (L, 1))), torch.full((L,), 0.5,
                                                             device=device),
                torch.full((L,), 50.0, device=device),
                torch.zeros(L, dtype=i32, device=device),
                torch.arange(L, dtype=i32, device=device),
                torch.ones(L, dtype=torch.bool, device=device))
        if k == 2:
            snap = m
    return cam, snap, m


@pytest.mark.cuda
def test_global_ba_on_card_matches_cpu(cuda_device):
    """AmortizedGBA (4 slices of 3 GN iterations) and its merge on the
    card against the CPU on the same seeded map: poses within 1e-4,
    points within 1e-3 (the order of the scatter-adds' sums is not fixed
    on the card); the new keyframe's parent is the lowest keyframe of the
    covisibility tie on both."""
    from slam_dynamic_tpu_torch.backend.global_ba import AmortizedGBA
    out = {}
    for dev in ("cpu", cuda_device):
        cam, snap, live = _gba_map(dev, np.random.default_rng(4))
        solve = AmortizedGBA(snap, cam, stereo=True, total_iters=12,
                             slice_iters=3)
        while not solve.done:
            solve.step()
        covis = live.covis[3, :3]
        assert int((covis == covis.max()).sum()) >= 2
        out[str(dev)] = (solve.merge(live), live,
                         int(torch.argmax(covis)))
    (c, live, pc), (g, _, pg) = out["cpu"], out[str(cuda_device)]
    assert pc == pg == 0
    for f, tol in (("kf_R", 1e-4), ("kf_t", 1e-4), ("lm_pos", 1e-3)):
        assert (getattr(c, f) - getattr(g, f).cpu()).abs().max() < tol, f
    assert (c.kf_t - live.kf_t).abs().max() > 1e-3       # the solve moved


def _lane_stack(per):
    return [torch.stack(x) for x in zip(*per)]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n,m,dup", [(4, 2048, 2048, 0.3),
                                           (4, 2048, 4096, 0.1),
                                           (3, 300, 700, 0.1), (2, 1, 5, 0.0)])
def test_k1_batched_equals_single_launches_on_card(cuda_device, lanes, n, m,
                                                   dup):
    """One launch of K1 with a lane axis: bit-equal with B single launches
    and with the plain per-lane loop, idx included."""
    rng = np.random.default_rng(lanes * n + m)
    per = [_torch(_problem(rng, n, m, dup), cuda_device)
           for _ in range(lanes)]
    args = _lane_stack(per)
    before, batched = gm.launches, gm.batched_launches
    got = gm.gated_match_batched(*args)
    assert (gm.launches, gm.batched_launches) == (before + 1, batched + 1)
    plain = gm.gated_match_batched_plain(*args)
    assert all(torch.equal(k, p) for k, p in zip(got, plain))
    for b in range(lanes):
        single = gm.gated_match(*per[b])
        assert all(torch.equal(k[b], s) for k, s in zip(got, single))


@pytest.mark.cuda
def test_k1_vmap_is_one_batched_launch_on_card(cuda_device):
    """Under torch.func.vmap the custom op's rule makes one batched
    launch, also with an argument shared by every lane."""
    rng = np.random.default_rng(3)
    per = [_torch(_problem(rng, 2048, 2048, 0.2), cuda_device)
           for _ in range(4)]
    args = _lane_stack(per)
    before = gm.launches
    got = torch.func.vmap(gm.gated_match)(*args)
    shared = torch.func.vmap(gm.gated_match, in_dims=(0,) * 4 + (None,) * 5)(
        *args[:4], *per[0][4:])
    assert gm.launches == before + 2
    plain = gm.gated_match_batched_plain(*args)
    assert all(torch.equal(k, p) for k, p in zip(got, plain))
    plain = gm.gated_match_batched_plain(
        *args[:4], *(a.expand(4, *a.shape) for a in per[0][4:]))
    assert all(torch.equal(k, p) for k, p in zip(shared, plain))


@pytest.mark.cuda
def test_k1_batched_above_landmark_limit_on_card(cuda_device):
    """Above MAX_LANDMARKS the batched form runs one batched launch per
    landmark range and merges them exactly."""
    rng = np.random.default_rng(5)
    m = gm.MAX_LANDMARKS + 300
    per = [_torch(_problem(rng, 64, m, 0.2), cuda_device) for _ in range(2)]
    args = _lane_stack(per)
    before = gm.launches
    got = gm.gated_match_batched(*args)
    assert gm.launches == before + 2
    plain = gm.gated_match_batched_plain(*args)
    assert all(torch.equal(k, p) for k, p in zip(got, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n,m", [(2, 1000, 1000), (4, 2048, 2048),
                                       (3, 300, 170), (2, 1, 1)])
def test_k2_batched_equals_single_launches_on_card(cuda_device, lanes, n, m):
    rng = np.random.default_rng(lanes + n + m)
    a = torch.stack(_torch([_desc(rng, n) for _ in range(lanes)],
                           cuda_device))
    b = torch.stack(_torch([_desc(rng, m) for _ in range(lanes)],
                           cuda_device))
    before, batched = hm.launches, hm.batched_launches
    got = hm.hamming_matrix_batched(a, b)
    vm = torch.func.vmap(hm.hamming_matrix)(a, b)
    assert (hm.launches, hm.batched_launches) == (before + 2, batched + 2)
    assert torch.equal(got, hm.hamming_matrix_batched_plain(a, b))
    assert torch.equal(vm, got)
    for i in range(lanes):
        assert torch.equal(got[i], hm.hamming_matrix(a[i], b[i]))
