"""The plain reference's own arithmetic on synthetic cases: K1 and K2
against hand-made answers and their controls, the trajectory, depth and
box-status readings."""
import numpy as np
import torch

from portbench import reference as ref


def _desc(rng, n):
    return torch.from_numpy(rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
                            .view(np.int32))


def test_hamming_matches_bit_counts():
    rng = np.random.default_rng(0)
    a, b = _desc(rng, 5), _desc(rng, 7)
    d = ref.hamming_matrix(a, b)
    ua, ub = a.numpy().view(np.uint32), b.numpy().view(np.uint32)
    for i in range(5):
        for j in range(7):
            want = sum(bin(int(x) ^ int(y)).count("1")
                       for x, y in zip(ua[i], ub[j]))
            assert d[i, j] == want


def test_k1_and_k2_mismatch_counts_and_controls():
    rng = np.random.default_rng(1)
    n, m = 64, 48
    kp = [_desc(rng, n), torch.rand(n, 2) * 64, torch.randint(0, 3, (n,),
          dtype=torch.int32), torch.rand(n) < 0.9]
    lm = [_desc(rng, m), torch.rand(m, 2) * 64, torch.rand(m) * 20 + 2,
          torch.randint(0, 3, (m,), dtype=torch.int32), torch.rand(m) < 0.9]
    out = ref.gated_match(*kp, *lm)
    call = (kp, lm, -1, 1, list(out))
    assert ref.k1_mismatches(call) == 0
    bad = list(out)
    bad[1] = bad[1].clone()
    bad[1][0] += 1
    assert ref.k1_mismatches((kp, lm, -1, 1, bad)) == 1
    # the lane axis: two lanes of the same call
    two = ([torch.stack([t, t]) for t in kp], [torch.stack([t, t])
           for t in lm], -1, 1, [torch.stack([t, t]) for t in out])
    assert ref.k1_mismatches(two) == 0
    a, b = _desc(rng, 30), _desc(rng, 20)
    d = ref.hamming_matrix(a, b)
    assert ref.k2_mismatches((a, b, d)) == 0
    # random descriptors lie about 128 bits apart: int8 cannot hold them
    assert ref.k2_mismatches((a, b, d), int8=True) > 0


def _rot(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def test_trajectory_readings():
    n = 40
    gR = np.stack([_rot(0.01 * i) for i in range(n)])
    gc = np.stack([[0.01 * i, 0.0, 0.02 * i] for i in range(n)])
    # the program's poses: the truth in another world frame (R_cw, t_cw)
    W = _rot(0.3)
    R_cw = np.transpose(np.einsum("ij,njk->nik", W, gR), (0, 2, 1))
    c_prog = gc @ W.T + np.array([1.0, 2.0, 3.0])
    t_cw = -np.einsum("nij,nj->ni", R_cw, c_prog)
    idx = np.arange(n)
    r = ref.trajectory_check([(R_cw, t_cw, gR, gc, idx, gR[0], gc[0])])
    assert r["ate_mm"] < 1e-6 and r["rpe_mm"] < 1e-6
    assert r["frames_checked"] == n and r["pairs"] == n - 1
    frozen = ref.trajectory_check([(np.repeat(R_cw[:1], n, 0),
                                    np.repeat(t_cw[:1], n, 0), gR, gc, idx,
                                    gR[0], gc[0])])
    assert frozen["ate_mm"] > 100


def test_depth_and_status_readings():
    dmap = torch.full((10, 12), 2.0)
    xy = torch.tensor([[3.2, 4.7], [8.0, 1.0], [5.0, 5.0]])
    valid = torch.tensor([True, True, False])
    depth = torch.tensor([2.0001, 2.0, -1.0])
    r = ref.depth_check([(xy, valid, depth, dmap)], 1.0)
    assert r["depth_keypoints"] == 2
    assert abs(r["depth_err_mm"] - 0.1) < 1e-3
    assert r["control_depth_err_mm"] == 0.0     # 2.0 is a bfloat16
    assert "disparity_err_px" not in r
    # a stereo rig: bf 40 puts 2 m at 20 px; one keypoint a pixel off
    stereo = torch.tensor([2.0, 40.0 / 21.0, -1.0])
    d = ref.depth_check([(xy, valid, stereo, dmap)], 0.5, bf=40.0,
                        disparity_quantile=1.0)
    assert abs(d["disparity_err_px"] - 1.0) < 1e-4
    assert d["control_disparity_err_px"] == 0.0
    boxes = np.array([[[0, 0, 10, 10], [20, 20, 30, 30]]], np.float32)
    valid_b = np.array([[True, True]])
    moving = np.array([True, False])
    snaps = [(0, boxes[0], np.array([2, 2])), (0, boxes[0], np.array([2, 1])),
             (0, boxes[0][1:] + 100, np.array([2]))]
    s = ref.status_check(snaps, boxes, valid_b, moving)
    assert s["static_confirmed_dynamic"] == 1
    assert s["moving_confirmed_share"] == 100.0 * 2 / 3
