"""``slam_dynamic_tpu_torch.orbit_trace compare``: where two recorded
orbit runs part, on two synthetic records that differ from a known frame
and keyframe on."""
import numpy as np

from slam_dynamic_tpu_torch import orbit_trace


def _record(path, offset_from=None, offset=0.0, closures=((21, 18),)):
    n, nk, K = 30, 6, 8
    traj_tv = np.zeros((n, 3), np.float32)
    kf_t = np.zeros((nk, K, 3), np.float32)
    if offset_from is not None:
        traj_tv[offset_from:, 0] = offset
        kf_t[offset_from // 5:, 1, 0] = offset
    seqs = np.arange(1, nk + 1)
    closed = np.array([any(s == c[0] for c in closures) for s in seqs])
    np.savez(path, frame_id=np.arange(n), state=np.array(["OK"] * n),
             inliers=np.full(n, 100), traj_t=np.arange(n) / 30.0,
             traj_R=np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)),
             traj_tv=traj_tv, kf_slot=seqs - 1, kf_seq=seqs,
             kf_closed=closed,
             kf_cand=np.where(closed, [dict(closures).get(s, -1)
                                       for s in seqs], -1),
             kf_inliers=np.where(closed, 300, 0), kf_ms=np.ones(nk),
             kf_R=np.tile(np.eye(3, dtype=np.float32), (nk, K, 1, 1)),
             kf_t=kf_t, kf_valid=np.ones((nk, K), bool), ate=0.03)


def test_compare_finds_where_two_runs_part(tmp_path):
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    _record(a)
    _record(b, offset_from=12, offset=5e-4, closures=((4, 1),))
    res = orbit_trace.compare(str(a), str(b))
    assert res["first_frame_pose_diff_gt_1e-06"] == 12 / 30.0
    assert res["first_frame_pose_diff_gt_0.0001"] == 12 / 30.0
    assert res["first_frame_pose_diff_gt_0.001"] is None
    assert res["first_keyframe_event_differs"] is None
    by_seq = res["keyframe_pose_max_abs_by_seq"]
    assert by_seq[2] == 0.0 and by_seq[3] == 5e-4
    assert res["a"]["closures"] == [] and res["b"]["closures"] == [
        (4, 1, 300)]
    assert res["max_frame_pose_diff_by_10_frames"] == [0.0, 5e-4, 5e-4]
    same = orbit_trace.compare(str(a), str(a))
    assert all(same[f"first_frame_pose_diff_gt_{t:g}"] is None
               for t in (1e-6, 1e-4, 1e-3, 1e-2))
