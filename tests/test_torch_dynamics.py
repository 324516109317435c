"""The dynamic-object modules of the port against the JAX package's:
``ops/nullspace`` (``inv3``, ``rank2_project``), ``ops/pointcloud``
(``eigh3x3``, ``obb_from_points``), ``frontend/dynamics_ops``
(``classify_boxes``, ``box_3d_state``, ``reinstate_features``; and
``kernel_bench.recording_k2`` on a classification),
``frontend/boxtrack`` and the host half of ``frontend/dynamics``, on the
same numpy-seeded inputs; JAX on the CPU, the port with CPU tensors.
Frames are built by JAX from the 320x240 moving-object and falsely boxed
worlds (``tests/test_e2e_dynamic.py``) and carried across by
``convert.frame_data_from_numpy``.

Tolerances: inv3 and rank2_project to 1e-4 relative; eigenvalues to
1e-4 relative, eigenvectors and OBB axes up to sign to 1e-3, an empty
mask NaN in both (equal_nan); box_3d_state's centre depth exact and the
OBB centre and extents to 1e-4 m; classify_boxes with JAX's RANSAC
samples injected: verdicts equal, n_pass and n_fail within 1;
reinstate_features, box tracking and the streak and 3D-state
bookkeeping exact (floats to 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_dynamic_tpu.frontend import boxtrack as jbt
from slam_dynamic_tpu.frontend import dynamics_ops as jdo
from slam_dynamic_tpu.frontend.dynamics import DynamicsModule as JDyn
from slam_dynamic_tpu.frontend.frame import build_frame as jbuild
from slam_dynamic_tpu.ops import hamming as jhm
from slam_dynamic_tpu.ops import nullspace as jns
from slam_dynamic_tpu.ops import pointcloud as jpc
from slam_dynamic_tpu.ops import ransac as jr
from slam_dynamic_tpu.system import intrinsics_from_config as jintr
from slam_dynamic_tpu_torch import kernel_bench as kb
from slam_dynamic_tpu_torch.convert import box_state_from_numpy
from slam_dynamic_tpu_torch.frontend import boxtrack as tbt
from slam_dynamic_tpu_torch.frontend import dynamics_ops as tdo
from slam_dynamic_tpu_torch.frontend.dynamics import DynamicsModule as TDyn
from slam_dynamic_tpu_torch.frontend.frame import build_frame as tbuild
from slam_dynamic_tpu_torch.io.synthetic import SynthConfig, generate
from slam_dynamic_tpu_torch.ops import hamming as thm
from slam_dynamic_tpu_torch.ops import nullspace as tns
from slam_dynamic_tpu_torch.ops import pointcloud as tpc
from slam_dynamic_tpu_torch.system import intrinsics_from_config as tintr
from torch_port_util import SMALL, configs, frame_to_t, to_t

N_HYP = 256
WORLDS = {
    "moving": dict(dynamic_object=True, obj_size=1.6, obj_depth=3.0,
                   obj_speed=0.09),
    "static_box": dict(dynamic_object=True, obj_size=1.4, obj_depth=3.5,
                       obj_speed=0.0, obj_x0=0.0, obj_bob=0.0),
}


def _rel_close(got, want, rtol):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert np.abs(np.asarray(got) - want).max() <= rtol * scale


def test_inv3_and_rank2_project_match_jax(rng):
    M = rng.normal(0, 1, (64, 3, 3)).astype(np.float32)
    M += 5 * np.eye(3, dtype=np.float32)     # well conditioned
    inv_t = tns.inv3(to_t(M)).numpy()
    _rel_close(inv_t, jns.inv3(jnp.asarray(M)), 1e-4)
    np.testing.assert_allclose(inv_t @ M, np.broadcast_to(np.eye(3),
                                                          M.shape),
                               atol=1e-4)
    # singular values 3, 1 and a small third: the least singular vectors
    # are well separated
    U = np.linalg.qr(rng.normal(0, 1, (64, 3, 3)))[0]
    V = np.linalg.qr(rng.normal(0, 1, (64, 3, 3)))[0]
    F = (U * np.array([3.0, 1.0, 0.05]) @ V).astype(np.float32)
    Ft = tns.rank2_project(to_t(F)).numpy()
    _rel_close(Ft, jns.rank2_project(jnp.asarray(F)), 1e-4)
    assert (np.linalg.svd(Ft.astype(np.float64), compute_uv=False)[:, 2]
            < 1e-4).all()


def _up_to_sign(a, b, axis):
    """Flip each vector of b (along ``axis``) to a's sign."""
    s = np.sign((a * b).sum(axis, keepdims=True))
    return b * np.where(s == 0, 1, s)


def test_eigh3x3_matches_jax(rng):
    X = rng.normal(0, 1, (128, 3, 5)).astype(np.float32)
    A = X @ np.swapaxes(X, 1, 2)
    A[0] = np.diag([1.0, 2.0, 2.0]).astype(np.float32)   # a repeated value
    ej, vj = (np.asarray(x) for x in jpc.eigh3x3(jnp.asarray(A)))
    et, vt = (x.numpy() for x in tpc.eigh3x3(to_t(A)))
    _rel_close(et, ej, 1e-4)
    np.testing.assert_allclose(_up_to_sign(vj, vt, -2), vj, atol=1e-3)
    np.testing.assert_allclose(np.linalg.eigvalsh(A.astype(np.float64)),
                               et, rtol=1e-3, atol=1e-3)


def test_obb_from_points_matches_jax(rng):
    pts = (rng.normal(0, 1, (400, 3)) * [1.5, 0.6, 0.2]
           + [0.3, -0.2, 3.0]).astype(np.float32)
    masks = rng.random((6, 400)) < [[0.9], [0.5], [0.1], [0.02], [0.0],
                                    [1.0]]
    jo = jax.vmap(lambda mk: jpc.obb_from_points(jnp.asarray(pts), mk))(
        jnp.asarray(masks))
    to = tpc.obb_from_points(to_t(pts), to_t(masks))
    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
    np.testing.assert_allclose(to.center.numpy(), np.asarray(jo.center),
                               atol=1e-4, equal_nan=True)
    np.testing.assert_allclose(to.extents.numpy(), np.asarray(jo.extents),
                               atol=1e-4, equal_nan=True)
    aj = np.asarray(jo.axes)
    np.testing.assert_allclose(_up_to_sign(aj, to.axes.numpy(), -1), aj,
                               atol=1e-3, equal_nan=True)
    assert np.isnan(to.center.numpy()[4]).all()       # the empty mask


@pytest.fixture(scope="module", params=sorted(WORLDS))
def pair(request):
    """Frames 0 and 7 (0.23 s apart: the reference-frame age) of a 320x240
    dynamic world, built by JAX with the object's box quarantining."""
    scfg = SynthConfig(**{**SMALL, "n_frames": 8}, **WORLDS[request.param])
    seq = generate(scfg)
    gray8 = np.clip(seq.gray, 0, 255).astype(np.uint8)
    depth16 = np.clip(seq.depth * 1000.0, 0, 65535).astype(np.uint16)
    jcfg, tcfg = configs(scfg)
    jcam = jintr(jcfg)
    frames = [jbuild(jcfg, jcam, gray8[i], i, float(seq.timestamps[i]),
                     depth_map=depth16[i], boxes=seq.boxes[i],
                     box_valid=seq.box_valid[i]).data for i in (0, 7)]
    B = jcfg.dynamic.max_boxes
    boxes = np.full((B, 4), -1.0, np.float32)
    boxes[0] = seq.boxes[7][0]
    valid = np.zeros(B, bool)
    valid[0] = bool(seq.box_valid[7][0])
    assert valid[0]
    return dict(world=request.param, seq=seq, gray8=gray8, depth16=depth16,
                jcfg=jcfg, tcfg=tcfg, jcam=jcam, tcam=tintr(tcfg, "cpu"),
                frames=frames, boxes=boxes, valid=valid)


def test_build_frame_quarantines_boxes_like_jax(pair):
    p = pair
    ft = tbuild(p["tcfg"], p["tcam"], p["gray8"][7], 7, 0.0,
                p["depth16"][7], p["seq"].boxes[7],
                p["seq"].box_valid[7]).data
    fj = p["frames"][1]
    same = (np.asarray(fj.xy_raw) == ft.xy_raw.numpy()).all(1)
    assert same.mean() >= 0.99
    sm_j = np.asarray(fj.static_mask)
    np.testing.assert_array_equal(ft.static_mask.numpy()[same], sm_j[same])
    assert (np.asarray(fj.valid) & ~sm_j).sum() >= 20   # keypoints boxed


def _jax_samples(p, seed):
    """The RANSAC minimal sets JAX's classify_boxes draws for this seed
    (its background-pair mask recomputed the same way)."""
    ref, cur = p["frames"]
    dist = jhm.hamming_matrix(ref.desc, cur.desc)
    _, ok = jdo._match_from(dist, ref.valid & ref.static_mask,
                            cur.valid & cur.static_mask, ref.angle,
                            cur.angle, max_dist=64, ratio=0.8)
    kh, kf = jax.random.split(jax.random.PRNGKey(seed))
    n = ref.xy.shape[0]
    return (to_t(jr._sample_indices(kh, N_HYP, 4, n, ok)).long(),
            to_t(jr._sample_indices(kf, N_HYP, 8, n, ok)).long())


def test_classify_boxes_matches_jax(pair):
    p = pair
    seed = 11
    vj = jdo.classify_boxes(p["jcam"], p["frames"][0], p["frames"][1],
                            jnp.asarray(p["boxes"]), jnp.asarray(p["valid"]),
                            n_hyp=N_HYP, seed=seed)
    vt = tdo.classify_boxes(p["tcam"], frame_to_t(p["frames"][0]),
                            frame_to_t(p["frames"][1]), to_t(p["boxes"]),
                            to_t(p["valid"]), n_hyp=N_HYP,
                            sample_idx=_jax_samples(p, seed))
    np.testing.assert_array_equal(vt.verdict.numpy(),
                                  np.asarray(vj.verdict))
    assert np.abs(vt.n_pass.numpy() - np.asarray(vj.n_pass)).max() <= 1
    assert np.abs(vt.n_fail.numpy() - np.asarray(vj.n_fail)).max() <= 1
    assert bool(vt.used_homography) == bool(vj.used_homography)
    assert abs(int(vt.n_bg_inliers) - int(vj.n_bg_inliers)) <= 1
    want = {"moving": 2, "static_box": 1}[p["world"]]
    assert int(vt.verdict[0]) == want
    assert (vt.verdict.numpy()[1:] == 0).all()


def test_classify_boxes_own_samples_agree(pair):
    """The port's own draws (a device seed) reach the same verdict."""
    p = pair
    vt = tdo.classify_boxes(p["tcam"], frame_to_t(p["frames"][0]),
                            frame_to_t(p["frames"][1]), to_t(p["boxes"]),
                            to_t(p["valid"]), n_hyp=N_HYP,
                            seed=torch.tensor(11, dtype=torch.int32))
    want = {"moving": 2, "static_box": 1}[p["world"]]
    assert int(vt.verdict[0]) == want


def test_recording_k2_keeps_the_classification_inputs(pair):
    """Inside the block a classification's one K2 call keeps a copy of
    its input pair (ref, cur) and runs as it would; outside it the
    classification calls K2 directly again."""
    p = pair
    ref, cur = (frame_to_t(f) for f in p["frames"])
    args = (p["tcam"], ref, cur, to_t(p["boxes"]), to_t(p["valid"]))
    calls = []
    with kb.recording_k2(calls):
        got = tdo.classify_boxes(*args, n_hyp=N_HYP,
                                 sample_idx=_jax_samples(p, 11))
    assert tdo.hamming_matrix is thm.hamming_matrix
    assert len(calls) == 1
    assert torch.equal(calls[0][0], ref.desc)
    assert torch.equal(calls[0][1], cur.desc)
    want = tdo.classify_boxes(*args, n_hyp=N_HYP,
                              sample_idx=_jax_samples(p, 11))
    assert torch.equal(got.verdict, want.verdict)


def test_box_3d_state_matches_jax(pair):
    p = pair
    fd = p["frames"][1]
    boxes = p["boxes"].copy()
    boxes[1] = [0.0, 0.0, 3.0, 3.0]      # a box with no depth keypoint
    active = p["valid"].copy()
    active[1] = True
    bj = np.asarray(jdo.box_3d_state(p["jcam"], fd, jnp.asarray(boxes),
                                     jnp.asarray(active)))
    bt = tdo.box_3d_state(p["tcam"], frame_to_t(fd), to_t(boxes),
                          to_t(active)).numpy()
    assert bt.shape == (16, 16)
    np.testing.assert_array_equal(bt[:, 0], bj[:, 0])
    assert bt[0, 0] > 0 and bt[1, 0] == -1.0
    np.testing.assert_allclose(bt[:, 1:4], bj[:, 1:4], atol=1e-4,
                               equal_nan=True)
    np.testing.assert_allclose(bt[:, 13:16], bj[:, 13:16], atol=1e-4,
                               equal_nan=True)
    aj = bj[:, 4:13].reshape(16, 3, 3)
    at = bt[:, 4:13].reshape(16, 3, 3)
    np.testing.assert_allclose(_up_to_sign(aj, at, -1), aj, atol=1e-3,
                               equal_nan=True)


def test_reinstate_features_matches_jax(pair):
    p = pair
    fd = p["frames"][1]
    static = p["valid"].copy()
    fj = jdo.reinstate_features(fd, jnp.asarray(p["boxes"]),
                                jnp.asarray(static))
    ft = tdo.reinstate_features(frame_to_t(fd), to_t(p["boxes"]),
                                to_t(static))
    np.testing.assert_array_equal(ft.static_mask.numpy(),
                                  np.asarray(fj.static_mask))
    assert ft.static_mask.sum() > frame_to_t(fd).static_mask.sum()


def _det_sequence(rng, T=40):
    """Detections of up to 3 objects drifting across 640x480, with drops
    and an object appearing late."""
    base = np.array([[50, 60, 150, 200], [300, 100, 380, 260],
                     [500, 300, 600, 420]], np.float32)
    vel = np.array([[6, 1, 6, 1], [-3, 2, -3, 2], [0, -4, 0, -4]],
                   np.float32)
    seqs = []
    for t in range(T):
        dets = []
        for k in range(3):
            if k == 2 and t < 10:
                continue
            if rng.random() < 0.15:       # missed detection
                continue
            dets.append(base[k] + vel[k] * t
                        + rng.normal(0, 1.5, 4).astype(np.float32))
        seqs.append(np.asarray(dets, np.float32).reshape(-1, 4))
    return seqs


def test_track_boxes_matches_jax(rng):
    js, ts = jbt.BoxTrackerState.empty(), tbt.BoxTrackerState.empty()
    for det in _det_sequence(rng):
        js = jbt.track_boxes(js, det, max_missed=1, max_boxes=16)
        ts = tbt.track_boxes(ts, det, max_missed=1, max_boxes=16)
        np.testing.assert_array_equal(ts.ids, js.ids)
        np.testing.assert_array_equal(ts.missed, js.missed)
        np.testing.assert_allclose(ts.boxes, js.boxes, atol=1e-6)
        np.testing.assert_allclose(ts.velocity, js.velocity, atol=1e-6)
        assert ts.next_id == js.next_id
    assert ts.next_id >= 3
    np.testing.assert_allclose(tbt.iou_matrix(ts.boxes, ts.boxes),
                               jbt.iou_matrix(js.boxes, js.boxes))


def _dyn_cfgs():
    scfg = SynthConfig(**SMALL)
    return configs(scfg)


def test_update_streaks_and_box3d_match_jax(rng):
    """Scripted verdict packets through both modules' bookkeeping: the
    statuses, streaks and per-object 3D state agree on every frame."""
    jcfg, tcfg = _dyn_cfgs()
    jd, td = JDyn(jcfg, None), TDyn(tcfg, "cpu")
    det = np.array([[100, 80, 180, 160], [10, 10, 40, 40],
                    [200, 60, 260, 150]], np.float32)
    jb = jbt.track_boxes(jbt.BoxTrackerState.empty(), det)
    tb = box_state_from_numpy(jb)
    # box 0 is confirmed dynamic at frame 2 and stays so; boxes 1 and 2
    # never see two dynamic verdicts in a row and end static
    script = [[0, 2, 1], [2, 1, 1], [2, 2, 0], [1, 0, 0], [2, 1, 0],
              [0, 2, 0], [2, 1, 0]]
    for f, v in enumerate(script):
        verdicts = np.zeros(16, np.int32)
        verdicts[:3] = v
        box3d = rng.normal(0, 1, (16, 16)).astype(np.float32)
        box3d[:, 0] = rng.uniform(0.5, 6.0, 16)
        if f == 4:
            box3d[0, 0] = 30.0                 # beyond the depth gate
        ts = 0.1 * f + (1.0 if f >= 5 else 0.0)   # a stale gap at f=5
        jd.update_streaks(jb, verdicts)
        td.update_streaks(tb, verdicts)
        jd.update_box3d(jb, box3d, ts)
        td.update_box3d(tb, box3d, ts)
        np.testing.assert_array_equal(tb.status, jb.status)
        np.testing.assert_array_equal(tb.dyn_streak, jb.dyn_streak)
        assert sorted(td.obj_state) == sorted(jd.obj_state)
        for k, sj in jd.obj_state.items():
            st = td.obj_state[k]
            assert st["ts"] == sj["ts"]
            np.testing.assert_allclose(st["d"], sj["d"], rtol=1e-6)
            for name in ("t", "R", "ext"):
                np.testing.assert_allclose(st[name], sj[name], rtol=1e-6)
    assert (tb.status == 2).any() and (tb.status == 1).any()
    assert td.obj_state


def test_pick_ref_fd_matches_jax():
    """The reference frame: the newest queued frame at least
    ref_frame_age_s older, else the all-invalid placeholder."""
    jcfg, tcfg = _dyn_cfgs()
    jd, td = JDyn(jcfg, None), TDyn(tcfg, "cpu")
    picks = []
    for f in range(16):
        ts = f / 30.0
        fj, hj = jd.pick_ref_fd(ts, 64)
        ft, ht = td.pick_ref_fd(ts, 64)
        assert float(hj) == float(ht)
        picks.append(-1 if float(ht) == 0 else ft)
        if float(ht) == 0:
            assert not ft.valid.any() and ft.desc.shape == (64, 8)
            assert not bool(np.asarray(fj.valid).any())
        else:
            assert fj == ft
        jd.push_fd(ts, f)
        td.push_fd(ts, f)
    # at 30 fps the reference is 6 or 7 frames back
    assert picks[:6] == [-1] * 6
    assert all(6 <= f - r <= 7 for f, r in enumerate(picks) if f >= 7)
