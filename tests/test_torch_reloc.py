"""Relocalization and its drift correction in the port against the JAX
package: PnP (``ops/pnp.py``), the frame-to-keyframe matchers and
``relocalize`` (``backend/relocalization.py``), the Sim3 verification of
``LoopCloser`` (``_compute_sim3``, ``_compute_sim3_depth``),
``_search_and_fuse`` and ``on_relocalization`` (injected drift, the
depth fallback and the no-op gate), on a map carried across from a
30-frame JAX run of the 320x240 orbit world
(``tests/test_reloc_correction.py:built_system``); and at System level
the kidnap on the sweep world (per frame and chunked) and
``track_rgbd(mask=)`` on the moving-object world. JAX runs on the CPU,
the port with ``device="cpu"``; RANSAC samples are JAX's own where a
module is compared (``sample_idx`` / ``sample_fn``).

Tolerances: matchers and the landmark-set gates equal exactly (integer
Hamming distances); PnP with JAX's samples: equal inlier counts, pose
within 1e-4; relocalize and the Sim3 solves: the same decision and
candidate, inliers within 2, poses within 1e-3 rad / 1e-3 m;
on_relocalization: the same decision, keyframe poses within 1e-3 m of
JAX's and the drift recovered to under 0.35x in both; a clean map left
bit-for-bit unchanged; the fuse: landmark and observation tables equal
on at least 99.5% of entries; System runs: the same state on every frame
and pose errors / ATE within max(1 mm, 20%) of JAX's."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam_dynamic_tpu.backend import relocalization as jrel
from slam_dynamic_tpu.frontend.frame import build_frame as jbuild_frame
from slam_dynamic_tpu.io.evo import ate_rmse as jate
from slam_dynamic_tpu.models import vocabulary as jvoc
from slam_dynamic_tpu.ops import pnp as jpnp
from slam_dynamic_tpu.ops.ransac import _sample_indices
from slam_dynamic_tpu.system import System as JSystem
from slam_dynamic_tpu_torch.backend import loop_closing as tlc
from slam_dynamic_tpu_torch.backend import relocalization as trel
from slam_dynamic_tpu_torch.convert import (config_from_dict,
                                            kfdb_from_numpy,
                                            map_state_from_numpy)
from slam_dynamic_tpu_torch.io.evo import ate_rmse
from slam_dynamic_tpu_torch.models import vocabulary as tvoc
from slam_dynamic_tpu_torch.ops import pnp as tpnp
from slam_dynamic_tpu_torch.system import System, intrinsics_from_config
from tests.test_reloc_correction import built_system, inject_drift
from torch_port_util import (asdict, configs, dynamic_configs,
                             dynamic_world, frame_to_t, map_arrays,
                             small_world, to_t, with_tracking)


def _jax_samples(seed_base, n_hyp, k):
    """sample_fn drawing JAX's own samples for key seed_base + i."""
    def fn(i, mask):
        m = jnp.asarray(mask.cpu().numpy())
        return to_t(_sample_indices(jax.random.PRNGKey(seed_base + i),
                                    n_hyp, k, m.shape[0], m))
    return fn


@pytest.fixture(scope="module")
def built():
    """The JAX System after 30 frames of the orbit world, its map and
    keyframe database carried into the port."""
    js, seq = built_system()
    tcfg = config_from_dict(asdict(js.cfg))
    tcam = intrinsics_from_config(tcfg, "cpu")
    tv = tvoc.load(tvoc.default_vocab_path(), "cpu")
    db = kfdb_from_numpy({f: np.asarray(getattr(js.loop.db, f))
                          for f in js.loop.db._fields}, "cpu")
    return dict(js=js, seq=seq, tcfg=tcfg, tcam=tcam, tvoc=tv, db=db,
                arrays=map_arrays(js.tracker.map))


def _port_closer(b):
    closer = tlc.LoopCloser(b["tcfg"], b["tcam"], b["tvoc"])
    closer.db = b["db"]

    def fn(kind, k, mask):
        base = 1234 if kind == "sim3" else 4321
        return _jax_samples(base + k, 128, 3)(0, mask)
    closer.sample_fn = fn
    return closer


def _tmap(b, arrays=None):
    return map_state_from_numpy(arrays or b["arrays"], "cpu")


def _candidates(m):
    """(k_last, cand) as the JAX tests pick them: the last keyframe and the
    earliest keyframe sharing >= 30 landmarks with it."""
    fids = np.asarray(m.kf_frame_id)
    valid = np.asarray(m.kf_valid)
    k_last = int(np.argmax(np.where(valid, fids, -1)))
    obs = np.asarray(m.kf_obs_lm[k_last])
    obs = set(obs[obs >= 0].tolist())
    for k in np.argsort(fids):
        k = int(k)
        if not valid[k] or k == k_last:
            continue
        ko = np.asarray(m.kf_obs_lm[k])
        if len(obs & set(ko[ko >= 0].tolist())) >= 30:
            return k_last, k
    raise AssertionError("no candidate keyframe")


def _close_poses(tm, jm, atol=1e-3):
    v = np.asarray(jm.kf_valid)
    np.testing.assert_allclose(tm.kf_R.numpy()[v], np.asarray(jm.kf_R)[v],
                               atol=atol, rtol=0)
    np.testing.assert_allclose(tm.kf_t.numpy()[v], np.asarray(jm.kf_t)[v],
                               atol=atol, rtol=0)


# --- ops/pnp.py -----------------------------------------------------------

@pytest.mark.parametrize("planar", [False, True])
def test_ransac_pnp_with_jax_samples_matches_jax(rng, planar):
    """DLT and homography hypotheses scored together: with JAX's samples
    the same winner; the coplanar scene is solved by the homography
    family."""
    from slam_dynamic_tpu.utils.camera import Intrinsics as JI
    from slam_dynamic_tpu_torch.utils.camera import Intrinsics as TI
    n = 300
    xw = rng.uniform([-2, -1.5, 3], [2, 1.5, 7], (n, 3)).astype(np.float32)
    if planar:
        xw[:, 2] = 5.0
    th = 0.2
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]], np.float32)
    t = np.array([0.1, -0.05, 0.3], np.float32)
    xc = xw @ R.T + t
    uv = np.stack([260 * xc[:, 0] / xc[:, 2] + 160,
                   260 * xc[:, 1] / xc[:, 2] + 120], 1).astype(np.float32)
    uv[:60] += rng.uniform(-40, 40, (60, 2)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-20:] = False
    jc = JI.create(260., 260., 160., 120.)
    tc = TI.create(260., 260., 160., 120., device="cpu")
    key = jax.random.PRNGKey(3)
    ref = jpnp.ransac_pnp(jc, jnp.asarray(xw), jnp.asarray(uv),
                          jnp.asarray(mask), key)
    got = tpnp.ransac_pnp(tc, torch.from_numpy(xw), torch.from_numpy(uv),
                          torch.from_numpy(mask),
                          sample_idx=_jax_samples(3, 128, 6)(
                              0, torch.from_numpy(mask)))
    assert int(got.n_inliers) == int(ref.n_inliers) >= 200
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)
    own = tpnp.ransac_pnp(tc, torch.from_numpy(xw), torch.from_numpy(uv),
                          torch.from_numpy(mask), seed=torch.tensor(3))
    assert abs(int(own.n_inliers) - int(ref.n_inliers)) <= 2


# --- backend/relocalization.py on the carried map ------------------------

# the view relocalized: the run resets its young map once (the orbit turns
# 11.6 degrees a frame), and the map it keeps starts at frame 24
VIEW = 26


def _kidnap_frame(b, i=VIEW):
    js, seq = b["js"], b["seq"]
    fr = jbuild_frame(js.cfg, js.cam, seq.gray[i], 1000 + i, 50.0,
                      depth_map=seq.depth[i])
    return fr.data, frame_to_t(fr.data)


@pytest.mark.parametrize("direct_index", [False, True])
def test_match_frame_kf_and_widen_match_jax(built, direct_index):
    b = built
    jm = b["js"].tracker.map
    tm = _tmap(b)
    jfd, tfd = _kidnap_frame(b)
    fids = np.where(np.asarray(jm.kf_valid), np.asarray(jm.kf_frame_id),
                    10 ** 6)
    k = int(np.argmin(np.abs(fids - VIEW)))    # the keyframe nearest the view
    fn = kn = tfn = tkn = None
    if direct_index:
        jv = b["js"].voc
        fn = jvoc.transform(jv, jfd.desc, jfd.valid).node
        kn = jvoc.transform(jv, jm.kf_kp_desc[k], jm.kf_kp_valid[k]).node
        tfn, tkn = to_t(fn), to_t(kn)
    ref = np.asarray(jrel._match_frame_kf(
        jfd.desc, jfd.valid & jfd.static_mask, jm.kf_kp_desc[k],
        jm.kf_kp_valid[k], jm.kf_obs_lm[k], fn, kn))
    got = trel._match_frame_kf(tfd.desc, tfd.valid & tfd.static_mask,
                               tm.kf_kp_desc[k], tm.kf_kp_valid[k],
                               tm.kf_obs_lm[k], tfn, tkn)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref >= 0).sum() >= 15
    # the widening rounds around the view's true pose (the map's frame is
    # its first keyframe's camera), with every other match dropped
    seq = b["seq"]
    f0 = int(fids.min())
    R = (seq.R_wc[VIEW].T @ seq.R_wc[f0]).astype(np.float32)
    t = (seq.R_wc[VIEW].T @ (seq.t_wc[f0] - seq.t_wc[VIEW])).astype(
        np.float32)
    obs0 = np.where(np.arange(ref.shape[0]) % 2 == 0, ref, -1).astype(
        np.int32)
    for radius in (10.0, 3.0):
        wj = np.asarray(jrel._widen_matches(
            jm, b["js"].cam, jnp.int32(k), jnp.asarray(R), jnp.asarray(t),
            jfd, jnp.asarray(obs0), jnp.float32(radius)))
        wt = trel._widen_matches(tm, b["tcam"], k, torch.from_numpy(R),
                                 torch.from_numpy(t), tfd,
                                 torch.from_numpy(obs0), radius)
        np.testing.assert_array_equal(wt.numpy(), wj)
        assert (wj >= 0).sum() > (obs0 >= 0).sum()


def test_relocalize_matches_jax(built):
    """A view of the mapped stretch against the map: the same accepted
    candidate, pose and observations as JAX's, with JAX's PnP samples."""
    b = built
    js = b["js"]
    jfd, tfd = _kidnap_frame(b)
    ok_j, Rj, tj, obs_j, cand_j = jrel.relocalize(
        js.tracker.map, js.loop.db, js.voc, js.cam, jfd, seed=11,
        min_inliers=js.cfg.tracking.min_inliers_after_reloc)
    ok_t, Rt, tt, obs_t, cand_t = trel.relocalize(
        _tmap(b), b["db"], b["tvoc"], b["tcam"], tfd, seed=11,
        min_inliers=b["tcfg"].tracking.min_inliers_after_reloc,
        sample_fn=_jax_samples(11, 128, 6))
    assert ok_j and ok_t and cand_t == cand_j >= 0
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-3)
    nj, nt = int((np.asarray(obs_j) >= 0).sum()), int((obs_t >= 0).sum())
    assert abs(nj - nt) <= 2 and nt >= 50
    # a flat frame finds no candidate in either
    flat = jbuild_frame(js.cfg, js.cam, np.full_like(b["seq"].gray[0], 120.0),
                        2000, 60.0, depth_map=np.zeros_like(b["seq"].depth[0]))
    assert not jrel.relocalize(js.tracker.map, js.loop.db, js.voc, js.cam,
                               flat.data)[0]
    assert trel.relocalize(_tmap(b), b["db"], b["tvoc"], b["tcam"],
                           frame_to_t(flat.data)) == (False, None, None, None,
                                                      -1)


# --- Sim3 verification on the carried map --------------------------------

def test_compute_sim3_and_depth_sim3_match_jax(built):
    b = built
    jl = b["js"].loop
    jm = b["js"].tracker.map
    k_last, cand = _candidates(jm)
    tl = _port_closer(b)
    tm = _tmap(b)
    for name in ("_compute_sim3", "_compute_sim3_depth"):
        extra = (True,) if name == "_compute_sim3" else ()
        rj = getattr(jl, name)(jm, k_last, cand, *extra)
        rt = getattr(tl, name)(tm, k_last, cand, *extra)
        assert rj[0] and rt[0], (name, tl._last_sim3_fail)
        for a, c in zip(rj[1:4], rt[1:4]):
            np.testing.assert_allclose(c.numpy(), np.asarray(a), atol=1e-3)
        assert abs(rt[4] - rj[4]) <= 2 and abs(rt[5] - rj[5]) <= 2, \
            (name, rt[4:], rj[4:])


def test_search_and_fuse_matches_jax(built):
    b = built
    jm = b["js"].tracker.map
    k_last, cand = _candidates(jm)
    ref = b["js"].loop._search_and_fuse(jm, k_last, cand)
    got = _port_closer(b)._search_and_fuse(_tmap(b), k_last, cand)
    lv_j, lv_t = np.asarray(ref.lm_valid), got.lm_valid.numpy()
    assert (lv_j == lv_t).mean() >= 0.995
    assert (np.asarray(ref.kf_obs_lm) == got.kf_obs_lm.numpy()).mean() >= 0.995
    # duplicates merged: landmarks went away in both
    assert lv_j.sum() < np.asarray(jm.lm_valid).sum()
    assert lv_t.sum() < np.asarray(jm.lm_valid).sum()


@pytest.mark.parametrize("how", ["landmarks", "depth_fallback", "no_drift"])
def test_on_relocalization_matches_jax(built, how):
    """The drift correction three ways: landmarks duplicated with an
    injected drift (inject_drift), the drifted keyframe's observations all
    culled (the depth fallback), and a clean map (the noise gate)."""
    b = built
    js = b["js"]
    m0 = js.tracker.map
    k_last, cand = _candidates(m0)
    t_before = np.asarray(m0.kf_t[k_last]).copy()
    if how == "landmarks":
        inject_drift(js, k_last)
    elif how == "depth_fallback":
        R_k = np.asarray(m0.kf_R[k_last])
        t_new = t_before - R_k @ np.array([0.04, -0.02, 0.03])
        js.tracker.map = m0._replace(
            kf_t=m0.kf_t.at[k_last].set(jnp.asarray(t_new, jnp.float32)),
            kf_obs_lm=m0.kf_obs_lm.at[k_last].set(-1))
    try:
        jm = js.tracker.map
        tm = map_state_from_numpy(map_arrays(jm), "cpu")
        mj, rj = js.loop.on_relocalization(jm, k_last, cand, True, seq=30)
        mt, rt = _port_closer(b).on_relocalization(tm, k_last, cand, True,
                                                   seq=30)
    finally:
        js.tracker.map = m0
    assert rt.closed == rj.closed == (how != "no_drift")
    if how == "no_drift":
        for f in ("kf_R", "kf_t", "lm_pos", "kf_obs_lm"):
            np.testing.assert_array_equal(getattr(mt, f).numpy(),
                                          getattr(tm, f).numpy())
        return
    assert rt.matched_kf == rj.matched_kf == cand
    _close_poses(mt, mj)
    drift = float(np.linalg.norm(np.asarray(jm.kf_t[k_last]) - t_before))
    for m in (mt.kf_t.numpy(), np.asarray(mj.kf_t)):
        assert np.linalg.norm(m[k_last] - t_before) < 0.35 * drift
    assert int(mt.n_loop) == int(mj.n_loop) == 1


# --- System level ---------------------------------------------------------

def _kidnap(system, world):
    """20 frames of the sweep world, two flat frames with zero depth,
    frame 5 again, per frame: the states and the last camera centre."""
    _, seq, gray8, depth16 = world
    flat = np.full_like(gray8[0], 120)
    zdep = np.zeros_like(depth16[0])
    states = [system.track_rgbd(gray8[i], depth16[i],
                                float(seq.timestamps[i])).state
              for i in range(20)]
    states += [system.track_rgbd(flat, zdep, 1.0 + j * 0.03).state
               for j in range(2)]
    states.append(system.track_rgbd(gray8[5], depth16[5], 2.0).state)
    _, R, t = system.trajectory[-1]
    return states, -np.asarray(R).T @ np.asarray(t)


def test_kidnap_relocalizes_like_jax():
    world = small_world(n_frames=24)
    jcfg, tcfg = (with_tracking(c, max_frames_between_kf=5)
                  for c in configs(world[0]))
    (sj, cj), (st, ct) = (_kidnap(JSystem(jcfg), world),
                          _kidnap(System(tcfg, device="cpu"), world))
    assert st == sj
    assert st[20:] == ["LOST", "LOST", "OK"]
    gt = world[1].t_wc[5]
    ej, et = np.linalg.norm(cj - gt), np.linalg.norm(ct - gt)
    assert et < 0.05 and abs(et - ej) <= max(1e-3, 0.2 * ej), (et, ej)


def _chunked_kidnap(system, world):
    """The kidnap through track_chunk (C = 3, one chunk in flight): 18
    frames in chunks, a chunk of frame 19 and two flat frames, a chunk of
    frames 5-7 (timestamps 2.0...) and the same again (3.0...), then the
    frames in flight: the states each call returned, the tracker's state
    and in-flight count after the first 5-7 chunk, the trajectory's
    timestamps and frame 5's camera centre at 3.0."""
    _, seq, gray8, depth16 = world
    ts = [float(t) for t in seq.timestamps]
    flat = np.full_like(gray8[0], 120)
    zdep = np.zeros_like(depth16[0])
    calls = [[system.track_rgbd(gray8[0], depth16[0], ts[0])]]
    calls += [system.track_chunk(gray8[i:i + 3], depth16[i:i + 3],
                                 ts[i:i + 3]) for i in range(1, 19, 3)]
    calls.append(system.track_chunk([gray8[19], flat, flat],
                                    [depth16[19], zdep, zdep],
                                    [ts[19], 1.0, 1.03]))
    calls.append(system.track_chunk(gray8[5:8], depth16[5:8],
                                    [2.0, 2.04, 2.08]))
    after_loss = (system.tracker.state, len(system.tracker._pending))
    calls.append(system.track_chunk(gray8[5:8], depth16[5:8],
                                    [3.0, 3.04, 3.08]))
    left = system.tracker.flush()
    calls.append(left if isinstance(left, list) else
                 [left] if left is not None else [])
    states = [[s.state for s in c] for c in calls]
    poses = {t: (np.asarray(R), np.asarray(tt))
             for t, R, tt in system.trajectory}
    R, t = poses[3.0]
    return states, after_loss, sorted(poses), -R.T @ t


def test_chunked_kidnap_recovers_like_jax():
    """The chunk holding the flat frames goes LOST when it is finalized,
    the chunk dispatched after it is dropped, and the next chunk takes the
    per-frame route: frame 5's view relocalizes, 6 and 7 track. Against
    the JAX System with the same configuration (C = 3, one chunk in
    flight): the same states from every call, the same frames dropped
    from the trajectory, and frame 5's centre within max(1 mm, 20%) of
    JAX's error."""
    world = small_world(n_frames=24)
    jcfg, tcfg = (with_tracking(c, max_frames_between_kf=5,
                                pipeline_depth=1)
                  for c in configs(world[0]))
    tsys = System(tcfg, device="cpu")
    (sj, lj, tj, cj), (st, lt, tt, ct) = (
        _chunked_kidnap(JSystem(jcfg), world), _chunked_kidnap(tsys, world))
    assert st == sj, (st, sj)
    assert sum(st[:8], []) == ["OK"] * 19
    # frame 19, then the first flat frame; the second and this chunk drop
    assert st[8] == ["OK", "LOST"]
    assert lt == lj == ("LOST", 0)
    assert tt == tj and 2.0 not in tt and 3.0 in tt
    assert all(s == "OK" for s in st[9] + st[10]) and len(st[9] + st[10]) >= 3
    gt = world[1].t_wc[5]
    ej, et = np.linalg.norm(cj - gt), np.linalg.norm(ct - gt)
    assert et < 0.05 and abs(et - ej) <= max(1e-3, 0.2 * ej), (et, ej)
    assert tsys.tracker.packet_reads <= tsys.tracker.dispatches


def test_track_rgbd_mask_matches_jax():
    """The mask= path on the moving-object world with the object's boxes:
    frames built on the host, boxes classified before tracking (the
    RANSAC samples differ: compared by outcome), the object's pixels
    quarantined. The same state on every frame, the same keyframe
    decisions and inliers within max(5, 2%) up to the first decision that
    differs (a one-inlier difference at the 0.75 keyframe threshold,
    the extraction difference of ROADMAP Queue 3, can flip one), the ATE
    of the frames before it within max(1 mm, 20%) of JAX's, and the whole
    run under 30 mm in both."""
    n = 16
    world = dynamic_world("moving", n)
    _, seq, gray8, depth16 = world
    jcfg, tcfg = dynamic_configs(world[0])
    out = {}
    for name, system in (("jax", JSystem(jcfg)),
                         ("port", System(tcfg, device="cpu"))):
        stats = []
        for i in range(n):
            det = seq.boxes[i][seq.box_valid[i]] if seq.box_valid[i, 0] \
                else None
            stats.append(system.track_rgbd(
                gray8[i], depth16[i], float(seq.timestamps[i]),
                detections=det, mask=seq.masks[i]))
        est = np.stack([-R.T @ t for _, R, t in system.trajectory])
        out[name] = (stats, est, system)
    (sj, ej, js), (st, et, ts) = out["jax"], out["port"]
    assert [s.state for s in st] == [s.state for s in sj] == ["OK"] * n
    kj, kt = [s.is_keyframe for s in sj], [s.is_keyframe for s in st]
    d = next((i for i in range(n) if kj[i] != kt[i]), n)
    assert d >= n // 2
    for a, b in zip(sj[1:d], st[1:d]):
        assert abs(a.n_inliers_map - b.n_inliers_map) <= max(
            5, 0.02 * a.n_inliers_map)
    gt = seq.t_wc[:n]
    ate_j, ate_t = jate(ej[:d], gt[:d]), ate_rmse(et[:d], gt[:d])
    assert abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), (ate_t, ate_j)
    assert ate_rmse(et, gt) < 0.03 and jate(ej, gt) < 0.03
    assert ts.tracker.dispatches == n - 1     # every frame after the first
    assert len(ts.dynamics.queue) == len(js.dynamics.queue) > 0
    assert tuple(ts.boxes.status) == tuple(js.boxes.status) == (2,)
