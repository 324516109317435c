"""The dense map, map checkpoints and the headless viewers
(``slam_dynamic_tpu_torch/ops/pointcloud.py``, ``backend/dense_map.py``,
``worldmap/checkpoint.py``, ``viz/``, and the System's ``save_pcd``,
``save_dense_ply``, ``save_map`` and ``load_map``) against the JAX
package's on the same inputs.

Tolerances: ``backproject_dense`` within 1e-5; ``voxel_downsample``
index-equal (the same points kept, in the same order) with hashes that
wrap and tied keys; the PLY, PCD and PNG writers byte-equal; the
DenseMapper's clouds within 1e-5, its OBB within 1e-4 (axes up to sign)
and its voxel-merged point count within 1% of JAX's (the room's walls
lie on voxel faces, y = 2.0 m at 0.04 m voxels, so a last-bit difference
of a backprojected point moves it to the next voxel); the System-owned
dense map's point count within 2% of JAX's over 10 frames (the keyframe
poses differ by float rounding too); a checkpoint of either package
loaded by the other equal field for field, with the same keys and
dtypes; a System resumed from its own checkpoint LOST, then relocalized,
with the same state sequence as JAX's and ATE within max(1 mm, 20%).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_dynamic_tpu.backend.dense_map import DenseMapper as JDense
from slam_dynamic_tpu.io.evo import ate_rmse as jate
from slam_dynamic_tpu.ops import pointcloud as jpc
from slam_dynamic_tpu.system import System as JSystem
from slam_dynamic_tpu.utils.camera import Intrinsics as JIntrinsics
from slam_dynamic_tpu.viz import ar as jar
from slam_dynamic_tpu.viz import headless as jhv
from slam_dynamic_tpu.worldmap import checkpoint as jckpt
from slam_dynamic_tpu_torch.backend.dense_map import DenseMapper
from slam_dynamic_tpu_torch.io.evo import ate_rmse
from slam_dynamic_tpu_torch.io.synthetic import SynthConfig, generate
from slam_dynamic_tpu_torch.ops import pointcloud as pc
from slam_dynamic_tpu_torch.system import System
from slam_dynamic_tpu_torch.utils.camera import Intrinsics
from slam_dynamic_tpu_torch.viz import ar
from slam_dynamic_tpu_torch.viz import headless as hv
from slam_dynamic_tpu_torch.worldmap import checkpoint as ckpt
from torch_port_util import SMALL, configs, small_world, with_tracking

CAM = dict(fx=260.0, fy=260.0, cx=159.5, cy=119.5, width=320, height=240)
N_DENSE, N_RESUME = 10, 20


def _cams():
    return JIntrinsics.create(**CAM), Intrinsics.create(**CAM, device="cpu")


def _rot(rs):
    q, _ = np.linalg.qr(rs.normal(size=(3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


# --- ops ---

@pytest.mark.parametrize("stride", [3, 4])
def test_backproject_dense_matches_jax(stride):
    rs = np.random.default_rng(stride)
    jcam, tcam = _cams()
    gray = rs.uniform(0, 255, (240, 320)).astype(np.float32)
    depth = rs.uniform(-0.5, 7.0, (240, 320)).astype(np.float32)
    dyn = rs.uniform(size=(240, 320)) < 0.2
    R, t = _rot(rs), rs.normal(size=3).astype(np.float32)
    pj, ij, oj = jpc.backproject_dense(
        jcam, jnp.asarray(gray), jnp.asarray(depth), jnp.asarray(R),
        jnp.asarray(t), jnp.asarray(dyn), stride=stride)
    pt, it, ot = pc.backproject_dense(
        tcam, torch.from_numpy(gray), torch.from_numpy(depth),
        torch.from_numpy(R), torch.from_numpy(t), torch.from_numpy(dyn),
        stride=stride)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=1e-5)


def _voxel_inputs(seed):
    """Points whose voxel indices make the int32 hash wrap, many points
    per voxel (tied keys), and invalid points."""
    rs = np.random.default_rng(seed)
    centres = rs.uniform(-3e3, 3e3, (40, 3))
    pts = np.repeat(centres, 12, 0) + rs.uniform(-0.01, 0.01, (480, 3))
    pts = rs.permutation(pts).astype(np.float32)
    inten = rs.uniform(0, 255, 480).astype(np.float32)
    valid = rs.uniform(size=480) < 0.9
    return pts, inten, valid


def test_voxel_hash_wraps_as_jax_int32():
    pts, _, _ = _voxel_inputs(0)
    v = jnp.floor(jnp.asarray(pts) / 0.05).astype(jnp.int32)
    kj = np.asarray((v[:, 0] * 73856093) ^ (v[:, 1] * 19349663)
                    ^ (v[:, 2] * 83492791))
    kt = pc.voxel_hash(torch.from_numpy(pts), 0.05).numpy()
    np.testing.assert_array_equal(kt, kj)
    assert kt.dtype == np.int32
    # the products wrap: an int64 hash would differ
    v64 = np.floor(pts / np.float32(0.05)).astype(np.int64)
    wide = (v64[:, 0] * 73856093) ^ (v64[:, 1] * 19349663) \
        ^ (v64[:, 2] * 83492791)
    assert (wide != kt).mean() > 0.9


@pytest.mark.parametrize("seed,max_out", [(0, 64), (1, 480), (2, 16)])
def test_voxel_downsample_index_equal(seed, max_out):
    pts, inten, valid = _voxel_inputs(seed)
    pj, ij, oj = jpc.voxel_downsample(jnp.asarray(pts), jnp.asarray(inten),
                                      jnp.asarray(valid), 0.05,
                                      max_out=max_out)
    pt, it, ot = pc.voxel_downsample(torch.from_numpy(pts),
                                     torch.from_numpy(inten),
                                     torch.from_numpy(valid), 0.05,
                                     max_out=max_out)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    keys = pc.voxel_hash(torch.from_numpy(pts), 0.05).numpy()[valid]
    assert int(ot.sum()) == min(max_out, np.unique(keys).size)


@pytest.mark.parametrize("with_intensity,with_valid",
                         [(True, True), (True, False), (False, True),
                          (False, False)])
def test_save_ply_and_pcd_byte_equal(tmp_path, with_intensity, with_valid):
    pts, inten, valid = _voxel_inputs(3)
    kw = dict(intensity=inten if with_intensity else None,
              valid=valid if with_valid else None)
    for name, jf, tf in (("ply", jpc.save_ply, pc.save_ply),
                         ("pcd", jpc.save_pcd, pc.save_pcd)):
        jf(str(tmp_path / f"j.{name}"), pts, **kw)
        tf(str(tmp_path / f"t.{name}"), torch.from_numpy(pts),
           **{k: None if v is None else torch.from_numpy(v)
              for k, v in kw.items()})
        assert (tmp_path / f"t.{name}").read_bytes() == \
            (tmp_path / f"j.{name}").read_bytes()


# --- the dense mapper ---

def test_dense_mapper_two_keyframes_with_a_dynamic_box():
    """tests/test_dense_viz_ckpt.py's scene: two keyframes of the moving
    object's world, its box confirmed dynamic."""
    scfg = SynthConfig(n_frames=2, **{k: v for k, v in SMALL.items()
                                      if k != "n_frames"},
                       dynamic_object=True, obj_x0=0.0, obj_depth=3.0)
    seq = generate(scfg)
    jcam, tcam = _cams()
    jcfg, tcfg = (c.replace(pointcloud=dataclasses.replace(
        c.pointcloud, enabled=True, max_depth=20.0))
        for c in configs(scfg))
    jdm, tdm = JDense(jcfg, jcam), DenseMapper(tcfg, tcam)
    for i in range(2):
        R = seq.R_wc[i].T
        t = -R @ seq.t_wc[i]
        boxes = seq.boxes[i][seq.box_valid[i]]
        for dm in (jdm, tdm):
            dm.insert_keyframe(seq.gray[i], seq.depth[i], R, t,
                               dyn_mask=seq.masks[i], boxes=boxes,
                               box_ids=np.array([0]),
                               box_dynamic=np.array([True]))
    for cj, ct in zip(jdm.clouds + jdm.intens, tdm.clouds + tdm.intens):
        np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-5)
    (pj, _), (pt, _) = jdm.global_cloud(), tdm.global_cloud()
    assert len(pj) > 2000 and abs(len(pt) - len(pj)) <= 0.01 * len(pj)
    near_obj = np.linalg.norm(pt - np.array([0, 0, 3.3]), axis=1) < 0.4
    assert near_obj.sum() < 20
    assert set(tdm.obbs) == set(jdm.obbs) == {0}
    oj, ot = jdm.obbs[0], tdm.obbs[0]
    np.testing.assert_allclose(ot.center, np.asarray(oj.center), atol=1e-4)
    np.testing.assert_allclose(ot.extents, np.asarray(oj.extents), atol=1e-4)
    np.testing.assert_allclose(np.abs((ot.axes * np.asarray(oj.axes)).sum(1)),
                               1.0, atol=1e-4)


# --- the System: dense map, checkpoint, resume ---

def _dense_cfg(cfg):
    cfg = cfg.replace(pointcloud=dataclasses.replace(
        cfg.pointcloud, enabled=True, max_depth=20.0))
    return with_tracking(cfg, pipeline_depth=1, max_frames_between_kf=4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package: a dense-mapping System (one frame in flight) over
    frames 0-9, its PCD, PLY and map checkpoint; then a fresh System
    resumed from that checkpoint over frames 10-19."""
    d = tmp_path_factory.mktemp("runs")
    scfg, seq, gray8, depth16 = world = small_world(N_RESUME)
    ts = [float(t) for t in seq.timestamps]
    out = {"world": world}
    for name, cfg, make in zip(("jax", "port"), configs(scfg),
                               (JSystem,
                                lambda c: System(c, device="cpu"))):
        s = make(_dense_cfg(cfg))
        for i in range(N_DENSE):
            s.track_rgbd(gray8[i], depth16[i], ts[i])
        r = {"n_pcd": s.save_pcd(str(d / f"{name}.pcd")),
             "n_ply": s.save_dense_ply(str(d / f"{name}.ply")),
             "ckpt": str(d / f"{name}.npz"), "first": s}
        s.save_map(r["ckpt"])
        s2 = make(cfg)
        s2.load_map(r["ckpt"])
        r["loaded_state"] = s2.tracker.state
        r["n_kf"] = (s.tracker.n_kf_host, s2.tracker.n_kf_host)
        r["states"] = [s2.track_rgbd(gray8[i], depth16[i], ts[i]).state
                       for i in range(N_DENSE, N_RESUME)]
        r["est"] = np.stack([-R.T @ t for _, R, t in s2.trajectory])
        out[name] = r
    return out


def test_system_dense_map_point_count_tracks_jax(runs):
    nj, nt = runs["jax"]["n_pcd"], runs["port"]["n_pcd"]
    assert nt > 2000 and abs(nt - nj) <= 0.02 * nj, (nt, nj)
    assert runs["port"]["n_ply"] == nt
    assert runs["port"]["first"].dense is not None


def test_system_dense_map_needs_pointcloud():
    scfg = small_world(2)[0]
    s = System(configs(scfg)[1], device="cpu")
    with pytest.raises(RuntimeError, match="pointcloud"):
        s.save_pcd("unused.pcd")


def test_checkpoint_keys_and_dtypes_as_jax(runs):
    with np.load(runs["jax"]["ckpt"]) as zj, \
            np.load(runs["port"]["ckpt"]) as zt:
        assert sorted(zt.files) == sorted(zj.files)
        for f in zj.files:
            assert zt[f].dtype == zj[f].dtype, f
            assert zt[f].shape == zj[f].shape, f
        assert zt["kf_kp_desc"].dtype == np.uint32


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_in_the_other_package(runs, writer):
    path = runs[writer]["ckpt"]
    mj = jckpt.load_map(path)
    mt = ckpt.load_map(path, device="cpu")
    for f, tv in zip(mt._fields, mt):
        a, b = tv.numpy(), np.asarray(getattr(mj, f))
        if b.dtype == np.uint32:
            b = b.view(np.int32)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert mt.kf_kp_desc.dtype == torch.int32


def test_resumed_system_relocalizes_and_tracks_like_jax(runs):
    rj, rt = runs["jax"], runs["port"]
    assert rt["loaded_state"] == rj["loaded_state"] == "LOST"
    assert rt["n_kf"][1] == rt["n_kf"][0] and rj["n_kf"][1] == rj["n_kf"][0]
    assert rt["states"] == rj["states"]
    assert rt["states"].count("OK") >= 8, rt["states"]
    seq = runs["world"][1]
    ej, et = rj["est"], rt["est"]
    i0j, i0t = N_RESUME - len(ej), N_RESUME - len(et)
    ate_j = jate(ej, seq.t_wc[i0j:N_RESUME])
    ate_t = ate_rmse(et, seq.t_wc[i0t:N_RESUME])
    assert ate_t < 0.05 and abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), \
        (ate_t, ate_j)


# --- the headless viewers ---

def test_headless_outputs_byte_equal(tmp_path):
    rs = np.random.default_rng(5)
    gray = rs.uniform(0, 255, (120, 160)).astype(np.float32)
    xy = rs.uniform([0, 0], [160, 120], (50, 2)).astype(np.float32)
    kw = dict(tracked_mask=np.arange(50) < 25,
              quarantined_mask=np.arange(50) % 7 == 0,
              boxes=np.array([[10, 10, 60, 60], [70, 5, 150, 100]]),
              box_status=np.array([2, 1]))
    for name, mod in (("j", jhv), ("t", hv)):
        rgb = mod.draw_frame(gray, xy, np.ones(50, bool), **kw)
        mod.write_png(str(tmp_path / f"{name}_frame.png"), rgb)
        mod.write_png(str(tmp_path / f"{name}_top.png"),
                      mod.draw_trajectory_topdown(xy[:, [0, 1, 0]],
                                                  xy[:, [1, 0, 1]]))
    lm = rs.normal(size=(64, 3)).astype(np.float32)
    kf_R = np.stack([_rot(rs) for _ in range(4)])
    kf_t = rs.normal(size=(4, 3))
    obbs = {3: jpc.OBB(np.zeros(3), np.eye(3), np.array([1.0, 0.5, 0.2]),
                       True)}
    for name, mod in (("j", jhv), ("t", hv)):
        mod.export_map_ply(str(tmp_path / f"{name}_map.ply"), lm,
                           np.arange(64) % 3 > 0, kf_R, kf_t,
                           np.array([1, 1, 0, 1], bool))
        mod.export_obbs_ply(str(tmp_path / f"{name}_obb.ply"), obbs)
    for f in ("frame.png", "top.png", "map.ply", "obb.ply"):
        assert (tmp_path / f"t_{f}").read_bytes() == \
            (tmp_path / f"j_{f}").read_bytes(), f


def test_ar_outputs_byte_equal():
    rs = np.random.default_rng(6)
    plane_pts = np.concatenate([
        np.c_[rs.uniform(-1, 1, (80, 2)), np.full(80, 2.0)],
        rs.normal(size=(20, 3))]).astype(np.float32)
    valid = np.ones(100, bool)
    pj = jar.detect_plane(plane_pts, valid)
    pt = ar.detect_plane(plane_pts, valid)
    np.testing.assert_array_equal(pt.normal, pj.normal)
    vj, vt = jar.cube_vertices(pj), ar.cube_vertices(pt)
    np.testing.assert_array_equal(vt, vj)
    gray = rs.uniform(0, 255, (120, 160)).astype(np.float32)
    R, t = np.eye(3), np.array([0.0, 0.0, 1.0])
    a = ar.render_cube(gray, R, t, 100.0, 100.0, 80.0, 60.0, vt)
    b = jar.render_cube(gray, R, t, 100.0, 100.0, 80.0, 60.0, vj)
    np.testing.assert_array_equal(a, b)
    assert (a != np.stack([gray.astype(np.uint8)] * 3, -1)).any()
