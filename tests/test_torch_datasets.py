"""The port's dataset loaders (slam_dynamic_tpu_torch/io/datasets.py, a
copy of the JAX package's host numpy module) against the JAX package's,
and the EuRoC stereo drive of ``tests/test_euroc.py`` through the port's
System.

The port's copy of the synthetic renderer (io/synthetic.py) is checked
here too, as the other host data module: bit-equal sequences on every
kind of world the tests and ``chip_smoke.py`` render. Tolerances: the
rectification blocks, maps and remaps bit-equal on
``configs/EuRoC.yaml`` and on the identity and distortion cases of
``tests/test_euroc.py``; the EuRoC, TUM and KITTI loaders yield
bit-equal packets on trees written from the synthetic world; the EuRoC
drive (12 frames of the 256x192 stereo world, identity rectification)
tracks every frame with an unaligned ATE under the JAX test's 0.12 m."""
import os

import numpy as np
import pytest
from PIL import Image

from slam_dynamic_tpu.io import datasets as jds
from slam_dynamic_tpu.io import synthetic as jsyn
from slam_dynamic_tpu.viz.headless import write_png
from slam_dynamic_tpu_torch import config as C
from slam_dynamic_tpu_torch.io import datasets as tds
from slam_dynamic_tpu_torch.io.evo import ate_rmse
from slam_dynamic_tpu_torch.io.synthetic import SynthConfig, generate
from slam_dynamic_tpu_torch.system import System
from test_euroc import _identity_yaml, _write_euroc_tree

EUROC_YAML = os.path.join(os.path.dirname(__file__), "..", "configs",
                          "EuRoC.yaml")
K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]])
P = np.concatenate([K, np.zeros((3, 1))], 1)


def test_rect_blocks_and_maps_match_jax_on_euroc_yaml():
    bj, bt = jds.load_rect_blocks(EUROC_YAML), tds.load_rect_blocks(
        EUROC_YAML)
    assert sorted(bt) == sorted(bj) and len(bt) == 8
    for name in bj:
        np.testing.assert_array_equal(bt[name], bj[name], name)
    for side in ("LEFT", "RIGHT"):
        args = [bj[f"{side}.{n}"] for n in "KDRP"] + [752, 480]
        for a, b in zip(tds.rectify_maps(*args), jds.rectify_maps(*args)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("D", [np.zeros(5),
                               np.array([-0.28, 0.07, 0.0, 0.0, 0.0])],
                         ids=["identity", "distortion"])
def test_rectify_and_remap_match_jax(rng, D):
    mt = tds.rectify_maps(K, D, np.eye(3), P, 160, 120)
    mj = jds.rectify_maps(K, D, np.eye(3), P, 160, 120)
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a, b)
    img = rng.uniform(0, 255, (120, 160))
    np.testing.assert_array_equal(tds.remap_bilinear(img, *mt),
                                  jds.remap_bilinear(img, *mj))
    if not D.any():
        np.testing.assert_allclose(tds.remap_bilinear(img, *mt), img,
                                   atol=1e-2)


def _packets_equal(pt, pj):
    assert len(pt) == len(pj) > 0
    for a, b in zip(pt, pj):
        assert (a.index, a.timestamp) == (b.index, b.timestamp)
        for f in ("gray", "depth", "right", "detections", "mask"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, f)


def _write_tum(root, seq, n):
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    rgb, dep = [], []
    for i in range(n):
        ts = f"{float(seq.timestamps[i]):.6f}"
        write_png(str(root / "rgb" / f"{ts}.png"),
                  np.clip(seq.gray[i], 0, 255).astype(np.uint8))
        d16 = np.clip(seq.depth[i] * 5000, 0, 65535).astype(np.uint16)
        Image.fromarray(d16, mode="I;16").save(str(root / "depth"
                                                   / f"{ts}.png"))
        rgb.append(f"{ts} rgb/{ts}.png")
        dep.append(f"{ts} depth/{ts}.png")
    (root / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb) + "\n")
    (root / "depth.txt").write_text("# depth\n" + "\n".join(dep) + "\n")


def _write_kitti(root, seq, n):
    for cam, frames in (("image_0", seq.gray), ("image_1", seq.right)):
        os.makedirs(root / cam)
        for i in range(n):
            write_png(str(root / cam / f"{i:06d}.png"),
                      np.clip(frames[i], 0, 255).astype(np.uint8))
    (root / "times.txt").write_text(
        "\n".join(f"{float(t):.6e}" for t in seq.timestamps[:n]) + "\n")


@pytest.fixture(scope="module")
def small_stereo():
    return generate(SynthConfig(n_frames=12, width=256, height=192,
                                fx=210.0, fy=210.0, cx=127.5, cy=95.5,
                                stereo=True))


def test_tum_and_kitti_loaders_match_jax(tmp_path, small_stereo):
    seq = small_stereo
    _write_tum(tmp_path / "tum", seq, 4)
    _packets_equal(list(tds.TumRGBD(str(tmp_path / "tum"))),
                   list(jds.TumRGBD(str(tmp_path / "tum"))))
    _write_kitti(tmp_path / "kitti", seq, 4)
    _packets_equal(list(tds.KittiStereo(str(tmp_path / "kitti"))),
                   list(jds.KittiStereo(str(tmp_path / "kitti"))))


def test_euroc_stereo_drive_through_the_port(tmp_path, small_stereo):
    seq = small_stereo
    scfg = seq.cfg
    root = _write_euroc_tree(tmp_path, seq, 12)
    yaml = _identity_yaml(tmp_path, 256, 192, scfg.fx, scfg.fy, scfg.cx,
                          scfg.cy, scfg.fx * scfg.baseline)
    pkts = list(tds.EurocDataset(root, stereo=True, yaml_path=yaml))
    _packets_equal(pkts, list(jds.EurocDataset(root, stereo=True,
                                               yaml_path=yaml)))
    assert len(pkts) == 12 and pkts[0].right.dtype == np.uint8
    # tests/test_euroc.py's config
    cfg = C.SystemConfig(
        camera=C.CameraConfig(fx=scfg.fx, fy=scfg.fy, cx=scfg.cx,
                              cy=scfg.cy, bf=scfg.fx * scfg.baseline,
                              width=256, height=192, th_depth=120.0,
                              fps=scfg.fps),
        orb=C.ORBConfig(n_features=500),
        detector=C.DetectorConfig(mode="off"),
        capacity=C.CapacityConfig(max_keyframes=16, max_landmarks=4096,
                                  max_keypoints=512, local_ba_keyframes=8,
                                  local_ba_landmarks=1024),
        sensor="stereo")
    s = System(cfg, device="cpu")
    states = [s.track_stereo(p.gray, p.right, p.timestamp).state
              for p in pkts]
    assert states == ["OK"] * 12
    est = np.stack([-R.T @ t for _, R, t in s.trajectory])
    ate = ate_rmse(est, seq.t_wc[:len(est)], align=False)
    assert ate < 0.12, ate


SMALL = dict(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)


@pytest.mark.parametrize("world", [
    dict(), dict(stereo=True, baseline=0.2), dict(trajectory="orbit"),
    dict(advance=0.04, sway=0.5),
    dict(dynamic_object=True, obj_size=1.6, obj_depth=3.0, obj_speed=0.09,
         stereo=True),
    dict(dynamic_object=True, obj_size=1.4, obj_depth=3.5, obj_speed=0.0,
         obj_x0=0.0, obj_bob=0.0)],
    ids=["sweep", "stereo", "orbit", "mono", "moving_stereo", "static_box"])
def test_synthetic_worlds_match_jax(world):
    a = jsyn.generate(jsyn.SynthConfig(n_frames=6, **SMALL, **world))
    b = generate(SynthConfig(n_frames=6, **SMALL, **world))
    for name in a._fields[:-1]:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(y, x, name)
