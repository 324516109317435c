"""The online detector: the port's CenterNet and its post-processing
(``slam_dynamic_tpu_torch/models/detector.py``, ``ops/nms.py``) against
the JAX package's on the same inputs.

Tolerances: NMS indices equal; the heat and offset maps within 1e-4
absolute of flax's and the size map within 1e-5 relative (it is
``exp(.) * 8`` pixels, up to a few hundred, so a 1e-4 absolute
agreement of its logits is a relative one after the exp); detections
equal where the score clears the 0.5 threshold by 1e-3 (boxes within
1e-3 px, scores within 1e-4), with the detections nearer the threshold
counted and printed (the convolutions round differently, and a score
within about 1e-3 of it may flip); the post-processing on crafted maps
with tied scores equal, index for index.
"""
import io
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slam_dynamic_tpu import config as JC
from slam_dynamic_tpu.models import detector as JD
from slam_dynamic_tpu.ops.nms import nms as jnms
from slam_dynamic_tpu_torch import config as TC
from slam_dynamic_tpu_torch.models import detector as TD
from slam_dynamic_tpu_torch.io.synthetic import SynthConfig, generate
from slam_dynamic_tpu_torch.ops.nms import nms as tnms
from torch_port_util import DYNAMIC_WORLDS, SMALL

MARGIN = 1e-3


def _moving_frames(width, n=3):
    small = {} if width == 640 else {k: v for k, v in SMALL.items()
                                     if k != "n_frames"}
    seq = generate(SynthConfig(n_frames=n, **small,
                               **DYNAMIC_WORLDS["moving"]))
    return [g.astype(np.float32) for g in seq.gray]


@pytest.fixture(scope="module")
def weights():
    path = TD.default_detector_weights()
    assert path is not None
    return path


@pytest.fixture(scope="module")
def shipped(weights):
    """(JAX detector, port detector, frames) per width, the shipped
    weights."""
    out = {}
    for w, h in ((640, 480), (320, 240)):
        out[w] = (JD.Detector.from_npz(JC.DetectorConfig(mode="online"), h,
                                       w, weights),
                  TD.Detector.from_npz(TC.DetectorConfig(mode="online"), h,
                                       w, weights, device="cpu"),
                  _moving_frames(w))
    return out


def _jax_maps(det, img):
    x = jnp.asarray(img, jnp.float32)[..., None] / 255.0
    return [np.asarray(a) for a in det.model.apply(det.params, x)]


def _check_maps(jd, td, img):
    hj, sj, oj = _jax_maps(jd, img)
    ht, st, ot = (a.permute(1, 2, 0).numpy() for a in td.maps(img))
    np.testing.assert_allclose(ht, hj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1e-4)


# --- NMS ---

def _nms_case(seed):
    rs = np.random.default_rng(seed)
    n = 48
    xy = rs.uniform(0, 200, (n, 2))
    wh = rs.uniform(10, 60, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1)
    # a suppression chain: each box overlaps the next by IoU > 0.4, not
    # the one after
    for j in range(6):
        boxes[j] = [300 + 8 * j, 0, 320 + 8 * j, 20]
    scores = np.round(rs.uniform(0, 1, n), 1)          # many ties
    scores[rs.uniform(size=n) < 0.15] = 0.0
    valid = rs.uniform(size=n) < 0.85
    return (boxes.astype(np.float32), scores.astype(np.float32), valid)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_nms_index_equal_with_jax(seed):
    boxes, scores, valid = _nms_case(seed)
    for max_out in (8, 32):
        ij, kj = jnms(jnp.asarray(boxes), jnp.asarray(scores),
                      jnp.asarray(valid), 0.4, max_out=max_out)
        it, kt = tnms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      torch.from_numpy(valid), 0.4, max_out=max_out)
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        assert it.dtype == torch.int32


# --- the network ---

@pytest.mark.parametrize("width", [640, 320])
def test_maps_match_flax_shipped_weights(shipped, width):
    jd, td, frames = shipped[width]
    for img in frames:
        _check_maps(jd, td, img)


def test_maps_match_flax_random_params_odd_input():
    """JAX's random-init params carried across, on a 321x241 input (the
    odd side's SAME padding is (1, 1))."""
    jd = JD.Detector(JC.DetectorConfig(mode="online"), 241, 321, seed=5,
                     n_classes=6)
    td = TD.Detector(TC.DetectorConfig(mode="online"), 241, 321,
                     params=jd.params, n_classes=6, device="cpu")
    img = np.random.default_rng(7).uniform(0, 255, (241, 321)).astype(
        np.float32)
    _check_maps(jd, td, img)


def test_group_norm_is_per_row_with_flax_eps():
    """flax's GroupNorm on an unbatched [H, W, C] input normalizes each
    row with eps 1e-6: the port matches it, where normalizing the whole
    image misses and eps 1e-5 misses on rows of small variance."""
    import flax.linen as nn
    import jax
    rs = np.random.default_rng(0)
    x = rs.normal(size=(6, 5, 16)).astype(np.float32)
    x[3] = 1e-4 * rs.normal(size=(5, 16))     # variance ~1e-8, mean ~0
    gn = nn.GroupNorm(num_groups=8)
    params = gn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rs.normal(size=a.shape), jnp.float32), params)
    ref = np.asarray(gn.apply(params, jnp.asarray(x)))
    w = torch.from_numpy(np.array(params["params"]["scale"]))
    b = torch.from_numpy(np.array(params["params"]["bias"]))
    xt = torch.from_numpy(x).permute(2, 0, 1)[None]          # [1, C, H, W]
    got = TD._row_group_norm(xt, 8, w, b)[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    whole = F.group_norm(xt, 8, w, b, eps=1e-6)[0].permute(1, 2, 0).numpy()
    assert np.abs(whole - ref).max() > 0.1
    rows = xt[0].permute(1, 0, 2)
    eps5 = F.group_norm(rows, 8, w, b, eps=1e-5).permute(1, 0, 2)
    assert np.abs(eps5.permute(1, 2, 0).numpy() - ref)[3].max() > 0.1


@pytest.mark.parametrize("shape", [(6, 8), (7, 9)])
def test_same_padding_matches_flax_conv(shape):
    """A stride-2 3x3 conv with flax's SAME padding: (0, 1) on an even
    side, (1, 1) on an odd one. A unit impulse at (0, 0) lands on kernel
    tap (0, 0) of output (0, 0) on an even input; padding=1 misses."""
    import flax.linen as nn
    import jax
    rs = np.random.default_rng(1)
    x = rs.normal(size=(1, *shape, 3)).astype(np.float32)
    conv = nn.Conv(4, (3, 3), strides=(2, 2), use_bias=False)
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.asarray(params["params"]["kernel"])          # HWIO
    ref = np.asarray(conv.apply(params, jnp.asarray(x)))[0]
    w = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = F.conv2d(TD._same_pad(xt, 3, 2), w, stride=2)[0]
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), ref,
                               rtol=0, atol=1e-5)
    naive = F.conv2d(xt, w, stride=2, padding=1)[0].permute(1, 2, 0)
    even = shape[0] % 2 == 0
    assert (np.abs(naive.numpy() - ref).max() > 1e-3) == even
    if even:
        imp = torch.zeros(1, 1, *shape)
        imp[0, 0, 0, 0] = 1.0
        k = torch.arange(1, 10, dtype=torch.float32).reshape(1, 1, 3, 3)
        out = F.conv2d(TD._same_pad(imp, 3, 2), k, stride=2)
        assert float(out[0, 0, 0, 0]) == float(k[0, 0, 0, 0]) == 1.0


# --- detections ---

def _valid(det):
    v = np.asarray(det.valid)
    return (np.asarray(det.boxes)[v], np.asarray(det.scores)[v],
            np.asarray(det.classes)[v])


@pytest.mark.parametrize("width", [640, 320])
def test_detections_match_jax_above_the_margin(shipped, width):
    jd, td, frames = shipped[width]
    thr = jd.cfg.conf_threshold
    near = 0
    for img in frames:
        bj, sj, cj = _valid(jd.detect(img))
        bt, st, ct = _valid(td.detect(img))
        near += int((np.abs(sj - thr) < MARGIN).sum()
                    + (np.abs(st - thr) < MARGIN).sum())
        kj, kt = sj > thr + MARGIN, st > thr + MARGIN
        np.testing.assert_array_equal(ct[kt], cj[kj])
        np.testing.assert_allclose(bt[kt], bj[kj], rtol=0, atol=1e-3)
        np.testing.assert_allclose(st[kt], sj[kj], rtol=0, atol=1e-4)
        assert kj.any()
    print(f"{width}: {near} detections within {MARGIN} of the threshold")


def _crafted_maps(C=8, hh=6, ww=7):
    """Peaks of equal score in several cells and classes (more than the
    top-k keeps), far enough apart that NMS keeps them all."""
    heat = np.full((hh, ww, C), -6.0, np.float32)
    for (y, x, c) in [(0, 0, 0), (0, 3, 1), (0, 6, 2), (2, 0, 0),
                      (2, 3, 3), (2, 6, 5), (4, 0, 7), (4, 3, 0),
                      (4, 6, 0), (5, 3, 1)]:
        heat[y, x, c] = 2.0
    heat[5, 3, 1] = 1.0
    size = np.full((hh, ww, 2), 6.0, np.float32)
    off = np.full((hh, ww, 2), 0.25, np.float32)
    return heat, size, off


def test_postprocessing_ties_match_jax(monkeypatch):
    """Stable top-k (the lowest flat NHWC index on ties) and the first
    argmax in NMS, the class as ``index % C``: the two packages'
    post-processing on the same crafted maps keeps the same boxes in the
    same order."""
    cfg = dict(mode="online", max_detections=3, dynamic_classes=(0, 1, 2,
                                                                 3, 5, 7))
    jd = JD.Detector(JC.DetectorConfig(**cfg), 48, 56, n_classes=8)
    td = TD.Detector(TC.DetectorConfig(**cfg), 48, 56, n_classes=8,
                     device="cpu")
    heat, size, off = _crafted_maps()
    monkeypatch.setattr(jd.model, "apply", lambda p, x: (
        jnp.asarray(heat), jnp.asarray(size), jnp.asarray(off)))
    monkeypatch.setattr(td, "maps", lambda img: tuple(
        torch.from_numpy(a).permute(2, 0, 1) for a in (heat, size, off)))
    img = np.zeros((48, 56), np.float32)
    dj, dt = jd.detect(img), td.detect(img)
    np.testing.assert_array_equal(dt.valid.numpy(), np.asarray(dj.valid))
    np.testing.assert_array_equal(dt.classes.numpy(), np.asarray(dj.classes))
    np.testing.assert_array_equal(dt.boxes.numpy(), np.asarray(dj.boxes))
    assert np.asarray(dj.valid).all()
    np.testing.assert_array_equal(dt.classes.numpy(), [0, 1, 2])


# --- the weights file ---

def test_unpickler_refuses_non_numpy_globals(tmp_path, weights):
    tree = TD.load_params(weights)
    assert set(tree["params"]) == {f"ConvBlock_{i}" for i in range(7)} | \
        {"Conv_0", "Conv_1", "Conv_2"}

    class Evil:
        def __reduce__(self):
            return (print, ("not numpy",))
    p = tmp_path / "evil.npz"
    np.savez(p, blob=np.frombuffer(pickle.dumps({"params": Evil()}),
                                   np.uint8), n_classes=8)
    with pytest.raises(pickle.UnpicklingError, match="builtins.print"):
        TD.load_params(str(p))
    with pytest.raises(pickle.UnpicklingError):
        TD._NumpyUnpickler(io.BytesIO(pickle.dumps(io.BytesIO))).load()


def test_save_params_read_by_jax(tmp_path):
    td = TD.Detector(TC.DetectorConfig(mode="online"), 64, 80, seed=3,
                     n_classes=8, device="cpu")
    p = str(tmp_path / "det.npz")
    td.save_params(p)
    params = JD.Detector.load_params(p)
    jd = JD.Detector(JC.DetectorConfig(mode="online"), 64, 80,
                     params=params, n_classes=8)
    img = np.random.default_rng(2).uniform(0, 255, (64, 80)).astype(
        np.float32)
    _check_maps(jd, td, img)
    # and back: the port reads its own file as the JAX package's
    td2 = TD.Detector.from_npz(TC.DetectorConfig(mode="online"), 64, 80, p,
                               device="cpu")
    assert td2.n_classes == 8
    for a, b in zip(td.maps(img), td2.maps(img)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_reshape_boxes_stereo_as_jax():
    b = np.array([[0.0, 0.0, 10.0, 10.0], [5.5, 3.0, 40.0, 90.5]],
                 np.float32)
    np.testing.assert_array_equal(TD.reshape_boxes_stereo(b),
                                  JD.reshape_boxes_stereo(b))
