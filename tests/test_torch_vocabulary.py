"""The port's vocabulary (models/vocabulary.py) against the JAX package's:
``load`` of the shipped asset, ``transform``, ``sparse_bow`` and the
host-numpy ``train``, on inputs made from a numpy seed.

Tolerances: loaded arrays, words, nodes and trained centroids are equal
exactly; BoW weights agree within rtol 1e-6 (sums of a few float32
weights and their L1 norm are taken in another order)."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_dynamic_tpu.models import vocabulary as jvoc
from slam_dynamic_tpu_torch.frontend.frame import build_frame
from slam_dynamic_tpu_torch.models import vocabulary as tvoc
from slam_dynamic_tpu_torch.system import intrinsics_from_config
from torch_port_util import configs, small_world, to_t


@pytest.fixture(scope="module")
def vocs():
    path = tvoc.default_vocab_path()
    assert path.endswith("vocab_synth_100k.npz")
    assert os.path.samefile(path, jvoc.default_vocab_path())
    return jvoc.load(jvoc.default_vocab_path()), tvoc.load(path, "cpu")


@pytest.fixture(scope="module")
def frame_desc():
    """Descriptors and validity of frame 0 of the 320x240 world."""
    scfg, seq, gray8, depth16 = small_world(n_frames=1)
    tcfg = configs(scfg)[1]
    fr = build_frame(tcfg, intrinsics_from_config(tcfg, "cpu"), gray8[0], 0,
                     0.0, depth16[0])
    return fr.data.desc.numpy().view(np.uint32), fr.data.valid.numpy()


def _random_desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def test_load_shipped_asset_gives_equal_arrays(vocs):
    jv, tv = vocs
    assert (tv.k, tv.levels, tv.n_words) == (jv.k, jv.levels, jv.n_words)
    for a, b in zip(jv.centroids, tv.centroids):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).view(np.int32))
    np.testing.assert_array_equal(tv.weights.numpy(), np.asarray(jv.weights))


def _check_transform(jv, tv, desc, valid, di_level=2):
    ref = jvoc.transform(jv, jnp.asarray(desc), jnp.asarray(valid),
                         di_level=di_level)
    got = tvoc.transform(tv, to_t(desc), torch.from_numpy(valid),
                         di_level=di_level)
    np.testing.assert_array_equal(got.word.numpy(), np.asarray(ref.word))
    np.testing.assert_array_equal(got.node.numpy(), np.asarray(ref.node))
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(ref.weight),
                               rtol=1e-6, atol=0)
    return ref, got


@pytest.mark.parametrize("di_level", [2, 4])
def test_transform_random_descriptors_with_mask(vocs, di_level):
    rng = np.random.default_rng(di_level)
    desc = _random_desc(rng, 700)
    desc[100:120] = desc[0]                    # repeated descriptors
    valid = rng.uniform(size=700) < 0.8
    _check_transform(*vocs, desc, valid, di_level)


def test_transform_real_frame_descriptors(vocs, frame_desc):
    ref, _ = _check_transform(*vocs, *frame_desc)
    assert int((np.asarray(ref.word) >= 0).sum()) > 300


def _check_sparse_bow(word, weight, top_w):
    ref = jvoc._sparse_bow_impl(jnp.asarray(word), jnp.asarray(weight), top_w)
    got = tvoc.sparse_bow(tvoc.BowVector(torch.from_numpy(word),
                                         torch.from_numpy(word),
                                         torch.from_numpy(weight)), top_w)
    np.testing.assert_array_equal(got.word.numpy(), np.asarray(ref.word))
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(ref.weight),
                               rtol=1e-6, atol=0)
    return got


@pytest.mark.parametrize("top_w", [1024, 16, 5])
def test_sparse_bow_duplicate_words_and_tied_weights(top_w):
    """Words repeat (summed into one entry), several distinct words carry
    the same weight (ties at the top-W cut go to the lower slot), and
    invalid slots (-1) carry junk weights that must not count."""
    rng = np.random.default_rng(top_w)
    n = 200
    word = rng.integers(0, 40, n).astype(np.int32)
    weight = np.round(rng.uniform(0.5, 3.0, 40), 1).astype(np.float32)[word]
    weight[word % 7 == 0] = 1.5                # tied sums across words
    invalid = rng.uniform(size=n) < 0.2
    word[invalid] = -1
    weight[invalid] = 9.0
    got = _check_sparse_bow(word, weight, top_w)
    assert (got.word.numpy()[:-1] <= got.word.numpy()[1:]).all()


def test_sparse_bow_of_a_real_frame(vocs, frame_desc):
    jv, tv = vocs
    bv = tvoc.transform(tv, to_t(frame_desc[0]),
                        torch.from_numpy(frame_desc[1]))
    got = _check_sparse_bow(bv.word.numpy(), bv.weight.numpy(), 1024)
    assert abs(float(got.weight.sum()) - 1.0) < 1e-5


def test_sparse_bow_of_no_valid_word():
    word = np.full(32, -1, np.int32)
    got = _check_sparse_bow(word, np.ones(32, np.float32), 8)
    assert (got.word.numpy() == tvoc.PAD_WORD).all()
    assert (got.weight.numpy() == 0).all()


@pytest.mark.parametrize("k,levels", [(4, 2), (3, 3)])
def test_train_small_corpus_is_exact(k, levels):
    rng = np.random.default_rng(k * 10 + levels)
    base = _random_desc(rng, 12)
    # clustered corpus: noisy copies of a few centers, plus duplicates
    noise = rng.integers(0, 2**32, (400, 8), dtype=np.uint32) & \
        rng.integers(0, 2**32, (400, 8), dtype=np.uint32) & \
        rng.integers(0, 2**32, (400, 8), dtype=np.uint32)
    corpus = base[rng.integers(0, 12, 400)] ^ noise
    corpus[50:60] = corpus[0]
    ref = jvoc.train(corpus, k=k, levels=levels, seed=3)
    got = tvoc.train(corpus, k=k, levels=levels, seed=3, device="cpu")
    assert (got.k, got.levels) == (ref.k, ref.levels)
    for a, b in zip(ref.centroids, got.centroids):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).view(np.int32))
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(ref.weights))
    valid = np.ones(len(corpus), bool)
    _check_transform(ref, got, corpus, valid, di_level=levels - 1)


# --- the DBoW2 text format, .npz save and the scoring family -----------

def _trained(rng, n, k, levels, seed):
    """The same small vocabulary in both packages (``train`` is exact)."""
    corpus = _random_desc(rng, n)
    return (jvoc.train(corpus, k=k, levels=levels, seed=seed),
            tvoc.train(corpus, k=k, levels=levels, seed=seed, device="cpu"))


def _same_words(jv, tv, q):
    """Both vocabularies give the same words and weights to ``q``."""
    bj = jvoc.transform(jv, jnp.asarray(q), jnp.ones(len(q), bool))
    bt = tvoc.transform(tv, torch.from_numpy(q.view(np.int32)),
                        torch.ones(len(q), dtype=torch.bool))
    np.testing.assert_array_equal(bt.word.numpy(), np.asarray(bj.word))
    np.testing.assert_allclose(bt.weight.numpy(), np.asarray(bj.weight),
                               rtol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_orbvoc_text_written_by_either_package_loads_in_both(writer,
                                                             tmp_path):
    """``tests/test_vocabulary.py:213``: a text vocabulary round-trips, and
    the file one package writes is the other's byte for byte."""
    rng = np.random.default_rng(5)
    jv, tv = _trained(rng, 2000, 3, 3, 5)
    pj, pt = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    jvoc.save_orbvoc_text(pj, jv)
    tvoc.save_orbvoc_text(pt, tv)
    assert open(pj).read() == open(pt).read()
    path = pj if writer == "jax" else pt
    jv2, tv2 = jvoc.load_orbvoc_text(path), tvoc.load_orbvoc_text(path,
                                                                  "cpu")
    assert (tv2.k, tv2.levels) == (3, 3)
    for a, b in zip(jv2.centroids, tv2.centroids):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).view(np.int32))
    np.testing.assert_array_equal(tv2.weights.numpy(),
                                  np.asarray(jv2.weights))
    _same_words(jv, tv2, _random_desc(rng, 200))


def test_orbvoc_text_incomplete_tree_matches_jax(tmp_path):
    """``tests/test_vocabulary.py:232``'s tree with a shallow leaf and a
    missing sibling: the same hole filling, words and weights."""
    def line(parent, leaf, byte, weight):
        return f"{parent} {leaf} {' '.join([str(byte)] * 32)} {weight}\n"
    p = tmp_path / "voc.txt"
    p.write_text("2 2  0 0\n" + line(0, 1, 0, 0.7) + line(0, 0, 255, 0.0)
                 + line(2, 1, 240, 0.3))
    jv, tv = jvoc.load_orbvoc_text(str(p)), tvoc.load_orbvoc_text(str(p),
                                                                  "cpu")
    assert tv.n_words == 4
    for a, b in zip(jv.centroids, tv.centroids):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).view(np.int32))
    q = np.stack([np.zeros(8, np.uint32), np.full(8, 0xFFFFFFFF, np.uint32)])
    bt = tvoc.transform(tv, torch.from_numpy(q.view(np.int32)),
                        torch.ones(2, dtype=torch.bool))
    assert bt.word.tolist() == [0, 2]
    np.testing.assert_allclose(bt.weight.numpy(), [0.7, 0.3], rtol=1e-6)
    _same_words(jv, tv, q)


def test_npz_saved_by_either_package_loads_in_both(tmp_path):
    rng = np.random.default_rng(8)
    jv, tv = _trained(rng, 800, 4, 2, 2)
    jvoc.save(str(tmp_path / "jax.npz"), jv)
    tvoc.save(str(tmp_path / "port.npz"), tv)
    for name in ("jax.npz", "port.npz"):
        jv2 = jvoc.load(str(tmp_path / name))
        tv2 = tvoc.load(str(tmp_path / name), "cpu")
        for a, b, c in zip(jv.centroids, jv2.centroids, tv2.centroids):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            np.testing.assert_array_equal(c.numpy(),
                                          np.asarray(a).view(np.int32))
        np.testing.assert_array_equal(tv2.weights.numpy(),
                                      np.asarray(jv.weights))


SCORES = ["score_l1", "score_l2", "score_chi_square", "score_bhattacharyya",
          "score_dot", "score_kl"]


@pytest.fixture(scope="module")
def bows():
    """``tests/test_vocabulary.py:180``'s inputs: a 64-word vocabulary and
    two frames of 120 random descriptors, as BoW vectors, sparse vectors
    and dense histograms in both packages."""
    rng = np.random.default_rng(0)
    jv, tv = _trained(rng, 2500, 4, 3, 6)
    out = {"n": tv.n_words}
    for name in ("a", "b"):
        d = _random_desc(rng, 120)
        bj = jvoc.transform(jv, jnp.asarray(d), jnp.ones(120, bool))
        bt = tvoc.transform(tv, torch.from_numpy(d.view(np.int32)),
                            torch.ones(120, dtype=torch.bool))
        out[name] = dict(
            jq=jvoc.sparse_bow(bj, 128), tq=tvoc.sparse_bow(bt, 128),
            jh=jvoc.bow_histogram(bj, tv.n_words),
            th=tvoc.bow_histogram(bt, tv.n_words))
    return out


def test_bow_histogram_and_l1_score_match_jax(bows):
    for name in ("a", "b"):
        np.testing.assert_allclose(bows[name]["th"].numpy(),
                                   np.asarray(bows[name]["jh"]), atol=1e-6)
    a, b = bows["a"], bows["b"]
    sj = float(jvoc.l1_score(a["jh"], b["jh"]))
    st = float(tvoc.l1_score(a["th"], b["th"]))
    assert abs(st - sj) < 1e-6, (st, sj)
    # the dense L1 score is the sparse one (``test_vocabulary.py:193``)
    assert abs(float(tvoc.score_l1(a["tq"], b["tq"])) - st) < 1e-5


@pytest.mark.parametrize("name", SCORES)
def test_scoring_family_matches_jax(bows, name):
    """Each DBoW2 score of the port equals JAX's on the same sparse
    vectors (within 1e-6, 1e-5 for KL's logarithms), and the self-score
    extremes of ``test_vocabulary.py:208-210`` hold."""
    a, b = bows["a"], bows["b"]
    tol = 1e-5 if name == "score_kl" else 1e-6
    for x, y in ((a, b), (b, a), (a, a)):
        sj = float(getattr(jvoc, name)(x["jq"], y["jq"]))
        st = float(getattr(tvoc, name)(x["tq"], y["tq"]))
        assert abs(st - sj) < tol, (name, st, sj)
    if name == "score_l1":
        assert float(tvoc.score_l1(a["tq"], a["tq"])) > 0.999
    if name == "score_kl":
        assert float(tvoc.score_kl(a["tq"], a["tq"])) < 1e-5
