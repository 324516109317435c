"""Loop detection of the port against the JAX package's: the keyframe
database (``kfdb.add``, ``scores``, ``query``), the detection packet
(``_detect_device``) and ``LoopCloser.on_keyframe``, on sparse BoW vectors
of random words made from a numpy seed.

Tolerances: database rows, shared-word counts, candidate indices and
covisibility rows are equal exactly; scores agree within atol 1e-6
(float32 sums over up to 1024 words, taken in another order)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_dynamic_tpu.backend import loop_closing as jlc
from slam_dynamic_tpu.models import vocabulary as jvoc
from slam_dynamic_tpu.worldmap import kfdb as jdb
from slam_dynamic_tpu_torch.backend import loop_closing as tlc
from slam_dynamic_tpu_torch.models import vocabulary as tvoc
from slam_dynamic_tpu_torch.system import intrinsics_from_config
from slam_dynamic_tpu_torch.worldmap import kfdb as tdb
from slam_dynamic_tpu_torch.worldmap.state import empty_map
from torch_port_util import configs, small_world

K = 12
N_WORDS = 3000


def _bows(rng, n_kf, n=400):
    """n_kf (JAX SparseBow, port SparseBow) pairs; keyframes share words
    with their neighbours, as a moving camera's do."""
    base = rng.integers(0, N_WORDS, n)
    out = []
    for k in range(n_kf):
        word = base.copy()
        swap = rng.uniform(size=n) < 0.15 * (k % 5 + 1)
        word[swap] = rng.integers(0, N_WORDS, int(swap.sum()))
        word = word.astype(np.int32)
        word[rng.uniform(size=n) < 0.1] = -1
        weight = np.where(word >= 0, 0.1 + (word % 13) / 4.0,
                          0.0).astype(np.float32)
        ref = jvoc._sparse_bow_impl(jnp.asarray(word), jnp.asarray(weight),
                                    tdb.TOP_WORDS)
        got = tvoc.sparse_bow(tvoc.BowVector(torch.from_numpy(word),
                                             torch.from_numpy(word),
                                             torch.from_numpy(weight)),
                              tdb.TOP_WORDS)
        out.append((ref, got))
    return out


@pytest.fixture(scope="module")
def dbs():
    rng = np.random.default_rng(0)
    bows = _bows(rng, K + 1)
    jd = jdb.KFDatabase.empty(K, tdb.TOP_WORDS)
    td = tdb.KFDatabase.empty(K, tdb.TOP_WORDS, device="cpu")
    for k in range(K - 1):                     # the last row stays empty
        jd = jdb.add(jd, k, bows[k][0])
        td = tdb.add(td, k, bows[k][1])
    covis = rng.integers(0, 40, (K, K)).astype(np.int32)
    covis = np.triu(covis, 1)
    covis = covis + covis.T
    covis[rng.uniform(size=(K, K)) < 0.5] = 0
    covis = np.minimum(covis, covis.T)
    kf_valid = np.ones(K, bool)
    kf_valid[[2, 7]] = False
    return dict(jax=jd, port=td, query=bows[K], covis=covis,
                kf_valid=kf_valid)


def test_add_and_erase_rows_equal(dbs):
    jd, td = dbs["jax"], dbs["port"]
    np.testing.assert_array_equal(td.word.numpy(), np.asarray(jd.word))
    np.testing.assert_allclose(td.weight.numpy(), np.asarray(jd.weight),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    np.testing.assert_array_equal(tdb.erase(td, 3).valid.numpy(),
                                  np.asarray(jdb.erase(jd, 3).valid))


def test_scores_equal(dbs):
    qj, qt = dbs["query"]
    sj, hj = jdb.scores(dbs["jax"], qj)
    st, ht = tdb.scores(dbs["port"], qt)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6, rtol=0)
    assert int(ht[:K - 1].min()) > 0 and int(ht[K - 1]) == 0


@pytest.mark.parametrize("min_score", [0.0, 0.05])
def test_query_equal(dbs, min_score):
    qj, qt = dbs["query"]
    exclude = np.zeros(K, bool)
    exclude[[0, 5]] = True
    ref = jdb.query(dbs["jax"], qj, jnp.asarray(dbs["covis"]),
                    jnp.asarray(exclude), min_score=min_score)
    got = tdb.query(dbs["port"], qt, torch.from_numpy(dbs["covis"]),
                    torch.from_numpy(exclude), min_score=min_score)
    np.testing.assert_array_equal(got.shared.numpy(), np.asarray(ref.shared))
    for a, b in ((got.score, ref.score), (got.accumulated, ref.accumulated)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)
    np.testing.assert_array_equal(got.score.numpy() > 0,
                                  np.asarray(ref.score) > 0)


@pytest.mark.parametrize("k", [0, 4, 9])
def test_detect_device_packet_equal(dbs, k):
    qj, qt = dbs["query"]
    ref = np.asarray(jlc._detect_device(
        dbs["jax"], qj, jnp.asarray(dbs["covis"]),
        jnp.asarray(dbs["kf_valid"]), jnp.int32(k)))
    got = tlc._detect_device(dbs["port"], qt, torch.from_numpy(dbs["covis"]),
                             torch.from_numpy(dbs["kf_valid"]), k).numpy()
    assert got[0] == ref[0]
    np.testing.assert_allclose(got[1], ref[1], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[2:], ref[2:])
    assert ref[1] > 0 and ref[0] not in (2, 7, k)


def _closer(monkeypatch, detect):
    scfg, *_ = small_world(n_frames=1)
    tcfg = configs(scfg)[1]
    cam = intrinsics_from_config(tcfg, "cpu")
    voc = tvoc.load(tvoc.default_vocab_path(), "cpu")
    monkeypatch.setattr(tlc.LoopCloser, "_detect", detect)
    rng = np.random.default_rng(3)
    m = empty_map(tcfg.capacity, "cpu")
    desc = torch.from_numpy(rng.integers(0, 2**32, m.kf_kp_desc.shape[1:],
                                         dtype=np.uint32).view(np.int32))
    m = m._replace(kf_kp_desc=m.kf_kp_desc.clone().index_put_(
        (torch.tensor([1]),), desc[None]),
        kf_kp_valid=torch.ones_like(m.kf_kp_valid))
    return tlc.LoopCloser(tcfg, cam, voc), m


def test_on_keyframe_raises_on_a_candidate(monkeypatch):
    """A candidate no longer raises: on_keyframe verifies it
    (``_compute_sim3``); a failed verification leaves the map alone, a
    verified one runs the correction and the fuse and closes the loop.
    Either way the keyframe's vector is added to the database."""
    calls = []

    def detect(self, m, k, hist, seq=None):
        calls.append(("detect", k, seq))
        return 0
    closer, m = _closer(monkeypatch, detect)
    verdicts = iter([(False, None, None, None, 0, 0),
                     (True, torch.tensor(1.0), torch.eye(3), torch.zeros(3),
                      33, 61)])

    def compute_sim3(self, m, k, cand, stereo):
        calls.append(("sim3", k, cand, stereo))
        return next(verdicts)
    monkeypatch.setattr(tlc.LoopCloser, "_compute_sim3", compute_sim3)
    monkeypatch.setattr(tlc.LoopCloser, "_correct",
                        lambda self, m, k, c, s, R, t:
                        calls.append(("correct", k, c)) or m)
    monkeypatch.setattr(tlc.LoopCloser, "_search_and_fuse",
                        lambda self, m, k, c:
                        calls.append(("fuse", k, c)) or m)
    _, result = closer.on_keyframe(m, 1, True, seq=12)
    assert not result.closed and closer.last_loop_kf < 0
    _, result = closer.on_keyframe(m, 1, True, seq=13)
    assert result == tlc.LoopResult(True, 0, 33, 61)
    assert calls == [("detect", 1, 12), ("sim3", 1, 0, True),
                     ("detect", 1, 13), ("sim3", 1, 0, True),
                     ("correct", 1, 0), ("fuse", 1, 0)]
    assert (closer.n_candidates, closer.n_closed, closer.last_loop_kf) == \
        (2, 1, 13)
    assert bool(closer.db.valid[1])


def test_on_keyframe_adds_every_keyframe(monkeypatch):
    """Before the 10th keyframe there is no detection, and every keyframe's
    vector is added to the database."""
    calls = []

    def detect(self, m, k, hist, seq=None):
        calls.append(seq)
        return -1
    closer, m = _closer(monkeypatch, detect)
    for seq in (3, 10):
        m, result = closer.on_keyframe(m, 1, True, seq=seq)
        assert not result.closed
    assert calls == [10]
    assert bool(closer.db.valid[1]) and int(closer.db.valid.sum()) == 1
    assert int((closer.db.word[1] >= 0).sum()) > 100


def test_detect_streaks_match_jax(monkeypatch):
    """The streak bookkeeping of _detect, fed the same scripted packets in
    both packages: a candidate group seen in consecutive keyframes
    reaches the consistency threshold, a zero score or a skipped keyframe
    resets the streaks."""
    scfg, *_ = small_world(n_frames=1)
    jcfg, tcfg = configs(scfg)
    kf = 8

    def packet(best, score, group):
        row = np.zeros(kf, np.float32)
        row[list(group)] = 1.0
        return np.concatenate([[best, score], row]).astype(np.float32)

    script = [(10, packet(3, 0.2, [2])), (11, packet(2, 0.3, [3, 4])),
              (12, packet(4, 0.1, [5])), (13, packet(4, 0.0, [])),
              (14, packet(1, 0.2, [])), (15, packet(1, 0.2, [6])),
              (17, packet(6, 0.2, [1])), (18, packet(1, 0.4, [6])),
              (19, packet(6, 0.3, []))]
    packets = iter([p for _, p in script])
    monkeypatch.setattr(tlc, "_detect_device",
                        lambda *a: torch.from_numpy(next(packets)))
    closer = tlc.LoopCloser.__new__(tlc.LoopCloser)
    closer.cfg, closer.db, closer.streaks = tcfg, None, {}
    closer._last_detect_kf = -1000
    got = []
    m = empty_map(tcfg.capacity, "cpu")
    for seq, _ in script:
        got.append((closer._detect(m, 0, None, seq), dict(closer.streaks)))

    jpackets = iter([jnp.asarray(p) for _, p in script])
    monkeypatch.setattr(jlc, "_detect_device", lambda *a: next(jpackets))
    jcloser = jlc.LoopCloser.__new__(jlc.LoopCloser)
    jcloser.cfg, jcloser.db, jcloser.streaks = jcfg, None, {}
    jcloser._last_detect_kf = -1000
    ref = []

    class _M:
        covis = kf_valid = None
    for seq, _ in script:
        ref.append((jcloser._detect(_M, 0, None, seq),
                    dict(jcloser.streaks)))
    assert got == ref
    assert [r for r, _ in got].count(-1) < len(got)   # a candidate fired
