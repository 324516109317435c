"""Batched RANSAC (ops/ransac.py) of the port against the JAX package's, on
the same numpy-seeded inputs, JAX on the CPU and the port with CPU
tensors. JAX's minimal sets are drawn by its own PRNG and injected into
the port (``sample_idx``), since torch cannot reproduce threefry.

Tolerances: normalization, transfer and epipolar errors to rtol 1e-4;
batched weighted solves of 64 points (the refit's form; homographies
scaled to H[2,2] = 1, fundamental matrices to unit norm and a common
sign) to 1e-3 relative; the fits: the same best hypothesis, the
per-hypothesis inlier counts within 1 on at least 97% of the hypotheses
(a minimal set can be ill-conditioned in float32), the fit's inlier count
within 1 and the model within 1e-3 relative after scaling. The port's own sampler: repeatable, distinct
indices per hypothesis, only masked-in indices when at least k are."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_dynamic_tpu.ops import ransac as jr
from slam_dynamic_tpu_torch.ops import ransac as tr
from torch_port_util import to_t

N_HYP = 256


def _scene(rng, planar, n=400, outliers=0.3, noise=0.3):
    """Correspondences p1 -> p2 of two 640x480 views (fx 525) of points
    on a plane or at random depths, with Gaussian pixel noise and a share
    of outliers; an invalid tail masked out."""
    if planar:
        xy = rng.uniform(-2.0, 2.0, (n, 2))
        X = np.c_[xy, 4.0 + 0.3 * xy[:, 0]]
    else:
        X = np.c_[rng.uniform(-2.0, 2.0, (n, 2)), rng.uniform(2.0, 8.0, n)]
    a = 0.08
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.3, 0.05, 0.1])

    def proj(P):
        return np.c_[525 * P[:, 0] / P[:, 2] + 320,
                     525 * P[:, 1] / P[:, 2] + 240]
    p1 = proj(X) + rng.normal(0, noise, (n, 2))
    p2 = proj(X @ R.T + t) + rng.normal(0, noise, (n, 2))
    bad = rng.random(n) < outliers
    p2[bad] = rng.uniform([0, 0], [640, 480], (bad.sum(), 2))
    mask = np.ones(n, bool)
    mask[-40:] = False
    return p1.astype(np.float32), p2.astype(np.float32), mask


def _scaled_h(H):
    return H / H[..., 2:3, 2:3]


def _scaled_f(F):
    F = F / np.linalg.norm(F, axis=(-2, -1), keepdims=True)
    s = np.sign(np.take_along_axis(
        F.reshape(F.shape[:-2] + (9,)),
        np.abs(F.reshape(F.shape[:-2] + (9,))).argmax(-1)[..., None],
        -1))
    return F * s[..., None]


def test_hartley_matches_jax(rng):
    x = rng.uniform(0, 640, (16, 8, 2)).astype(np.float32)
    w = (rng.random((16, 8)) > 0.2).astype(np.float32)
    for a, b in zip(jr._hartley(jnp.asarray(x), jnp.asarray(w)),
                    tr._hartley(to_t(x), to_t(w))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("planar", [True, False])
def test_weighted_solves_batched_match_jax(rng, planar):
    """32 weighted 64-point systems (the refit's form; some weights 0)."""
    p1, p2, _ = _scene(rng, planar, n=2048, outliers=0.0)
    idx = rng.permutation(2048).reshape(32, 64)
    w = (rng.random((32, 64)) > 0.25).astype(np.float32)
    jsolve, tsolve, scaled = (jr._solve_h, tr._solve_h, _scaled_h) \
        if planar else (jr._solve_f, tr._solve_f, _scaled_f)
    a = scaled(np.asarray(jsolve(jnp.asarray(p1[idx]), jnp.asarray(p2[idx]),
                                 jnp.asarray(w))))
    b = scaled(tsolve(to_t(p1[idx]), to_t(p2[idx]), to_t(w)).numpy())
    scale = np.abs(a).max(axis=(-2, -1), keepdims=True)
    assert (np.abs(b - a) <= 1e-3 * scale).all()


def test_transfer_and_epipolar_errors_match_jax(rng):
    p1, p2, _ = _scene(rng, True, n=300)
    M = rng.normal(0, 1, (8, 3, 3)).astype(np.float32)
    M[:, 2, 2] += 4.0
    for jf, tf in ((jr.h_transfer_errors, tr.h_transfer_errors),
                   (jr.f_epipolar_errors, tr.f_epipolar_errors)):
        got = tf(to_t(M), to_t(p1), to_t(p2))
        want = jf(jnp.asarray(M), jnp.asarray(p1), jnp.asarray(p2))
        for g, w in zip(got, want):
            assert g.shape == (8, 300)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-6)


def _counts(solve, errors, p1, p2, mask, idx, th2=9.0):
    """Inlier count of every minimal-set hypothesis."""
    Ms = solve(p1[idx], p2[idx], p1[idx][..., 0] * 0 + 1)
    e1, e2 = errors(Ms, p1, p2)
    counts = ((e1 < th2) & (e2 < th2) & mask[None, :]).sum(-1)
    return counts


@pytest.mark.parametrize("model,planar", [("h", True), ("h", False),
                                          ("f", True), ("f", False)])
def test_fit_with_jax_samples_matches_jax(rng, model, planar):
    """The same minimal sets in both packages: the same best hypothesis,
    inlier counts within 1, the refit model within 1e-3 relative."""
    p1, p2, mask = _scene(rng, planar)
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    k = 4 if model == "h" else 8
    jidx = jr._sample_indices(key, N_HYP, k, p1.shape[0], jnp.asarray(mask))
    jfit = (jr.fit_homography if model == "h" else jr.fit_fundamental)(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask), key,
        n_hyp=N_HYP)
    tfit = (tr.fit_homography if model == "h" else tr.fit_fundamental)(
        to_t(p1), to_t(p2), to_t(mask), n_hyp=N_HYP,
        sample_idx=to_t(jidx).long())
    solve = (jr._solve_h, tr._solve_h) if model == "h" else \
        (jr._solve_f, tr._solve_f)
    errs = (jr.h_transfer_errors, tr.h_transfer_errors) if model == "h" \
        else (jr.f_epipolar_errors, tr.f_epipolar_errors)
    cj = np.asarray(_counts(solve[0], errs[0], jnp.asarray(p1),
                            jnp.asarray(p2), jnp.asarray(mask), jidx))
    ct = _counts(solve[1], errs[1], to_t(p1), to_t(p2), to_t(mask),
                 to_t(jidx).long()).numpy()
    assert (np.abs(ct - cj) <= 1).mean() >= 0.97
    assert int(ct.argmax()) == int(cj.argmax())
    assert abs(int(ct.max()) - int(cj.max())) <= 1
    assert abs(int(tfit.n_inliers) - int(jfit.n_inliers)) <= 1
    if planar == (model == "h"):      # the scene's own model
        assert int(jfit.n_inliers) > 100
    assert (tfit.inliers.numpy() != np.asarray(jfit.inliers)).sum() <= 1
    scaled = _scaled_h if model == "h" else _scaled_f
    a, b = scaled(np.asarray(jfit.M)), scaled(tfit.M.numpy())
    assert (np.abs(b - a) <= 1e-3 * np.abs(a).max()).all(), (a, b)


def test_port_sampler_repeatable_distinct_and_masked(rng):
    mask = rng.random(500) < 0.5
    seed = torch.tensor(1234, dtype=torch.int32)
    a = tr.sample_indices(seed, 0, N_HYP, 8, to_t(mask))
    b = tr.sample_indices(seed, 0, N_HYP, 8, to_t(mask))
    assert a.shape == (N_HYP, 8)
    assert torch.equal(a, b)
    assert not torch.equal(a, tr.sample_indices(seed + 1, 0, N_HYP, 8,
                                                to_t(mask)))
    assert not torch.equal(a, tr.sample_indices(seed, 1, N_HYP, 8,
                                                to_t(mask)))
    an = a.numpy()
    assert all(len(set(r)) == 8 for r in an)
    assert mask[an].all()
    # every valid point is drawn somewhere across the hypotheses
    assert len(np.unique(an)) > 0.9 * mask.sum()
    # fewer valid points than k: all of them, then the lowest masked-out
    # indices (the -inf ties keep the lowest index)
    few = np.zeros(50, bool)
    few[[7, 30, 41]] = True
    c = tr.sample_indices(seed, 0, 4, 5, to_t(few)).numpy()
    for row in c:
        assert sorted(row[:3]) == [7, 30, 41]
        assert list(row[3:]) == [0, 1]
    # a negative seed (the pose-derived sum wraps in int32) is fine
    d = tr.sample_indices(torch.tensor(-5, dtype=torch.int32), 0, 4, 4,
                          to_t(mask)).numpy()
    assert mask[d].all()
