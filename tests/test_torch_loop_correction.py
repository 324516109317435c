"""Loop correction of the port against the JAX package's: the Sim3 group
(``utils/sim3.py``), Horn's closed form and the Sim3 RANSAC
(``ops/horn.py``), the relative Sim3 optimization
(``optim/sim3_opt.py``), the essential-graph solve
(``optim/pose_graph.py``), the loop landmark set with its ties and
``LoopCloser._correct`` on a synthetic map with a persistent loop edge.
Inputs are made from a numpy seed; JAX runs on the CPU and the port with
``device="cpu"``.

Tolerances: the Sim3 functions within 1e-5 (float32 closed forms);
RANSAC fits fed JAX's own samples pick the same best hypothesis: equal
inlier counts and masks, the model within 1e-4; the optimizers from the
same start within 1e-3 rad and 1e-3 m (float32 iterations with their own
summation order), their Jacobians within 1e-4 relative to the largest
entry; the landmark set equal; ``_correct`` within 1e-3 rad and 1e-3 m
with the same loop-edge table."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam_dynamic_tpu.backend import loop_closing as jlc
from slam_dynamic_tpu.config import (CameraConfig, CapacityConfig,
                                     SystemConfig)
from slam_dynamic_tpu.models import vocabulary as jvoc
from slam_dynamic_tpu.ops import horn as jhorn
from slam_dynamic_tpu.ops.ransac import _sample_indices
from slam_dynamic_tpu.optim import pose_graph as jpg
from slam_dynamic_tpu.optim import sim3_opt as jso
from slam_dynamic_tpu.system import intrinsics_from_config as jintr
from slam_dynamic_tpu.utils import sim3 as js3
from slam_dynamic_tpu.worldmap import state as jstate
from slam_dynamic_tpu_torch import config as TC
from slam_dynamic_tpu_torch.backend import loop_closing as tlc
from slam_dynamic_tpu_torch.convert import (config_from_dict,
                                            map_state_from_numpy)
from slam_dynamic_tpu_torch.models import vocabulary as tvoc
from slam_dynamic_tpu_torch.ops import horn as thorn
from slam_dynamic_tpu_torch.optim import pose_graph as tpg
from slam_dynamic_tpu_torch.optim import sim3_opt as tso
from slam_dynamic_tpu_torch.system import intrinsics_from_config as tintr
from slam_dynamic_tpu_torch.utils import sim3 as ts3
from slam_dynamic_tpu_torch.worldmap import state as tstate
from torch_port_util import asdict, check_orbit_closure, map_arrays


def _rot(rng, scale):
    from scipy.spatial.transform import Rotation
    return Rotation.from_rotvec(rng.normal(0, scale, 3)).as_matrix().astype(
        np.float32)


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol)


# --- utils/sim3.py ------------------------------------------------------

@pytest.mark.parametrize("phi_scale,sigma_scale",
                         [(0.5, 0.2), (1e-7, 0.2), (0.5, 1e-7), (1e-7, 0.0),
                          (2.5, 0.5)])
def test_sim3_exp_log_W_match_jax(rng, phi_scale, sigma_scale):
    """exp, log and W on batches spanning the small-angle and small-sigma
    branches."""
    xi = rng.normal(0, 1, (16, 7)).astype(np.float32)
    xi[:, 3:6] *= phi_scale
    xi[:, 6] *= sigma_scale
    js = js3.sim3_exp(jnp.asarray(xi))
    ts = ts3.sim3_exp(torch.from_numpy(xi))
    for a, b in zip(js, ts):
        _close(b.numpy(), a, 1e-5)
    _close(ts3._sim3_W(torch.from_numpy(xi[:, 3:6]),
                       torch.from_numpy(xi[:, 6])).numpy(),
           js3._sim3_W(jnp.asarray(xi[:, 3:6]), jnp.asarray(xi[:, 6])), 1e-5)
    back = ts3.sim3_log(*ts)
    _close(back.numpy(), js3.sim3_log(*js), 1e-5 * max(1.0, phi_scale))


def test_sim3_compose_inverse_apply_match_jax(rng):
    s = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    R = np.stack([_rot(rng, 1.0) for _ in range(8)])
    t = rng.normal(0, 1, (8, 3)).astype(np.float32)
    x = rng.normal(0, 1, (8, 3)).astype(np.float32)
    J = [jnp.asarray(a) for a in (s, R, t)]
    T = [torch.from_numpy(a) for a in (s, R, t)]
    for a, b in zip(js3.sim3_inverse(*J), ts3.sim3_inverse(*T)):
        _close(b.numpy(), a, 1e-5)
    for a, b in zip(js3.sim3_compose(*J, *js3.sim3_inverse(*J)),
                    ts3.sim3_compose(*T, *ts3.sim3_inverse(*T))):
        _close(b.numpy(), a, 1e-5)
    _close(ts3.sim3_apply(*T, torch.from_numpy(x)).numpy(),
           js3.sim3_apply(*J, jnp.asarray(x)), 1e-5)
    for a, b in zip(js3.sim3_identity(), ts3.sim3_identity()):
        _close(b.numpy(), a, 0.0)


# --- ops/horn.py ----------------------------------------------------------

CAM = dict(fx=260.0, fy=260.0, cx=159.5, cy=119.5, width=320, height=240)


def _cams():
    cfg = SystemConfig(camera=CameraConfig(**CAM))
    return jintr(cfg), tintr(config_from_dict(asdict(cfg)), "cpu")


def _sim3_scene(rng, n=300, outliers=0.3, scale=1.0):
    """Camera-1 points, their camera-2 twins under a Sim3, pixels with
    0.3 px noise, a share of outlier pairs and invalid tail pairs."""
    x1 = rng.uniform([-2, -1.5, 2.5], [2, 1.5, 7], (n, 3)).astype(np.float32)
    R = _rot(rng, 0.15)
    t = np.array([0.2, -0.05, 0.1], np.float32)
    x2 = (scale * x1 @ R.T + t).astype(np.float32)
    bad = rng.uniform(size=n) < outliers
    x2[bad] += rng.normal(0, 0.5, (int(bad.sum()), 3)).astype(np.float32)

    def pix(x):
        return np.stack([CAM["fx"] * x[:, 0] / x[:, 2] + CAM["cx"],
                         CAM["fy"] * x[:, 1] / x[:, 2] + CAM["cy"]],
                        1).astype(np.float32) + rng.normal(
            0, 0.3, (n, 2)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-25:] = False
    return x1, x2, pix(x1), pix(x2), mask


@pytest.mark.parametrize("fix_scale", [True, False])
def test_horn_sim3_matches_jax(rng, fix_scale):
    x1, x2, _, _, mask = _sim3_scene(rng, outliers=0.0, scale=1.3)
    w = mask.astype(np.float32)
    a = jhorn.horn_sim3(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w),
                        fix_scale)
    b = thorn.horn_sim3(torch.from_numpy(x1), torch.from_numpy(x2),
                        torch.from_numpy(w), fix_scale)
    for u, v in zip(a, b):
        _close(v.numpy(), u, 1e-5)
    if not fix_scale:
        assert abs(float(b[0]) - 1.3) < 1e-4


@pytest.mark.parametrize("fix_scale", [True, False])
def test_ransac_sim3_with_jax_samples_matches_jax(rng, fix_scale):
    x1, x2, uv1, uv2, mask = _sim3_scene(rng)
    jc, tc = _cams()
    key = jax.random.PRNGKey(1234 + 7)
    idx = np.asarray(_sample_indices(key, 128, 3, len(x1), jnp.asarray(mask)))
    ref = jhorn.ransac_sim3(jc, jc, *(jnp.asarray(a) for a in
                                      (x1, x2, uv1, uv2, mask)), key,
                            fix_scale=fix_scale)
    got = thorn.ransac_sim3(tc, tc, *(torch.from_numpy(a) for a in
                                      (x1, x2, uv1, uv2, mask)),
                            fix_scale=fix_scale,
                            sample_idx=torch.from_numpy(idx))
    assert int(got.n_inliers) == int(ref.n_inliers) > 150
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(ref.inliers))
    for a, b in ((ref.s, got.s), (ref.R, got.R), (ref.t, got.t)):
        _close(b.numpy(), a, 1e-4)
    # the port's own draw reaches the same consensus
    own = thorn.ransac_sim3(tc, tc, *(torch.from_numpy(a) for a in
                                      (x1, x2, uv1, uv2, mask)),
                            seed=torch.tensor(1241), fix_scale=fix_scale)
    assert abs(int(own.n_inliers) - int(ref.n_inliers)) <= 2


# --- optim/sim3_opt.py ----------------------------------------------------

def _sim3_problem(rng):
    x1, x2, uv1, uv2, mask = _sim3_scene(rng, outliers=0.2)
    lvl1 = rng.integers(0, 4, len(x1)).astype(np.float32)
    lvl2 = rng.integers(0, 4, len(x1)).astype(np.float32)
    inv1 = (1.0 / 1.2 ** (2 * lvl1)).astype(np.float32)
    inv2 = (1.0 / 1.2 ** (2 * lvl2)).astype(np.float32)
    R0 = _rot(rng, 0.15)
    return x1, x2, uv1, uv2, inv1, inv2, mask, R0


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_sim3_matches_jax(rng, fix_scale):
    x1, x2, uv1, uv2, inv1, inv2, mask, _ = _sim3_problem(rng)
    jc, tc = _cams()
    # a start near the truth: Horn on the inlier half
    w = np.zeros(len(x1), np.float32)
    w[:120] = 1.0
    s0, R0, t0 = (np.asarray(a) for a in jhorn.horn_sim3(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w), fix_scale))
    R0 = (_rot(rng, 0.01) @ R0).astype(np.float32)
    t0 = (t0 + np.array([0.01, -0.01, 0.02], np.float32)).astype(np.float32)
    args = (x1, x2, uv1, uv2, inv1, inv2, mask)
    ref = jso.optimize_sim3(jc, jc, jnp.float32(s0), jnp.asarray(R0),
                            jnp.asarray(t0), *(jnp.asarray(a) for a in args),
                            fix_scale=fix_scale)
    got = tso.optimize_sim3(tc, tc, torch.tensor(float(s0)),
                            torch.from_numpy(R0), torch.from_numpy(t0),
                            *(torch.from_numpy(a) for a in args),
                            fix_scale=fix_scale)
    _close(got.R.numpy(), ref.R, 1e-3)
    _close(got.t.numpy(), ref.t, 1e-3)
    _close(got.s.numpy(), ref.s, 1e-3)
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 2
    assert int(ref.n_inliers) > 150


def test_sim3_opt_jacobian_matches_jax(rng):
    x1, x2, uv1, uv2, *_ = _sim3_problem(rng)
    jc, tc = _cams()
    s, R, t = 1.1, _rot(rng, 0.2), np.array([0.1, 0.2, -0.1], np.float32)

    def res(xi):
        ds, dR, dt = js3.sim3_exp(xi)
        g = js3.sim3_compose(ds, dR, dt, jnp.float32(s), jnp.asarray(R),
                             jnp.asarray(t))
        return jso._residuals(jc, jc, g, *(jnp.asarray(a) for a in
                                            (x1, x2, uv1, uv2)))[0]
    ref = np.asarray(jax.jacfwd(res)(jnp.zeros(7)))
    got = tso.sim3_jacobian(tc, tc, (torch.tensor(s), torch.from_numpy(R),
                                     torch.from_numpy(t)),
                            *(torch.from_numpy(a) for a in
                              (x1, x2, uv1, uv2)), fix_scale=False).numpy()
    assert got.shape == ref.shape == (len(x1), 4, 7)
    _close(got, ref, 1e-4 * np.abs(ref).max())


# --- optim/pose_graph.py --------------------------------------------------

def _graph(rng, K=10, n_edges=24, drift=0.03):
    """A ring of K poses with chain, random chord and one loop edge,
    measured from the true poses; the estimates carry accumulated drift.
    Padded with 8 invalid edges; keyframe 0 fixed, the last slot
    invalid."""
    true_R = [np.eye(3, dtype=np.float32)]
    true_t = [np.zeros(3, np.float32)]
    for k in range(1, K):
        true_R.append((_rot(rng, 0.2) @ true_R[-1]).astype(np.float32))
        true_t.append((true_t[-1] + rng.normal(0, 0.3, 3)).astype(np.float32))
    est_R = [R.copy() for R in true_R]
    est_t = [t.copy() for t in true_t]
    for k in range(1, K):
        est_R[k] = (_rot(rng, drift * k / K) @ est_R[k]).astype(np.float32)
        est_t[k] = (est_t[k] + drift * k / K).astype(np.float32)
    pairs = [(k, k - 1) for k in range(1, K)] + [(K - 2, 0)]
    while len(pairs) < n_edges:
        i, j = rng.integers(0, K - 1, 2)
        if i != j:
            pairs.append((int(i), int(j)))
    E = len(pairs) + 8
    e_i = np.zeros(E, np.int32)
    e_j = np.zeros(E, np.int32)
    e_s = np.ones(E, np.float32)
    e_R = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
    e_t = np.zeros((E, 3), np.float32)
    e_w = np.zeros(E, np.float32)
    e_v = np.zeros(E, bool)
    for e, (i, j) in enumerate(pairs):
        Rm = true_R[j] @ true_R[i].T
        e_i[e], e_j[e] = i, j
        e_R[e] = Rm
        e_t[e] = true_t[j] - Rm @ true_t[i]
        e_w[e] = 10.0 if e == K - 1 else 1.0
        e_v[e] = True
    valid = np.arange(K) < K - 1
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return dict(s=np.ones(K, np.float32), R=np.stack(est_R),
                t=np.stack(est_t), fixed=fixed, valid=valid, e_i=e_i,
                e_j=e_j, e_s=e_s, e_R=e_R, e_t=e_t, e_valid=e_v,
                e_weight=e_w)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_pose_graph_matches_jax(rng, fix_scale):
    g = _graph(rng)
    jp = jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in g.items()})
    tp = tpg.PoseGraphProblem(**{k: torch.from_numpy(v)
                                 for k, v in g.items()})
    ref = jpg.optimize_pose_graph(jp, iters=20, fix_scale=fix_scale)
    got = tpg.optimize_pose_graph(tp, iters=20, fix_scale=fix_scale)
    _close(got[1].numpy(), ref[1], 1e-3)
    _close(got[2].numpy(), ref[2], 1e-3)
    _close(got[0].numpy(), ref[0], 1e-3)
    # it did work: the last valid pose moved, fixed and invalid did not
    assert np.abs(np.asarray(ref[2])[-2] - g["t"][-2]).max() > 1e-3
    _close(got[2].numpy()[[0, -1]], g["t"][[0, -1]], 0.0)


def test_pose_graph_jacobians_match_jax(rng):
    g = _graph(rng)
    n = int(g["e_valid"].sum())
    ei, ej = g["e_i"][:n], g["e_j"][:n]
    gi = (np.full(n, 1.05, np.float32), g["R"][ei], g["t"][ei])
    gj = (np.full(n, 0.97, np.float32), g["R"][ej], g["t"][ej])
    meas = (g["e_s"][:n], g["e_R"][:n], g["e_t"][:n])

    def jfun(xi_i, xi_j, a, b, m):
        ga = js3.sim3_compose(*js3.sim3_exp(xi_i), *a)
        gb = js3.sim3_compose(*js3.sim3_exp(xi_j), *b)
        return jpg.edge_residual(ga, gb, m)
    z7 = jnp.zeros(7)
    J = [tuple(jnp.asarray(x) for x in t) for t in (gi, gj, meas)]
    ref_i = jax.vmap(lambda a, b, m: jax.jacfwd(jfun, 0)(z7, z7, a, b, m))(*J)
    ref_j = jax.vmap(lambda a, b, m: jax.jacfwd(jfun, 1)(z7, z7, a, b, m))(*J)
    T = [tuple(torch.from_numpy(x) for x in t) for t in (gi, gj, meas)]
    got_i, got_j = tpg.edge_jacobians(*T)
    for a, b in ((ref_i, got_i), (ref_j, got_j)):
        a = np.asarray(a)
        _close(b.numpy(), a, 1e-4 * np.abs(a).max())
    _close(tpg.edge_residual(*T).numpy(), jpg.edge_residual(*J), 1e-5)


def test_pose_graph_duplicate_edges_sum(rng):
    """A duplicated edge counts twice in the normal equations, as the
    reference's scatter-add."""
    g = _graph(rng)
    tp = tpg.PoseGraphProblem(**{k: torch.from_numpy(v)
                                 for k, v in g.items()})
    H, b, e = tpg.normal_equations(tp, tp.s, tp.R, tp.t)
    dup = dict(g)
    n = int(g["e_valid"].sum())
    for k in ("e_i", "e_j", "e_s", "e_R", "e_t", "e_weight", "e_valid"):
        dup[k] = g[k].copy()
        dup[k][n] = g[k][n - 1]
    tp2 = tpg.PoseGraphProblem(**{k: torch.from_numpy(v)
                                  for k, v in dup.items()})
    H2, b2, e2 = tpg.normal_equations(tp2, tp2.s, tp2.R, tp2.t)
    Hs, bs, es = tpg.normal_equations(
        tp2._replace(e_valid=torch.zeros_like(tp2.e_valid).index_fill_(
            0, torch.tensor([n]), True)), tp2.s, tp2.R, tp2.t)
    _close(H2.numpy(), (H + Hs).numpy(), 1e-4)
    _close(b2.numpy(), (b + bs).numpy(), 1e-5)
    assert float(e2) == pytest.approx(float(e + es), rel=1e-5)


# --- the loop landmark set and _correct ----------------------------------

def _ring_map(K=12, drift=0.02):
    """tests/test_reloc_correction.py:test_persistent_loop_edge_in_second_
    correction's map: 12 keyframes on a circle with accumulated yaw drift,
    covisibility along the chain."""
    cfg = SystemConfig(camera=CameraConfig(fx=260.0, fy=260.0, cx=160.0,
                                           cy=120.0, width=320, height=240),
                       capacity=CapacityConfig(max_keyframes=16,
                                               max_landmarks=256,
                                               max_keypoints=64))
    m = jstate.empty_map(cfg.capacity)
    kf_R = np.tile(np.eye(3, dtype=np.float32), (16, 1, 1))
    kf_t = np.zeros((16, 3), np.float32)
    for k in range(K):
        th = 2 * np.pi * k / 10 + drift * k
        c, s = np.cos(th), np.sin(th)
        kf_R[k] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        kf_t[k] = np.array([0.1 * k * drift, 0, 0], np.float32)
    covis = np.zeros((16, 16), np.int32)
    for k in range(1, K):
        covis[k, k - 1] = covis[k - 1, k] = 120
    m = m._replace(kf_R=jnp.asarray(kf_R), kf_t=jnp.asarray(kf_t),
                   kf_valid=jnp.asarray(np.arange(16) < K),
                   kf_frame_id=jnp.asarray(np.arange(16), jnp.int32),
                   covis=jnp.asarray(covis), n_kf=jnp.int32(K))
    return cfg, m


def _closers(cfg):
    rng = np.random.RandomState(0)
    corpus = rng.randint(0, 2 ** 32, (64, 8), dtype=np.uint64).astype(
        np.uint32)
    jl = jlc.LoopCloser(cfg, jintr(cfg), jvoc.train(corpus, k=4, levels=2))
    tcfg = config_from_dict(asdict(cfg))
    tl = tlc.LoopCloser(tcfg, tintr(tcfg, "cpu"),
                        tvoc.train(corpus, k=4, levels=2, device="cpu"))
    return jl, tl


def test_correct_with_persistent_loop_edge_matches_jax():
    """Two corrections in a row: the second keeps the first's loop edge
    in its graph; poses and the loop-edge table as JAX's."""
    cfg, jm = _ring_map()
    jl, tl = _closers(cfg)
    tm = map_state_from_numpy(map_arrays(jm), "cpu")
    for k, cand in ((10, 0), (11, 1)):
        jm = jl._correct(jm, k, cand, 1.0, jnp.eye(3), jnp.zeros(3))
        tm = tl._correct(tm, k, cand, torch.tensor(1.0), torch.eye(3),
                         torch.zeros(3))
        _close(tm.kf_R.numpy(), jm.kf_R, 1e-3)
        _close(tm.kf_t.numpy(), jm.kf_t, 1e-3)
    assert int(tm.n_loop) == int(jm.n_loop) == 2
    for f in ("loop_i", "loop_j", "loop_valid"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)))
    RA = tm.kf_R[10].numpy() @ tm.kf_R[0].numpy().T
    assert np.arccos(np.clip((np.trace(RA) - 1) / 2, -1, 1)) < 0.02


def test_essential_graph_overflow_keeps_essential_edges():
    """Past max_pose_graph_edges the covisibility edges go and the
    spanning and loop edges stay, as in the reference."""
    cfg, jm = _ring_map()
    covis = np.asarray(jm.covis).copy()
    covis[:12, :12] = np.where(np.eye(12, dtype=bool), 0, 150)
    jm = jm._replace(covis=jnp.asarray(covis))
    tcfg = config_from_dict(asdict(cfg))
    tcfg = tcfg.replace(capacity=TC.CapacityConfig(
        max_keyframes=16, max_landmarks=256, max_keypoints=64,
        max_pose_graph_edges=16))
    _, tl = _closers(cfg)
    tl.cfg = tcfg
    tm = map_state_from_numpy(map_arrays(jm), "cpu")
    p = tl.essential_graph(tm, 10, 0, torch.tensor(1.0), torch.eye(3),
                           torch.zeros(3))
    assert p.e_valid.shape[0] == 16 and bool(p.e_valid.all())
    pairs = set(zip(p.e_i.tolist(), p.e_j.tolist()))
    assert (10, 0) in pairs                                  # the loop edge
    assert all((i, i - 1) in pairs or any(a == i for a, _ in pairs)
               for i in range(1, 12))                        # spanning edges


def test_loop_landmark_set_with_ties_matches_jax(rng):
    """Neighbours tied on covisibility weight and landmarks seen from
    several keyframes: the same deduplicated set in the same order."""
    cfg = SystemConfig(capacity=CapacityConfig(
        max_keyframes=12, max_landmarks=600, max_keypoints=128))
    m = jstate.empty_map(cfg.capacity)
    K, N, L = 12, 128, 600
    obs = rng.integers(-1, L, (K, N)).astype(np.int32)
    covis = rng.integers(0, 4, (K, K)).astype(np.int32) * 20   # many ties
    covis = np.maximum(covis, covis.T)
    lm_valid = rng.uniform(size=L) < 0.9
    kp_valid = rng.uniform(size=(K, N)) < 0.95
    kf_valid = np.ones(K, bool)
    kf_valid[[3, 8]] = False
    m = m._replace(kf_obs_lm=jnp.asarray(obs), covis=jnp.asarray(covis),
                   lm_valid=jnp.asarray(lm_valid),
                   kf_kp_valid=jnp.asarray(kp_valid),
                   kf_valid=jnp.asarray(kf_valid))
    tm = map_state_from_numpy(map_arrays(m), "cpu")
    for c, cap in ((0, 400), (5, 600), (11, 768)):
        ids_j, mask_j = jlc._loop_landmark_set(m, jnp.int32(c), cap=cap)
        ids_t, mask_t = tlc._loop_landmark_set(tm, c, cap=cap)
        np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        assert 0 < int(mask_t.sum()) <= cap
    idx, vals, strong = tstate.covisible_keyframes(tm, 2, 4)
    ji, jv, js = jstate.covisible_keyframes(m, 2, 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(strong.numpy(), np.asarray(js))


def test_add_loop_edge_matches_jax():
    cfg, jm = _ring_map()
    tm = map_state_from_numpy(map_arrays(jm), "cpu")
    R = _rot(np.random.default_rng(1), 0.3)
    for _ in range(cfg.capacity.max_loop_edges + 1):    # one past full
        jm = jstate.add_loop_edge(jm, 3, 1, 1.02, jnp.asarray(R),
                                  jnp.ones(3))
        tm = tstate.add_loop_edge(tm, 3, 1, 1.02, torch.from_numpy(R),
                                  torch.ones(3))
    for f in ("loop_i", "loop_j", "loop_s", "loop_R", "loop_t",
              "loop_valid", "n_loop"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)))


# --- System level: the orbit world up to its first closure ---------------

def test_orbit_closes_first_loop_like_jax():
    """The 320x240 orbit world of tests/test_e2e_loop_reloc.py per frame:
    the first loop closes at the same keyframe against the same candidate
    in both packages (torch_port_util.check_orbit_closure; the chunked
    form is tests/test_torch_orbit_chunk.py)."""
    check_orbit_closure(chunk=1)


def test_warm_up_runs_each_solver_at_the_configured_sizes(monkeypatch):
    """``loop_closing.warm_up`` (the System's construction on the card)
    runs the Sim3 RANSAC and optimization in both scale modes, the PnP
    RANSAC over ``max_keypoints`` pairs, and one pose-graph step over
    ``max_keyframes`` vertices and ``max_pose_graph_edges`` edges, with
    finite results; a System on the CPU does not run it."""
    from slam_dynamic_tpu_torch.ops import pnp as tpnp
    from slam_dynamic_tpu_torch.system import System
    tcfg = TC.SystemConfig(
        camera=TC.CameraConfig(fx=260.0, fy=260.0, cx=159.5, cy=119.5,
                               bf=26.0, width=320, height=240),
        capacity=TC.CapacityConfig(max_keyframes=16, max_keypoints=256,
                                   max_pose_graph_edges=64),
        sensor="rgbd")
    calls = []

    def record(name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            calls.append((name, a, kw, out))
            return out
        return wrapped
    monkeypatch.setattr(tlc, "ransac_sim3", record("ransac_sim3",
                                                   tlc.ransac_sim3))
    monkeypatch.setattr(tlc, "optimize_sim3", record("optimize_sim3",
                                                     tlc.optimize_sim3))
    monkeypatch.setattr(tlc, "optimize_pose_graph", record(
        "pose_graph", tlc.optimize_pose_graph))
    monkeypatch.setattr(tpnp, "ransac_pnp", record("ransac_pnp",
                                                   tpnp.ransac_pnp))
    tlc.warm_up(tcfg, tintr(tcfg, torch.device("cpu")))
    names = [c[0] for c in calls]
    assert names == ["ransac_sim3", "optimize_sim3", "ransac_pnp",
                     "pose_graph"]
    assert [c[2]["fix_scale"] for c in calls[:2]] == [True, True]
    for name, a, kw, out in calls[:3]:
        assert a[-1].shape == (256,), name            # the valid mask
        assert int(out.n_inliers) > 200, name     # the synthetic pairs fit
    problem = calls[3][1][0]
    assert problem.s.shape == (16,) and problem.e_i.shape == (64,)
    assert all(torch.isfinite(x).all() for x in calls[3][3])
    # a System on the CPU skips it
    calls.clear()
    System(tcfg, device="cpu")
    assert not calls
