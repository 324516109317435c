"""The post-loop global BA of the port against the JAX package: the
landmark-sharded GN (``parallel/sharded_ba.py``) and the global BA with
its amortized merge (``backend/global_ba.py``), on
``tests/test_sharded_ba.py``'s perturbed maps carried across with
``convert.map_state_from_numpy``. The JAX package runs its 4-shard layout
on 4 of the 8 virtual CPU devices; the port runs the same layout shard
after shard in one process.

Tolerances: problems built from the same map are equal; after GN steps,
keyframe rotations and translations within atol 1e-4 and points within
atol 1e-3 of JAX's (float32 sums in another order, as
``tests/test_torch_optim.py`` holds the local BA); the port's 4-shard
solve within the same of its 1-shard solve.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_dynamic_tpu.backend import global_ba as jg
from slam_dynamic_tpu.parallel import sharded_ba as jsba
from slam_dynamic_tpu.parallel.mesh import make_mesh
from slam_dynamic_tpu.worldmap.state import add_landmarks, insert_keyframe
from slam_dynamic_tpu_torch import convert
from slam_dynamic_tpu_torch.backend import global_ba as tg
from slam_dynamic_tpu_torch.parallel import sharded_ba as tsba
from slam_dynamic_tpu_torch.utils.camera import Intrinsics
from tests.test_optim import CAM as JCAM
from tests.test_sharded_ba import _perturbed_map

TCAM = Intrinsics.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0,
                         width=640, height=480, device="cpu")
POSE_TOL, POINT_TOL = 1e-4, 1e-3


def _to_port(m):
    return convert.map_state_from_numpy(
        {k: np.asarray(v) for k, v in m._asdict().items()}, device="cpu")


def _close(j, t, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def _close_solve(j, t):
    """(kf_R, kf_t, points) of two solves."""
    for a, b, tol in zip(j, t, (POSE_TOL, POSE_TOL, POINT_TOL)):
        _close(a, b, tol)


@pytest.fixture(scope="module")
def world():
    m, pts, L = _perturbed_map(np.random.default_rng(0))
    return m, _to_port(m), pts, L


@pytest.fixture(scope="module")
def problems(world):
    """Both packages' problems at 1 and 4 shards."""
    m, tm, _, _ = world
    out = {}
    for n in (1, 4):
        jp, _, K, _, Lp, Oc = jg._build_problem(m, JCAM, True, n, 1.2)
        tp, n_shards, *_ = tg._build_problem(tm, TCAM, True, n, 1.2)
        out[n] = dict(jax=jp, port=tp, K=K, Lp=Lp, Oc=Oc, n=n_shards)
    return out


# --- partition_obs_by_landmark ---------------------------------------------

@pytest.mark.parametrize("n_shards,L,O,n_valid,overflow", [
    (1, 64, 96, 70, False), (4, 64, 96, 60, False), (4, 64, 96, 60, True),
    (8, 256, 512, 300, False)])
def test_partition_obs_by_landmark_matches_jax(n_shards, L, O, n_valid,
                                               overflow):
    """The same permutation, permuted validity and overflow flag as the
    reference's loop; ``overflow`` crowds shard 1 past its slice."""
    rng = np.random.default_rng(n_shards + O + overflow)
    obs_lm = rng.integers(0, L, O).astype(np.int32)
    if overflow:
        block = L // n_shards
        obs_lm[:O // 2] = rng.integers(block, 2 * block, O // 2)
    valid = np.zeros(O, bool)
    valid[rng.choice(O, n_valid, replace=False)] = True
    j = jsba.partition_obs_by_landmark(obs_lm, valid, n_shards, L, O)
    t = tsba.partition_obs_by_landmark(obs_lm, valid, n_shards, L, O)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
    assert t[2] == j[2] == (not overflow)


def test_build_problem_matches_jax(problems):
    """The snapshot problem equals JAX's, field for field, at 1 and 4
    shards."""
    for n, p in problems.items():
        assert p["n"] == n
        for name, a, b in zip(p["jax"]._fields, p["jax"], p["port"]):
            np.testing.assert_array_equal(
                b.numpy(), np.asarray(a).astype(b.numpy().dtype),
                err_msg=f"{n} shards: {name}")


# --- make_sharded_ba -------------------------------------------------------

@pytest.fixture(scope="module")
def solves(problems):
    out = {}
    for n, p in problems.items():
        for iters in (1, 12):
            args = (p["K"], p["Lp"], p["Oc"], True, iters)
            out[n, iters] = (
                jsba.make_sharded_ba(make_mesh(n), JCAM, *args)(p["jax"]),
                tsba.make_sharded_ba(n, TCAM, *args)(p["port"]))
    return out


@pytest.mark.parametrize("n_shards,iters", [(1, 1), (1, 12), (4, 1),
                                            (4, 12)])
def test_sharded_ba_matches_jax(solves, n_shards, iters):
    _close_solve(*solves[n_shards, iters])


@pytest.mark.parametrize("iters", [1, 12])
def test_four_shards_match_one_shard(solves, iters):
    """The shard layout changes only the order of the sums."""
    _close_solve([x.numpy() for x in solves[1, iters][1]],
                 solves[4, iters][1])


def test_sharded_ba_reduces_twice_per_step(problems, monkeypatch):
    """Every GN iteration sums across shards through ``reduce`` only,
    twice (the system with the error before the step, then the error
    after it), each time one part per shard."""
    p = problems[4]
    calls = []
    reduce = tsba.reduce

    def counted(parts, group=None):
        assert group is None        # one process: no all-reduce
        calls.append(len(parts))
        return reduce(parts, group)
    monkeypatch.setattr(tsba, "reduce", counted)
    tsba.make_sharded_ba(4, TCAM, p["K"], p["Lp"], p["Oc"], True,
                         3)(p["port"])
    assert calls == [4] * 6


# --- global_bundle_adjust --------------------------------------------------

def test_global_ba_from_mapstate_matches_jax(world):
    """``tests/test_sharded_ba.py::test_global_ba_from_mapstate`` on the
    port (median point error under 0.02), within tolerance of JAX's."""
    m, tm, pts, L = world
    j = jg.global_bundle_adjust(m, JCAM, stereo=True, iters=12, n_devices=4)
    t = tg.global_bundle_adjust(tm, TCAM, stereo=True, iters=12,
                                n_devices=4)
    p_err = np.linalg.norm(t.lm_pos.numpy()[:L] - pts, axis=1)
    assert np.median(p_err) < 0.02, np.median(p_err)
    _close_solve((j.kf_R, j.kf_t, j.lm_pos), (t.kf_R, t.kf_t, t.lm_pos))
    # outside the valid keyframes and landmarks nothing moved
    np.testing.assert_array_equal(t.kf_t.numpy()[3:], tm.kf_t.numpy()[3:])
    np.testing.assert_array_equal(t.lm_pos.numpy()[L:],
                                  tm.lm_pos.numpy()[L:])


def test_global_ba_over_a_mesh_equals_its_shard_count(world):
    """``mesh=`` (where JAX's ``_build_problem`` makes its mesh): a
    4-entry "lm" mesh of this process lays the shards out as
    ``n_devices=4`` does, to the same bits, the amortized form too."""
    from slam_dynamic_tpu_torch.parallel.mesh import make_mesh
    _, tm, _, _ = world
    mesh = make_mesh(4, "lm", devices=["cpu"] * 4)
    a = tg.global_bundle_adjust(tm, TCAM, stereo=True, iters=3,
                                n_devices=4)
    b = tg.global_bundle_adjust(tm, TCAM, stereo=True, iters=3, mesh=mesh)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    ga = tg.AmortizedGBA(tm, TCAM, stereo=True, total_iters=3,
                         slice_iters=3, mesh=mesh)
    ga.step()
    assert ga.done
    for x, y in zip(ga.merge(tm), b):
        assert torch.equal(x, y)


# --- AmortizedGBA ----------------------------------------------------------

def _live_map(m, rng):
    """The map as it stands at the merge: keyframe 3 inserted after the
    snapshot, observing keyframe 2's landmarks (a covisibility tie with
    keyframes 1 and 2), and 4 landmarks created from it."""
    obs = np.asarray(m.kf_obs_lm[2])
    m = insert_keyframe(
        m, m.kf_R[2], m.kf_t[2] + jnp.asarray([0.05, 0, 0]),
        3, 0.3, m.kf_kp_xy[2], m.kf_kp_level[2], jnp.zeros(64),
        m.kf_kp_desc[2], m.kf_kp_valid[2], m.kf_kp_ur[2], m.kf_kp_depth[2],
        jnp.asarray(obs))
    n = 4
    pos = rng.uniform([-1, -1, 4], [1, 1, 6], (n, 3)).astype(np.float32)
    return add_landmarks(
        m, jnp.asarray(pos), jnp.zeros((n, 8), jnp.uint32),
        jnp.tile(jnp.asarray([0., 0, 1]), (n, 1)), jnp.full(n, 0.5),
        jnp.full(n, 50.0), jnp.full(n, 3, jnp.int32),
        jnp.arange(48, 48 + n, dtype=jnp.int32), jnp.ones(n, bool))


def test_amortized_gba_matches_jax(world):
    """``::test_amortized_gba_matches_inline`` on both packages: 4 slices
    of 3 for 12 iterations, then the merge into the live map. Keyframe 3
    (after the snapshot) follows its strongest covisible keyframe of the
    snapshot, the lowest of a tie, keeping its relative transform, and
    the landmarks made after the snapshot follow their first keyframe;
    the merged map within tolerance of JAX's."""
    m, tm, pts, L = world
    jgba = jg.AmortizedGBA(m, JCAM, stereo=True, total_iters=12,
                           slice_iters=3, n_devices=4)
    tgba = tg.AmortizedGBA(tm, TCAM, stereo=True, total_iters=12,
                           slice_iters=3, n_devices=4)
    n_steps = 0
    while not tgba.done:
        tgba.step()
        jgba.step()
        n_steps += 1
    assert n_steps == 4 and jgba.done
    live = _live_map(m, np.random.default_rng(1))
    covis = np.asarray(live.covis[3])[:3]
    assert (covis == covis.max()).sum() >= 2, covis       # a tie
    par = int(np.flatnonzero(covis == covis.max())[0])
    tlive = _to_port(live)
    R_rel0 = tlive.kf_R[3] @ tlive.kf_R[par].T
    t_rel0 = tlive.kf_t[3] - R_rel0 @ tlive.kf_t[par]
    j2, t2 = jgba.merge(live), tgba.merge(tlive)
    _close_solve((j2.kf_R, j2.kf_t, j2.lm_pos), (t2.kf_R, t2.kf_t, t2.lm_pos))
    p_err = np.linalg.norm(t2.lm_pos.numpy()[:L] - pts, axis=1)
    assert np.median(p_err) < 0.02, np.median(p_err)
    R_rel1 = t2.kf_R[3] @ t2.kf_R[par].T
    torch.testing.assert_close(R_rel1, R_rel0, atol=1e-5, rtol=0)
    torch.testing.assert_close(t2.kf_t[3] - R_rel1 @ t2.kf_t[par], t_rel0,
                               atol=1e-5, rtol=0)
    # the new landmarks kept their place in keyframe 3's camera
    for a, b in ((tlive, t2),):
        xa = (a.kf_R[3] @ a.lm_pos[L:L + 4].T).T + a.kf_t[3]
        xb = (b.kf_R[3] @ b.lm_pos[L:L + 4].T).T + b.kf_t[3]
        torch.testing.assert_close(xb, xa, atol=1e-5, rtol=0)
    assert not torch.equal(t2.lm_pos[L:L + 4], tlive.lm_pos[L:L + 4])
