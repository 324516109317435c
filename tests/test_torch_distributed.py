"""The port's distributed layer (``parallel/mesh.py``,
``parallel/distributed.py``, ``parallel/sharded_pose_graph.py`` and the
multi-process ``parallel/sharded_ba.py``) against the JAX package.

- The edge-sharded pose graph on ``tests/test_distributed.py``'s ring at
  8 shards in one process, against JAX's on the 8-device virtual mesh and
  against ``optimize_pose_graph``: s within 1e-4, R and t within 1e-3
  (that test's tolerances), the residual under 1e-4.
- The landmark-sharded BA at 8 shards against JAX's on
  ``tests/test_sharded_ba.py``'s two problems: keyframe translations
  within 5e-3 (those tests' tolerance against the single-device solve),
  the first test's ground-truth bounds and the second's single-device
  solve.
- A real two-process run: two processes of the port only (no JAX), a
  gloo process group initialised through a ``file://`` store in
  ``tmp_path`` (no TCP port: the JAX test holds one and may run at the
  same time), each with its own timeout. It solves the ring and the
  16 keyframe x 1024 landmark BA, compared with the JAX results this
  process computed: R within 1e-3 of ``optimize_pose_graph``'s, keyframe
  translations within 5e-3 of ``bundle_adjust``'s; two all-reduces per GN
  iteration, of the sizes the systems have; a rank's landmark blocks
  alone (``host_sharded_array``) solve to the same bits as the whole
  problem's slices.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_dynamic_tpu.optim.local_ba import bundle_adjust
from slam_dynamic_tpu.optim.pose_graph import optimize_pose_graph
from slam_dynamic_tpu.parallel import sharded_ba as jsba
from slam_dynamic_tpu.parallel.mesh import make_mesh as jmake_mesh
from slam_dynamic_tpu.parallel.sharded_pose_graph import \
    make_sharded_pose_graph as jmake_pg
from slam_dynamic_tpu_torch.optim import pose_graph as tpg
from slam_dynamic_tpu_torch.parallel import distributed as pd
from slam_dynamic_tpu_torch.parallel import mesh as tmesh
from slam_dynamic_tpu_torch.parallel import sharded_ba as tsba
from slam_dynamic_tpu_torch.parallel.sharded_pose_graph import \
    make_sharded_pose_graph
from slam_dynamic_tpu_torch.utils.camera import Intrinsics
from tests import port_shards
from tests.test_distributed import _ring_problem
from tests.test_optim import CAM as JCAM, _ba_problem
from tests.test_sharded_ba import to_sharded

ROOT = Path(__file__).resolve().parent.parent
TCAM = Intrinsics.create(**port_shards.CAM, device="cpu")


def _arrays(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _port(cls, arrays):
    def t(a):
        x = torch.from_numpy(np.array(a))
        return x.long() if x.dtype == torch.int32 else x
    return cls(*[t(arrays[f]) for f in cls._fields])


def _close(j, t, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


# --- meshes ----------------------------------------------------------------

def test_make_mesh_layouts(monkeypatch):
    m = tmesh.make_mesh(2, "dp", devices=["cpu", "cpu"])
    assert m.shape == {"dp": 2} and m.size == 2 and m.group is None
    assert m.axis_devices("dp") == [torch.device("cpu")] * 2
    assert m.local_shards("dp") == range(2)
    m2 = tmesh.make_mesh_2d(2, 3, devices=["cpu"] * 6)
    assert m2.shape == {"lm": 2, "dp": 3}
    assert m2.local_shards("lm") == range(2)
    x = torch.arange(12.0).reshape(6, 2)
    blocks = tmesh.shard_leading(m2, x, "dp")
    assert [i for i, _ in blocks] == [0, 1, 2]
    assert torch.equal(torch.cat([b for _, b in blocks]), x)
    assert len(tmesh.replicated(m, x)) == 1      # one distinct device
    with pytest.raises(ValueError):
        tmesh.make_mesh(3, devices=["cpu", "cpu"])
    # with no card and no devices named, a mesh raises (the card is the
    # default), as every entry point does
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh(1)


def test_host_sharded_array_keeps_the_rank_block():
    """Rank 2 of a 4-rank mesh: its block, at its global offset."""
    m = tmesh.Mesh(["cpu"] * 4, ("lm",), owners=[0, 1, 2, 3], rank=2)
    assert m.local_shards("lm") == range(2, 3)
    blk = pd.host_sharded_array(m, (64, 3), np.ones((16, 3), np.float32))
    assert blk.offset == 32 and blk.global_shape == (64, 3)
    assert tuple(blk.block.shape) == (16, 3)
    with pytest.raises(ValueError):
        pd.host_sharded_array(m, (64, 3), np.ones((32, 3), np.float32))
    assert [i for i, _ in tmesh.shard_leading(m, torch.zeros(8))] == [2]


# --- the edge-sharded pose graph -----------------------------------------

@pytest.fixture(scope="module")
def ring():
    """The ring in both packages, and the port's solves of it at one shard
    and over an 8-entry mesh of this process (15 iterations)."""
    problem = _ring_problem()
    tp = _port(tpg.PoseGraphProblem, _arrays(problem))
    mesh = tmesh.make_mesh(8, devices=["cpu"] * 8)
    return problem, tp, dict(
        one=make_sharded_pose_graph(1, K=12, E=40, iters=15)(tp),
        eight=make_sharded_pose_graph(mesh, K=12, E=40, iters=15)(tp))


def test_sharded_pose_graph_matches_jax(ring):
    jp, tp, solves = ring
    s1, R1, t1 = optimize_pose_graph(jp, iters=15)
    sj, Rj, tj = jmake_pg(jmake_mesh(8), K=12, E=40, iters=15)(jp)
    s2, R2, t2 = solves["eight"]
    for ref in ((s1, R1, t1), (sj, Rj, tj)):
        for a, b, tol in zip(ref, (s2, R2, t2), (1e-4, 1e-3, 1e-3)):
            _close(a, b, tol)
    # the drift is gone
    err = float(tpg.edge_error(tp, s2, R2, t2))
    assert err < 1e-4, err


def test_sharded_pose_graph_equals_single_device_port(ring):
    """One shard is ``optimize_pose_graph``; 8 differ only in the order
    of the sums."""
    _, tp, solves = ring
    ref = tpg.optimize_pose_graph(tp, iters=15)
    for a, b in zip(solves["one"], ref):
        assert torch.equal(a, b)
    for a, b, tol in zip(ref, solves["eight"], (1e-5, 1e-4, 1e-4)):
        _close(a.numpy(), b, tol)


# --- the landmark-sharded BA at 8 shards --------------------------------

@pytest.mark.parametrize("K,L,O_cap", [(6, 160, 1280), (5, 120, 1024)])
def test_sharded_ba_eight_shards_matches_jax(K, L, O_cap):
    """``tests/test_sharded_ba.py:44`` (its ground-truth bounds) and
    ``:60`` (against JAX's single-device ``bundle_adjust``)."""
    problem, _, ts_gt, pts_gt = _ba_problem(np.random.default_rng(0), K=K,
                                            L=L, stereo=True)
    sp, Lp = to_sharded(problem, 8, O_cap)
    args = (K, Lp, O_cap, True, 15)
    jR, jt, jpts = jsba.make_sharded_ba(jmake_mesh(8), JCAM, *args)(sp)
    tp = _port(tsba.ShardedBAProblem, _arrays(sp))
    tR, tt, tpts = tsba.make_sharded_ba(8, TCAM, *args)(tp)
    _close(jt, tt, 5e-3)
    if K == 6:
        t_err = np.linalg.norm(tt.numpy() - ts_gt, axis=1)
        assert t_err.max() < 0.02, t_err
        p_err = np.linalg.norm(tpts.numpy()[:L] - pts_gt, axis=1)
        assert np.median(p_err) < 0.03
    else:
        _close(bundle_adjust(JCAM, problem, stereo=True).kf_t, tt, 5e-3)


# --- two processes -------------------------------------------------------

@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """The problems of the two-process run, saved for its workers, and the
    JAX package's single-device solutions of them."""
    ring = _ring_problem()
    bap, *_ = _ba_problem(np.random.default_rng(0), K=16, L=1024,
                          stereo=True)
    sp, Lp = to_sharded(bap, 2, 12288)
    assert Lp == 1024
    src = tmp_path_factory.mktemp("shards") / "problems.npz"
    np.savez(src, **port_shards.problem_arrays(_arrays(ring), _arrays(sp)))
    s1, R1, t1 = optimize_pose_graph(ring, iters=port_shards.PG_ITERS)
    res = bundle_adjust(JCAM, bap, stereo=True)
    return dict(src=src, pg=(np.asarray(s1), np.asarray(R1),
                             np.asarray(t1)),
                ba_t=np.asarray(res.kf_t))


def test_sharded_solvers_across_two_gloo_processes(jax_refs, tmp_path):
    prefix = tmp_path / "run"
    # one thread a process: two processes of a full thread pool each, beside
    # the other test workers, run 3-4x slower
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "port_shards.py"), str(r),
         "cpu", str(jax_refs["src"]), str(prefix), "gloo:2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK rank {r} of 2" in out, out
    z = np.load(f"{prefix}.gloo.npz")
    assert int(z["world"]) == 2 and str(z["backend"]) == "gloo"
    for a, b, tol in zip(jax_refs["pg"], (z["pg_s"], z["pg_R"], z["pg_t"]),
                         (1e-4, 1e-3, 1e-3)):
        np.testing.assert_allclose(b, a, rtol=0, atol=tol)
    np.testing.assert_allclose(z["ba_t"], jax_refs["ba_t"], rtol=0,
                               atol=5e-3)
    assert float(z["local_dt"]) == float(z["local_dp"]) == 0.0
    # two all-reduces per GN iteration: (H, b, err) or (S, b, Hcc, bc,
    # err) as one buffer, then the error after the step
    K = 12
    assert float(z["pg_allreduces_per_iter"]) == 2.0
    assert z["pg_allreduce_bytes"].tolist() == [
        4 * ((7 * K) ** 2 + 7 * K + 1), 4]
    K = 16
    assert float(z["ba_allreduces_per_iter"]) == 2.0
    assert z["ba_allreduce_bytes"].tolist() == [
        4 * ((6 * K) ** 2 + 6 * K + 36 * K + 6 * K + 1), 4]
    assert z["ba_gather_bytes"].tolist() == [4 * 1024 * 3]
