"""The port's sharded solvers across processes: the problems, built with
numpy from a seed, and the worker that one rank of a run executes.

    python tests/port_shards.py RANK DEVICE IN PREFIX BACKEND:WORLD ...

For each BACKEND:WORLD in turn (ranks past WORLD skip it), joins a
process group of WORLD ranks through the file store ``PREFIX.BACKEND``
(``parallel/distributed.init_distributed``), solves the edge-sharded
pose graph and the landmark-sharded BA in ``IN`` (an .npz of
``problem_arrays``) over ``global_mesh()``, and rank 0 writes the
solutions, the ms per GN iteration and the all-reduces per iteration
with their bytes to ``PREFIX.BACKEND.npz``; then it leaves the group.
Several runs in one process pay its start (torch, the card's context)
once. The CPU test (``tests/test_torch_distributed.py``, gloo:2) and
``chip_smoke.py``'s phase 15b (gloo:2 on CUDA tensors, then nccl:1) run
it. It imports neither JAX nor the JAX package.
"""
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from slam_dynamic_tpu_torch.optim.pose_graph import \
    PoseGraphProblem  # noqa: E402
from slam_dynamic_tpu_torch.parallel import sharded_ba as sba  # noqa: E402
from slam_dynamic_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from slam_dynamic_tpu_torch.parallel.sharded_pose_graph import \
    make_sharded_pose_graph  # noqa: E402
from slam_dynamic_tpu_torch.utils import se3  # noqa: E402
from slam_dynamic_tpu_torch.utils.camera import (Intrinsics,  # noqa: E402
                                                 project_stereo)

PG_ITERS = 15
BA_ITERS = 15
CAM = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0, width=640,
           height=480)
PG_FIELDS = PoseGraphProblem._fields
BA_FIELDS = sba.ShardedBAProblem._fields


def _yaw(th):
    c, s = np.cos(th), np.sin(th)
    out = np.zeros((len(th), 3, 3), np.float32)
    out[:, 0, 0] = c
    out[:, 0, 2] = s
    out[:, 1, 1] = 1.0
    out[:, 2, 0] = -s
    out[:, 2, 2] = c
    return out


def drifting_ring(K: int = 256, n_shards: int = 2) -> dict:
    """``__graft_entry__.py``'s trajectory-scale pose graph: K poses on a
    ring with accumulated yaw drift, odometry edges measured without it,
    loop edges every 64 poses back to the start; the edges padded to a
    multiple of ``n_shards`` (of 320). Field name -> numpy array."""
    e_cap = n_shards * -(-320 // n_shards)
    th_gt = 2 * np.pi * np.arange(K) / K
    Rn, Rg = _yaw(th_gt + 0.002 * np.arange(K)), _yaw(th_gt)
    e_i = np.arange(1, K, dtype=np.int32)
    e_j = e_i - 1
    e_R = np.einsum("kij,kmj->kim", Rg[e_j], Rg[e_i])
    li = np.arange(63, K, 64, dtype=np.int32)
    e_i = np.concatenate([e_i, li])
    e_j = np.concatenate([e_j, np.zeros_like(li)])
    e_R = np.concatenate([e_R, np.einsum("ij,kmj->kim", Rg[0], Rg[li])])
    pad = e_cap - len(e_i)
    return dict(
        s=np.ones(K, np.float32), R=Rn, t=np.zeros((K, 3), np.float32),
        fixed=np.arange(K) == 0, valid=np.ones(K, bool),
        e_i=np.pad(e_i, (0, pad)), e_j=np.pad(e_j, (0, pad)),
        e_s=np.ones(e_cap, np.float32),
        e_R=np.concatenate([e_R, np.tile(np.eye(3, dtype=np.float32),
                                         (pad, 1, 1))]),
        e_t=np.zeros((e_cap, 3), np.float32),
        e_valid=np.arange(e_cap) < len(e_i),
        e_weight=np.ones(e_cap, np.float32))


def ba_problem(seed: int = 0, K: int = 16, L: int = 1024,
               n_shards: int = 2, O_cap: int = 12288) -> dict:
    """``tests/test_optim.py``'s stereo BA problem at K keyframes x L
    landmarks (poses 0.4 rad apart in x, the later poses and every point
    perturbed), built with numpy and the port's geometry on the CPU, then
    padded and partitioned by landmark over ``n_shards`` as
    ``tests/test_sharded_ba.py``'s ``to_sharded``. Field name -> numpy
    array."""
    rng = np.random.default_rng(seed)
    cam = Intrinsics.create(**CAM, device="cpu")
    pts_gt = np.stack([rng.uniform(-4, 4, L), rng.uniform(-3, 3, L),
                       rng.uniform(4, 12, L)], 1).astype(np.float32)
    Rs, ts, okf, olm, ouv = [], [], [], [], []
    for k in range(K):
        xi = np.concatenate([[0.4 * k, 0.02 * k, 0.01 * k],
                             rng.normal(0, 0.03, 3)]).astype(np.float32)
        R, t = se3.se3_exp(torch.from_numpy(xi))
        xc = (torch.from_numpy(pts_gt) @ R.T + t)
        proj = project_stereo(cam, xc).numpy()
        proj = proj + rng.normal(0, 0.4, proj.shape)
        xc = xc.numpy()
        vis = (xc[:, 2] > 0.5) & (np.abs(proj[:, 0] - 320) < 320) & \
            (np.abs(proj[:, 1] - 240) < 240)
        ids = np.flatnonzero(vis)
        okf += [k] * len(ids)
        olm += ids.tolist()
        ouv.append(proj[ids])
        if k == 0:
            Rs.append(R.numpy())
            ts.append(t.numpy())
            continue
        dxi = np.concatenate([rng.normal(0, 0.15, 3),
                              rng.normal(0, 0.02, 3)]).astype(np.float32)
        R2, t2 = se3.se3_retract(R, t, torch.from_numpy(dxi))
        Rs.append(R2.numpy())
        ts.append(t2.numpy())
    pts0 = pts_gt + rng.normal(0, 0.15, pts_gt.shape).astype(np.float32)
    O = len(okf)
    assert O <= O_cap and L % n_shards == 0, (O, O_cap)
    pad = O_cap - O
    okf = np.pad(np.asarray(okf, np.int64), (0, pad))
    olm = np.pad(np.asarray(olm, np.int64), (0, pad))
    ouv = np.pad(np.concatenate(ouv).astype(np.float32), ((0, pad), (0, 0)))
    oval = np.arange(O_cap) < O
    ones = oval.astype(np.float32)      # 1 per observation, 0 padding
    perm, oval_p, ok = sba.partition_obs_by_landmark(olm, oval, n_shards, L,
                                                     O_cap)
    assert ok
    return dict(
        kf_R=np.stack(Rs), kf_t=np.stack(ts), kf_fixed=np.arange(K) == 0,
        kf_valid=np.ones(K, bool), points=pts0, lm_valid=np.ones(L, bool),
        obs_kf=okf[perm], obs_lm=olm[perm], obs_uv=ouv[perm],
        obs_inv_sigma2=ones[perm], obs_valid=oval_p,
        obs_ur_weight=ones[perm])


def problem_arrays(pg: dict, ba: dict) -> dict:
    """The two problems as one flat dict for an .npz."""
    return {**{f"pg_{k}": v for k, v in pg.items()},
            **{f"ba_{k}": v for k, v in ba.items()}}


def load_problems(z, device):
    """(PoseGraphProblem, ShardedBAProblem) on ``device`` from an .npz of
    ``problem_arrays`` (indices as int64)."""
    def t(a):
        x = torch.from_numpy(np.asarray(a))
        if x.dtype == torch.int32:
            x = x.long()
        return x.to(device)
    pg = PoseGraphProblem(*[t(z[f"pg_{f}"]) for f in PG_FIELDS])
    ba = sba.ShardedBAProblem(*[t(z[f"ba_{f}"]) for f in BA_FIELDS])
    return pg, ba


class _Counted:
    """``torch.distributed.all_reduce`` with a count of the calls and of
    the bytes each moved."""

    def __init__(self):
        self.orig = dist.all_reduce
        self.calls = []

    def __call__(self, tensor, *a, **kw):
        self.calls.append(tensor.numel() * tensor.element_size())
        return self.orig(tensor, *a, **kw)


def _timed(fn, sync, counted):
    """(result, ms, the bytes of each all-reduce) of a second call of
    ``fn`` (the first warms)."""
    fn()
    sync()
    counted.calls.clear()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3, list(counted.calls)


def solve(mesh, pg, ba, device, sync):
    """Both solves over ``mesh``: solutions, ms per GN iteration and the
    all-reduces of one iteration (their bytes)."""
    cam = Intrinsics.create(**CAM, device=device)
    K, E = pg.s.shape[0], pg.e_i.shape[0]
    Kb, L, O = ba.kf_R.shape[0], ba.points.shape[0], ba.obs_kf.shape[0]
    run_pg = make_sharded_pose_graph(mesh, K, E, iters=PG_ITERS)
    run_ba = sba.make_sharded_ba(mesh, cam, Kb, L, O, stereo=True,
                                 iters=BA_ITERS)
    counted = _Counted()
    dist.all_reduce = counted
    try:
        (s, R, t), pg_ms, pg_calls = _timed(lambda: run_pg(pg), sync,
                                            counted)
        (kR, kt, pts), ba_ms, ba_calls = _timed(lambda: run_ba(ba), sync,
                                                counted)
    finally:
        dist.all_reduce = counted.orig
    # over several ranks the BA gathers the points once, after its
    # iterations
    gather = int(isinstance(mesh, Mesh) and mesh.group is not None
                 and len(mesh.local_shards("lm")) < mesh.shape["lm"])
    return dict(
        pg_s=s, pg_R=R, pg_t=t, ba_R=kR, ba_t=kt, ba_pts=pts,
        pg_ms_per_iter=pg_ms / PG_ITERS, ba_ms_per_iter=ba_ms / BA_ITERS,
        pg_allreduces_per_iter=len(pg_calls) / PG_ITERS,
        pg_allreduce_bytes=pg_calls[:2],
        ba_allreduces_per_iter=(len(ba_calls) - gather) / BA_ITERS,
        ba_allreduce_bytes=ba_calls[:2], ba_gather_bytes=ba_calls[-gather:]
        if gather else [])


def worker(rank: int, world: int, backend: str, url: str, device: str,
           src: str, dst: str):
    """One rank of one run (see the module's docstring)."""
    from slam_dynamic_tpu_torch.parallel import distributed as pd
    dev = pd.init_distributed(url, world, rank, backend=backend,
                              device=device)
    mesh = pd.global_mesh("lm", device=dev)
    with np.load(src) as z:
        pg, ba = load_problems(z, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    out = solve(mesh, pg, ba, dev, sync)
    # this rank's landmarks alone (host_sharded_array's layout) solve as
    # the whole problem's slices do
    n = mesh.shape["lm"]
    Lb, Ob = ba.points.shape[0] // n, ba.obs_kf.shape[0] // n
    lo, oo = slice(rank * Lb, (rank + 1) * Lb), slice(rank * Ob,
                                                      (rank + 1) * Ob)
    blk = pd.host_sharded_array(mesh, tuple(ba.points.shape),
                                ba.points[lo].cpu())
    assert blk.offset == rank * Lb
    local = ba._replace(
        points=blk.block, lm_valid=ba.lm_valid[lo],
        **{f: getattr(ba, f)[oo] for f in BA_FIELDS if f.startswith("obs")})
    cam = Intrinsics.create(**CAM, device=dev)
    kR, kt, pts = sba.make_sharded_ba(
        mesh, cam, ba.kf_R.shape[0], ba.points.shape[0], ba.obs_kf.shape[0],
        stereo=True, iters=BA_ITERS)(local)
    # (on the card the scatter-adds sum in a run-dependent order, and a
    # GN step near the noise floor can be kept in one solve and refused
    # in another: two solves of one problem differ in their last digits)
    local_dt = float((kt - out["ba_t"]).abs().max())
    local_dp = float((pts - out["ba_pts"][lo]).abs().max())
    if rank == 0:
        np.savez(dst, local_dt=local_dt, local_dp=local_dp, world=world,
                 device=str(dev), backend=backend,
                 **{k: (v.cpu().numpy() if torch.is_tensor(v)
                        else np.asarray(v)) for k, v in out.items()})
    dist.barrier()
    dist.destroy_process_group()
    print(f"OK rank {rank} of {world} ({backend}, {dev})", flush=True)


def main(argv) -> int:
    rank, device, src, prefix = int(argv[0]), argv[1], argv[2], argv[3]
    for run in argv[4:]:
        backend, world = run.split(":")
        if rank < int(world):
            worker(rank, int(world), backend, f"file://{prefix}.{backend}",
                   device, src, f"{prefix}.{backend}.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
