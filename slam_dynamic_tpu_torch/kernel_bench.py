"""Device-side timing and least-time bounds of the port's CUDA kernels.

    python -m slam_dynamic_tpu_torch.kernel_bench --old-source OLD.cu
    python -m slam_dynamic_tpu_torch.kernel_bench --k3

builds ``OLD.cu`` (another revision of ``csrc/kernels.cu`` with the same
C entry points) beside this checkout's kernels and times K1 and K2 of both
on one card, in turns (old, new, new, old): K1 on a random 2048 x 2048
problem and on the inputs of every K1 call of ``PATH_FRAMES`` frames of
``System.track_rgbd`` on the bench world, K2 at the main path's 2048 x
2048. It checks that both give the same results and prints one JSON line.
``--k3`` times K3 (the pose LM) at the tracker's shapes beside its plain
version and prints one JSON line.
``chip_smoke.py`` takes its kernel timings and bounds from the helpers
here. Needs a CUDA card.

Timing is on the device: the launches are captured in a CUDA graph and
CUDA events bracket its replays, so the host's per-call work (argument
checks, allocations, the ctypes call) is not in the time.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .ops import gated_match as gm
from .ops import kernels

# H100 SXM peaks (NVIDIA's data sheet, dense): HBM3 at 3.35 TB/s; int8
# tensor cores at 1,979 TOP/s. The kernels take their distances from the
# binary tensor cores, whose rate is not published; the int8 rate of the
# bipolar formulation stands in for it, and at either rate the distances
# bound neither kernel. CUDA cores at the 1.98 GHz boost clock on 132 SMs:
# fp32 add, multiply and compare at 128 per clock per SM, 32-bit integer
# add, multiply-add, compare, min and max at 64 (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0).
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 132 * 128 * 1.98e9
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# K1's CUDA-core operations per pair with both ok flags set, the fewest
# the function needs. fp32, 6: the radius test's 2 subtract, 2 multiply,
# 1 add (rounded one by one, as the plain version) and its compare.
# Integer, 6: the level window 2 (subtract the landmark's level from the
# row's kp_lvl - lvl_min, one unsigned compare against lvl_max - lvl_min),
# the candidate key 1 (one multiply-add of the landmark's precomputed
# key and popc(a & b); the row's own popcount is constant along the row,
# so it is added once per row), the top-2 update 3 (min, max, min). The
# gates combine as predicates of the compares. A pair with a flag clear
# needs none.
K1_FP32_OPS_PER_PAIR = 6
K1_INT32_OPS_PER_PAIR = 6

# K3's fp32 operations per observation and pass (a multiply-add counts
# one), the fewest the function needs, by D: the transform 9, the
# projection and its Jacobian rows about 25 (D = 2) or 32 (D = 3), the
# residuals and chi2 2 D + 1, the robust weight and cost 8, and the
# normal equations 33 per row (6 products J w, 21 of H, 6 of b).
K3_FP32_OPS_PER_OBS = {2: 117, 3: 157}
K3_SCHEDULES = ((2, 6), (4, 10))   # the motion model's, the local map's
K3_PATH_N = 2048                   # the tracker's observations (keypoints)

REPS = 20       # launches captured in one graph
REPLAYS = 10    # graph replays between the events
PATH_FRAMES = 20  # frames of the System run whose K1 inputs are kept


def device_ms(fn, reps: int = REPS, replays: int = REPLAYS) -> float:
    """Device time of one ``fn()`` in ms: ``reps`` calls captured in a CUDA
    graph, replayed ``replays`` times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * replays)


def calls_ms(fn, calls) -> float:
    """Device time per call of ``fn(*args, lvl_min=, lvl_max=)`` over a
    list of recorded ``(args, lvl_min, lvl_max)``."""
    def run():
        for args, lo, hi in calls:
            fn(*args, lvl_min=lo, lvl_max=hi)
    return device_ms(run, reps=max(1, REPS // len(calls))) / len(calls)


def bound(bytes_moved: float, tc_ops: float = 0.0, fp32_ops: float = 0.0,
          int32_ops: float = 0.0):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over the rate of their unit (the
    tensor cores and the CUDA cores' fp32 and integer pipes run side by
    side, so the slowest of them)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(tc_ops / INT8_TC_OPS_PER_S, fp32_ops / FP32_OPS_PER_S,
                int32_ops / INT32_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_bound(args):
    """Least time of K1 on these inputs (gated_match's argument list, or
    gated_match_batched's with a leading lane axis): only the pairs with
    both ok flags set need a distance and the gates."""
    n, m = args[0].shape[-2], args[4].shape[-2]
    lanes = args[0].numel() // (n * 8) if n else 1
    pairs = int((args[3].reshape(lanes, n).sum(1)
                 * args[8].reshape(lanes, m).sum(1)).sum())
    bytes_moved = lanes * (n * (32 + 8 + 4 + 1) + m * (32 + 8 + 4 + 4 + 1)
                           + 3 * n * 4)
    return bound(bytes_moved, tc_ops=2 * 256 * pairs,
                 fp32_ops=K1_FP32_OPS_PER_PAIR * pairs,
                 int32_ops=K1_INT32_OPS_PER_PAIR * pairs)


def k1_calls_bound(calls):
    """(mean least time per call, what bounds most calls) over recorded
    K1 calls."""
    bounds = [k1_bound(args) for args, _, _ in calls]
    by = max(("bytes", "operations"),
             key=lambda b: sum(x[1] == b for x in bounds))
    return sum(x[0] for x in bounds) / len(bounds), by


def k2_bound(n: int, m: int, lanes: int = 1):
    """Least time of K2 at [n, 8] x [m, 8] (in each of ``lanes`` lanes):
    every pair's distance is needed, and the int32 output written once."""
    return bound(lanes * (n * 32 + m * 32 + n * m * 4),
                 tc_ops=lanes * 2 * 256 * n * m)


def k3_bound(n: int, d: int, rounds: int, iters: int, lanes: int = 1):
    """Least time of one K3 launch: every pass (rounds x (iters + 1) + 1)
    needs each observation's terms and sums; the inputs are read and the
    outputs written once."""
    passes = rounds * (iters + 1) + 1
    per_lane = n * (4 * (3 + d + 2) + 1 + 1 + 4) + 4 * (5 + 12 + 12 + 1)
    return bound(lanes * per_lane,
                 fp32_ops=lanes * passes * n * K3_FP32_OPS_PER_OBS[d])


def k1_problem(rng, n, m, dup_frac=0.0, dev=None):
    """Random gated-match inputs at the main path's types (descriptors as
    int32 bit views), as numpy arrays, or as tensors on ``dev``.
    Duplicated descriptors (``dup_frac`` of the landmarks) force distance
    ties, and up to that many keypoints have an exact copy among the
    landmarks."""
    kp_desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    lm_desc = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
    if dup_frac and m:
        k = max(int(m * dup_frac), 1)
        lm_desc[rng.integers(0, m, k)] = lm_desc[rng.integers(0, m, k)]
        h = min(k // 2, n)
        lm_desc[:h] = kp_desc[:h]
    arrays = [kp_desc.view(np.int32),
              rng.uniform(0, 640, (n, 2)).astype(np.float32),
              rng.integers(0, 8, n).astype(np.int32),
              rng.uniform(size=n) < 0.9,
              lm_desc.view(np.int32),
              rng.uniform(-50, 690, (m, 2)).astype(np.float32),
              rng.uniform(5, 400, m).astype(np.float32),
              rng.integers(0, 8, m).astype(np.int32),
              rng.uniform(size=m) < 0.9]
    if dev is None:
        return arrays
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def k3_problem(rng, n, d=3, outliers=0.3, dev="cpu", case="random",
               noise=0.5, start=1.0):
    """A pose problem at ``pose_lm``'s types: ``n`` points 4-12 m in front
    of a camera (fx 500, bf 50), observed from a true pose with ``noise``
    px of noise in D = ``d`` values (u, v, u_right), ``outliers`` of them
    moved 30-120 px, 95% valid, 80% with stereo depth (``ur_weight``), and
    a start pose ``start`` x (0.15 rad, 0.05 m) off the truth. ``case``:
    "random", "none_valid", "three_valid", "behind" (every point behind
    the camera). Returns [cam, R0, t0, xw, obs, inv_sigma2, valid,
    ur_weight] on ``dev``."""
    from .utils.se3 import se3_exp, se3_retract
    cam = np.array([500.0, 500.0, 320.0, 240.0, 50.0 if d == 3 else 0.0],
                   np.float32)
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                    rng.uniform(4, 12, n)], 1).astype(np.float32)
    if case == "behind":
        pts[:, 2] *= -1
    xi = np.concatenate([rng.normal(0, 0.3, 3), rng.normal(0, 0.1, 3)])
    R, t = se3_exp(torch.tensor(xi, dtype=torch.float32))
    xc = (pts @ R.numpy().T + t.numpy()).astype(np.float32)
    z = xc[:, 2]
    u = cam[0] * xc[:, 0] / z + cam[2]
    v = cam[1] * xc[:, 1] / z + cam[3]
    obs = np.stack([u, v, u - cam[4] / z][:d], 1).astype(np.float32)
    obs += rng.normal(0, noise, obs.shape).astype(np.float32)
    k = int(round(n * outliers))
    if k:
        idx = rng.choice(n, k, replace=False)
        obs[idx, :2] += (rng.uniform(30, 120, (k, 2))
                         * rng.choice([-1, 1], (k, 2))).astype(np.float32)
    dxi = start * np.concatenate([rng.normal(0, 0.15, 3),
                                  rng.normal(0, 0.05, 3)])
    R0, t0 = se3_retract(R, t, torch.tensor(dxi, dtype=torch.float32))
    inv_s2 = (1.2 ** (-2.0 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.uniform(size=n) < 0.95
    if case == "none_valid":
        valid[:] = False
    elif case == "three_valid":
        valid[:] = False
        valid[rng.choice(n, min(3, n), replace=False)] = True
    urw = (rng.uniform(size=n) < 0.8).astype(np.float32)
    out = [torch.from_numpy(cam), R0, t0] + [
        torch.from_numpy(np.ascontiguousarray(a))
        for a in (pts, obs, inv_s2, valid, urw)]
    return [x.contiguous().to(dev) for x in out]


def hold_k3(got, ref, chi2_th: float) -> float:
    """K3's result against its plain version's on the same problem:
    R and t within 1e-4, inlier labels equal except for observations
    whose chi2 lies within 1% of the gate, n_inliers within 1%, chi2 of
    the plain version's shape and finite. Raises if not; returns the
    largest difference in R and t."""
    err = max(float((g - r).abs().max()) for g, r in zip(got[:2], ref[:2]))
    if not err <= 1e-4:
        raise AssertionError(f"K3: R, t differ from plain by {err}")
    near_gate = (ref[4] / chi2_th - 1).abs() <= 0.01
    differ = got[2] != ref[2]
    if bool((differ & ~near_gate).any()):
        raise AssertionError(f"K3: {int(differ.sum())} inlier labels "
                             f"differ from plain away from the gate")
    n_got, n_ref = int(got[3]), int(ref[3])
    if abs(n_got - n_ref) > 0.01 * n_ref:
        raise AssertionError(f"K3: {n_got} inliers, plain {n_ref}")
    if got[4].shape != ref[4].shape or not bool(torch.isfinite(got[4]).all()):
        raise AssertionError("K3: chi2 of another shape or not finite")
    return err


def desc_pair(rng, n, m, dev):
    """Random [n, 8] and [m, 8] int32 descriptors on ``dev``."""
    return [torch.from_numpy(rng.integers(0, 2**32, (r, 8), dtype=np.uint32)
                             .view(np.int32)).to(dev) for r in (n, m)]


@contextlib.contextmanager
def recording_k1(calls: list):
    """Within the block, the tracker's K1 calls append a copy of their
    inputs to ``calls`` as ``(args, lvl_min, lvl_max)``; the calls
    themselves run as they would."""
    from .frontend import fused, tracking_ops

    def record(*args, lvl_min=-1, lvl_max=1):
        kept = [a.clone(memory_format=torch.contiguous_format)
                for a in args]
        kept[6] = kept[6].to(torch.float32)   # as the wrapper passes it
        calls.append((kept, lvl_min, lvl_max))
        return gm.gated_match(*args, lvl_min=lvl_min, lvl_max=lvl_max)

    users = (fused, tracking_ops)
    for mod in users:
        mod.gated_match = record
    try:
        yield calls
    finally:
        for mod in users:
            mod.gated_match = gm.gated_match


@contextlib.contextmanager
def recording_k2(calls: list, every: bool = False):
    """Within the block, every K2 call of the dynamic step's box
    classification (``frontend/dynamics_ops.py``) appends a copy of its
    input pair to ``calls``; with ``every``, so does every other K2 call
    (the Hamming matrices of mapping, relocalization and loop closing,
    through ``ops/hamming.py``). The calls themselves run as they
    would."""
    from .frontend import dynamics_ops
    from .ops import hamming as hm
    kernel = hm.hamming_matrix

    def record(a, b):
        calls.append((a.clone(), b.clone()))
        return kernel(a, b)

    dynamics_ops.hamming_matrix = record
    if every:
        hm.hamming_matrix = record
    try:
        yield calls
    finally:
        dynamics_ops.hamming_matrix = kernel
        hm.hamming_matrix = kernel


@contextlib.contextmanager
def recording_batched(k1_calls: list, k2_calls: list):
    """Within the block, every batched launch of K1 (the lanes of a
    vmapped ``gated_match``, through ``gated_match_batched``) appends a
    copy of its inputs to ``k1_calls`` as ``(args, lvl_min, lvl_max)``,
    and every batched launch of K2 (``hamming_matrix_batched``) its input
    pair to ``k2_calls``. The calls themselves run as they would."""
    from .ops import hamming as hm
    k1, k2 = gm.gated_match_batched, hm.hamming_matrix_batched

    def record1(*args, lvl_min=-1, lvl_max=1):
        kept = [a.clone() for a in args]
        kept[6] = kept[6].to(torch.float32)   # as the wrapper passes it
        k1_calls.append((kept, lvl_min, lvl_max))
        return k1(*args, lvl_min=lvl_min, lvl_max=lvl_max)

    def record2(a, b):
        k2_calls.append((a.clone(), b.clone()))
        return k2(a, b)

    gm.gated_match_batched, hm.hamming_matrix_batched = record1, record2
    try:
        yield
    finally:
        gm.gated_match_batched, hm.hamming_matrix_batched = k1, k2


def per_lane(fn):
    """``fn`` (a one-lane kernel wrapper) called lane by lane over the
    leading axis of its tensor arguments: B single launches."""
    def lanes(*args, **kw):
        return [fn(*(a[b] for a in args), **kw)
                for b in range(args[0].shape[0])]
    return lanes


def path_k1_calls(n_frames: int = PATH_FRAMES, seed: int = 0):
    """The inputs of every K1 call of ``n_frames`` frames of
    ``System.track_rgbd`` on the bench world."""
    from .io.bench_world import bench_world
    from .system import System

    seq, gray8, depth16, cfg = bench_world(n_frames, seed)
    system = System(cfg)
    calls = []
    with recording_k1(calls):
        for i in range(n_frames):
            system.track_rgbd(gray8[i], depth16[i], float(seq.timestamps[i]))
    torch.cuda.synchronize()
    return calls


def ok_shares(calls):
    """Mean shares of ok keypoints and ok landmarks over recorded calls."""
    kp = sum(float(a[3].float().mean()) for a, _, _ in calls) / len(calls)
    lm = sum(float(a[8].float().mean()) for a, _, _ in calls) / len(calls)
    return kp, lm


def k1_raw(lib, calls):
    """K1 of one library as bare launches into preallocated outputs, one
    per recorded call; returns a function that launches them all and
    returns the outputs."""
    jobs = []
    for args, lo, hi in calls:
        n, m = args[0].shape[0], args[4].shape[0]
        outs = [torch.empty(n, dtype=torch.int32, device=args[0].device)
                for _ in range(3)]
        jobs.append(([t.data_ptr() for t in args], outs, n, m, lo, hi))
    dev = calls[0][0][0].device

    def run():
        stream = kernels.stream_handle(dev)    # the capturing stream
        for ptrs, outs, n, m, lo, hi in jobs:
            kernels.check(lib.slam_gated_match(
                *ptrs, *[o.data_ptr() for o in outs], n, m, lo, hi, stream),
                "slam_gated_match")
        return [o for job in jobs for o in job[1]]
    return run


def k2_raw(lib, a, b):
    """K2 of one library as a bare launch into a preallocated output."""
    d = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32,
                    device=a.device)

    def run():
        kernels.check(lib.slam_hamming_matrix(
            a.data_ptr(), b.data_ptr(), d.data_ptr(), a.shape[0], b.shape[0],
            kernels.stream_handle(a.device)), "slam_hamming_matrix")
        return [d]
    return run


def compare(old_source: Path) -> dict:
    """Time K1 and K2 of ``old_source`` and of this checkout in turns."""
    dev = torch.device("cuda")
    new_lib = kernels.lib()
    old_lib = kernels.load(kernels.build(old_source))
    rng = np.random.default_rng(0)
    n = m = 2048
    random_calls = [(k1_problem(rng, n, m, 0.3, dev), -1, 1)]
    path_calls = path_k1_calls()
    a, b = desc_pair(rng, n, m, dev)
    cases = {"gated_match_random": (k1_raw(old_lib, random_calls),
                                    k1_raw(new_lib, random_calls), 1),
             "gated_match_path": (k1_raw(old_lib, path_calls),
                                  k1_raw(new_lib, path_calls),
                                  len(path_calls)),
             "hamming_matrix": (k2_raw(old_lib, a, b), k2_raw(new_lib, a, b),
                                1)}
    for name, (old, new, _) in cases.items():
        ro, rn = [t.clone() for t in old()], [t.clone() for t in new()]
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(ro, rn)):
            raise AssertionError(f"{name}: old and new kernels disagree")
    # the floor of a launch timed this way: a one-element PyTorch add
    one = torch.zeros(1, device=dev)
    kp_ok, lm_ok = ok_shares(path_calls)
    result = {"device": torch.cuda.get_device_name(0), "n": n, "m": m,
              "path_calls": len(path_calls), "path_kp_ok": kp_ok,
              "path_lm_ok": lm_ok,
              "launch_floor_ms": device_ms(lambda: one.add_(1))}
    for name, (old, new, per) in cases.items():
        reps = max(1, REPS // per)
        turns = [device_ms(f, reps=reps) / per for f in (old, new, new, old)]
        old_ms, new_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        result[name] = {"old_ms": [turns[0], turns[3]],
                        "new_ms": [turns[1], turns[2]],
                        "speedup": old_ms / new_ms}
    return result


def host_ms(fn, calls: int = 5) -> float:
    """Wall time of one eager ``fn()`` in ms, the card synchronised after
    ``calls`` calls: what a caller pays when the host's dispatch is the
    limit."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def k3_report() -> dict:
    """K3 at the tracker's shapes (K3_PATH_N stereo observations, both
    schedules, one lane and 16 in one launch, as the op's vmap rule makes
    it) beside its plain
    version: the device time of each by CUDA-graph replay, the host's wall
    time of an eager call, and K3's least time."""
    from .optim import pose_opt
    dev = torch.device("cuda")
    n, d, chi2 = K3_PATH_N, 3, 7.815
    rng = np.random.default_rng(0)
    result = {"device": torch.cuda.get_device_name(0), "n": n, "d": d}
    for rounds, iters in K3_SCHEDULES:
        for lanes in (1, 16):
            probs = [k3_problem(rng, n, d, 0.3, dev) for _ in range(lanes)]
            if lanes == 1:
                args = probs[0]

                def k3(a=args, r=rounds, i=iters):
                    return pose_opt.pose_lm(*a, r, i, chi2)

                def plain(a=args, r=rounds, i=iters):
                    return pose_opt.pose_lm_plain(*a, r, i, chi2)
            else:
                args = [torch.stack([p[k] for p in probs])
                        for k in range(8)]

                def k3(a=args, r=rounds, i=iters):
                    return pose_opt.launch_k3(*a, r, i, chi2)

                def plain(a=args, r=rounds, i=iters):
                    return torch.func.vmap(
                        lambda *x: pose_opt.pose_lm_plain(*x, r, i, chi2))(
                        *a)
            bound_ms, by = k3_bound(n, d, rounds, iters, lanes)
            k3_ms = device_ms(k3)
            result[f"pose_lm_{rounds}x{iters}_b{lanes}"] = {
                "k3_ms": k3_ms, "k3_host_ms": host_ms(k3),
                "plain_ms": device_ms(plain, reps=1, replays=3),
                "plain_host_ms": host_ms(plain, calls=2),
                "bound_ms": bound_ms, "bound_by": by,
                "roofline_pct": 100 * bound_ms / k3_ms}
    one = torch.zeros(1, device=dev)
    result["launch_floor_ms"] = device_ms(lambda: one.add_(1))
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old-source", type=Path,
                        help="another revision of csrc/kernels.cu")
    parser.add_argument("--k3", action="store_true",
                        help="time K3 beside its plain version")
    args = parser.parse_args(argv)
    if args.old_source is None and not args.k3:
        parser.error("give --old-source, --k3 or both")
    if not torch.cuda.is_available():
        print("kernel_bench: needs a CUDA card", file=sys.stderr)
        return 1
    if args.old_source is not None:
        print(json.dumps(compare(args.old_source)), flush=True)
    if args.k3:
        print(json.dumps(k3_report()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
