#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (slam_dynamic_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc; takes no arguments. Phases, one line each:

  0. the card's name and power limit (nvidia-smi), the nvcc build of
     slam_dynamic_tpu_torch/csrc/kernels.cu with ptxas's registers,
     shared memory and spills per kernel, and the host's CPU count and
     load average;
  1. kernel K1 (gated match) against its plain PyTorch version at the
     main path's 2048 x 2048, with forced ties, all-masked inputs and a
     widened level window: bit-equal, idx included, and its device time
     on those random inputs;
  2. kernel K2 (Hamming matrix) against its plain version at 2048 x 2048,
     bit-equal, beside one PyTorch call computing the same matrix
     (bipolar int8 torch._int_mm, timed here only, never called by the
     port);
  3. System.track_rgbd on the synthetic 640x480 RGB-D world, 1000 ORB
     features, bench capacities, loop detection on: fps, p50 ms per
     frame, keyframes, LOST frames, ATE, and the launch counts of K1 and
     K2 over that run, timed bare; a second, untimed run of the same
     frames keeps the inputs of its K1 calls;
  4. K1 on those inputs: bit-equal with its plain version on every call,
     their shares of ok keypoints and landmarks, and the device time and
     bound per call that the kernel table reports;
  5. the main path as ``python -m slam_dynamic_tpu_torch.bench`` runs it
     (``bench.py``'s default): System.track_chunk on 120 frames of the
     same world at C = 6 with one chunk in flight, loop detection on:
     fps, chunk p50 and p90 ms, keyframes, the keyframe count, the loop
     detector's calls and candidates, LOST frames, ATE, the launches of
     K1 and K2 over the phase, and the vocabulary the System read; the
     K1 calls of its first (untimed) warm chunk are held bit-equal with
     the plain version.

Kernel, plain and library times are device times (CUDA-graph replay
between CUDA events, slam_dynamic_tpu_torch/kernel_bench.py), each beside
the least time the card could take for the same work. It then prints the
kernel table as one JSON line (``launches`` is phase 5's count, the main
path's; ``launches_per_phase`` adds phase 3's) and, last, the result
line. Any failed check raises, and a hang ends in a traceback and a
nonzero exit after 600 s.
"""
import faulthandler
import json
import os
import subprocess
import sys
import time

faulthandler.dump_traceback_later(600, exit=True)

SEED = 0
N_FRAMES = 60
CHUNK = 6
CHUNK_FRAMES = 120


def log(msg):
    print(msg, flush=True)


def phase_k1(dev, gm, kb, INVALID):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    n = m = 2048
    cases = [("ties", kb.k1_problem(rng, n, m, 0.3, dev), -1, 1),
             ("random", kb.k1_problem(rng, n, m, 0.0, dev), -1, 1)]
    masked = kb.k1_problem(rng, n, m, 0.0, dev)
    masked[8] = torch.zeros(m, dtype=torch.bool, device=dev)
    cases.append(("all_masked", masked, -1, 1))
    cases.append(("wide_window", cases[1][1], -7, 7))
    max_err = 0
    for name, args, lo, hi in cases:
        got = gm.gated_match(*args, lvl_min=lo, lvl_max=hi)
        ref = gm.gated_match_plain(*args, lvl_min=lo, lvl_max=hi)
        torch.cuda.synchronize()
        err = max(int((k - p).abs().max()) for k, p in zip(got, ref))
        if not all(torch.equal(k, p) for k, p in zip(got, ref)):
            raise AssertionError(f"K1 {name}: kernel != plain (err {err})")
        if name == "all_masked" and not bool((got[1] == INVALID).all()):
            raise AssertionError("K1 all_masked: a pair passed the gates")
        max_err = max(max_err, err)
    _, b_narrow, _ = gm.gated_match(*cases[1][1], lvl_min=0, lvl_max=0)
    _, b_wide, _ = gm.gated_match(*cases[1][1], lvl_min=-7, lvl_max=7)
    if not bool((b_wide <= b_narrow).all()):
        raise AssertionError("K1: widening the level window lost matches")
    args = cases[0][1]
    ms = kb.device_ms(lambda: gm.gated_match(*args))
    b_ms, b_by = kb.k1_bound(args)
    log(f"phase 1 K1 gated_match {n}x{m}: bit-equal with plain on "
        f"{len(cases)} cases; random inputs, 90% of keypoints and "
        f"landmarks ok: device time kernel {ms:.5f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}, {b_ms / ms:.1%} of it reached)")
    return max_err


def phase_k1_path(gm, kb, calls, max_err):
    """K1 on the inputs of the System run's own K1 calls."""
    import torch
    for args, lo, hi in calls:
        got = gm.gated_match(*args, lvl_min=lo, lvl_max=hi)
        ref = gm.gated_match_plain(*args, lvl_min=lo, lvl_max=hi)
        torch.cuda.synchronize()
        err = max(int((k - p).abs().max()) for k, p in zip(got, ref))
        if not all(torch.equal(k, p) for k, p in zip(got, ref)):
            raise AssertionError(f"K1 on the path's inputs: kernel != plain "
                                 f"(err {err})")
        max_err = max(max_err, err)
    kp_ok, lm_ok = kb.ok_shares(calls)
    ms = kb.calls_ms(gm.gated_match, calls)
    plain_ms = kb.calls_ms(gm.gated_match_plain, calls)
    b_ms, b_by = kb.k1_calls_bound(calls)
    log(f"phase 4 K1 gated_match on the {len(calls)} calls of phase 3: "
        f"bit-equal with plain; ok keypoints {kp_ok:.1%}, ok landmarks "
        f"{lm_ok:.1%} (mean per call); device time per call kernel "
        f"{ms:.5f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by}, {b_ms / ms:.1%} of it reached)")
    return dict(name="gated_match", route="cuda",
                source="slam_dynamic_tpu_torch/csrc/kernels.cu",
                replaces="slam_dynamic_tpu/ops/pallas_match.py:83",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def phase_k2(dev, hm, kb):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 1)
    n = m = 2048
    a, b = kb.desc_pair(rng, n, m, dev)
    dk = hm.hamming_matrix(a, b)
    dp = hm.hamming_matrix_plain(a, b)
    torch.cuda.synchronize()
    err = int((dk - dp).abs().max())
    if not torch.equal(dk, dp):
        raise AssertionError(f"K2: kernel != plain (err {err})")
    # yardstick: the JAX package's own formulation, (256 - A.B^T) / 2 on
    # bipolar int8 operands, as one PyTorch call on pre-unpacked inputs
    shifts = torch.arange(32, device=dev, dtype=torch.int32)

    def bipolar(d):
        bits = (d[:, :, None] >> shifts) & 1
        return (bits.reshape(d.shape[0], 256) * 2 - 1).to(torch.int8)

    A, Bt = bipolar(a), bipolar(b).t()
    dot = torch._int_mm(A, Bt)
    if not torch.equal((256 - dot) >> 1, dk):
        raise AssertionError("K2: library yardstick disagrees")
    ms = kb.device_ms(lambda: hm.hamming_matrix(a, b))
    plain_ms = kb.device_ms(lambda: hm.hamming_matrix_plain(a, b))
    lib_ms = kb.device_ms(lambda: torch._int_mm(A, Bt))
    b_ms, b_by = kb.k2_bound(n, m)
    log(f"phase 2 K2 hamming_matrix {n}x{m}: bit-equal with plain; device "
        f"time kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch._int_mm "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{b_ms / ms:.1%} of it reached)")
    return dict(name="hamming_matrix", route="cuda",
                source="slam_dynamic_tpu_torch/csrc/kernels.cu",
                replaces="slam_dynamic_tpu/ops/pallas_hamming.py:42",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def track_frames(system, world, n_frames):
    """System.track_rgbd on the first n_frames: per-frame host times
    (each ending in a synchronize), states and keyframe count."""
    import torch
    seq, gray8, depth16, _ = world
    times, states, n_kf = [], [], 0
    for i in range(n_frames):
        t0 = time.perf_counter()
        st = system.track_rgbd(gray8[i], depth16[i], float(seq.timestamps[i]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        states.append(st.state)
        n_kf += int(st.is_keyframe)
    return times, states, n_kf


def phase_system(gm, hm, kb):
    import numpy as np
    from slam_dynamic_tpu_torch.io.bench_world import bench_world
    from slam_dynamic_tpu_torch.io.evo import ate_rmse
    from slam_dynamic_tpu_torch.system import System

    world = bench_world(N_FRAMES, SEED)
    seq, cfg = world[0], world[3]
    system = System(cfg)                   # device defaults to cuda
    gm.launches = 0
    hm.launches = 0
    t_run = time.perf_counter()
    times, states, n_kf = track_frames(system, world, N_FRAMES)
    wall = time.perf_counter() - t_run
    launches = {"gated_match": gm.launches, "hamming_matrix": hm.launches}
    traj = system.trajectory
    est = np.stack([-R.T @ t for _, R, t in traj])
    if not np.isfinite(est).all() or est.shape != (N_FRAMES, 3):
        raise AssertionError(f"trajectory shape {est.shape} or non-finite")
    ate_mm = ate_rmse(est, seq.t_wc[:len(est)]) * 1e3
    n_lost = sum(s != "OK" for s in states)
    log(f"phase 3 System.track_rgbd 640x480 x {N_FRAMES} frames: "
        f"{N_FRAMES / wall:.2f} fps, p50 {np.median(times) * 1e3:.2f} ms, "
        f"first frame {times[0] * 1e3:.1f} ms, keyframes {n_kf}, "
        f"not-OK frames {n_lost}, ATE {ate_mm:.3f} mm, launches {launches}")
    log("  " + system.vocabulary_line())
    if min(launches.values()) <= 0 or n_lost or ate_mm >= 30.0 or n_kf < 3:
        raise AssertionError("System phase failed its checks")
    # the K1 inputs of the same frames, on a second, untimed System
    calls = []
    with kb.recording_k1(calls):
        track_frames(System(cfg), world, N_FRAMES)
    if len(calls) != launches["gated_match"]:
        raise AssertionError(f"{len(calls)} K1 calls kept, "
                             f"{launches['gated_match']} launched")
    return launches, calls


def phase_chunk(gm, hm, kb):
    """The main path as the port's bench runs it: 120 frames, C = 6."""
    import numpy as np
    import torch
    from slam_dynamic_tpu_torch import bench

    calls = []
    gm.launches = 0
    hm.launches = 0
    r = bench.run(CHUNK_FRAMES, CHUNK, seed=SEED,
                  first_warm_chunk=lambda: kb.recording_k1(calls))
    launches = {"gated_match": gm.launches, "hamming_matrix": hm.launches}
    system = r["system"]
    tracker, loop = system.tracker, system.loop
    n_kf = sum(s.is_keyframe for s in r["stats"])
    n_lost = sum(s.state != "OK" for s in r["stats"])
    db_rows = int(loop.db.valid.sum())
    ms = np.sort(r["step_ms"])
    ate_mm = r["ate_m"] * 1e3
    log(f"phase 5 System.track_chunk 640x480 x {CHUNK_FRAMES} frames, "
        f"C = {CHUNK}, one chunk in flight: {r['fps']:.2f} fps over "
        f"{r['n_timed']} timed frames, chunk p50 {np.median(ms):.1f} ms, "
        f"p90 {ms[int(len(ms) * 0.9)]:.1f} ms, keyframes {n_kf} "
        f"(kf_seq {tracker.kf_seq}, keyframe-database rows {db_rows}), "
        f"loop detection calls {loop.n_detect}, candidates "
        f"{loop.n_candidates}, LOST frames {n_lost}, ATE {ate_mm:.3f} mm, "
        f"trajectory {r['n_traj']} frames, fused dispatches "
        f"{tracker.dispatches}, packet readbacks {tracker.packet_reads}, "
        f"launches {launches}")
    log("  " + system.vocabulary_line())
    if n_lost or ate_mm >= 30.0 or min(launches.values()) <= 0:
        raise AssertionError("chunk phase failed its checks")
    if not n_kf == db_rows == tracker.kf_seq:
        raise AssertionError(f"{n_kf} keyframes, {db_rows} database rows")
    if tracker.packet_reads != tracker.dispatches:
        raise AssertionError(f"{tracker.packet_reads} packet readbacks for "
                             f"{tracker.dispatches} fused dispatches")
    if len(calls) != 3 * CHUNK:
        raise AssertionError(f"{len(calls)} K1 calls in the first chunk")
    for args, lo, hi in calls:
        got = gm.gated_match(*args, lvl_min=lo, lvl_max=hi)
        ref = gm.gated_match_plain(*args, lvl_min=lo, lvl_max=hi)
        torch.cuda.synchronize()
        if not all(torch.equal(k, p) for k, p in zip(got, ref)):
            raise AssertionError("K1 on the chunk's inputs: kernel != plain")
    k1_ms = kb.calls_ms(gm.gated_match, calls)
    b_ms, b_by = kb.k1_calls_bound(calls)
    log(f"  K1 on the {len(calls)} calls of the first warm chunk: bit-equal "
        f"with plain; device time per call {k1_ms:.5f} ms, bound "
        f"{b_ms:.5f} ms ({b_by})")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from slam_dynamic_tpu_torch import kernel_bench as kb
    from slam_dynamic_tpu_torch.ops import gated_match as gm
    from slam_dynamic_tpu_torch.ops import hamming as hm
    from slam_dynamic_tpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    kernels.lib()
    log(f"phase 0 build: {kernels.library_path().name} in "
        f"{time.perf_counter() - t0:.2f} s (torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)})")
    ptxas = kernels.library_path().with_suffix(".ptxas.txt").read_text()
    for line in ptxas.splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            log("  ptxas: " + line.split(":", 1)[-1].strip())
    # the System phase is host-bound: its fps moves with the host's CPU
    log(f"host: {os.cpu_count()} CPUs, torch threads "
        f"{torch.get_num_threads()}, load average "
        f"{' '.join(f'{x:.2f}' for x in os.getloadavg())}")
    dev = torch.device("cuda")
    k1_err = phase_k1(dev, gm, kb, hm.INVALID)
    k2_row = phase_k2(dev, hm, kb)
    frame_launches, calls = phase_system(gm, hm, kb)
    rows = [phase_k1_path(gm, kb, calls, k1_err), k2_row]
    chunk_launches = phase_chunk(gm, hm, kb)
    for r in rows:
        r["launches"] = chunk_launches[r["name"]]
        r["launches_per_phase"] = {
            "track_rgbd": frame_launches[r["name"]],
            "track_chunk": chunk_launches[r["name"]]}
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_per_phase"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
