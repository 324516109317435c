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
     K2 over that run, which keeps a copy of the inputs of its K1 calls
     (device-side copies of a few hundred kB a frame);
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
     the plain version;
  6. the dynamic scene as ``python -m slam_dynamic_tpu_torch.bench
     --dynamic`` runs it (``bench.py --dynamic``'s default): the same
     640x480 world with a moving object, its boxes fed every frame it is
     in view (frames 0-50), System.track_chunk at C = 6 with one chunk in
     flight and the fused H/F box classification on every 2nd chunk
     frame: fps, chunk p50 and p90 ms, LOST frames, ATE, the launches of
     K1 and K2, K2's launches per chunk (3 classifications in every
     chunk that makes no keyframe, at least 3 in the others), packet
     readbacks (one per chunk) and the per-box status history; the
     object must be confirmed dynamic (status 2) before it leaves view.
     K2 is held bit-equal with its plain version on the three
     classifications of the first chunk with a reference frame and timed
     there, beside its plain version and the library call;
  7. the per-frame dynamic path: 20 frames of that world through
     System.track_rgbd(detections=) classifying every 2nd frame, so both
     forms of the dynamic step run: LOST frames, the forms dispatched,
     the launches and the box status;
  8. loop closure at full width: tests/test_e2e_loop_reloc.py's orbit
     world (a closed circuit, ``ORBIT_FRAMES`` frames, a keyframe at
     least every 5 frames) at 640x480 with the bench capacities, through
     System.track_rgbd as that test runs it, once with loop closing on
     and once off (the chunked form is phase 8b: with a chunk in flight
     the JAX package loses this orbit at frame 16, and without one a
     loop's effect on the ATE is inside the runs' spread: PERF.md,
     section 6): at least one loop closed, no LOST frame, the unaligned ATE under 0.15 m and under 0.75x the
     run without closing; every K2 call of the first closing keyframe's
     verification, correction and fuse held bit-equal with its plain
     version and timed, and its host time split;
  8b. the chunked form of the loop closure: the orbit at
     ``ORBIT_CHUNK_FRAMES`` frames through System.track_chunk at C = 6,
     each chunk finalized before the next is dispatched, up to the chunk
     that closes the first loop, with torch's deterministic algorithms
     (the card's scatter-adds otherwise sum in a run-dependent order):
     the closure at the CPU's keyframe and
     candidate (``ORBIT_CHUNK_CLOSURE``), no LOST frame, the unaligned
     ATE under 0.15 m and within max(1 mm, 20%) of the CPU's, the frames
     of the chunk still in flight at the correction exported with their
     keyframes' corrected poses, and K2 held on the closing keyframe's
     calls;
  9. relocalization, its drift correction and the ``mask=`` path at
     640x480: a kidnap per frame (20 frames, two flat frames with zero
     depth that go LOST, frame 5 again, relocalized within 5 cm) with K1
     held bit-equal on the relocalized frame's track; the same kidnap
     through track_chunk (C = 6), where the chunk after the LOST one is
     dropped and the next relocalizes; a drift injected into the last
     keyframe and its landmarks, corrected by the relocalization hook to
     under 0.35x; and 20 frames of the moving-object world through
     track_rgbd(mask=, detections=) with no LOST frame;
  10. stereo as ``python -m slam_dynamic_tpu_torch.bench --stereo`` runs
     it (``bench.py --stereo``): the 640x480 stereo pair, two
     extractions and the row-band matcher per frame, System.track_chunk
     at C = 6 with one chunk in flight, 120 frames: fps, chunk p50 and
     p90 ms, LOST frames (none), ATE (under 30 mm) beside the JAX
     package's on the CPU, launches; K1 held bit-equal on the first warm
     chunk's calls, and K2 on its six stereo matches (1000 x 1000, left
     against right keypoints), timed there beside its plain version,
     torch._int_mm and its bound;
  10b. the stereo pair of the moving-object world through
     System.track_stereo(detections=), 30 frames, classifying every 2nd
     frame: LOST frames (none), ATE, the object confirmed dynamic, beside
     the JAX package's frame of confirmation on the CPU; K1 and K2 held
     bit-equal on every call of the first 6 frames (the per-frame stereo
     matches among them);
  11. System.track_mono on the 640x480 mono world (the bench world's
     room, the camera moving 0.04 m a frame with a 0.5 m sway), 50
     frames: the frame it initialized at (within the first 5), at least
     90% of the frames from there OK, the Sim3-aligned ATE under 0.15 m,
     beside the JAX package's on the CPU; K1 and K2 held bit-equal on
     every call of the first 6 frames (the bootstrap's [2048, 2048]
     matches and the first tracked frames).

Kernel, plain and library times are device times (CUDA-graph replay
between CUDA events, slam_dynamic_tpu_torch/kernel_bench.py), each beside
the least time the card could take for the same work; K2's row takes
its times from phase 6's inputs. It then prints the wall time of each
phase, the kernel table as one JSON line (``launches`` is phase 5's
count, the main path's; ``launches_per_phase`` adds phases 3, 6, 7, 8,
8b, 9, 10, 10b and 11) and, last, the result line. Any failed check
raises, and a hang ends in a traceback and a nonzero exit after 1100 s.
"""
import contextlib
import faulthandler
import json
import os
import subprocess
import sys
import time

faulthandler.dump_traceback_later(1100, exit=True)

SEED = 0
N_FRAMES = 45
CHUNK = 6
CHUNK_FRAMES = 120
DYN_FRAMES = 20
OBJECT_LEAVES = 50      # the bench world's object is in view before this
ORBIT_FRAMES = 100      # tests/test_e2e_loop_reloc.py's circuit
ORBIT_CHUNK_FRAMES = 200
# The chunked orbit's first loop closure (C = 6, none in flight) on the
# CPU, in both packages: keyframe seq 21 against slot 18
# (tests/jax_loop_reference.py --frames 200 --chunk 6; the port:
# python -m slam_dynamic_tpu_torch.orbit_trace run --device cpu
# --until-closure), and the port's unaligned ATE there, in metres.
ORBIT_CHUNK_CLOSURE = (21, 18)
ORBIT_CHUNK_CPU_ATE = 0.0306262
KIDNAP_FRAMES = 20
MASK_FRAMES = 20
STEREO_DYN_FRAMES = 30
MONO_FRAMES = 50
# phases 10b and 11 keep the inputs of every K1 and K2 call of their first
# frames (the mono bootstrap's attempts and first tracked frames among
# them) and hold each against its plain version
RECORD_FRAMES = 6
# The JAX package on the CPU on the same worlds: ``python bench.py
# --stereo --cpu`` (phase 10's ATE, mm) and ``JAX_PLATFORMS=cpu
# PYTHONPATH=. python tests/torch_port_util.py --world stereo-dynamic``
# (phase 10b: ATE in mm, the first frame with the object confirmed
# dynamic) and ``--world mono`` (phase 11: the frame it initialized at,
# the Sim3-aligned ATE in mm); the port on the CPU with the JAX package's
# bootstrap draws, ``--world mono --package port --jax-samples`` (mm).
JAX_STEREO_CHUNK_ATE_MM = 27.55
JAX_STEREO_DYN = (9.024, 9)
JAX_MONO = (2, 23.016)
JAX_MONO_PORT_CPU_MM = 22.962


def log(msg):
    print(msg, flush=True)


def _max_diff(a, b):
    return int((a - b).abs().max()) if a.numel() else 0


def hold_k1(gm, calls, what, err=0):
    """Every recorded K1 call ``(args, lvl_min, lvl_max)`` bit-equal with
    its plain version; returns ``err`` raised to the largest absolute
    difference."""
    import torch
    for args, lo, hi in calls:
        got = gm.gated_match(*args, lvl_min=lo, lvl_max=hi)
        ref = gm.gated_match_plain(*args, lvl_min=lo, lvl_max=hi)
        torch.cuda.synchronize()
        err = max(err, *(_max_diff(k, p) for k, p in zip(got, ref)))
        if not all(torch.equal(k, p) for k, p in zip(got, ref)):
            raise AssertionError(f"K1 on {what}: kernel != plain (err {err})")
    return err


def hold_k2(hm, calls, what, err=0):
    """Every recorded K2 input pair bit-equal with the plain version;
    returns ``err`` raised to the largest absolute difference."""
    import torch
    for a, b in calls:
        got, ref = hm.hamming_matrix(a, b), hm.hamming_matrix_plain(a, b)
        torch.cuda.synchronize()
        err = max(err, _max_diff(got, ref))
        if not torch.equal(got, ref):
            raise AssertionError(f"K2 on {what}: kernel != plain (err {err})")
    return err


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
    max_err = hold_k1(gm, calls, "the path's inputs", max_err)
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
    ms, plain_ms, lib_ms, b_ms, b_by = k2_times(hm, kb, a, b)
    log(f"phase 2 K2 hamming_matrix {n}x{m}: bit-equal with plain; device "
        f"time kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch._int_mm "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{b_ms / ms:.1%} of it reached)")
    return err


def k2_times(hm, kb, a, b):
    """Device times of K2, its plain version and one library call on one
    input pair, and K2's bound there. The library call is the JAX
    package's own formulation, (256 - A.B^T) / 2 on bipolar int8
    operands, as one ``torch._int_mm`` on pre-unpacked inputs (timed here
    only, never called by the port)."""
    import torch
    dev = a.device
    shifts = torch.arange(32, device=dev, dtype=torch.int32)

    def bipolar(d):
        bits = (d[:, :, None] >> shifts) & 1
        return (bits.reshape(d.shape[0], 256) * 2 - 1).to(torch.int8)

    A, Bt = bipolar(a), bipolar(b).t()
    if not torch.equal((256 - torch._int_mm(A, Bt)) >> 1,
                       hm.hamming_matrix_plain(a, b)):
        raise AssertionError("K2: library yardstick disagrees")
    return (kb.device_ms(lambda: hm.hamming_matrix(a, b)),
            kb.device_ms(lambda: hm.hamming_matrix_plain(a, b)),
            kb.device_ms(lambda: torch._int_mm(A, Bt)),
            *kb.k2_bound(a.shape[0], b.shape[0]))


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
    t_make = time.perf_counter()
    system = System(cfg)                   # device defaults to cuda
    make_ms = (time.perf_counter() - t_make) * 1e3
    gm.launches = 0
    hm.launches = 0
    calls = []
    t_run = time.perf_counter()
    with kb.recording_k1(calls):
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
    log(f"  the process's first System construction {make_ms:.1f} ms (the "
        f"loop-closing warm-up included)")
    log("  " + system.vocabulary_line())
    if min(launches.values()) <= 0 or n_lost or ate_mm >= 30.0 or n_kf < 3:
        raise AssertionError("System phase failed its checks")
    if len(calls) != launches["gated_match"]:
        raise AssertionError(f"{len(calls)} K1 calls kept, "
                             f"{launches['gated_match']} launched")
    return launches, calls


def phase_chunk(gm, hm, kb):
    """The main path as the port's bench runs it: 120 frames, C = 6."""
    import numpy as np
    from slam_dynamic_tpu_torch import bench

    calls = []
    gm.launches = 0
    hm.launches = 0
    r = bench.run(CHUNK_FRAMES, CHUNK, seed=SEED,
                  warm_chunk=lambda: kb.recording_k1(calls))
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
    hold_k1(gm, calls, "the chunk's inputs")
    k1_ms = kb.calls_ms(gm.gated_match, calls)
    b_ms, b_by = kb.k1_calls_bound(calls)
    log(f"  K1 on the {len(calls)} calls of the first warm chunk: bit-equal "
        f"with plain; device time per call {k1_ms:.5f} ms, bound "
        f"{b_ms:.5f} ms ({b_by})")
    return launches


def status_changes(history):
    """The steps at which the box tracker's statuses changed, as
    (first frame finalized, statuses)."""
    out, last = [], None
    for fids, status in history:
        if status != last and fids:
            out.append((fids[0], status))
            last = status
    return out


def phase_dynamic_chunk(gm, hm, kb, k2_err):
    """The dynamic scene on the chunked path, as ``bench.py --dynamic``."""
    import numpy as np
    from slam_dynamic_tpu_torch import bench

    history, k2_calls, k2_after = [], [], []

    def on_step(system, new):
        history.append(([s.frame_id for s in new],
                        tuple(int(x) for x in system.boxes.status)))
        k2_after.append((hm.launches, any(s.is_keyframe for s in new)))

    gm.launches = 0
    hm.launches = 0
    # K2's inputs are copied from the second warm chunk's three
    # classifications: the first with a reference frame (the first chunk
    # classifies against the placeholder)
    r = bench.run(CHUNK_FRAMES, CHUNK, seed=SEED, dynamic=True,
                  warm_chunk=lambda: kb.recording_k2(k2_calls),
                  warm_index=1, on_step=on_step)
    launches = {"gated_match": gm.launches, "hamming_matrix": hm.launches}
    # K2 launches per chunk after the first: the classifications, and
    # the keyframe work of the frames finalized in that call
    per_chunk = [(n - m, kf) for (m, _), (n, kf)
                 in zip(k2_after, k2_after[1:])]
    cls_only = [n for n, kf in per_chunk if not kf]
    system = r["system"]
    tracker = system.tracker
    n_lost = sum(s.state != "OK" for s in r["stats"])
    ms = np.sort(r["step_ms"])
    ate_mm = r["ate_m"] * 1e3
    changes = status_changes(history)
    confirmed = [fids for fids, st in history if 2 in st]
    log(f"phase 6 System.track_chunk dynamic scene 640x480 x {CHUNK_FRAMES} "
        f"frames, C = {CHUNK}, one chunk in flight, classification every "
        f"{system.cfg.dynamic.classify_every_chunked}nd chunk frame: "
        f"{r['fps']:.2f} fps over {r['n_timed']} timed frames, chunk p50 "
        f"{np.median(ms):.1f} ms, p90 {ms[int(len(ms) * 0.9)]:.1f} ms, "
        f"keyframes {sum(s.is_keyframe for s in r['stats'])}, LOST frames "
        f"{n_lost}, ATE {ate_mm:.3f} mm, trajectory {r['n_traj']} frames, "
        f"fused dispatches {tracker.dispatches}, packet readbacks "
        f"{tracker.packet_reads}, K2 launches in the chunks that made no "
        f"keyframe {cls_only}, launches {launches}")
    log(f"  box statuses (first frame finalized, statuses): {changes}")
    if n_lost or ate_mm > 30.0 or min(launches.values()) <= 0:
        raise AssertionError("dynamic chunk phase failed its checks")
    if tracker.packet_reads != tracker.dispatches:
        raise AssertionError(f"{tracker.packet_reads} packet readbacks for "
                             f"{tracker.dispatches} fused dispatches")
    if not cls_only or any(n != 3 for n in cls_only) \
            or any(n < 3 for n, _ in per_chunk) or len(k2_calls) != 3:
        raise AssertionError(f"K2 launches per chunk {per_chunk}, "
                             f"{len(k2_calls)} classifications copied: not "
                             "3 per chunk")
    if not confirmed or max(confirmed[0]) >= OBJECT_LEAVES:
        raise AssertionError("the moving object was not confirmed dynamic "
                             f"before frame {OBJECT_LEAVES}")
    k2_err = hold_k2(hm, k2_calls, "the classification's inputs", k2_err)
    times = [k2_times(hm, kb, a, b) for a, b in k2_calls]
    ms_k, ms_p, ms_l, b_ms, b_by = (
        [float(np.mean([t[i] for t in times])) for i in range(4)]
        + [times[0][4]])
    a, b = k2_calls[0]
    log(f"  K2 on the {len(k2_calls)} classifications of the second chunk "
        f"({a.shape[0]} x {b.shape[0]}, {int((a != 0).any(1).sum())} and "
        f"{int((b != 0).any(1).sum())} nonzero descriptors): bit-equal "
        f"with plain; device time kernel {ms_k:.6f} ms, plain {ms_p:.4f} "
        f"ms, torch._int_mm {ms_l:.6f} ms, bound {b_ms:.5f} ms ({b_by}, "
        f"{b_ms / ms_k:.1%} of it reached)")
    row = dict(name="hamming_matrix", route="cuda",
               source="slam_dynamic_tpu_torch/csrc/kernels.cu",
               replaces="slam_dynamic_tpu/ops/pallas_hamming.py:42",
               max_abs_err=k2_err, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
               bound_by=b_by, library_ms=ms_l)
    return launches, row


def phase_dynamic_frame(gm, hm):
    """The per-frame dynamic path, both forms of the dynamic step."""
    import numpy as np
    from slam_dynamic_tpu_torch import bench
    from slam_dynamic_tpu_torch.frontend import tracking

    forms, statuses = [], []
    orig = tracking.fused_track_step_dyn

    def spy(*args, **kw):
        forms.append(bool(kw["classify"]))
        return orig(*args, **kw)

    gm.launches = 0
    hm.launches = 0
    tracking.fused_track_step_dyn = spy
    try:
        r = bench.run(DYN_FRAMES, 1, seed=SEED, dynamic=True,
                      classify_every=2,
                      on_step=lambda s, new: statuses.append(
                          tuple(int(x) for x in s.boxes.status)))
    finally:
        tracking.fused_track_step_dyn = orig
    launches = {"gated_match": gm.launches, "hamming_matrix": hm.launches}
    n_lost = sum(s.state != "OK" for s in r["stats"])
    n_cls = sum(forms)
    first2 = next((i for i, st in enumerate(statuses) if 2 in st), None)
    log(f"phase 7 System.track_rgbd dynamic scene 640x480 x {DYN_FRAMES} "
        f"frames, classification every 2nd frame: {r['fps']:.2f} fps over "
        f"{r['n_timed']} timed frames, p50 {np.median(r['step_ms']):.2f} ms, "
        f"LOST frames {n_lost}, ATE {r['ate_m'] * 1e3:.3f} mm, dynamic "
        f"steps classifying {n_cls} / light {len(forms) - n_cls}, box status "
        f"{statuses[-1]} (2 from frame {first2}), launches {launches}")
    if n_lost or not 0 < n_cls < len(forms) or first2 is None \
            or min(launches.values()) <= 0:
        raise AssertionError("dynamic per-frame phase failed its checks")
    return launches


@contextlib.contextmanager
def host_spans(spans: dict, *targets):
    """Within the block, each (owner, attribute) of ``targets`` is wrapped
    to add its wall time, the device synchronized on both ends, to
    ``spans[attribute]`` (ms)."""
    import torch
    saved = [(owner, name, getattr(owner, name)) for owner, name in targets]

    def wrap(name, fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                spans[name] = spans.get(name, 0.0) + \
                    (time.perf_counter() - t0) * 1e3
        return timed

    for owner, name, fn in saved:
        setattr(owner, name, wrap(name, fn))
    try:
        yield spans
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _spans_line(spans: dict) -> str:
    return ", ".join(f"{k} {v:.1f} ms" for k, v in spans.items())


def _zero_launches(gm, hm):
    gm.launches = 0
    hm.launches = 0


def _launches(gm, hm):
    return {"gated_match": gm.launches, "hamming_matrix": hm.launches}


def run_orbit(kb, loop_on: bool, k2_calls: list, frames: int = ORBIT_FRAMES,
              chunk: int = 1, world=None):
    """The orbit world through track_rgbd, frame by frame, or (``chunk``
    > 1) through track_chunk after the first OK frame, each chunk
    finalized before the next is dispatched, up to the chunk that closes
    the first loop. With loop closing on, the K2 calls of the first
    keyframe that closes a loop are kept in ``k2_calls``, and the
    keyframe poses and the frames in flight just before its loop closing
    in ``in_flight``."""
    import dataclasses
    import numpy as np
    import torch
    from slam_dynamic_tpu_torch.io.bench_world import bench_world
    from slam_dynamic_tpu_torch.io.evo import ate_rmse
    from slam_dynamic_tpu_torch.system import System

    seq, gray8, depth16, cfg = world or bench_world(frames, SEED,
                                                    trajectory="orbit")
    cfg = cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, max_frames_between_kf=5,
                                     pipeline_depth=0),
        loop=dataclasses.replace(cfg.loop, enabled=loop_on))
    from slam_dynamic_tpu_torch.backend.loop_closing import LoopCloser
    system = System(cfg)
    closed, spans, in_flight = [], [], {}
    orig = system._on_keyframe
    parts = [(LoopCloser, n) for n in ("_detect", "_compute_sim3", "_correct",
                                       "_search_and_fuse")]

    def on_keyframe(k):
        calls, kf_spans = [], {}
        if not k2_calls:         # until the first closure
            m = system.tracker.map
            before = (m.kf_R.cpu().numpy(), m.kf_t.cpu().numpy())
            pending = [fr for fr, _, _ in system.tracker._pending]
        with kb.recording_k2(calls, every=True), \
                host_spans(kf_spans, *parts):
            t0 = time.perf_counter()
            orig(k)
            torch.cuda.synchronize()
            kf_spans["on_keyframe"] = (time.perf_counter() - t0) * 1e3
        r = system.last_loop
        if r is not None and r.closed:
            closed.append((k, system.tracker.kf_seq, r.matched_kf,
                           r.n_inliers, r.n_total))
            spans.append(kf_spans)
            if not k2_calls:
                k2_calls.extend(calls)
                in_flight.update(kf_pose=before, frames=pending)
    system.tracker.on_keyframe = on_keyframe
    ts = [float(t) for t in seq.timestamps]
    stats, i = [], 0
    t0 = time.perf_counter()
    while i < frames and not (chunk > 1 and closed):
        if chunk == 1 or system.tracker.state != "OK" or i + chunk > frames:
            stats.append(system.track_rgbd(gray8[i], depth16[i], ts[i]))
            i += 1
        else:
            stats += system.track_chunk(gray8[i:i + chunk],
                                        depth16[i:i + chunk],
                                        ts[i:i + chunk])
            i += chunk
    stats += system.tracker.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    est = np.stack([-R.T @ t for _, R, t in system.trajectory])
    if not np.isfinite(est).all():
        raise AssertionError("orbit: non-finite trajectory")
    est_w = (seq.R_wc[0] @ est.T).T + seq.t_wc[0]
    return dict(closed=closed, frames=len(est), wall=wall, spans=spans,
                lost=sum(s.state == "LOST" for s in stats),
                keyframes=system.tracker.kf_seq, in_flight=in_flight,
                system=system,
                ate=ate_rmse(est_w, seq.t_wc[:len(est)], align=False),
                fail=system.loop._last_sim3_fail if system.loop else "")


def check_in_flight_corrected(system, in_flight) -> int:
    """The frames in flight when the first loop was corrected, finalized
    afterwards: each exported pose is its tracked pose relative to its
    reference keyframe at dispatch, composed with that keyframe's
    corrected pose, and the correction moved those keyframes
    (tests/torch_port_util.py:check_in_flight_corrected on the card).
    Returns the number of such frames."""
    import numpy as np
    t0 = in_flight["kf_pose"][1]
    m = system.tracker.map
    kf_R, kf_t = m.kf_R.cpu().numpy(), m.kf_t.cpu().numpy()
    poses = {t: (R, tt) for t, R, tt in system.trajectory}
    for fr in in_flight["frames"]:
        k = fr.ref_kf
        R_rel = fr.np_R @ fr.np_Rk.T
        t_rel = fr.np_t - R_rel @ fr.np_tk
        R, t = poses[fr.timestamp]
        moved = float(np.linalg.norm(kf_t[k] - t0[k]))
        if not (np.allclose(R, R_rel @ kf_R[k], atol=1e-5)
                and np.allclose(t, R_rel @ kf_t[k] + t_rel, atol=1e-5)
                and moved > 1e-3
                and np.linalg.norm(t - fr.np_t) > 0.5 * moved):
            raise AssertionError(f"frame {fr.timestamp} in flight at the "
                                 "correction did not take its keyframe's "
                                 "corrected pose")
    return len(in_flight["frames"])


def phase_loop_closure(gm, hm, kb, k2_err):
    """Phase 8: the loop closed on the card, and K2 on its inputs."""
    from slam_dynamic_tpu_torch.io.bench_world import bench_world
    world = bench_world(ORBIT_FRAMES, SEED, trajectory="orbit")
    k2_calls = []
    _zero_launches(gm, hm)
    on = run_orbit(kb, True, k2_calls, world=world)
    launches = _launches(gm, hm)
    off = run_orbit(kb, False, [], world=world)
    for name, r in (("on", on), ("off", off)):
        log(f"phase 8 orbit 640x480 x {ORBIT_FRAMES} frames, track_rgbd, "
            f"loop closing {name}: "
            f"{r['frames'] / r['wall']:.2f} fps, keyframes {r['keyframes']}, "
            f"loops closed (slot, seq, candidate, inliers, total) "
            f"{r['closed']}, LOST frames {r['lost']}, unaligned ATE "
            f"{r['ate'] * 1e3:.3f} mm" + (f", launches {launches}"
                                          if name == "on" else ""))
    for (k, *_), sp in zip(on["closed"], on["spans"]):
        log(f"  keyframe {k}'s loop closing, host time: {_spans_line(sp)}")
    if not on["closed"] or on["lost"] or off["closed"]:
        raise AssertionError(f"orbit: closed {on['closed']}, LOST "
                             f"{on['lost']}, last Sim3 gate {on['fail']}")
    if not (on["ate"] < 0.15 and on["ate"] < 0.75 * off["ate"]):
        raise AssertionError(f"orbit: ATE {on['ate']:.4f} m with closing, "
                             f"{off['ate']:.4f} m without")
    return launches, check_k2_on_closure(hm, kb, k2_calls, k2_err)


def check_k2_on_closure(hm, kb, k2_calls, k2_err):
    """K2 held bit-equal with its plain version on the K2 calls of a
    closing keyframe, and timed there."""
    import numpy as np
    k2_err = hold_k2(hm, k2_calls, "the loop closure's inputs", k2_err)
    times = [k2_times(hm, kb, a, b) for a, b in k2_calls]
    if not times:
        raise AssertionError("no K2 call recorded on the closing keyframe")
    ms_k, ms_p, ms_l, b_ms = (float(np.mean([t[i] for t in times]))
                              for i in range(4))
    shapes = sorted({(int(a.shape[0]), int(b.shape[0])) for a, b in k2_calls})
    log(f"  K2 on the {len(k2_calls)} calls of the closing keyframe "
        f"(shapes {shapes}): bit-equal with plain; mean device time per "
        f"call kernel {ms_k:.6f} ms, plain {ms_p:.4f} ms, torch._int_mm "
        f"{ms_l:.6f} ms, bound {b_ms:.5f} ms ({times[0][4]}, "
        f"{b_ms / ms_k:.1%} of it reached)")
    return k2_err


def phase_loop_closure_chunked(gm, hm, kb, k2_err):
    """Phase 8b: the chunked orbit on the card up to its first closure,
    held to the CPU's: the same keyframe and candidate, the frames in
    flight at the correction moved with their keyframes, and K2 on the
    closing keyframe's inputs."""
    import torch
    k2_calls = []
    # the card's scatter-adds sum in an order that changes from run to
    # run, and runs of this orbit part within 10 frames; with the
    # deterministic algorithms every run is the same (PERF.md, section 6)
    torch.use_deterministic_algorithms(True, warn_only=True)
    _zero_launches(gm, hm)
    try:
        r = run_orbit(kb, True, k2_calls, ORBIT_CHUNK_FRAMES, CHUNK)
    finally:
        torch.use_deterministic_algorithms(False)
    launches = _launches(gm, hm)
    n_flight = check_in_flight_corrected(r["system"], r["in_flight"]) \
        if r["in_flight"] else 0
    closure = tuple(r["closed"][0][1:3]) if r["closed"] else None
    log(f"phase 8b orbit 640x480 x {ORBIT_CHUNK_FRAMES} frames, "
        f"track_chunk C = {CHUNK}, each chunk finalized before the next, "
        f"to the first closure: {r['frames']} frames, "
        f"{r['frames'] / r['wall']:.2f} fps, loop closed (slot, seq, "
        f"candidate, inliers, total) {r['closed']}, {n_flight} frame(s) in "
        f"flight at the correction took their keyframes' corrected poses, "
        f"LOST frames {r['lost']}, unaligned ATE {r['ate'] * 1e3:.3f} mm "
        f"(the CPU {ORBIT_CHUNK_CPU_ATE * 1e3:.3f} mm), launches {launches}")
    for (k, *_), sp in zip(r["closed"], r["spans"]):
        log(f"  keyframe {k}'s loop closing, host time: {_spans_line(sp)}")
    if closure != ORBIT_CHUNK_CLOSURE or r["lost"]:
        raise AssertionError(f"chunked orbit: closed {r['closed']} (the "
                             f"CPU: seq, candidate {ORBIT_CHUNK_CLOSURE}), "
                             f"LOST {r['lost']}, last Sim3 gate {r['fail']}")
    ref = ORBIT_CHUNK_CPU_ATE
    if not (r["ate"] < 0.15 and abs(r["ate"] - ref) <= max(1e-3, 0.2 * ref)):
        raise AssertionError(f"chunked orbit: ATE {r['ate']:.4f} m, the "
                             f"CPU {ref:.4f} m")
    return launches, check_k2_on_closure(hm, kb, k2_calls, k2_err)


def _kidnap_frames(world, views):
    """20 frames of the sweep world, two flat frames with zero depth
    (timestamps 1.0, 1.03), and frame 5's view at each of ``views``."""
    import numpy as np
    seq, gray8, depth16, _ = world
    flat = np.full_like(gray8[0], 120)
    zdep = np.zeros_like(depth16[0])
    frames = [(gray8[i], depth16[i], float(seq.timestamps[i]))
              for i in range(KIDNAP_FRAMES)]
    frames += [(flat, zdep, 1.0 + 0.03 * j) for j in range(2)]
    return frames + [(gray8[5], depth16[5], t) for t in views]


def _centre_error(system, seq, ts):
    import numpy as np
    poses = {t: (R, tt) for t, R, tt in system.trajectory}
    R, t = poses[ts]
    return float(np.linalg.norm(-R.T @ t - seq.t_wc[5]))


def _inject_drift(system, k_last, dt):
    """The drifted revisit of tests/test_reloc_correction.py:inject_drift
    on the card: every landmark k_last observes is duplicated with the
    world offset dt, and k_last's camera moves consistently."""
    import numpy as np
    import torch
    m = system.tracker.map
    obs_k = m.kf_obs_lm[k_last].cpu().numpy()
    src = np.unique(obs_k[obs_k >= 0])
    free = np.nonzero(~m.lm_valid.cpu().numpy())[0][:len(src)]
    remap = dict(zip(src.tolist(), free.tolist()))
    dev = m.lm_pos.device
    s_t, f_t = (torch.from_numpy(x).to(dev) for x in (src, free))
    lm_pos = m.lm_pos.clone()
    lm_pos[f_t] = m.lm_pos[s_t] + torch.tensor(dt, dtype=torch.float32,
                                               device=dev)
    lm_desc, lm_valid, lm_first = (m.lm_desc.clone(), m.lm_valid.clone(),
                                   m.lm_first_kf.clone())
    lm_desc[f_t] = m.lm_desc[s_t]
    lm_valid[f_t] = True
    lm_first[f_t] = k_last
    obs = m.kf_obs_lm.clone()
    obs[k_last] = torch.tensor([remap.get(int(o), int(o)) if o >= 0 else -1
                                for o in obs_k], dtype=torch.int32,
                               device=dev)
    kf_t = m.kf_t.clone()
    kf_t[k_last] = m.kf_t[k_last] - m.kf_R[k_last] @ torch.tensor(
        dt, dtype=torch.float32, device=dev)
    system.tracker.map = m._replace(kf_t=kf_t, kf_obs_lm=obs, lm_pos=lm_pos,
                                    lm_desc=lm_desc, lm_valid=lm_valid,
                                    lm_first_kf=lm_first)
    system.tracker._kf_pose_cache.clear()


def phase_relocalization(gm, hm, kb, k1_err):
    """Phase 9: the kidnap per frame and chunked, the drift correction and
    the mask= path, with K1 held on the relocalized frame's track."""
    import dataclasses
    import numpy as np
    from slam_dynamic_tpu_torch.backend import relocalization
    from slam_dynamic_tpu_torch.backend.loop_closing import LoopCloser
    from slam_dynamic_tpu_torch.frontend.tracking import Tracker
    from slam_dynamic_tpu_torch.io.bench_world import (bench_world,
                                                       detections)
    from slam_dynamic_tpu_torch.system import System

    world = bench_world(KIDNAP_FRAMES + 4, SEED)
    seq, cfg = world[0], world[3]
    kid_cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, max_frames_between_kf=5))
    _zero_launches(gm, hm)
    # the kidnap, per frame; K1's inputs on the relocalized frame
    system = System(kid_cfg)
    frames = _kidnap_frames(world, [2.0])
    states = [system.track_rgbd(*f).state for f in frames[:-1]]
    calls, spans = [], {}
    with kb.recording_k1(calls), host_spans(
            spans, (relocalization, "relocalize"),
            (LoopCloser, "on_relocalization"),
            (LoopCloser, "_compute_sim3"), (LoopCloser, "_compute_sim3_depth"),
            (Tracker, "_track"), (System, "track_rgbd")):
        states.append(system.track_rgbd(*frames[-1]).state)
    err = _centre_error(system, seq, 2.0)
    log(f"phase 9 kidnap per frame 640x480: states after frame "
        f"{KIDNAP_FRAMES - 1} {states[KIDNAP_FRAMES:]}, frame 5's view "
        f"relocalized {err * 1e3:.2f} mm from the truth, drift corrections "
        f"{system.n_reloc_corrections} (last Sim3 gate "
        f"{system.loop._last_sim3_fail or 'passed'}); the relocalizing "
        f"frame's host time: {_spans_line(spans)}")
    if states[:KIDNAP_FRAMES] != ["OK"] * KIDNAP_FRAMES \
            or states[KIDNAP_FRAMES:] != ["LOST", "LOST", "OK"] \
            or err >= 0.05:
        raise AssertionError(f"kidnap per frame: {states}, {err:.4f} m")
    if len(calls) != 3:
        raise AssertionError(f"{len(calls)} K1 calls on the relocalized "
                             "frame")
    k1_err = hold_k1(gm, calls, "the relocalized frame", k1_err)
    log(f"  K1 on the {len(calls)} calls of the relocalized frame's track: "
        f"bit-equal with plain")
    # the kidnap through track_chunk
    system = System(kid_cfg.replace(tracking=dataclasses.replace(
        kid_cfg.tracking, pipeline_depth=1)))
    frames = _kidnap_frames(world, [])
    states = [system.track_rgbd(*frames[0]).state]
    flat = frames[KIDNAP_FRAMES]
    chunks = [frames[i:i + CHUNK] for i in range(1, KIDNAP_FRAMES - 1, CHUNK)]
    chunks.append([frames[KIDNAP_FRAMES - 1]] + [flat] * (CHUNK - 1))
    view = [(world[1][5 + j], world[2][5 + j], 3.0 + 0.04 * j)
            for j in range(CHUNK)]
    dropped = [(g, d, t - 1.0) for g, d, t in view]
    for chunk in chunks + [dropped, view]:
        g, d, t = zip(*chunk)
        states += [st.state for st in system.track_chunk(list(g), list(d),
                                                         list(t))]
    states += [st.state for st in system.tracker.flush()]
    err = _centre_error(system, seq, 3.0)
    lost_at = states.index("LOST") if "LOST" in states else None
    log(f"phase 9 kidnap through track_chunk, C = {CHUNK}: "
        f"{len(states)} states, LOST {states.count('LOST')} (first at "
        f"state {lost_at}), last {states[-CHUNK:]}, frame 5's view "
        f"relocalized {err * 1e3:.2f} mm from the truth")
    if lost_at is None or states[-CHUNK:] != ["OK"] * CHUNK or err >= 0.05 \
            or 2.0 in {t for t, _, _ in system.trajectory}:
        raise AssertionError(f"kidnap chunked: {states}, {err:.4f} m")
    # the drift correction of a relocalization
    drift_cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, max_frames_between_kf=4))
    system = System(drift_cfg)
    for f in frames[:KIDNAP_FRAMES]:
        system.track_rgbd(*f)
    m = system.tracker.map
    k_last = system.tracker.last_kf_id
    fids = m.kf_frame_id.cpu().numpy()
    valid = m.kf_valid.cpu().numpy()
    obs = m.kf_obs_lm.cpu().numpy()
    mine = set(obs[k_last][obs[k_last] >= 0].tolist())
    cand = next(int(k) for k in np.argsort(fids) if valid[k]
                and int(k) != k_last
                and len(mine & set(obs[k][obs[k] >= 0].tolist())) >= 30)
    t_before = m.kf_t[k_last].cpu().numpy().copy()
    _inject_drift(system, k_last, [0.04, -0.02, 0.03])
    drift = float(np.linalg.norm(
        system.tracker.map.kf_t[k_last].cpu().numpy() - t_before))
    spans = {}
    with host_spans(spans, *[(LoopCloser, n) for n in (
            "_compute_sim3", "_compute_sim3_depth", "_correct",
            "_search_and_fuse")]):
        system._on_reloc(k_last, cand)
    resid = float(np.linalg.norm(
        system.tracker.map.kf_t[k_last].cpu().numpy() - t_before))
    closed = system.last_loop is not None and system.last_loop.closed
    log(f"phase 9 drift correction: keyframe {k_last} against {cand}, "
        f"injected {drift * 1e3:.2f} mm, residual {resid * 1e3:.2f} mm, "
        f"closed {closed}; host time: {_spans_line(spans)}")
    if not closed or resid >= 0.35 * drift:
        raise AssertionError("the injected drift was not corrected")
    # the mask= path on the moving-object world
    dseq, dgray, ddepth, dcfg = bench_world(MASK_FRAMES, SEED, dynamic=True)
    system = System(dcfg)
    states = [system.track_rgbd(dgray[i], ddepth[i],
                                float(dseq.timestamps[i]),
                                detections=detections(dseq, i),
                                mask=dseq.masks[i]).state
              for i in range(MASK_FRAMES)]
    log(f"phase 9 track_rgbd(mask=, detections=) on the moving-object "
        f"world, {MASK_FRAMES} frames: LOST frames {states.count('LOST')}, "
        f"box status {tuple(int(x) for x in system.boxes.status)}, "
        f"host-built dispatches {system.tracker.dispatches}")
    if states != ["OK"] * MASK_FRAMES:
        raise AssertionError(f"mask path: {states}")
    launches = _launches(gm, hm)
    log(f"  phase 9 launches {launches}")
    return launches, k1_err


def phase_stereo_chunk(gm, hm, kb, k1_err, k2_err):
    """Phase 10: ``bench --stereo``'s path, 120 frames at C = 6 with one
    chunk in flight; K1 and K2 held on the first warm chunk's inputs."""
    import numpy as np
    from slam_dynamic_tpu_torch import bench

    k1_calls, k2_calls = [], []

    def warm():
        stack = contextlib.ExitStack()
        stack.enter_context(kb.recording_k1(k1_calls))
        stack.enter_context(kb.recording_k2(k2_calls, every=True))
        return stack

    _zero_launches(gm, hm)
    r = bench.run(CHUNK_FRAMES, CHUNK, seed=SEED, stereo=True,
                  warm_chunk=warm)
    launches = _launches(gm, hm)
    system = r["system"]
    tracker = system.tracker
    n_lost = sum(s.state != "OK" for s in r["stats"])
    ms = np.sort(r["step_ms"])
    ate_mm = r["ate_m"] * 1e3
    log(f"phase 10 System.track_chunk stereo 640x480 x {CHUNK_FRAMES} "
        f"frames, C = {CHUNK}, one chunk in flight: {r['fps']:.2f} fps over "
        f"{r['n_timed']} timed frames, chunk p50 {np.median(ms):.1f} ms, p90 "
        f"{ms[int(len(ms) * 0.9)]:.1f} ms, keyframes "
        f"{sum(s.is_keyframe for s in r['stats'])}, LOST frames {n_lost}, "
        f"ATE {ate_mm:.3f} mm (the JAX package on the CPU: "
        f"{JAX_STEREO_CHUNK_ATE_MM} mm), trajectory {r['n_traj']} frames, "
        f"fused dispatches {tracker.dispatches}, packet readbacks "
        f"{tracker.packet_reads}, launches {launches}")
    if n_lost or ate_mm >= 30.0 or min(launches.values()) <= 0:
        raise AssertionError("stereo chunk phase failed its checks")
    if tracker.packet_reads != tracker.dispatches:
        raise AssertionError(f"{tracker.packet_reads} packet readbacks for "
                             f"{tracker.dispatches} fused dispatches")
    if len(k1_calls) != 3 * CHUNK:
        raise AssertionError(f"{len(k1_calls)} K1 calls in the first chunk")
    k1_err = hold_k1(gm, k1_calls, "the stereo chunk's inputs", k1_err)
    k1_ms = kb.calls_ms(gm.gated_match, k1_calls)
    b_ms, b_by = kb.k1_calls_bound(k1_calls)
    log(f"  K1 on the {len(k1_calls)} calls of the first warm chunk: "
        f"bit-equal with plain; device time per call {k1_ms:.5f} ms, bound "
        f"{b_ms:.5f} ms ({b_by})")
    # the stereo matcher's Hamming matrices: one per frame, left against
    # right keypoints (n_features each)
    n = system.cfg.orb.n_features
    stereo = [(a, b) for a, b in k2_calls if a.shape[0] == b.shape[0] == n]
    if len(stereo) != CHUNK:
        raise AssertionError(f"{len(stereo)} stereo K2 calls in the first "
                             f"chunk, of {len(k2_calls)}")
    k2_err = hold_k2(hm, stereo, "the stereo frame's inputs", k2_err)
    a, b = stereo[0]
    ms_k, ms_p, ms_l, b_ms, b_by = k2_times(hm, kb, a, b)
    log(f"  K2 on the {len(stereo)} stereo matches of the first warm chunk "
        f"({n} x {n}, of {len(k2_calls)} K2 calls): bit-equal with plain; "
        f"first frame's: device time kernel {ms_k:.6f} ms, plain "
        f"{ms_p:.4f} ms, torch._int_mm {ms_l:.6f} ms, bound {b_ms:.5f} ms "
        f"({b_by}, {b_ms / ms_k:.1%} of it reached)")
    return launches, k1_err, k2_err


def recording_frames(gm, hm, kb, rec):
    """A ``frame_ctx`` for ``bench.drive_per_frame``: the frames before
    RECORD_FRAMES append a copy of every K1 and K2 call's inputs to
    ``rec["k1"]`` and ``rec["k2"]`` and add the launches they made to
    ``rec["launched"]``."""
    @contextlib.contextmanager
    def ctx(i):
        if i >= RECORD_FRAMES:
            yield
            return
        l1, l2 = gm.launches, hm.launches
        with kb.recording_k1(rec["k1"]), \
                kb.recording_k2(rec["k2"], every=True):
            yield
        rec["launched"][0] += gm.launches - l1
        rec["launched"][1] += hm.launches - l2
    return ctx


def hold_recorded(gm, hm, rec, what, k1_err, k2_err):
    """K1 and K2 bit-equal with their plain versions on every call that
    ``recording_frames`` kept, each launch of those frames kept once."""
    n1, n2 = len(rec["k1"]), len(rec["k2"])
    if [n1, n2] != rec["launched"] or not n1 or not n2:
        raise AssertionError(f"{what}: {n1} K1 and {n2} K2 calls kept, "
                             f"{rec['launched']} launched")
    k1_err = hold_k1(gm, rec["k1"], what, k1_err)
    k2_err = hold_k2(hm, rec["k2"], what, k2_err)
    shapes = sorted({(int(a.shape[0]), int(b.shape[0]))
                     for a, b in rec["k2"]})
    log(f"  K1 on the {n1} calls and K2 on the {n2} calls of the first "
        f"{RECORD_FRAMES} frames (K2 shapes {shapes}): bit-equal with plain")
    return k1_err, k2_err


def phase_stereo_dynamic_frame(gm, hm, kb, k1_err, k2_err):
    """Phase 10b: the stereo pair of the moving-object world through
    track_stereo(detections=), classifying every 2nd frame; K1 and K2
    held on the first frames' calls."""
    import dataclasses
    import numpy as np
    import torch
    from slam_dynamic_tpu_torch.bench import drive_per_frame
    from slam_dynamic_tpu_torch.io.bench_world import bench_world
    from slam_dynamic_tpu_torch.io.evo import ate_rmse
    from slam_dynamic_tpu_torch.system import System

    world = bench_world(STEREO_DYN_FRAMES, SEED, dynamic=True,
                        sensor="stereo")
    seq, cfg = world[0], world[3]
    cfg = cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, pipeline_depth=1),
        dynamic=dataclasses.replace(cfg.dynamic, classify_every=2))
    system = System(cfg)
    rec = {"k1": [], "k2": [], "launched": [0, 0]}
    _zero_launches(gm, hm)
    r = drive_per_frame(system, world, STEREO_DYN_FRAMES, dynamic=True,
                        sync=torch.cuda.synchronize,
                        frame_ctx=recording_frames(gm, hm, kb, rec))
    launches = _launches(gm, hm)
    states, first2, est = r["states"], r["first_dynamic"], r["est"]
    ate_mm = ate_rmse(est, seq.t_wc[:len(est)]) * 1e3
    n_lost = states.count("LOST")
    log(f"phase 10b System.track_stereo dynamic scene 640x480 x "
        f"{STEREO_DYN_FRAMES} frames, classification every 2nd frame: p50 "
        f"{np.median(r['times'][10:]) * 1e3:.2f} ms a frame after the first "
        f"10, "
        f"LOST frames {n_lost}, ATE {ate_mm:.3f} mm, box status "
        f"{tuple(int(x) for x in system.boxes.status)} (2 from frame "
        f"{first2}; the JAX package on the CPU: ATE "
        f"{JAX_STEREO_DYN[0]} mm, 2 from frame {JAX_STEREO_DYN[1]}), "
        f"launches {launches}")
    if n_lost or first2 is None or min(launches.values()) <= 0:
        raise AssertionError("stereo dynamic phase failed its checks")
    return (launches, *hold_recorded(gm, hm, rec, "phase 10b's frames",
                                     k1_err, k2_err))


def phase_mono(gm, hm, kb, k1_err, k2_err):
    """Phase 11: track_mono on the 640x480 mono world; K1 and K2 held on
    the calls of the bootstrap and the first tracked frames."""
    import numpy as np
    import torch
    from slam_dynamic_tpu_torch.bench import drive_per_frame
    from slam_dynamic_tpu_torch.io.bench_world import bench_world
    from slam_dynamic_tpu_torch.io.evo import ate_rmse
    from slam_dynamic_tpu_torch.system import System

    world = bench_world(MONO_FRAMES, SEED, sensor="mono")
    seq, cfg = world[0], world[3]
    system = System(cfg)
    rec = {"k1": [], "k2": [], "launched": [0, 0]}
    _zero_launches(gm, hm)
    r = drive_per_frame(system, world, MONO_FRAMES,
                        sync=torch.cuda.synchronize,
                        frame_ctx=recording_frames(gm, hm, kb, rec))
    launches = _launches(gm, hm)
    states, first_ok, est = r["states"], r["first_ok"], r["est"]
    after = states[first_ok:] if first_ok is not None else []
    i0 = MONO_FRAMES - len(est)
    ate_m = ate_rmse(est, seq.t_wc[i0:i0 + len(est)], with_scale=True)
    if first_ok is None or first_ok >= RECORD_FRAMES - 1:
        raise AssertionError(f"mono initialized at frame {first_ok}, not "
                             f"within the {RECORD_FRAMES} recorded frames")
    log(f"phase 11 System.track_mono 640x480 x {MONO_FRAMES} frames: "
        f"initialized at frame {first_ok}, OK {after.count('OK')} of the "
        f"{len(after)} frames from there, keyframes "
        f"{system.tracker.kf_seq}, landmarks "
        f"{int(system.tracker.map.n_lm)}, p50 "
        f"{np.median(r['times'][RECORD_FRAMES:]) * 1e3:.2f} ms a frame from "
        f"frame {RECORD_FRAMES} on, "
        f"Sim3-aligned ATE {ate_m * 1e3:.3f} mm (the JAX package on the "
        f"CPU: initialized at frame {JAX_MONO[0]}, {JAX_MONO[1]} mm; the "
        f"port on the CPU with JAX's bootstrap draws: "
        f"{JAX_MONO_PORT_CPU_MM} mm), launches {launches}")
    if after.count("OK") < 0.9 * len(after) or ate_m >= 0.15 \
            or min(launches.values()) <= 0:
        raise AssertionError("mono phase failed its checks")
    return (launches, *hold_recorded(gm, hm, rec, "phase 11's frames",
                                     k1_err, k2_err))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    # cuBLAS's deterministic workspace, for phase 8b
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    walls = {"0": time.perf_counter() - t0}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t
        return out

    k1_err = timed("1", phase_k1, dev, gm, kb, hm.INVALID)
    k2_err = timed("2", phase_k2, dev, hm, kb)
    frame_launches, calls = timed("3", phase_system, gm, hm, kb)
    k1_row = timed("4", phase_k1_path, gm, kb, calls, k1_err)
    chunk_launches = timed("5", phase_chunk, gm, hm, kb)
    dyn_launches, k2_row = timed("6", phase_dynamic_chunk, gm, hm, kb,
                                 k2_err)
    dyn_frame_launches = timed("7", phase_dynamic_frame, gm, hm)
    loop_launches, k2_row["max_abs_err"] = timed(
        "8", phase_loop_closure, gm, hm, kb, k2_row["max_abs_err"])
    loop_chunk_launches, k2_row["max_abs_err"] = timed(
        "8b", phase_loop_closure_chunked, gm, hm, kb, k2_row["max_abs_err"])
    reloc_launches, k1_row["max_abs_err"] = timed(
        "9", phase_relocalization, gm, hm, kb, k1_row["max_abs_err"])
    errs = k1_row["max_abs_err"], k2_row["max_abs_err"]
    stereo_launches, *errs = timed("10", phase_stereo_chunk, gm, hm, kb,
                                   *errs)
    stereo_dyn_launches, *errs = timed("10b", phase_stereo_dynamic_frame,
                                       gm, hm, kb, *errs)
    mono_launches, *errs = timed("11", phase_mono, gm, hm, kb, *errs)
    k1_row["max_abs_err"], k2_row["max_abs_err"] = errs
    log("wall time per phase, s (host clock, world rendering included): "
        + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
        + f"; since the build began {time.perf_counter() - t0:.1f}")
    rows = [k1_row, k2_row]
    for r in rows:
        r["launches"] = chunk_launches[r["name"]]
        r["launches_per_phase"] = {
            "track_rgbd": frame_launches[r["name"]],
            "track_chunk": chunk_launches[r["name"]],
            "track_chunk_dynamic": dyn_launches[r["name"]],
            "track_rgbd_dynamic": dyn_frame_launches[r["name"]],
            "loop_closure": loop_launches[r["name"]],
            "loop_closure_chunked": loop_chunk_launches[r["name"]],
            "relocalization": reloc_launches[r["name"]],
            "track_chunk_stereo": stereo_launches[r["name"]],
            "track_stereo_dynamic": stereo_dyn_launches[r["name"]],
            "track_mono": mono_launches[r["name"]]}
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
