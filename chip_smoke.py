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
  2b. kernel K3 (the tracker's pose LM) against its plain version at the
     tracker's 2048 observations, D = 3 and 2, the motion model's 2 x 6
     and the local map's 4 x 10, 30% outliers: 16 single calls each
     within kernel_bench.hold_k3's tolerances, and one torch.func.vmap
     call of the 16 lanes one launch, bit-equal with them; K3's and the
     plain version's device times (kernel_bench.k3_report);
  3. System.track_rgbd on the synthetic 640x480 RGB-D world, 1000 ORB
     features, bench capacities, loop detection on: fps, p50 ms per
     frame, keyframes, LOST frames, ATE, and the launch counts of K1, K2
     and K3 (at least 3 a tracked frame) over that run, which keeps a
     copy of the inputs of its K1 calls
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
     frame, ``DYN_CHUNK_FRAMES`` frames (the object's 50 and 10 after
     it): fps, chunk p50 and p90 ms, LOST frames, ATE, the launches of
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
  8c. phase 8's orbit with loop closing on and the post-loop global BA
     on (``LoopConfig(run_global_ba=True)``): the first loop closed at
     phase 8's keyframe and candidate, one solve started, run in
     ceil(20 / 3) = 7 slices of 3 GN iterations (the last in the
     trajectory read) and merged once, no LOST frame, the merged map
     finite (``utils.debug.check_finite_tree``), the unaligned ATE under
     0.15 m and within max(1 mm, 20%) of the JAX package's on the CPU
     (``JAX_ORBIT_GBA_ATE``); the device ms of each slice between CUDA
     events (the first, cold, apart) beside the host ms of the ``step()``
     call, the launches and kernels of one slice under torch.profiler,
     per GN iteration, and the merge's ms; K2 held on the closing
     keyframe's calls;
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
     at C = 6 with one chunk in flight, ``STEREO_CHUNK_FRAMES`` frames:
     fps, chunk p50 and
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
     matches and the first tracked frames);
  12. the online detector: the port's CenterNet on the card against the
     same network on the CPU on 6 frames of the moving-object world at
     640x480 (the maps' largest differences, within 1e-3; the detections
     of the two sides paired by class and box, those that clear the
     threshold by 1e-3 present on both sides with boxes within 1e-3 px;
     those nearer it and the threshold flips, the detections found on
     one side only, counted), its device time and kernel launches per
     detect; then System.track_chunk at C = 6, one chunk in flight, on
     25 frames of that world with no boxes passed, so the System's own
     detector finds them: no LOST frame, a detection every frame, boxes
     tracked and the object confirmed dynamic, the ATE (under 30 mm)
     beside the JAX package's and the port's on the CPU; K1 and K2 held
     bit-equal on every call of the first 6 frames;
  13. the dataset CLI in process on the card, three paths, each with its
     own launch counts (set to 0 just before it) and K1 and K2 held
     bit-equal on every call it made: ``python -m
     slam_dynamic_tpu_torch.io.run --dataset synthetic --frames 20 --ply
     --save-map`` (the JAX CLI's files, no LOST frame, the dense map's
     points, ATE under 30 mm), then ``--load-map --skip 10`` (LOST after
     the load, then every frame OK: relocalized on the first), then a
     System loaded from the checkpoint in localization-only mode over 8
     frames (all OK, no keyframe added); then a fourth: ``--dataset
     rosbag`` on 10 frames of the synthetic world recorded by the port's
     BagWriter (no LOST frame, the ATE within max(1 mm, 20%) of
     track_rgbd's on the same decoded frames).
  14. batched serving and strided depth, each path with its own launch
     counts: (a) ``python -m slam_dynamic_tpu_torch.bench --multi 4``'s
     run, a pipelined MultiSystem of 4 lanes on 32 frames of the bench
     world each (lane b shifted by 3 b frames): aggregate and per-lane
     fps, step p50 and p90, no LOST frame in any lane, lane 0's ATE under
     30 mm and within max(1 mm, 20%) of a solo System on the same frames
     with one frame in flight, run in the same call; the kernel launches,
     sync calls and busy share of a steady batched step under
     torch.profiler beside one lane's frame (the solo System's), and 3
     batched K1 and 3 batched K3 launches in every timed step, as one
     lane's fused step makes; the batched K1 calls of the first 3 steps held bit-equal with
     4 single launches and the plain version, timed beside them;
     (b) ``--multi 2 --chunk 6`` on 30 frames from a cold start (per-frame
     batches until every lane is OK, then chunks); (c)
     ``MultiSystem.track_stereo_batch`` on 2 lanes x 18 frames of the
     stereo pair, K1 and K2 batched, held on the first 3 steps' calls and
     K2's batched launch timed; (d) System.track_rgbd with
     ``depth_stride=2`` on 20 frames of phase 3's world, its ATE beside
     phase 3's.
  15. the distributed layer and the rest of item 22, each path with its
     own launch counts: (a) ``MultiSystem(mesh=)``, 4 lanes of the bench
     world (lane b shifted by 3 b frames) over a 2-entry "dp" mesh whose
     entries are both the card, 20 steps with one in flight, beside the
     unsharded MultiSystem on the same frames: the same LOST and keyframe
     decisions lane by lane, each lane's ATE within max(1 mm, 20%), the
     batched K1 launches per call, and the batched K1 and K2 calls of
     steps 1-3 held bit-equal; (b) the sharded solvers across processes
     on the card (``tests/port_shards.py``): the edge-sharded pose graph
     on a drifting ring of 256 poses and the landmark-sharded BA on 16
     keyframes x 1024 landmarks, both built with numpy from the seed,
     over 2 ranks through gloo on CUDA tensors and over 1 rank through
     NCCL: ms per GN iteration, all-reduces per iteration and their
     bytes, the solutions within 1e-3 in R and 5e-3 in t of the
     single-process solve; (c) System.track_rgbd with one frame in
     flight and ``adaptive_pipeline``, then with ``prefetch_next=``, 30
     frames each: no LOST frame, ATE under 30 mm, the frames run deeper,
     fps beside the direct path's in this call, K1 and K2 held on the
     first 6 frames' calls.

Kernel, plain and library times are device times (CUDA-graph replay
between CUDA events, slam_dynamic_tpu_torch/kernel_bench.py), each beside
the least time the card could take for the same work; K2's row takes
its times from phase 6's inputs, K3's from phase 2b's, per call of a
tracked frame's three (two 2 x 6, one 4 x 10). Each tracking phase
sets the launch counts of K1, K2 and K3 to 0 before it and reads them
after. It then prints the wall time of each phase, the kernel table as
one JSON line (``launches`` is phase 5's count, the main path's;
``launches_per_phase`` adds phases 3, 6, 7, 8, 8c, 8b, 9, 10, 10b, 11,
12, the four paths of 13, the four of 14 and the three of 15; the batched
launches of K1, K2 and K3 have rows of their own, ``launches`` there
phase 14a's, 14c's and 14a's) and, last, the result line. Any
failed check raises, and a hang ends in a traceback and a nonzero exit
after 1100 s.
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
# phases 6 and 10 run 60 frames of bench --dynamic's and bench --stereo's
# 120, so that phase 14 fits the script's time (PERF.md, section 4)
DYN_CHUNK_FRAMES = 60
STEREO_CHUNK_FRAMES = 60
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
# phase 8c: the JAX package on phase 8's orbit with the post-loop global BA
# on, on the CPU (``python tests/jax_loop_reference.py --frames 100
# --chunk 1 --closing on --global-ba``: the loop closed at slot 20, seq 21
# against keyframe 2 in frame 95's call, which started the solve; merged
# in the trajectory read), unaligned ATE in metres
JAX_ORBIT_GBA_ATE = 0.016843776
KIDNAP_FRAMES = 20
MASK_FRAMES = 20
STEREO_DYN_FRAMES = 30
MONO_FRAMES = 50
# phases 10b and 11 keep the inputs of every K1 and K2 call of their first
# frames (the mono bootstrap's attempts and first tracked frames among
# them) and hold each against its plain version
RECORD_FRAMES = 6
# The JAX package on the CPU on the same worlds: ``python bench.py
# --stereo --cpu --frames 60`` (phase 10's ATE, mm; 27.55 at its default
# 120 frames) and ``JAX_PLATFORMS=cpu
# PYTHONPATH=. python tests/torch_port_util.py --world stereo-dynamic``
# (phase 10b: ATE in mm, the first frame with the object confirmed
# dynamic) and ``--world mono`` (phase 11: the frame it initialized at,
# the Sim3-aligned ATE in mm); the port on the CPU with the JAX package's
# bootstrap draws, ``--world mono --package port --jax-samples`` (mm).
JAX_STEREO_CHUNK_ATE_MM = 9.38
JAX_STEREO_DYN = (9.024, 9)
JAX_MONO = (2, 23.016)
JAX_MONO_PORT_CPU_MM = 22.962
# phase 12: the online detector's card-against-CPU frames, the chunked
# System's frames (the first, then four chunks) and the maps' tolerance
# (heat and offset absolute, size relative: it is exp(.) * 8 pixels);
# the detections that clear the threshold by DETECT_MARGIN must agree,
# their boxes within BOX_TOL px
ONLINE_DETECT_FRAMES = 6
ONLINE_FRAMES = 25
MAP_TOL = 1e-3
DETECT_MARGIN = 1e-3
BOX_TOL = 1e-3
# The JAX package and the port on the CPU on phase 12's world:
# ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_port_util.py --world
# online [--package port]``: ATE in mm, the first frame of the call after
# which a box is confirmed dynamic, the most boxes tracked at once.
JAX_ONLINE = (6.923, 13, 12)
PORT_CPU_ONLINE = (6.918, 13, 12)
# phase 13: the CLI's synthetic run, the frame it resumes at, and the
# frames tracked in localization-only mode after a load_map
CLI_FRAMES = 20
CLI_SKIP = 10
LOCALIZE_FRAMES = 8
BAG_FRAMES = 10
MULTI_LANES = 4
# phases 14a-d run 32, 30, 18 and 20 frames (60, 48, 20 and 30 before
# phase 15 was added), so that it fits the script's time (PERF.md,
# section 4)
MULTI_FRAMES = 32
MULTI_CHUNK_LANES = 2
MULTI_CHUNK_FRAMES = 30
MULTI_STEREO_FRAMES = 18
STRIDE_FRAMES = 20
RECORD_STEPS = 3        # batched steps whose K1 and K2 calls are kept
# phase 15: MultiSystem(mesh=), the sharded solvers across processes (the
# pose graph of __graft_entry__.py's ring, the BA of
# tests/test_distributed.py), the adaptive pipeline depth and prefetch
MESH_LANES = 4
MESH_FRAMES = 20
SHARD_POSES = 256
SHARD_KF, SHARD_LM, SHARD_OBS = 16, 1024, 12288
ADAPTIVE_FRAMES = 30
PROFILED_STEPS = 1
K3_LANES = 16           # phase 2b: the fleet's lanes in one K3 launch


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


def phase_k3(dev, kb):
    """Phase 2b: kernel K3 (the pose LM) against its plain version at the
    tracker's shapes, and the rows of the kernel table from
    ``kernel_bench.k3_report``'s device times in this run."""
    import numpy as np
    import torch
    from slam_dynamic_tpu_torch.optim import pose_opt

    n, lanes, err = kb.K3_PATH_N, K3_LANES, 0.0
    rng = np.random.default_rng(SEED)
    for d in (3, 2):
        chi2 = 7.815 if d == 3 else 5.991
        for rounds, iters in kb.K3_SCHEDULES:
            probs = [kb.k3_problem(rng, n, d, 0.3, dev)
                     for _ in range(lanes)]
            before = pose_opt.launches, pose_opt.batched_launches
            singles = [pose_opt.pose_lm(*p, rounds, iters, chi2)
                       for p in probs]
            cam = probs[0][0]          # shared, as the batched step's
            batched = torch.func.vmap(
                lambda *a: pose_opt.pose_lm(cam, *a, rounds, iters, chi2))(
                *(torch.stack([p[k] for p in probs]) for k in range(1, 8)))
            made = (pose_opt.launches - before[0],
                    pose_opt.batched_launches - before[1])
            if made != (lanes + 1, 1):
                raise AssertionError(f"K3 launches (all, batched) {made} "
                                     f"for {lanes} single calls and one "
                                     f"vmap call of {lanes} lanes")
            for b, p in enumerate(probs):
                ref = pose_opt.pose_lm_plain(*p, rounds, iters, chi2)
                err = max(err, kb.hold_k3(singles[b], ref, chi2))
                if not all(torch.equal(g[b], x)
                           for g, x in zip(batched, singles[b])):
                    raise AssertionError(f"K3 D = {d} {rounds} x {iters}: "
                                         f"lane {b} of the batched launch "
                                         f"differs from its single launch")
            log(f"phase 2b K3 pose_lm N = {n}, D = {d}, {rounds} x "
                f"{iters}, 30% outliers: {lanes} single calls within "
                f"tolerance of plain (R, t within 1e-4, labels off the "
                f"gate equal, n_inliers within 1%), one vmap call of "
                f"{lanes} lanes one launch and bit-equal with them")
    rep = kb.k3_report()
    frame = {}              # a tracked frame's three calls: two 2 x 6, one
    for b in (1, lanes):    # 4 x 10; per call, in ms
        a, c = rep[f"pose_lm_2x6_b{b}"], rep[f"pose_lm_4x10_b{b}"]
        frame[b] = {k: (2 * a[k] + c[k]) / 3
                    for k in ("k3_ms", "plain_ms", "bound_ms")}
        log(f"  K3 device time, N = {n}, D = 3, B = {b}: 2 x 6 "
            f"{a['k3_ms']:.5f} ms, 4 x 10 {c['k3_ms']:.5f} ms (host wall "
            f"{a['k3_host_ms']:.4f} and {c['k3_host_ms']:.4f} ms); plain "
            f"{a['plain_ms']:.4f} and {c['plain_ms']:.4f} ms device, "
            f"{a['plain_host_ms']:.2f} and {c['plain_host_ms']:.2f} ms host "
            f"wall; bound {a['bound_ms']:.6f} and {c['bound_ms']:.6f} ms "
            f"({a['bound_by']})")
    log(f"  launch floor (one tiny kernel) {rep['launch_floor_ms']:.5f} ms")
    rows = [dict(name=name, route="cuda",
                 source="slam_dynamic_tpu_torch/csrc/kernels.cu",
                 replaces="none: slam_dynamic_tpu/optim/pose_opt.py:43, "
                          "left to XLA's fusion",
                 max_abs_err=err, ms=frame[b]["k3_ms"],
                 plain_ms=frame[b]["plain_ms"],
                 bound_ms=frame[b]["bound_ms"],
                 bound_by=rep["pose_lm_2x6_b1"]["bound_by"], library_ms=None)
            for name, b in (("pose_lm", 1), ("pose_lm_batched", lanes))]
    return rows


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
    _zero_launches(gm, hm)
    calls = []
    t_run = time.perf_counter()
    with kb.recording_k1(calls):
        times, states, n_kf = track_frames(system, world, N_FRAMES)
    wall = time.perf_counter() - t_run
    launches = _launches(gm, hm)
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
    # the motion model's two calls and the local map's in every frame
    # after the first (BoW recovery and relocalization add their own)
    if launches["pose_lm"] < 3 * (N_FRAMES - 1):
        raise AssertionError(f"{launches['pose_lm']} K3 launches in "
                             f"{N_FRAMES - 1} tracked frames")
    return launches, calls, ate_mm


def phase_chunk(gm, hm, kb):
    """The main path as the port's bench runs it: 120 frames, C = 6."""
    import numpy as np
    from slam_dynamic_tpu_torch import bench

    calls = []
    _zero_launches(gm, hm)
    r = bench.run(CHUNK_FRAMES, CHUNK, seed=SEED,
                  warm_chunk=lambda: kb.recording_k1(calls))
    launches = _launches(gm, hm)
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

    _zero_launches(gm, hm)
    # K2's inputs are copied from the second warm chunk's three
    # classifications: the first with a reference frame (the first chunk
    # classifies against the placeholder)
    r = bench.run(DYN_CHUNK_FRAMES, CHUNK, seed=SEED, dynamic=True,
                  warm_chunk=lambda: kb.recording_k2(k2_calls),
                  warm_index=1, on_step=on_step)
    launches = _launches(gm, hm)
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
    log(f"phase 6 System.track_chunk dynamic scene 640x480 x "
        f"{DYN_CHUNK_FRAMES} "
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

    _zero_launches(gm, hm)
    tracking.fused_track_step_dyn = spy
    try:
        r = bench.run(DYN_FRAMES, 1, seed=SEED, dynamic=True,
                      classify_every=2,
                      on_step=lambda s, new: statuses.append(
                          tuple(int(x) for x in s.boxes.status)))
    finally:
        tracking.fused_track_step_dyn = orig
    launches = _launches(gm, hm)
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
    """Set the launch counts of K1 (``gm``), K2 (``hm``) and K3 to 0."""
    from slam_dynamic_tpu_torch.optim import pose_opt
    gm.launches = 0
    hm.launches = 0
    pose_opt.launches = 0


def _launches(gm, hm):
    from slam_dynamic_tpu_torch.optim import pose_opt
    return {"gated_match": gm.launches, "hamming_matrix": hm.launches,
            "pose_lm": pose_opt.launches}


def run_orbit(kb, loop_on: bool, k2_calls: list, frames: int = ORBIT_FRAMES,
              chunk: int = 1, world=None, global_ba: bool = False):
    """The orbit world through track_rgbd, frame by frame, or (``chunk``
    > 1) through track_chunk after the first OK frame, each chunk
    finalized before the next is dispatched, up to the chunk that closes
    the first loop. With loop closing on, the K2 calls of the first
    keyframe that closes a loop are kept in ``k2_calls``, and the
    keyframe poses and the frames in flight just before its loop closing
    in ``in_flight``. ``global_ba`` turns the post-loop global BA on; the
    trajectory read at the end runs a solve still in flight to its
    merge."""
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
        loop=dataclasses.replace(cfg.loop, enabled=loop_on,
                                 run_global_ba=global_ba))
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
    stats += system.tracker.drain()
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
    return launches, check_k2_on_closure(hm, kb, k2_calls, k2_err), \
        on["closed"][0][:3]


@contextlib.contextmanager
def gba_probe():
    """Within the block, every AmortizedGBA made, and each slice of its
    solve: the device ms between CUDA events around the ``step`` call and
    the host ms of the call itself (the second slice is run under
    torch.profiler instead, for its launches and kernels), and the ms of
    each merge with the device synchronized on both ends."""
    import torch
    from slam_dynamic_tpu_torch.backend import global_ba
    cls = global_ba.AmortizedGBA
    init, step, merge = cls.__init__, cls.step, cls.merge
    out = dict(made=0, slices=[], merges=[], profiled=None)

    def made(self, *a, **kw):
        out["made"] += 1
        init(self, *a, **kw)

    def stepped(self):
        if self.done:
            return step(self)
        if len(out["slices"]) == 1 and out["profiled"] is None:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                step(self)
                torch.cuda.synchronize()
            avg = prof.key_averages()
            calls = {e.key: e.count for e in avg}
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            top = sorted((e for e in avg if e.device_type
                          == torch.autograd.DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)[:4]
            out["profiled"] = dict(
                iters=self.slice_iters,
                launches=sum(calls.get(k, 0) for k in (
                    "cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx")),
                syncs=calls.get("cudaStreamSynchronize", 0),
                kernels=len(kernels),
                kernel_ms=sum(e.device_time_total for e in kernels) / 1e3,
                top=[(e.key[:48], e.count,
                      round(e.self_device_time_total / 1e3, 3))
                     for e in top])
            out["slices"].append(None)
            return None
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        step(self)
        host = (time.perf_counter() - t0) * 1e3
        e1.record()
        out["slices"].append((e0, e1, host))
        return None

    def merged(self, m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m2 = merge(self, m)
        torch.cuda.synchronize()
        out["merges"].append((time.perf_counter() - t0) * 1e3)
        return m2

    cls.__init__, cls.step, cls.merge = made, stepped, merged
    try:
        yield out
    finally:
        cls.__init__, cls.step, cls.merge = init, step, merge


def phase_loop_closure_gba(gm, hm, kb, k2_err, closure):
    """Phase 8c: phase 8's orbit with the post-loop global BA on. The
    first loop closes as in phase 8; its solve runs one slice a frame
    and is merged (here in the trajectory read: the loop closes 5 frames
    before the last), and the merged map is finite; the ATE is held to
    the JAX package's with the global BA on the CPU."""
    import numpy as np
    import torch
    from slam_dynamic_tpu_torch.utils import debug
    k2_calls = []
    _zero_launches(gm, hm)
    with gba_probe() as probe:
        r = run_orbit(kb, True, k2_calls, global_ba=True)
    launches = _launches(gm, hm)
    torch.cuda.synchronize()
    cfg = r["system"].cfg
    n_slices = -(-cfg.optimizer.global_ba_iters // cfg.loop.gba_slice_iters)
    timed = [(e0.elapsed_time(e1), host) for e0, e1, host in
             (x for x in probe["slices"] if x is not None)]
    cold, warm = timed[0], timed[1:]
    prof = probe["profiled"]
    finite = debug.check_finite_tree(r["system"].tracker.map,
                                     "the map after the merge")
    log(f"phase 8c orbit 640x480 x {ORBIT_FRAMES} frames, track_rgbd, loop "
        f"closing on, post-loop global BA on: {r['frames'] / r['wall']:.2f} "
        f"fps, keyframes {r['keyframes']}, loops closed (slot, seq, "
        f"candidate, inliers, total) {r['closed']}, solves started "
        f"{probe['made']}, slices {len(probe['slices'])} (of "
        f"{n_slices}), merges {len(probe['merges'])}, LOST frames "
        f"{r['lost']}, unaligned ATE {r['ate'] * 1e3:.3f} mm (JAX on the "
        f"CPU {JAX_ORBIT_GBA_ATE * 1e3:.3f} mm; phase 8 without the global "
        f"BA: see its line), map finite after the merge {finite}, "
        f"launches {launches}")
    log(f"  global BA slices ({cfg.loop.gba_slice_iters} GN iterations "
        f"each): cold slice {cold[0]:.3f} ms device between CUDA events, "
        f"{cold[1]:.3f} ms host in step(); warm slices device "
        f"{[round(d, 3) for d, _ in warm]} ms (median "
        f"{float(np.median([d for d, _ in warm])):.3f}), host in step() "
        f"{[round(h, 3) for _, h in warm]} ms (median "
        f"{float(np.median([h for _, h in warm])):.3f}); the second slice "
        f"under torch.profiler: {prof['launches']} kernel launch calls, "
        f"{prof['kernels']} kernels on the card "
        f"({prof['kernel_ms']:.3f} ms of kernel time), "
        f"{prof['launches'] / prof['iters']:.1f} launches per GN iteration, "
        f"{prof['syncs']} cudaStreamSynchronize calls, the longest kernels "
        f"(name, count, ms) {prof['top']};"
        f" merge {probe['merges'][0] if probe['merges'] else float('nan'):.3f}"
        f" ms")
    for (k, *_), sp in zip(r["closed"], r["spans"]):
        log(f"  keyframe {k}'s loop closing, host time: {_spans_line(sp)}")
    ref = JAX_ORBIT_GBA_ATE
    if not r["closed"] or tuple(r["closed"][0][:3]) != tuple(closure) \
            or r["lost"] or probe["made"] != 1 \
            or len(probe["slices"]) != n_slices \
            or len(probe["merges"]) != 1 or not finite \
            or not (r["ate"] < 0.15
                    and abs(r["ate"] - ref) <= max(1e-3, 0.2 * ref)):
        raise AssertionError(
            f"orbit with the global BA: closed {r['closed']} (phase 8 "
            f"{closure}), LOST {r['lost']}, solves {probe['made']}, slices "
            f"{len(probe['slices'])}, merges {len(probe['merges'])}, ATE "
            f"{r['ate']:.4f} m (JAX {ref:.4f} m)")
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
    states += [st.state for st in system.tracker.drain()]
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
    """Phase 10: ``bench --stereo``'s path, 60 frames at C = 6 with one
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
    r = bench.run(STEREO_CHUNK_FRAMES, CHUNK, seed=SEED, stereo=True,
                  warm_chunk=warm)
    launches = _launches(gm, hm)
    system = r["system"]
    tracker = system.tracker
    n_lost = sum(s.state != "OK" for s in r["stats"])
    ms = np.sort(r["step_ms"])
    ate_mm = r["ate_m"] * 1e3
    log(f"phase 10 System.track_chunk stereo 640x480 x "
        f"{STEREO_CHUNK_FRAMES} "
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


def hold_recorded(gm, hm, rec, what, k1_err, k2_err,
                  scope=f"the first {RECORD_FRAMES} frames"):
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
    log(f"  K1 on the {n1} calls and K2 on the {n2} calls of {scope} (K2 "
        f"shapes {shapes}): bit-equal with plain")
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


def _detector_profile(det, img) -> tuple:
    """One ``det.detect(img)`` under torch.profiler: its kernel launches
    (the host's cudaLaunchKernel and cuLaunchKernel calls, either form),
    the kernels the card ran and their summed device time in ms."""
    import torch
    from torch.autograd import DeviceType
    det.detect(img)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        det.detect(img)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                "cuLaunchKernel", "cuLaunchKernelEx"))
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    return launches, len(kernels), busy_ms


def _detect_ms(det, img, reps: int = 20) -> float:
    """Device ms of one detect, between CUDA events around ``reps`` calls
    (the gaps between its launches are in it)."""
    import torch
    det.detect(img)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        det.detect(img)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _valid_detections(det):
    v = det.valid.cpu().numpy()
    return (det.boxes.cpu().numpy()[v], det.scores.cpu().numpy()[v],
            det.classes.cpu().numpy()[v])


def pair_detections(a, b, within: float = 0.5) -> tuple:
    """The detections of two sides, each (boxes, scores, classes), paired
    greedily by class and box (the nearest box of the same class within
    ``within`` px on every coordinate): returns the pairs (i, j) and the
    indices found on side a only and on side b only."""
    import numpy as np
    pairs, taken = [], set()
    for i in range(len(a[0])):
        d = np.where(b[2] == a[2][i],
                     np.abs(b[0] - a[0][i]).max(axis=1, initial=0), np.inf)
        for j in np.argsort(d, kind="stable"):
            if d[j] > within:
                break
            if j not in taken:
                taken.add(int(j))
                pairs.append((i, int(j)))
                break
    only_a = sorted(set(range(len(a[0]))) - {i for i, _ in pairs})
    only_b = sorted(set(range(len(b[0]))) - taken)
    return pairs, only_a, only_b


def check_detector_on_card(frames):
    """The card's Detector against the CPU's on the same frames: the
    maps' largest differences; the detections paired by class and box,
    those that clear the threshold by DETECT_MARGIN on either side found
    on both with boxes within BOX_TOL px, the ones nearer it counted and
    the threshold flips (detections on one side only) counted; then its
    device time and launches per detect."""
    import numpy as np
    import torch
    from slam_dynamic_tpu_torch.config import DetectorConfig
    from slam_dynamic_tpu_torch.models.detector import (
        Detector, default_detector_weights)
    weights = default_detector_weights()
    if weights is None:
        raise AssertionError("the detector's weights are missing")
    dc = DetectorConfig(mode="online")
    H, W = frames[0].shape
    gpu = Detector.from_npz(dc, H, W, weights)        # the card
    cpu = Detector.from_npz(dc, H, W, weights, device="cpu")
    thr = dc.conf_threshold
    err = [0.0, 0.0, 0.0]
    near = flips = kept = 0
    box_err = 0.0
    for img in frames:
        for k, (a, b) in enumerate(zip(gpu.maps(img), cpu.maps(img))):
            d = (a.cpu() - b).abs()
            if k == 1:
                d = d / b.abs().clamp(min=1.0)
            err[k] = max(err[k], float(d.max()))
        g, c = (_valid_detections(d.detect(img)) for d in (gpu, cpu))
        near += int((np.abs(g[1] - thr) < DETECT_MARGIN).sum()
                    + (np.abs(c[1] - thr) < DETECT_MARGIN).sum())
        pairs, only_g, only_c = pair_detections(g, c)
        flips += len(only_g) + len(only_c)
        clear = [g[1][i] > thr + DETECT_MARGIN for i in only_g] + \
            [c[1][j] > thr + DETECT_MARGIN for j in only_c]
        held = [(i, j) for i, j in pairs
                if max(g[1][i], c[1][j]) > thr + DETECT_MARGIN]
        kept += len(held)
        for i, j in held:
            box_err = max(box_err, float(np.abs(g[0][i] - c[0][j]).max()))
        if any(clear) or box_err > BOX_TOL:
            raise AssertionError(
                "detector: the card's detections above the margin differ "
                f"from the CPU's (on one side only: {sum(clear)}; largest "
                f"box difference {box_err:.3g} px)")
    img_dev = torch.from_numpy(frames[0]).cuda().to(torch.float32)
    ms = _detect_ms(gpu, img_dev)
    launches, n_kernels, busy_ms = _detector_profile(gpu, img_dev)
    log(f"  detector on the card against the CPU, {len(frames)} frames "
        f"{W}x{H}: largest map difference heat {err[0]:.3g}, size "
        f"{err[1]:.3g} (relative), offset {err[2]:.3g} (tolerance "
        f"{MAP_TOL}); {kept} detections clear the threshold by "
        f"{DETECT_MARGIN}, all on both sides, boxes within {box_err:.3g} px "
        f"(tolerance {BOX_TOL}); {near} within {DETECT_MARGIN} of it; "
        f"threshold flips (detections on one side only) {flips}; per "
        f"detect {ms:.4f} ms (between CUDA events around 20 calls, launch "
        f"gaps in), {launches} kernel launches, {n_kernels} kernels on the "
        f"card busy {busy_ms:.4f} ms (torch.profiler)")
    if max(err) > MAP_TOL:
        raise AssertionError("detector maps: card and CPU disagree")


def _tests_path(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        name + ".py")


def _tests_module(name: str):
    """A module of ``tests/`` that imports no JAX, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, _tests_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parity_driver():
    """``tests/port_drive.py``, the driver the CPU parity tests run."""
    return _tests_module("port_drive")


def phase_online(gm, hm, kb, k1_err, k2_err):
    """Phase 12: the online detector on the card against the CPU, then
    the moving-object world chunked with boxes from the System's own
    detector; K1 and K2 held on the calls of the first 6 frames."""
    import dataclasses
    import numpy as np
    import torch
    from slam_dynamic_tpu_torch.config import DetectorConfig
    from slam_dynamic_tpu_torch.io.bench_world import bench_world
    from slam_dynamic_tpu_torch.io.evo import ate_rmse
    from slam_dynamic_tpu_torch.system import System

    world = bench_world(ONLINE_FRAMES, SEED, dynamic=True)
    seq, gray8, depth, cfg = world
    check_detector_on_card(list(gray8[:ONLINE_DETECT_FRAMES]))
    cfg = cfg.replace(
        detector=DetectorConfig(mode="online"),
        tracking=dataclasses.replace(cfg.tracking, pipeline_depth=1))
    system = System(cfg)
    n_detect = [0]
    detect = system.detector.detect

    def counting(image):
        n_detect[0] += 1
        return detect(image)
    system.detector.detect = counting
    rec = {"k1": [], "k2": [], "launched": [0, 0]}
    _zero_launches(gm, hm)
    r = parity_driver().run_dynamic(
        system, (cfg, seq, gray8, depth), ONLINE_FRAMES, CHUNK,
        use_boxes=False, sync=torch.cuda.synchronize,
        call_ctx=recording_frames(gm, hm, kb, rec))
    launches = _launches(gm, hm)
    states = [s.state for s in r["stats"]]
    est = r["est"]
    ate_mm = ate_rmse(est, seq.t_wc[:len(est)]) * 1e3
    log(f"phase 12 System.track_chunk with the online detector, moving "
        f"object 640x480 x {r['n_frames']} frames, C = {CHUNK}, one chunk "
        f"in flight: chunk p50 {np.median(r['times'][1:]) * 1e3:.1f} ms, "
        f"LOST frames {states.count('LOST')} of {len(states)}, detector "
        f"calls {n_detect[0]}, boxes tracked at most {r['max_boxes']} at "
        f"once, box status {tuple(int(x) for x in system.boxes.status)} "
        f"(2 from the call at frame {r['first_dynamic']}), ATE "
        f"{ate_mm:.3f} mm (on the CPU, ATE mm, first dynamic, boxes: the "
        f"JAX package {JAX_ONLINE}, the port {PORT_CPU_ONLINE}), launches "
        f"{launches}")
    if states.count("OK") != len(states) or r["n_frames"] != ONLINE_FRAMES \
            or n_detect[0] != ONLINE_FRAMES or not r["max_boxes"] \
            or r["first_dynamic"] is None or ate_mm >= 30.0 \
            or min(launches.values()) <= 0:
        raise AssertionError("online detector phase failed its checks")
    return (launches, *hold_recorded(gm, hm, rec, "phase 12's frames",
                                     k1_err, k2_err))


def _run_cli(args) -> list:
    """``python -m slam_dynamic_tpu_torch.io.run`` in process: the JSON
    lines it printed (standard output also goes to ours)."""
    import io
    from slam_dynamic_tpu_torch.io import run as cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(args)
    text = out.getvalue()
    sys.stdout.write("".join(f"  cli: {x}\n" for x in text.splitlines()))
    if rc != 0:
        raise AssertionError(f"the CLI exited {rc}")
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def _ply_points(path) -> int:
    with open(path) as f:
        for line in f:
            if line.startswith("element vertex"):
                return int(line.split()[-1])
    raise AssertionError(f"{path}: no vertex count")


def recorded_run(gm, hm, kb, fn):
    """``fn()`` with the launch counts set to 0 just before it and read
    just after, and a copy of every K1 and K2 call's inputs kept: returns
    (its result, the launches, the record for ``hold_recorded``)."""
    rec = {"k1": [], "k2": []}
    _zero_launches(gm, hm)
    with kb.recording_k1(rec["k1"]), kb.recording_k2(rec["k2"], every=True):
        out = fn()
    rec["launched"] = [gm.launches, hm.launches]
    return out, _launches(gm, hm), rec


def write_bag_world(d: str) -> tuple:
    """BAG_FRAMES frames of the synthetic 640x480 world recorded as a ROS
    bag by the port's BagWriter (uint8 gray, uint16 depth in mm), with a
    camera yaml for them: (bag path, yaml path, the world)."""
    import numpy as np
    from slam_dynamic_tpu_torch.io.rosbag import BagWriter
    from slam_dynamic_tpu_torch.io.synthetic import SynthConfig, generate
    s = SynthConfig(n_frames=BAG_FRAMES)
    seq = generate(s)
    bag, yaml = os.path.join(d, "world.bag"), os.path.join(d, "cam.yaml")
    w = BagWriter(bag)
    for i in range(BAG_FRAMES):
        ts = float(seq.timestamps[i])
        w.write_image("/camera/rgb/image_raw", ts,
                      np.clip(seq.gray[i], 0, 255).astype(np.uint8))
        w.write_image("/camera/depth_registered/image_raw", ts,
                      np.clip(seq.depth[i] * 1000.0, 0, 65535)
                      .astype(np.uint16))
    w.close()
    with open(yaml, "w") as f:
        f.write("%YAML:1.0\n" + "".join(
            f"{k}: {v}\n" for k, v in (
                ("Camera.fx", s.fx), ("Camera.fy", s.fy), ("Camera.cx", s.cx),
                ("Camera.cy", s.cy), ("Camera.bf", s.fx * s.baseline),
                ("Camera.width", s.width), ("Camera.height", s.height),
                ("ThDepth", 120.0), ("DepthMapFactor", 1000.0))))
    return bag, yaml, seq


def rosbag_run(gm, hm, kb, d, k1_err, k2_err):
    """The CLI replaying the bag of ``write_bag_world`` on the card, its
    K1 and K2 calls counted apart and held; then track_rgbd on the same
    decoded frames with the same config. Returns the CLI's summary, its
    ATE and the direct run's (Umeyama-aligned, metres), the direct run's
    states, the launches and the errors."""
    import numpy as np
    from slam_dynamic_tpu_torch.io import run as cli
    from slam_dynamic_tpu_torch.io.evo import ate_rmse
    from slam_dynamic_tpu_torch.io.rosbag import RosbagRGBD
    from slam_dynamic_tpu_torch.io.trajectory import load_tum
    from slam_dynamic_tpu_torch.system import System
    bag, yaml, seq = write_bag_world(d)
    out = os.path.join(d, "rosbag")
    args = ["--dataset", "rosbag", "--path", bag, "--yaml", yaml,
            "--log-frames", "--out", out]
    lines, launches, rec = recorded_run(gm, hm, kb,
                                        lambda: _run_cli(args))
    k1_err, k2_err = hold_recorded(gm, hm, rec, "phase 13's rosbag run",
                                   k1_err, k2_err, "the rosbag CLI run")
    _, pos, _ = load_tum(os.path.join(out, "FrameTrajectory.txt"))
    ate_cli = float(ate_rmse(pos, seq.t_wc[:len(pos)]))
    system = System(cli.build_config(cli._parser().parse_args(args)))
    states = [system.track_rgbd(p.gray, p.depth, p.timestamp).state
              for p in RosbagRGBD(bag)]
    est = np.stack([-R.T @ t for _, R, t in system.trajectory])
    ate_direct = float(ate_rmse(est, seq.t_wc[:len(est)]))
    return lines[-1], ate_cli, ate_direct, states, launches, k1_err, k2_err


def phase_cli(gm, hm, kb, k1_err, k2_err):
    """Phase 13: three paths, each with its own launch counts and K1 and
    K2 held bit-equal on every call it made: the dataset CLI in process on
    the card (the synthetic world with the dense map and the checkpoint),
    the CLI resumed from the checkpoint, and a System loaded from it in
    localization-only mode."""
    import tempfile
    from slam_dynamic_tpu_torch.io import run as cli
    from slam_dynamic_tpu_torch.io.synthetic import SynthConfig, generate
    from slam_dynamic_tpu_torch.system import System

    launches = {}
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "map.npz")
        first, resumed = (os.path.join(d, x) for x in ("first", "resumed"))
        base = ["--dataset", "synthetic", "--frames", str(CLI_FRAMES),
                "--log-frames"]
        lines, launches["cli"], rec = recorded_run(
            gm, hm, kb, lambda: _run_cli(base + ["--ply", "--save-map", ck,
                                                 "--out", first]))
        s1 = lines[-1]
        k1_err, k2_err = hold_recorded(gm, hm, rec, "phase 13's first run",
                                       k1_err, k2_err, "the first CLI run")
        n_dense = _ply_points(os.path.join(first, "map.ply"))
        files = sorted(os.listdir(first))
        lines, launches["cli_resumed"], rec = recorded_run(
            gm, hm, kb, lambda: _run_cli(base + [
                "--skip", str(CLI_SKIP), "--load-map", ck, "--out",
                resumed]))
        loaded, s2 = lines[0], lines[-1]
        k1_err, k2_err = hold_recorded(gm, hm, rec, "phase 13's resumed run",
                                       k1_err, k2_err, "the resumed CLI run")
        with open(os.path.join(resumed, "frames.jsonl")) as f:
            rows = [json.loads(x) for x in f]
        # localization-only mode on the loaded map
        args = cli._parser().parse_args(base)
        system = System(cli.build_config(args))
        system.load_map(ck)
        n_kf = system.tracker.n_kf_host
        system.activate_localization_mode()
        seq = generate(SynthConfig(n_frames=CLI_FRAMES))
        loc, launches["localization"], rec = recorded_run(
            gm, hm, kb, lambda: [
                system.track_rgbd(seq.gray[i], seq.depth[i],
                                  float(seq.timestamps[i])).state
                for i in range(CLI_SKIP, CLI_SKIP + LOCALIZE_FRAMES)])
        loc_kf = system.tracker.n_kf_host
        k1_err, k2_err = hold_recorded(
            gm, hm, rec, "phase 13's localization frames", k1_err, k2_err,
            "the localization-only frames")
        s3, ate_bag, ate_direct, bag_states, launches["cli_rosbag"], \
            k1_err, k2_err = rosbag_run(gm, hm, kb, d, k1_err, k2_err)
    log(f"phase 13 the CLI (python -m slam_dynamic_tpu_torch.io.run) on the "
        f"card, synthetic 640x480 x {CLI_FRAMES} frames with --ply "
        f"--save-map: {s1['frames']} frames, LOST {s1['lost']}, keyframes "
        f"{s1['keyframes']}, landmarks {s1['landmarks']}, dense map "
        f"{n_dense} points, ATE {s1.get('ate_m', float('nan')) * 1e3:.3f} "
        f"mm, {s1['fps']:.2f} fps; files {files}; launches {launches['cli']}")
    log(f"  resumed with --load-map --skip {CLI_SKIP}: state after the load "
        f"{loaded['state']} ({loaded['keyframes']} keyframes), then "
        f"{[r['state'] for r in rows]}, LOST {s2['lost']}, ATE "
        f"{s2.get('ate_m', float('nan')) * 1e3:.3f} mm; launches "
        f"{launches['cli_resumed']}")
    log(f"  localization-only mode on the loaded map, {LOCALIZE_FRAMES} "
        f"frames: {loc}, keyframes {n_kf} -> {loc_kf}; launches "
        f"{launches['localization']}")
    log(f"  --dataset rosbag on {BAG_FRAMES} frames of the synthetic world "
        f"recorded by BagWriter: {s3['frames']} frames, LOST {s3['lost']}, "
        f"keyframes {s3['keyframes']}, ATE {ate_bag * 1e3:.3f} mm "
        f"(track_rgbd on the decoded frames: {ate_direct * 1e3:.3f} mm, "
        f"states {sorted(set(bag_states))}), {s3['fps']:.2f} fps; launches "
        f"{launches['cli_rosbag']}")
    expect = ["CameraTrajectory_kitti.txt", "FrameTrajectory.txt",
              "KeyFrameTrajectory.txt", "frames.jsonl", "groundtruth.txt",
              "map.pcd", "map.ply", "summary.json"]
    if files != expect or s1["lost"] or s1["ate_m"] >= 0.03 \
            or n_dense < 1000 or loaded["state"] != "LOST" \
            or s2["lost"] or len(rows) != CLI_FRAMES - CLI_SKIP \
            or any(r["state"] != "OK" for r in rows) \
            or s2["ate_m"] >= 0.03 or loc != ["OK"] * LOCALIZE_FRAMES \
            or loc_kf != n_kf \
            or s3["frames"] != BAG_FRAMES or s3["lost"] \
            or bag_states != ["OK"] * BAG_FRAMES \
            or abs(ate_bag - ate_direct) > max(1e-3, 0.2 * ate_direct) \
            or min(min(x.values()) for x in launches.values()) <= 0:
        raise AssertionError("CLI phase failed its checks")
    return launches, k1_err, k2_err


def _profiled(fn, n: int) -> dict:
    """``n`` calls of ``fn()`` under torch.profiler, the device synchronized
    after them: per call, the kernel launches (the runtime's launch calls)
    and the synchronize and copy calls; the device's busy share over the
    window (summed kernel time over wall time). Only the CUDA activity is
    traced (the runtime's calls and the kernels, no operator events): the
    trace's processing, not the steps, is most of the time."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    on_card = [e for e in ev
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_us = sum(e.self_device_time_total for e in on_card)
    if not on_card:
        raise AssertionError("torch.profiler recorded nothing on the card")
    return dict(
        launches=sum(e.count for e in ev if "LaunchKernel" in e.key) / n,
        kernels=sum(e.count for e in on_card) / n,
        syncs=sum(e.count for e in ev if "Synchronize" in e.key
                  or "Memcpy" in e.key) / n,
        busy=kernel_us / 1e3 / wall_ms, wall_ms=wall_ms / n)


def hold_batched(gm, hm, kb, k1_calls, k2_calls, what, k1_err, k2_err):
    """Every recorded batched K1 and K2 call bit-equal with B single
    launches and with the plain per-lane loop (idx included); returns the
    errors raised to the largest absolute differences."""
    import torch
    for args, lo, hi in k1_calls:
        got = gm.gated_match_batched(*args, lvl_min=lo, lvl_max=hi)
        singles = kb.per_lane(gm.gated_match)(*args, lvl_min=lo, lvl_max=hi)
        plain = gm.gated_match_batched_plain(*args, lvl_min=lo, lvl_max=hi)
        torch.cuda.synchronize()
        single = [torch.stack(x) for x in zip(*singles)]
        k1_err = max(k1_err, *(_max_diff(k, p) for k, p in zip(got, plain)))
        if not all(torch.equal(k, p) and torch.equal(k, o)
                   for k, p, o in zip(got, plain, single)):
            raise AssertionError(f"batched K1 on {what}: kernel != single "
                                 f"launches or plain (err {k1_err})")
    for a, b in k2_calls:
        got = hm.hamming_matrix_batched(a, b)
        single = torch.stack(kb.per_lane(hm.hamming_matrix)(a, b))
        plain = hm.hamming_matrix_batched_plain(a, b)
        torch.cuda.synchronize()
        k2_err = max(k2_err, _max_diff(got, plain))
        if not (torch.equal(got, plain) and torch.equal(got, single)):
            raise AssertionError(f"batched K2 on {what}: kernel != single "
                                 f"launches or plain (err {k2_err})")
    return k1_err, k2_err


def _recording_steps(kb, k1_calls, k2_calls, launched):
    """A ``step_ctx`` for ``bench.run_multi``: the RECORD_STEPS steps after
    the first (where every lane initializes on its own path) keep their
    batched K1 and K2 calls; ``launched`` gets the batched launches they
    made."""
    from slam_dynamic_tpu_torch.ops import gated_match as gm
    from slam_dynamic_tpu_torch.ops import hamming as hm

    @contextlib.contextmanager
    def ctx(step):
        if not 1 <= step <= RECORD_STEPS:
            yield
            return
        l1, l2 = gm.batched_launches, hm.batched_launches
        with kb.recording_batched(k1_calls, k2_calls):
            yield
        launched[0] += gm.batched_launches - l1
        launched[1] += hm.batched_launches - l2
    return ctx


def _zero_batched(gm, hm):
    from slam_dynamic_tpu_torch.optim import pose_opt
    _zero_launches(gm, hm)
    gm.batched_launches = 0
    hm.batched_launches = 0
    pose_opt.batched_launches = 0


def _batched_launches(gm, hm):
    from slam_dynamic_tpu_torch.optim import pose_opt
    return {**_launches(gm, hm),
            "gated_match_batched": gm.batched_launches,
            "hamming_matrix_batched": hm.batched_launches,
            "pose_lm_batched": pose_opt.batched_launches}


def _multi_checks(r, what, lanes):
    """No LOST frame in any lane, every lane's trajectory whole and finite,
    lane 0's ATE under 30 mm, one packet readback per batched step."""
    import numpy as np
    ms = r["ms"]
    flat = [st for row in r["stats"] if row for st in row if st is not None]
    n_lost = sum(st.state == "LOST" for st in flat)
    lens = [len(s.trajectory) for s in ms.systems]
    steps = (ms.dispatches, ms.packet_reads)
    if n_lost or r["ate_m"] * 1e3 >= 30.0 or len(ms.systems) != lanes \
            or ms.dispatches != ms.packet_reads \
            or any(s.tracker.state != "OK" for s in ms.systems) \
            or not all(np.isfinite(np.stack([t for _, _, t in
                                             s.trajectory])).all()
                       for s in ms.systems):
        raise AssertionError(f"{what}: LOST frames {n_lost}, ATE "
                             f"{r['ate_m'] * 1e3:.3f} mm, trajectories "
                             f"{lens}, steps and readbacks {steps}")
    return n_lost, lens, steps


def phase_multi(gm, hm, kb, k1_err, k2_err):
    """Phase 14a: ``bench --multi 4``'s batched serving, lanes of one
    pipelined MultiSystem, beside a solo System on lane 0's frames."""
    import numpy as np
    from slam_dynamic_tpu_torch import bench

    from slam_dynamic_tpu_torch.optim import pose_opt
    k1_calls, k2_calls, launched = [], [], [0, 0]
    per_step, k3_per_step = [], []

    def on_step(ms, i, timed):
        if timed:
            per_step.append(gm.batched_launches)
            k3_per_step.append(pose_opt.batched_launches)

    _zero_batched(gm, hm)
    t0 = time.perf_counter()
    r = bench.run_multi(MULTI_LANES, MULTI_FRAMES, seed=SEED,
                        on_step=on_step,
                        step_ctx=_recording_steps(kb, k1_calls, k2_calls,
                                                  launched))
    launches = _batched_launches(gm, hm)
    walls = {"run": time.perf_counter() - t0}
    k1_steps = np.diff(per_step)
    k3_steps = np.diff(k3_per_step)
    n_lost, lens, steps = _multi_checks(r, "phase 14a", MULTI_LANES)
    ms_sorted = np.sort(r["step_ms"])
    t0 = time.perf_counter()
    multi_prof = _profiled(lambda: r["step"](MULTI_FRAMES - 1),
                           PROFILED_STEPS)
    walls["profiled"] = time.perf_counter() - t0
    solo = bench.run(MULTI_FRAMES, 1, seed=SEED, warm_frames=14)
    walls["solo"] = time.perf_counter() - t0 - walls["profiled"]
    t0 = time.perf_counter()
    solo_prof = _profiled(lambda: solo["step"](MULTI_FRAMES - 1),
                          PROFILED_STEPS)
    walls["solo_profiled"] = time.perf_counter() - t0
    ate_mm, solo_mm = r["ate_m"] * 1e3, solo["ate_m"] * 1e3
    log(f"phase 14a bench --multi {MULTI_LANES}: MultiSystem of "
        f"{MULTI_LANES} lanes, 640x480 RGB-D x {MULTI_FRAMES} frames each "
        f"(lane b shifted by 3 b frames), one step in flight: aggregate "
        f"{r['fps']:.2f} fps, per lane {r['per_lane_fps']:.2f} fps over "
        f"{r['n_timed']} timed steps, step p50 {np.median(ms_sorted):.1f} ms,"
        f" p90 {ms_sorted[int(len(ms_sorted) * 0.9)]:.1f} ms; LOST frames "
        f"{n_lost}, trajectories {lens}, lane 0 ATE {ate_mm:.3f} mm (solo "
        f"System, same frames, one frame in flight: {solo_mm:.3f} mm, "
        f"{solo['fps']:.2f} fps); batched steps and packet readbacks "
        f"{steps}; launches {launches}")
    log(f"  per batched step ({PROFILED_STEPS} steady step under "
        f"torch.profiler, CUDA activity): {multi_prof['launches']:.0f} "
        f"launch calls, {multi_prof['kernels']:.0f} kernels and copies on "
        f"the card, {multi_prof['syncs']:.0f} sync/copy calls, device busy "
        f"{multi_prof['busy']:.3f}, {multi_prof['wall_ms']:.1f} ms; one "
        f"lane's frame (the solo System): {solo_prof['launches']:.0f} "
        f"launch calls, {solo_prof['kernels']:.0f} on the card, "
        f"{solo_prof['syncs']:.0f} sync/copy calls, busy "
        f"{solo_prof['busy']:.3f}, {solo_prof['wall_ms']:.1f} ms; batched "
        f"K1 and K3 launches per timed step "
        f"{sorted(set(k1_steps.tolist()))} and "
        f"{sorted(set(k3_steps.tolist()))} (one lane's fused step: 3 "
        f"each); wall s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    if abs(ate_mm - solo_mm) > max(1.0, 0.2 * solo_mm) or \
            set(k1_steps.tolist()) != {3} or min(lens) != MULTI_FRAMES or \
            set(k3_steps.tolist()) != {3} or \
            min(launches[k] for k in ("gated_match", "hamming_matrix",
                                      "gated_match_batched",
                                      "pose_lm_batched")) <= 0:
        raise AssertionError("multi phase failed its checks")
    if len(k1_calls) != 3 * RECORD_STEPS or k2_calls or \
            launched != [len(k1_calls), 0]:
        raise AssertionError(f"{len(k1_calls)} batched K1 and "
                             f"{len(k2_calls)} K2 calls kept in "
                             f"{RECORD_STEPS} steps, {launched} launched")
    k1_err, k2_err = hold_batched(gm, hm, kb, k1_calls, [], "phase 14a's "
                                  "steps", k1_err, k2_err)
    ms_b = kb.calls_ms(gm.gated_match_batched, k1_calls)
    ms_1 = kb.calls_ms(kb.per_lane(gm.gated_match), k1_calls)
    plain = kb.calls_ms(gm.gated_match_batched_plain, k1_calls)
    b_ms, b_by = kb.k1_calls_bound(k1_calls)
    log(f"  batched K1 on the {len(k1_calls)} calls of the first "
        f"{RECORD_STEPS} batched steps (B = {MULTI_LANES}): bit-equal with "
        f"{MULTI_LANES} single launches and plain; device time per batched "
        f"launch {ms_b:.5f} ms, the {MULTI_LANES} single launches "
        f"{ms_1:.5f} ms, plain {plain:.4f} ms, bound {b_ms:.5f} ms ({b_by},"
        f" {b_ms / ms_b:.1%} of it reached)")
    row = dict(name="gated_match_batched", route="cuda",
               source="slam_dynamic_tpu_torch/csrc/kernels.cu",
               replaces="slam_dynamic_tpu/ops/pallas_match.py:83",
               launches=launches["gated_match_batched"],
               max_abs_err=k1_err, ms=ms_b, plain_ms=plain, bound_ms=b_ms,
               bound_by=b_by, library_ms=None)
    return launches, row, k1_err, k2_err


def phase_multi_chunk(gm, hm):
    """Phase 14b: ``bench --multi 2 --chunk 6`` from a cold start."""
    import numpy as np
    from slam_dynamic_tpu_torch import bench

    _zero_batched(gm, hm)
    r = bench.run_multi(MULTI_CHUNK_LANES, MULTI_CHUNK_FRAMES, CHUNK,
                        seed=SEED)
    launches = _batched_launches(gm, hm)
    n_lost, lens, steps = _multi_checks(r, "phase 14b", MULTI_CHUNK_LANES)
    ms_sorted = np.sort(r["step_ms"])
    log(f"phase 14b bench --multi {MULTI_CHUNK_LANES} --chunk {CHUNK}: "
        f"{MULTI_CHUNK_FRAMES} frames a lane from a cold start: aggregate "
        f"{r['fps']:.2f} fps over {r['n_timed']} timed frames a lane, call "
        f"p50 {np.median(ms_sorted):.1f} ms, p90 "
        f"{ms_sorted[int(len(ms_sorted) * 0.9)]:.1f} ms; LOST frames "
        f"{n_lost}, trajectories {lens}, lane 0 ATE "
        f"{r['ate_m'] * 1e3:.3f} mm; batched calls and readbacks {steps} "
        f"(per-frame batches while a lane was not OK, then chunks), "
        f"launches {launches}")
    if launches["gated_match_batched"] <= 0 \
            or min(lens) != MULTI_CHUNK_FRAMES:
        raise AssertionError("multi chunk phase failed its checks")
    return launches


def phase_multi_stereo(gm, hm, kb, k1_err, k2_err):
    """Phase 14c: ``track_stereo_batch`` on 2 lanes; K1 and K2 batched."""
    from slam_dynamic_tpu_torch import bench

    k1_calls, k2_calls, launched = [], [], [0, 0]
    _zero_batched(gm, hm)
    r = bench.run_multi(MULTI_CHUNK_LANES, MULTI_STEREO_FRAMES, seed=SEED,
                        stereo=True,
                        step_ctx=_recording_steps(kb, k1_calls, k2_calls,
                                                  launched))
    launches = _batched_launches(gm, hm)
    n_lost, lens, _ = _multi_checks(r, "phase 14c", MULTI_CHUNK_LANES)
    log(f"phase 14c MultiSystem.track_stereo_batch, {MULTI_CHUNK_LANES} "
        f"lanes x {MULTI_STEREO_FRAMES} frames of the 640x480 stereo pair: "
        f"LOST frames {n_lost}, trajectories {lens}, lane 0 ATE "
        f"{r['ate_m'] * 1e3:.3f} mm, launches {launches}")
    if len(k2_calls) != RECORD_STEPS or launched != [len(k1_calls),
                                                     len(k2_calls)] \
            or min(launches.values()) <= 0:
        raise AssertionError(f"{len(k1_calls)} batched K1 and "
                             f"{len(k2_calls)} K2 calls kept, {launched} "
                             f"launched")
    k1_err, k2_err = hold_batched(gm, hm, kb, k1_calls, k2_calls,
                                  "phase 14c's steps", k1_err, k2_err)
    a, b = k2_calls[0]
    ms_b = kb.device_ms(lambda: hm.hamming_matrix_batched(a, b))
    ms_1 = kb.device_ms(lambda: kb.per_lane(hm.hamming_matrix)(a, b))
    plain = kb.device_ms(lambda: hm.hamming_matrix_batched_plain(a, b))
    b_ms, b_by = kb.k2_bound(a.shape[1], b.shape[1], a.shape[0])
    log(f"  K1 on the {len(k1_calls)} and K2 on the {len(k2_calls)} "
        f"batched calls of the first {RECORD_STEPS} batched steps: "
        f"bit-equal with "
        f"single launches and plain; K2 at {tuple(a.shape[:2])} x "
        f"{b.shape[1]}: device time per batched launch {ms_b:.6f} ms, the "
        f"{a.shape[0]} single launches {ms_1:.6f} ms, plain {plain:.4f} "
        f"ms, bound {b_ms:.5f} ms ({b_by}, {b_ms / ms_b:.1%} of it "
        f"reached)")
    row = dict(name="hamming_matrix_batched", route="cuda",
               source="slam_dynamic_tpu_torch/csrc/kernels.cu",
               replaces="slam_dynamic_tpu/ops/pallas_hamming.py:42",
               launches=launches["hamming_matrix_batched"],
               max_abs_err=k2_err, ms=ms_b, plain_ms=plain, bound_ms=b_ms,
               bound_by=b_by, library_ms=None)
    return launches, row, k1_err, k2_err


def phase_depth_stride(gm, hm, frame_ate_mm):
    """Phase 14d: System.track_rgbd at depth_stride 2 on phase 3's world."""
    import dataclasses
    import numpy as np
    from slam_dynamic_tpu_torch.io.bench_world import bench_world
    from slam_dynamic_tpu_torch.io.evo import ate_rmse
    from slam_dynamic_tpu_torch.system import System

    world = bench_world(STRIDE_FRAMES, SEED)
    seq, cfg = world[0], world[3]
    system = System(cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, depth_stride=2)))
    _zero_batched(gm, hm)
    times, states, n_kf = track_frames(system, world, STRIDE_FRAMES)
    launches = _batched_launches(gm, hm)
    est = np.stack([-R.T @ t for _, R, t in system.trajectory])
    ate_mm = ate_rmse(est, seq.t_wc[:len(est)]) * 1e3
    n_lost = sum(s != "OK" for s in states)
    log(f"phase 14d System.track_rgbd depth_stride 2, 640x480 x "
        f"{STRIDE_FRAMES} frames: p50 {np.median(times) * 1e3:.2f} ms, "
        f"keyframes {n_kf}, not-OK frames {n_lost}, ATE {ate_mm:.3f} mm "
        f"(phase 3, stride 1, {N_FRAMES} frames: {frame_ate_mm:.3f} mm), "
        f"fused dispatches {system.tracker.dispatches}, launches {launches}")
    if n_lost or ate_mm >= 30.0 or not np.isfinite(est).all() \
            or system.tracker.dispatches != STRIDE_FRAMES - 1 \
            or min(launches[k] for k in ("gated_match", "hamming_matrix")) \
            <= 0:
        raise AssertionError("depth-stride phase failed its checks")
    return launches

def _lane_frames(a, i, lanes, frames):
    """Step i's frames of ``lanes`` lanes, lane b shifted by 3 b frames
    (``bench --multi``'s layout)."""
    return [a[max(0, min(i - 3 * b, frames - 1))] for b in range(lanes)]


def _drive_lanes(world, mesh, k1_calls=None, k2_calls=None):
    """A pipelined MultiSystem of MESH_LANES lanes over ``mesh`` (None:
    unsharded) on MESH_FRAMES steps; the batched calls of steps 1 to
    RECORD_STEPS kept when lists are given. Returns the MultiSystem, each
    lane's (state, keyframe) decisions, each lane's ATE in mm, the
    batched K1 launches of each call, and the wall seconds."""
    import numpy as np
    import torch
    from slam_dynamic_tpu_torch.io.evo import ate_rmse
    from slam_dynamic_tpu_torch.ops import gated_match as gm
    from slam_dynamic_tpu_torch.parallel.multi_system import MultiSystem
    from slam_dynamic_tpu_torch import kernel_bench as kb

    seq, gray8, depth16, cfg = world
    n, F = MESH_LANES, MESH_FRAMES
    ts = np.asarray(seq.timestamps, np.float64)
    ms = MultiSystem(cfg, n, pipeline=True, mesh=mesh)
    rows, per_call = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(F):
        rec = k1_calls is not None and 1 <= i <= RECORD_STEPS
        before = gm.batched_launches
        with kb.recording_batched(k1_calls, k2_calls) if rec \
                else contextlib.nullcontext():
            rows.append(ms.track_rgbd_batch(
                *(_lane_frames(a, i, n, F) for a in (gray8, depth16, ts))))
        per_call.append(gm.batched_launches - before)
    rows.append(ms.flush())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decisions, ates = [], []
    for b, s in enumerate(ms.systems):
        decisions.append([(r[b].state, r[b].is_keyframe) for r in rows
                          if r is not None and r[b] is not None])
        est = np.stack([-R.T @ t for _, R, t in s.trajectory])
        gt = seq.t_wc[[max(0, min(i - 3 * b, F - 1)) for i in range(F)]]
        if not np.isfinite(est).all() or len(est) != F:
            raise AssertionError(f"lane {b}: trajectory {est.shape}")
        ates.append(ate_rmse(est, gt) * 1e3)
    return ms, decisions, ates, per_call, wall


def phase_mesh(gm, hm, kb, k1_err, k2_err):
    """Phase 15a: MultiSystem(mesh=), 4 lanes over a 2-entry "dp" mesh
    (both entries the one card), beside the unsharded MultiSystem on the
    same frames."""
    from slam_dynamic_tpu_torch.io.bench_world import bench_world
    from slam_dynamic_tpu_torch.parallel.mesh import make_mesh

    world = bench_world(MESH_FRAMES, SEED)
    _, dec_1, ate_1, per_1, wall_1 = _drive_lanes(world, None)
    mesh = make_mesh(2, "dp", devices=["cuda:0", "cuda:0"])
    k1_calls, k2_calls = [], []
    _zero_batched(gm, hm)
    ms, dec_m, ate_m, per_m, wall_m = _drive_lanes(world, mesh, k1_calls,
                                                   k2_calls)
    launches = _batched_launches(gm, hm)
    n_lost = sum(st == "LOST" for d in dec_m for st, _ in d)
    steady = sorted(set(per_m[RECORD_STEPS + 1:]))
    log(f"phase 15a MultiSystem(mesh=): {MESH_LANES} lanes of the 640x480 "
        f"bench world over {mesh} (lanes {[list(g.lanes) for g in ms.groups]}"
        f"), {MESH_FRAMES} steps, one in flight: LOST frames {n_lost}, "
        f"keyframes per lane {[sum(k for _, k in d) for d in dec_m]} "
        f"(unsharded {[sum(k for _, k in d) for d in dec_1]}), ATE per lane "
        f"mm {[round(a, 3) for a in ate_m]} (unsharded "
        f"{[round(a, 3) for a in ate_1]}); batched K1 launches per call "
        f"{steady} after step {RECORD_STEPS} (unsharded "
        f"{sorted(set(per_1[RECORD_STEPS + 1:]))}); group steps and packet "
        f"readbacks {(ms.dispatches, ms.packet_reads)}; wall s {wall_m:.1f} "
        f"(unsharded {wall_1:.1f}); launches {launches}")
    if dec_m != dec_1 or n_lost or any(
            abs(a - b) > max(1.0, 0.2 * b) for a, b in zip(ate_m, ate_1)) \
            or ms.dispatches != ms.packet_reads \
            or launches["gated_match_batched"] <= 0:
        raise AssertionError("mesh phase failed its checks")
    if not k1_calls:
        raise AssertionError("no batched K1 call kept")
    k1_err, k2_err = hold_batched(gm, hm, kb, k1_calls, k2_calls,
                                  "phase 15a's steps", k1_err, k2_err)
    log(f"  batched K1 on the {len(k1_calls)} and K2 on the "
        f"{len(k2_calls)} calls of steps 1-{RECORD_STEPS}: bit-equal with "
        f"single launches and plain")
    return launches, k1_err, k2_err


def phase_sharded_solvers():
    """Phase 15b: the sharded pose graph and BA across processes on the
    one card (2 ranks through gloo on CUDA tensors, 1 rank through NCCL),
    each solution held to the single-process solve."""
    import shutil
    import tempfile
    import numpy as np
    import torch

    ps = _tests_module("port_shards")
    d = tempfile.mkdtemp(prefix="chip_smoke_shards_")
    try:
        src = os.path.join(d, "problems.npz")
        np.savez(src, **ps.problem_arrays(
            ps.drifting_ring(SHARD_POSES, 2),
            ps.ba_problem(SEED, SHARD_KF, SHARD_LM, 2, SHARD_OBS)))
        dev = torch.device("cuda", 0)
        with np.load(src) as z:
            pg, ba = ps.load_problems(z, dev)
        ref = ps.solve(1, pg, ba, dev, torch.cuda.synchronize)
        log(f"phase 15b single process: pose graph K = {SHARD_POSES} "
            f"{ref['pg_ms_per_iter']:.2f} ms per GN iteration, BA "
            f"{SHARD_KF} keyframes x {SHARD_LM} landmarks "
            f"{ref['ba_ms_per_iter']:.2f} ms per GN iteration")
        # the two ranks of the gloo run; rank 0 then runs the NCCL one
        runs = ((2, "gloo"), (1, "nccl"))
        prefix = os.path.join(d, "run")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, _tests_path("port_shards"), str(r), "cuda:0",
             src, prefix] + [f"{b}:{w}" for w, b in runs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=300)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0])
        wall = time.perf_counter() - t0
        for world, backend in runs:
            for r, (p, out) in enumerate(zip(procs[:world], outs)):
                if p.returncode != 0 or \
                        f"OK rank {r} of {world} ({backend}" not in out:
                    raise AssertionError(f"{backend} rank {r} failed:\n"
                                         + out[-4000:])
            z = np.load(f"{prefix}.{backend}.npz")
            d_R = float(np.abs(z["pg_R"] - ref["pg_R"].cpu().numpy()).max())
            d_t = float(np.abs(z["ba_t"] - ref["ba_t"].cpu().numpy()).max())
            d_p = float(np.abs(z["ba_pts"]
                               - ref["ba_pts"].cpu().numpy()).max())
            log(f"  {world} rank(s) through {backend} on CUDA tensors: pose "
                f"graph {float(z['pg_ms_per_iter']):.2f} ms per GN "
                f"iteration, {float(z['pg_allreduces_per_iter']):g} "
                f"all-reduces per iteration of "
                f"{z['pg_allreduce_bytes'].tolist()} bytes, max |dR| "
                f"{d_R:.2e}; BA {float(z['ba_ms_per_iter']):.2f} ms per GN "
                f"iteration, {float(z['ba_allreduces_per_iter']):g} "
                f"all-reduces per iteration of "
                f"{z['ba_allreduce_bytes'].tolist()} bytes (gathers of "
                f"{z['ba_gather_bytes'].tolist()} bytes after them), max "
                f"|dt| {d_t:.2e} (points {d_p:.2e}); a rank's own blocks "
                f"alone against the whole problem's slices: max |dt| "
                f"{float(z['local_dt']):.2e} (points "
                f"{float(z['local_dp']):.2e})")
            if d_R >= 1e-3 or d_t >= 5e-3 or float(z["local_dt"]) >= 5e-3 \
                    or float(z["pg_allreduces_per_iter"]) != 2 \
                    or float(z["ba_allreduces_per_iter"]) != 2:
                raise AssertionError(f"sharded solvers over {backend} "
                                     "failed their checks")
        log(f"  both runs' processes: wall {wall:.1f} s")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _track_in_flight(world, cfg, adaptive=False, prefetch=False,
                     rec=None):
    """System.track_rgbd on ADAPTIVE_FRAMES frames with one frame in
    flight; K1 and K2 recorded over the first RECORD_FRAMES frames when
    ``rec`` is given; fps over the frames after them. Returns the stats,
    the readiness answers of the adaptive depth, fps and ATE in mm."""
    import dataclasses
    import numpy as np
    import torch
    from slam_dynamic_tpu_torch import kernel_bench as kb
    from slam_dynamic_tpu_torch.io.evo import ate_rmse
    from slam_dynamic_tpu_torch.ops import gated_match as gm
    from slam_dynamic_tpu_torch.ops import hamming as hm
    from slam_dynamic_tpu_torch.system import System

    seq, gray8, depth16, _ = world
    system = System(cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, pipeline_depth=1, adaptive_pipeline=adaptive)))
    answers = []
    ready = system.tracker._packet_ready

    def counted(out):
        answers.append(ready(out))
        return answers[-1]
    system.tracker._packet_ready = counted
    n = ADAPTIVE_FRAMES
    frames = [(gray8[i], depth16[i]) for i in range(n)] + [None]
    stats = []
    for i in range(n):
        if i == RECORD_FRAMES:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        ctx = contextlib.nullcontext()
        if rec is not None and i < RECORD_FRAMES:
            l1, l2 = gm.launches, hm.launches
            ctx = contextlib.ExitStack()
            ctx.enter_context(kb.recording_k1(rec["k1"]))
            ctx.enter_context(kb.recording_k2(rec["k2"], every=True))
        with ctx:
            stats.append(system.track_rgbd(
                *frames[i], float(seq.timestamps[i]),
                prefetch_next=frames[i + 1] if prefetch else None))
        if rec is not None and i < RECORD_FRAMES:
            rec["launched"][0] += gm.launches - l1
            rec["launched"][1] += hm.launches - l2
    stats += system.tracker.drain()
    torch.cuda.synchronize()
    fps = (n - RECORD_FRAMES) / (time.perf_counter() - t0)
    est = np.stack([-R.T @ t for _, R, t in system.trajectory])
    if len(est) != n or not np.isfinite(est).all():
        raise AssertionError(f"trajectory {est.shape}")
    return stats, answers, fps, ate_rmse(est, seq.t_wc[:n]) * 1e3


def phase_adaptive_prefetch(gm, hm, k1_err, k2_err):
    """Phase 15c: the adaptive pipeline depth, then prefetch_next=, each
    beside the direct path (one frame in flight) in this call."""
    from slam_dynamic_tpu_torch.io.bench_world import bench_world

    world = bench_world(ADAPTIVE_FRAMES, SEED)
    cfg = world[3]
    _, _, direct_fps, direct_mm = _track_in_flight(world, cfg)
    out = {}
    for name, kw in (("adaptive", dict(adaptive=True)),
                     ("prefetch", dict(prefetch=True))):
        rec = dict(k1=[], k2=[], launched=[0, 0])
        _zero_batched(gm, hm)
        stats, answers, fps, ate_mm = _track_in_flight(world, cfg, rec=rec,
                                                       **kw)
        out[name] = _batched_launches(gm, hm)
        n_lost = sum(st.state == "LOST" for st in stats)
        log(f"phase 15c {name}: System.track_rgbd 640x480 x "
            f"{ADAPTIVE_FRAMES} frames, one in flight"
            + (", adaptive_pipeline" if kw.get("adaptive") else
               ", prefetch_next=") + f": LOST frames {n_lost}, ATE "
            f"{ate_mm:.3f} mm, {fps:.2f} fps over frames "
            f"{RECORD_FRAMES}-{ADAPTIVE_FRAMES - 1} (the direct path in this "
            f"call: {direct_fps:.2f} fps, {direct_mm:.3f} mm); readiness "
            f"polls {len(answers)}, frames run deeper {answers.count(False)};"
            f" launches {out[name]}")
        if n_lost or ate_mm >= 30.0 or min(
                out[name][k] for k in ("gated_match", "hamming_matrix")) <= 0 \
                or (kw.get("adaptive") and not answers):
            raise AssertionError(f"{name} phase failed its checks")
        n1, n2 = len(rec["k1"]), len(rec["k2"])
        if [n1, n2] != rec["launched"] or not n1:
            raise AssertionError(f"{name}: {n1} K1 and {n2} K2 calls kept, "
                                 f"{rec['launched']} launched")
        k1_err = hold_k1(gm, rec["k1"], f"phase 15c {name}", k1_err)
        k2_err = hold_k2(hm, rec["k2"], f"phase 15c {name}", k2_err)
        log(f"  K1 on the {n1} calls and K2 on the {n2} calls of the first "
            f"{RECORD_FRAMES} frames: bit-equal with plain")
    return out, k1_err, k2_err


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
    k3_row, k3b_row = timed("2b", phase_k3, dev, kb)
    frame_launches, calls, frame_ate_mm = timed("3", phase_system, gm, hm,
                                                kb)
    k1_row = timed("4", phase_k1_path, gm, kb, calls, k1_err)
    chunk_launches = timed("5", phase_chunk, gm, hm, kb)
    dyn_launches, k2_row = timed("6", phase_dynamic_chunk, gm, hm, kb,
                                 k2_err)
    dyn_frame_launches = timed("7", phase_dynamic_frame, gm, hm)
    loop_launches, k2_row["max_abs_err"], closure = timed(
        "8", phase_loop_closure, gm, hm, kb, k2_row["max_abs_err"])
    loop_gba_launches, k2_row["max_abs_err"] = timed(
        "8c", phase_loop_closure_gba, gm, hm, kb, k2_row["max_abs_err"],
        closure)
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
    online_launches, *errs = timed("12", phase_online, gm, hm, kb, *errs)
    cli_launches, *errs = timed("13", phase_cli, gm, hm, kb, *errs)
    multi_launches, k1b_row, *errs = timed("14a", phase_multi, gm, hm, kb,
                                           *errs)
    multi_chunk_launches = timed("14b", phase_multi_chunk, gm, hm)
    multi_stereo_launches, k2b_row, *errs = timed(
        "14c", phase_multi_stereo, gm, hm, kb, *errs)
    stride_launches = timed("14d", phase_depth_stride, gm, hm, frame_ate_mm)
    mesh_launches, *errs = timed("15a", phase_mesh, gm, hm, kb, *errs)
    timed("15b", phase_sharded_solvers)
    paths15, *errs = timed("15c", phase_adaptive_prefetch, gm, hm, *errs)
    k1_row["max_abs_err"], k2_row["max_abs_err"] = errs
    log("wall time per phase, s (host clock, world rendering included): "
        + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
        + f"; since the build began {time.perf_counter() - t0:.1f}")
    lane_phases = {"multi": multi_launches,
                   "multi_chunk": multi_chunk_launches,
                   "multi_stereo": multi_stereo_launches,
                   "depth_stride": stride_launches, "mesh": mesh_launches,
                   **paths15}
    k3b_row["launches"] = multi_launches["pose_lm_batched"]
    for r in (k1b_row, k2b_row, k3b_row):
        r["launches_per_phase"] = {k: v[r["name"]]
                                   for k, v in lane_phases.items()}
    rows = [k1_row, k2_row, k3_row]
    for r in rows:
        r["launches"] = chunk_launches[r["name"]]
        r["launches_per_phase"] = {
            "track_rgbd": frame_launches[r["name"]],
            "track_chunk": chunk_launches[r["name"]],
            "track_chunk_dynamic": dyn_launches[r["name"]],
            "track_rgbd_dynamic": dyn_frame_launches[r["name"]],
            "loop_closure": loop_launches[r["name"]],
            "loop_closure_gba": loop_gba_launches[r["name"]],
            "loop_closure_chunked": loop_chunk_launches[r["name"]],
            "relocalization": reloc_launches[r["name"]],
            "track_chunk_stereo": stereo_launches[r["name"]],
            "track_stereo_dynamic": stereo_dyn_launches[r["name"]],
            "track_mono": mono_launches[r["name"]],
            "track_chunk_online": online_launches[r["name"]],
            **{k: v[r["name"]] for k, v in cli_launches.items()},
            **{k: v[r["name"]] for k, v in lane_phases.items()}}
    rows += [k1b_row, k2b_row, k3b_row]
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
