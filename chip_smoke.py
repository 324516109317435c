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
  7. the per-frame dynamic path: 30 frames of that world through
     System.track_rgbd(detections=) classifying every 2nd frame, so both
     forms of the dynamic step run: LOST frames, the forms dispatched,
     the launches and the box status.

Kernel, plain and library times are device times (CUDA-graph replay
between CUDA events, slam_dynamic_tpu_torch/kernel_bench.py), each beside
the least time the card could take for the same work; K2's row takes
its times from phase 6's inputs. It then prints the kernel table as one
JSON line (``launches`` is phase 5's count, the main path's;
``launches_per_phase`` adds phases 3, 6 and 7) and, last, the result
line. Any failed check raises, and a hang ends in a traceback and a
nonzero exit after 1100 s.
"""
import faulthandler
import json
import os
import subprocess
import sys
import time

faulthandler.dump_traceback_later(1100, exit=True)

SEED = 0
N_FRAMES = 60
CHUNK = 6
CHUNK_FRAMES = 120
DYN_FRAMES = 30
OBJECT_LEAVES = 50      # the bench world's object is in view before this


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
    import torch
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
    times = []
    for a, b in k2_calls:
        got, ref = hm.hamming_matrix(a, b), hm.hamming_matrix_plain(a, b)
        torch.cuda.synchronize()
        k2_err = max(k2_err, int((got - ref).abs().max()))
        if not torch.equal(got, ref):
            raise AssertionError("K2 on the classification's inputs: kernel "
                                 "!= plain")
        times.append(k2_times(hm, kb, a, b))
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
    k2_err = phase_k2(dev, hm, kb)
    frame_launches, calls = phase_system(gm, hm, kb)
    k1_row = phase_k1_path(gm, kb, calls, k1_err)
    chunk_launches = phase_chunk(gm, hm, kb)
    dyn_launches, k2_row = phase_dynamic_chunk(gm, hm, kb, k2_err)
    dyn_frame_launches = phase_dynamic_frame(gm, hm)
    rows = [k1_row, k2_row]
    for r in rows:
        r["launches"] = chunk_launches[r["name"]]
        r["launches_per_phase"] = {
            "track_rgbd": frame_launches[r["name"]],
            "track_chunk": chunk_launches[r["name"]],
            "track_chunk_dynamic": dyn_launches[r["name"]],
            "track_rgbd_dynamic": dyn_frame_launches[r["name"]]}
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
