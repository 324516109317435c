"""Throughput of the port on the bench world, as ``bench.py`` runs the
JAX package with no arguments.

    python -m slam_dynamic_tpu_torch.bench [--frames 120] [--chunk 6]
        [--stereo] [--dynamic [--classify-every 2]] [--multi N]
        [--depth-stride S] [--no-pipeline | --pipeline-depth D]
        [--eager-finalize] [--ate] [--budget S] [--cpu]

The synthetic 640x480 RGB-D world with 1000 ORB features and the
capacities of ``bench.py:250-261``, with its default pipelined readback
(one frame or chunk in flight). ``--chunk C`` (default 6) runs temporal
chunking as ``bench.py``'s ``_run_chunk`` (:412-510) does: per-frame
bootstrap until tracking is OK, up to 3 warm chunks with a keyframe at
least every 3 frames, the configured cadence back, the timed window,
``flush``, ATE. ``--chunk 1`` runs the per-frame path (10 warm frames,
then the timed window). ``--dynamic`` runs ``bench.py --dynamic``'s
dynamic scene (:114-123): the moving object, its boxes fed every frame
in view, the fused H/F classification on every 2nd chunk frame
(``classify_every_chunked``) or, per frame, every
``--classify-every``-th frame (default 2, as ``bench.py``). ``--stereo``
runs ``bench.py --stereo``'s stereo pair (:111-113, :236-261) through
``track_stereo`` and ``track_chunk`` with the right images. Prints one
JSON line with ``bench.py``'s keys: metric, value (tracked frames per
second), unit, vs_baseline (fps / 30, the camera's rate) and ate_m. Runs
on the card; ``--cpu`` runs the plain PyTorch path on the CPU.

``--multi N`` runs batched serving as ``bench.py``'s ``_run_multi``
(:515-640): N lanes of one ``MultiSystem`` (one batched device step and
one packed readback per step, pipelined one step deep), lane b tracking
the world phase-shifted by 3 b frames, the detector off; a warm-up of 14
frames with a keyframe at least every 3 frames, then the configured
cadence. ``--chunk C`` > 1 there runs B lanes x C frames per call
(starting cold: until every lane is OK a chunk runs as per-frame
batches). Unlike ``bench.py``, the timed window starts after the last
warm frame, so no frame is tracked twice. The JSON line then holds the
aggregate fps, ``per_lane_fps`` and lane 0's ATE. ``--depth-stride S``
uploads every S-th depth pixel (RGB-D); ``--pipeline-depth D`` (default
1) sets the frames or chunks in flight and ``--no-pipeline`` none;
``--eager-finalize`` finalizes a chunk before the next is dispatched;
``--ate`` reports the ATE as the metric (``bench.py --ate``).
``--budget S`` (default 420, or ``BENCH_BUDGET_S``; ``bench.py``'s
watchdog, :41 and :144-150): when S seconds pass before the run ends, a
watchdog thread prints the partial result line (the fps of the timed
frames so far, or an error line when fewer than 5 were timed) and exits
with 0.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from .backend.loop_closing import _detect_device
from .io.bench_world import bench_world, detections
from .io.evo import ate_rmse
from .models import vocabulary as voc_mod
from .parallel.multi_system import MultiSystem
from .system import System

# bench.py's default --pipeline --pipeline-depth 1
PIPELINE_DEPTH = 1
CAMERA_FPS = 30.0


def _sync(system):
    if system.device.type == "cuda":
        torch.cuda.synchronize(system.device)


def _warm_loop_detect(system):
    """One loop-detection scoring on keyframe 0, so its first real call
    (from the 10th keyframe on) is not the first of its ops on the device
    (``bench.py``'s ``_warm_loop_detect``)."""
    if system.loop is None:
        return
    m = system.tracker.map
    bv = voc_mod.transform(system.voc, m.kf_kp_desc[0], m.kf_kp_valid[0])
    sb = voc_mod.sparse_bow(bv, top_w=system.loop.db.word.shape[1])
    _detect_device(system.loop.db, sb, m.covis, m.kf_valid, 0).cpu()


def track_entry(system):
    """The per-frame entry of a System of either package for its sensor,
    as f(gray, aux, timestamp, detections=None): aux is the depth map,
    the right image, or ignored (mono)."""
    sensor = system.cfg.sensor
    if sensor == "stereo":
        return system.track_stereo
    if sensor == "mono":
        return lambda gray, _, ts, detections=None: system.track_mono(gray,
                                                                      ts)
    return system.track_rgbd


def drive_per_frame(system, world, n_frames: int, dynamic: bool = False,
                    sync=None, frame_ctx=None) -> dict:
    """A System of either package frame by frame through its sensor's
    entry over a bench world (``io/bench_world.py``), the boxes fed when
    ``dynamic``: per-frame host times (each ending in ``sync()`` when
    given), states, the first OK frame, the first frame after which a
    box is confirmed dynamic (None if none is) and the trajectory's
    camera centres. ``frame_ctx(i)``, when given, is a context manager
    entered around frame i's track call."""
    seq, gray8, aux, _ = world
    track = track_entry(system)
    times, states, first2 = [], [], None
    for i in range(n_frames):
        t0 = time.perf_counter()
        with frame_ctx(i) if frame_ctx is not None \
                else contextlib.nullcontext():
            st = track(gray8[i], None if aux is None else aux[i],
                       float(seq.timestamps[i]),
                       detections=detections(seq, i) if dynamic else None)
            if sync is not None:
                sync()
        times.append(time.perf_counter() - t0)
        states.append(st.state)
        if first2 is None and (np.asarray(system.boxes.status) == 2).any():
            first2 = i
    est = np.stack([-R.T @ t for _, R, t in system.trajectory])
    return dict(times=times, states=states, first_dynamic=first2, est=est,
                first_ok=states.index("OK") if "OK" in states else None)


class Progress:
    """The timed window of a run so far, read by the budget watchdog."""

    def __init__(self):
        self.lock = threading.Lock()
        self.t_timed0 = None      # perf_counter at the timed window's start
        self.frames = 0           # timed frames tracked (all lanes)
        self.done = False

    def start(self, t0: float):
        with self.lock:
            self.t_timed0 = t0

    def add(self, frames: int):
        with self.lock:
            self.frames += frames


def partial_line(args, progress: Progress) -> Optional[dict]:
    """The result line of a run cut by its budget (None when it ended):
    the fps of the timed frames so far, or an error line when fewer than
    5 were timed."""
    with progress.lock:
        if progress.done:
            return None
        n, t0 = progress.frames, progress.t_timed0
    if t0 is None or n < 5:
        return {"metric": "tracked frames/s (640x480, full SLAM)",
                "value": 0.0, "unit": "fps", "vs_baseline": 0.0,
                "error": f"budget of {args.budget} s: fewer than 5 timed "
                         f"frames ({n}) completed"}
    fps = n / (time.perf_counter() - t0)
    lanes = max(args.multi, 1)
    out = result_line(argparse.Namespace(**{**vars(args), "ate": False}),
                      dict(fps=fps, ate_m=float("nan"),
                           per_lane_fps=fps / lanes))
    out.pop("ate_m")
    out["metric"] += f" (partial: budget of {args.budget} s hit)"
    out["partial_frames"] = n
    return out


def _watchdog(args, progress: Progress, exit=os._exit):
    """At the budget: print the partial line and end the process."""
    line = partial_line(args, progress)
    if line is None:
        return
    print(f"[bench] budget of {args.budget} s hit: partial result",
          file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    exit(0)


def _with_tracking(cfg, **kw):
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking, **kw))


def run(frames: int = 120, chunk: int = 6, device=None, seed: int = 0,
        warm_chunk=contextlib.nullcontext, warm_index: int = 0,
        dynamic: bool = False, classify_every: int = 2,
        on_step=None, stereo: bool = False,
        pipeline_depth: int = PIPELINE_DEPTH, depth_stride: int = 1,
        eager_finalize: bool = False, warm_frames: int = 10,
        progress: Optional[Progress] = None) -> dict:
    """Track the bench world and time it. ``warm_chunk`` is a context manager
    factory entered around warm chunk (or warm frame) number
    ``warm_index``; ``on_step(system, stats)`` is called after every step
    with the stats it finalized, outside the timed span; the per-frame
    path warms ``warm_frames`` frames. Returns the System, the stats of
    every frame, the timed steps' host times, fps, ATE and ``step(i)``,
    which tracks one more step from frame i. ``progress`` gets the timed
    window as it goes (for the budget watchdog)."""
    progress = progress or Progress()
    seq, gray8, aux, cfg = bench_world(
        frames, seed, dynamic=dynamic, sensor="stereo" if stereo else "rgbd")
    cfg = _with_tracking(cfg, pipeline_depth=pipeline_depth,
                         depth_stride=depth_stride,
                         chunk_eager_finalize=eager_finalize)
    if dynamic:
        cfg = cfg.replace(dynamic=dataclasses.replace(
            cfg.dynamic, classify_every=classify_every))
    warm_cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, max_frames_between_kf=3))
    system = System(warm_cfg, device=device)
    track = track_entry(system)
    ts = [float(t) for t in seq.timestamps]
    C = chunk
    stats = []

    def det(i):
        return detections(seq, i) if dynamic else None

    def step(i):
        if C == 1:
            new = [track(gray8[i], aux[i], ts[i], det(i))]
        else:
            new = system.track_chunk(
                gray8[i:i + C], aux[i:i + C], ts[i:i + C],
                [det(i + j) for j in range(C)] if dynamic else None)
        stats.extend(new)
        return i + C, new

    i = 0
    if C == 1:
        n_warm_steps = min(warm_frames, frames - 1)
    else:
        while system.tracker.state != "OK" and i < 6:
            stats.append(track(gray8[i], aux[i], ts[i], det(i)))
            i += 1
        n_warm_steps = max(0, min(3, (frames - i) // C - 1))
    for w in range(n_warm_steps):
        with warm_chunk() if w == warm_index else contextlib.nullcontext():
            i, new = step(i)
        if on_step:
            on_step(system, new)
    system.cfg = cfg
    system.tracker.cfg = cfg
    _warm_loop_detect(system)
    _sync(system)
    step_s = []
    t0 = time.perf_counter()
    progress.start(t0)
    while i + C <= frames:
        f0 = time.perf_counter()
        i, new = step(i)
        step_s.append(time.perf_counter() - f0)
        progress.add(C)
        if on_step:
            on_step(system, new)
    stats.extend(system.tracker.drain())
    _sync(system)
    wall = time.perf_counter() - t0
    n_timed = len(step_s) * C
    traj = system.trajectory
    est = np.stack([-R.T @ t for _, R, t in traj])
    if not np.isfinite(est).all():
        raise RuntimeError("non-finite trajectory")
    return dict(system=system, stats=stats, n_timed=n_timed,
                step_ms=np.asarray(step_s) * 1e3, fps=n_timed / wall,
                n_traj=len(traj), step=lambda i: step(i)[1],
                ate_m=float(ate_rmse(est, seq.t_wc[:len(est)])))


def run_multi(n: int, frames: int = 60, chunk: int = 1, device=None,
              seed: int = 0, stereo: bool = False, depth_stride: int = 1,
              on_step=None, step_ctx=None,
              progress: Optional[Progress] = None) -> dict:
    """Batched serving (``bench.py``'s ``_run_multi``): ``n`` lanes of one
    pipelined MultiSystem on the bench world, lane b phase-shifted by
    3 b frames, ``chunk`` frames per lane and call. ``on_step(ms, i,
    timed)`` is called after the step that began at frame i, outside the
    timed span; ``step_ctx(k)``, when given, is a context manager entered
    around the k-th step. Returns the MultiSystem, the stats of every
    step, the timed steps' host times, aggregate and per-lane fps, lane
    0's ATE and ``step(i)``, which runs one more step from frame i;
    ``progress`` as ``run``'s."""
    progress = progress or Progress()
    seq, gray8, aux, cfg = bench_world(
        frames, seed, sensor="stereo" if stereo else "rgbd")
    cfg = _with_tracking(cfg, depth_stride=depth_stride)
    ms = MultiSystem(_with_tracking(cfg, max_frames_between_kf=3), n,
                     pipeline=True, device=device)
    C = chunk
    stereo_lanes = cfg.sensor == "stereo"
    track_batch = ms.track_stereo_batch if stereo_lanes \
        else ms.track_rgbd_batch
    chunk_batch = ms.track_stereo_chunk_batch if stereo_lanes \
        else ms.track_rgbd_chunk_batch

    def idx(i, b):
        return max(0, min(i - 3 * b, frames - 1))

    def lanes(a, i):
        if C > 1:
            return [[a[idx(i + j, b)] for j in range(C)] for b in range(n)]
        return [a[idx(i, b)] for b in range(n)]

    ts = np.asarray(seq.timestamps, np.float64)
    stats = []

    def step(i):
        call = chunk_batch if C > 1 else track_batch
        with step_ctx(len(stats)) if step_ctx is not None \
                else contextlib.nullcontext():
            stats.append(call(lanes(gray8, i), lanes(aux, i),
                              lanes(ts, i)))
        return i + C

    i, n_warm = 0, min(14, frames - 1)
    while i < n_warm:
        i = step(i)
        if on_step:
            on_step(ms, i - C, False)
    # the configured keyframe cadence back (read on the host each frame)
    ms.cfg = cfg = ms.cfg.replace(tracking=dataclasses.replace(
        ms.cfg.tracking,
        max_frames_between_kf=cfg.tracking.max_frames_between_kf))
    for s in ms.systems:
        s.cfg = s.tracker.cfg = cfg
    _sync(ms.systems[0])
    step_s = []
    t0 = time.perf_counter()
    progress.start(t0)
    while i + C <= frames:
        f0 = time.perf_counter()
        i = step(i)
        step_s.append(time.perf_counter() - f0)
        progress.add(C * n)
        if on_step:
            on_step(ms, i - C, True)
    stats.append(ms.flush())
    _sync(ms.systems[0])
    wall = time.perf_counter() - t0
    n_timed = len(step_s) * C
    traj = ms.systems[0].trajectory
    est = np.stack([-R.T @ t for _, R, t in traj])
    if not np.isfinite(est).all():
        raise RuntimeError("non-finite trajectory")
    fps = n_timed * n / wall
    return dict(ms=ms, stats=stats, n_timed=n_timed, n_traj=len(traj),
                step_ms=np.asarray(step_s) * 1e3, fps=fps,
                per_lane_fps=fps / n, step=step,
                ate_m=float(ate_rmse(est, seq.t_wc[:len(est)])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--chunk", type=int, default=None,
                    help="frames per fused call (default 6, with --multi "
                         "1); 1 runs the per-frame path")
    ap.add_argument("--stereo", action="store_true",
                    help="the stereo pair (two extractions and the "
                         "row-band matcher) instead of RGB-D")
    ap.add_argument("--dynamic", action="store_true",
                    help="the dynamic scene: moving object, its boxes, "
                         "fused H/F box classification")
    ap.add_argument("--classify-every", type=int, default=2,
                    help="--dynamic, per frame: classify every Nth frame")
    ap.add_argument("--multi", type=int, default=0,
                    help="batched serving: N lanes in one MultiSystem")
    ap.add_argument("--depth-stride", type=int, default=1,
                    help="upload every Nth depth pixel (RGB-D)")
    ap.add_argument("--pipeline", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="pipelined readback (frames or chunks in flight)")
    ap.add_argument("--pipeline-depth", type=int, default=PIPELINE_DEPTH,
                    help="frames or chunks in flight with --pipeline")
    ap.add_argument("--eager-finalize", action="store_true",
                    help="chunked: finalize a chunk before dispatching the "
                         "next")
    ap.add_argument("--ate", action="store_true",
                    help="report the ATE as the metric")
    ap.add_argument("--budget", type=float,
                    default=float(os.environ.get("BENCH_BUDGET_S", "420")),
                    help="seconds after which a watchdog prints the "
                         "partial result line and exits")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.chunk is None:
        args.chunk = 1 if args.multi > 1 else 6
    if args.multi > 1 and args.dynamic:
        ap.error("--multi batches the static scene (no --dynamic)")
    if args.chunk < 1 or args.depth_stride < 1 or args.pipeline_depth < 0:
        ap.error("--chunk and --depth-stride must be >= 1, "
                 "--pipeline-depth >= 0")
    device = "cpu" if args.cpu else None
    progress = Progress()
    watchdog = threading.Timer(args.budget, _watchdog, (args, progress))
    watchdog.daemon = True
    watchdog.start()
    try:
        if args.multi > 1:
            r = run_multi(args.multi, args.frames, args.chunk,
                          device=device, stereo=args.stereo,
                          depth_stride=args.depth_stride, progress=progress)
        else:
            r = run(args.frames, args.chunk, device=device,
                    dynamic=args.dynamic,
                    classify_every=args.classify_every, stereo=args.stereo,
                    pipeline_depth=(args.pipeline_depth if args.pipeline
                                    else 0),
                    depth_stride=args.depth_stride,
                    eager_finalize=args.eager_finalize, progress=progress)
    finally:
        with progress.lock:
            progress.done = True
        watchdog.cancel()
    ms = np.sort(r["step_ms"])
    what = "frame" if args.chunk == 1 else f"chunk (={args.chunk} frames)"
    if args.multi > 1:
        what = f"step (={args.multi * args.chunk} frames)"
    print(f"[bench] {what} ms: p50 {np.median(ms):.1f} p90 "
          f"{ms[int(len(ms) * 0.9)]:.1f} max {ms[-1]:.1f}", file=sys.stderr)
    print(json.dumps(result_line(args, r)))
    return 0


def result_line(args, r: dict) -> dict:
    """The JSON line of a run: ``bench.py``'s keys (and, with --multi,
    ``per_lane_fps``)."""
    if args.ate:
        return {"metric": "ATE RMSE (synthetic bench world, "
                          "evo_ape-equivalent -as)",
                "value": round(r["ate_m"], 5), "unit": "m",
                "vs_baseline": round(0.02 / max(r["ate_m"], 1e-9), 3)}
    dev = ("CPU" if args.cpu else torch.cuda.get_device_name(0))
    mode = ("per-frame" if args.chunk == 1
            else f"chunk={args.chunk} frames/call")
    kind = ("stereo" if args.stereo else "RGB-D") + \
        (" dynamic-scene" if args.dynamic and not args.multi else "")
    if args.multi > 1:
        what = (f"aggregate tracked frames/s ({args.multi} lanes, {mode}, "
                f"640x480 {kind}, batched MultiSystem, PyTorch port on "
                f"{dev})")
    else:
        what = (f"tracked frames/s ({mode}, 640x480 {kind}, full SLAM, "
                f"PyTorch port on {dev})")
    out = {"metric": what, "value": round(r["fps"], 2), "unit": "fps",
           "vs_baseline": round(r["fps"] / CAMERA_FPS, 3),
           "ate_m": round(r["ate_m"], 5)}
    if args.multi > 1:
        out["per_lane_fps"] = round(r["per_lane_fps"], 2)
    return out


if __name__ == "__main__":
    sys.exit(main())
