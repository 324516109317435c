"""Throughput of the port on the bench world, as ``bench.py`` runs the
JAX package with no arguments.

    python -m slam_dynamic_tpu_torch.bench [--frames 120] [--chunk 6]
        [--stereo] [--dynamic [--classify-every 2]] [--cpu]

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
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .backend.loop_closing import _detect_device
from .io.bench_world import bench_world, detections
from .io.evo import ate_rmse
from .models import vocabulary as voc_mod
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


def run(frames: int = 120, chunk: int = 6, device=None, seed: int = 0,
        warm_chunk=contextlib.nullcontext, warm_index: int = 0,
        dynamic: bool = False, classify_every: int = 2,
        on_step=None, stereo: bool = False) -> dict:
    """Track the bench world and time it. ``warm_chunk`` is a context manager
    factory entered around warm chunk (or warm frame) number
    ``warm_index``; ``on_step(system, stats)`` is called after every step
    with the stats it finalized, outside the timed span. Returns the
    System, the stats of every frame, the timed steps' host times, fps and
    ATE."""
    seq, gray8, aux, cfg = bench_world(
        frames, seed, dynamic=dynamic, sensor="stereo" if stereo else "rgbd")
    cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, pipeline_depth=PIPELINE_DEPTH))
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
        n_warm_steps = min(10, frames - 1)
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
    while i + C <= frames:
        f0 = time.perf_counter()
        i, new = step(i)
        step_s.append(time.perf_counter() - f0)
        if on_step:
            on_step(system, new)
    stats.extend(system.tracker.flush())
    _sync(system)
    wall = time.perf_counter() - t0
    n_timed = len(step_s) * C
    traj = system.trajectory
    est = np.stack([-R.T @ t for _, R, t in traj])
    if not np.isfinite(est).all():
        raise RuntimeError("non-finite trajectory")
    return dict(system=system, stats=stats, n_timed=n_timed,
                step_ms=np.asarray(step_s) * 1e3, fps=n_timed / wall,
                n_traj=len(traj),
                ate_m=float(ate_rmse(est, seq.t_wc[:len(est)])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--chunk", type=int, default=6,
                    help="frames per fused call; 1 runs the per-frame path")
    ap.add_argument("--stereo", action="store_true",
                    help="the stereo pair (two extractions and the "
                         "row-band matcher) instead of RGB-D")
    ap.add_argument("--dynamic", action="store_true",
                    help="the dynamic scene: moving object, its boxes, "
                         "fused H/F box classification")
    ap.add_argument("--classify-every", type=int, default=2,
                    help="--dynamic, per frame: classify every Nth frame")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.chunk < 1:
        ap.error("--chunk must be >= 1")
    r = run(args.frames, args.chunk, device="cpu" if args.cpu else None,
            dynamic=args.dynamic, classify_every=args.classify_every,
            stereo=args.stereo)
    ms = np.sort(r["step_ms"])
    what = "frame" if args.chunk == 1 else f"chunk (={args.chunk} frames)"
    print(f"[bench] {what} ms: p50 {np.median(ms):.1f} p90 "
          f"{ms[int(len(ms) * 0.9)]:.1f} max {ms[-1]:.1f}", file=sys.stderr)
    dev = ("CPU" if args.cpu else torch.cuda.get_device_name(0))
    mode = ("per-frame" if args.chunk == 1
            else f"chunk={args.chunk} frames/call")
    kind = ("stereo" if args.stereo else "RGB-D") + \
        (" dynamic-scene" if args.dynamic else "")
    out = {"metric": f"tracked frames/s ({mode}, 640x480 {kind}, full "
                     f"SLAM, PyTorch port on {dev})",
           "value": round(r["fps"], 2), "unit": "fps",
           "vs_baseline": round(r["fps"] / CAMERA_FPS, 3),
           "ate_m": round(r["ate_m"], 5)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
