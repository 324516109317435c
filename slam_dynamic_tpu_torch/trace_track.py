"""Where the time of the tracker goes on the card, per frame and chunked.

    python -m slam_dynamic_tpu_torch.trace_track [--dynamic | --stereo]
        [--batched-levels]

Runs ``FRAMES`` frames of the bench world (io/bench_world.py) on the GPU
twice: ``System.track_rgbd`` frame by frame, then ``System.track_chunk``
in chunks of ``CHUNK`` with one chunk in flight, as
``slam_dynamic_tpu_torch.bench`` runs it. ``--dynamic`` instead runs the
chunked path once on the dynamic scene (``bench --dynamic``: the moving
object in view throughout, its boxes, the H/F classification on every
2nd chunk frame), with the ``classify`` and ``box3d`` spans;
``--stereo`` runs both paths on the stereo pair of ``bench --stereo``
(two extractions and the row-band matcher in ``frame_build``);
``--batched-levels`` extracts with ``ORBConfig(batched_levels=True)``
(``ops/orb_batched.py``) on whichever paths run. Each step
is timed on the host clock with a synchronize, then ``torch.profiler``
covers the last ``WINDOW`` frames (and, chunked, the flush of the chunk
in flight). Prints the steady step times, the device's busy share over
the window (summed kernel time / wall time), kernel launches and syncs
per frame, the named stages (``record_function`` spans in the port) and
the operators that take the most device and host time. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .bench import PIPELINE_DEPTH, track_entry
from .io.bench_world import bench_world, detections
from .system import System

FRAMES = 40
WINDOW = 12
CHUNK = 6
STAGES = ("frame_build", "classify", "mm_track", "local_map",
          "local_track", "box3d", "mapping_stage", "triangulate", "fuse",
          "local_ba")


def _steps(system, world, chunk: int, dynamic: bool):
    """(first frame, step) pairs covering the frames: one frame each, or
    frame 0 to initialize and then chunks; with their boxes when
    ``dynamic``."""
    seq, gray8, aux, _ = world
    ts = [float(t) for t in seq.timestamps]
    track = track_entry(system)

    def det(i):
        return detections(seq, i) if dynamic else None

    def frame(i):
        return lambda: [track(gray8[i], aux[i], ts[i], det(i))]

    def block(i):
        return lambda: system.track_chunk(
            gray8[i:i + chunk], aux[i:i + chunk], ts[i:i + chunk],
            [det(i + j) for j in range(chunk)] if dynamic else None)
    if chunk == 1:
        return [(i, frame(i)) for i in range(FRAMES)]
    return [(0, frame(0))] + [(i, block(i))
                              for i in range(1, FRAMES - chunk + 1, chunk)]


def trace(chunk: int, dynamic: bool = False, stereo: bool = False,
          batched_levels: bool = False):
    world = bench_world(FRAMES, dynamic=dynamic,
                        sensor="stereo" if stereo else "rgbd")
    cfg = world[3]
    if batched_levels:
        cfg = cfg.replace(orb=dataclasses.replace(cfg.orb,
                                                  batched_levels=True))
    if chunk > 1:
        cfg = cfg.replace(tracking=dataclasses.replace(
            cfg.tracking, pipeline_depth=PIPELINE_DEPTH))
    system = System(cfg)
    steps = _steps(system, world, chunk, dynamic)
    n_win = WINDOW // chunk
    times = []
    for _, step in steps[:-n_win]:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n_kf = 0
    with torch.profiler.profile(activities=acts) as prof:
        t_win = time.perf_counter()
        for _, step in steps[-n_win:]:
            n_kf += sum(st.is_keyframe for st in step())
        n_kf += sum(st.is_keyframe for st in system.tracker.flush())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_win) * 1e3
    n_frames = n_win * chunk
    what = "frame" if chunk == 1 else f"chunk of {chunk}"
    entry = "track_stereo" if stereo else "track_rgbd"
    print(f"== {entry if chunk == 1 else 'track_chunk'}"
          f"{', dynamic scene' if dynamic else ''}"
          f"{', stereo' if stereo else ''}"
          f"{', batched-levels extractor' if batched_levels else ''} on "
          f"{torch.cuda.get_device_name(0)}: steps before the window, host "
          f"ms per {what}: p50 {np.median(times[1:]):.2f}, first "
          f"{times[0]:.1f}")
    ev = prof.key_averages()
    # device time of the kernels themselves: the operators' rows repeat
    # it, and the record_function spans' device rows cover whole ranges
    kernel_us = sum(e.self_device_time_total for e in ev
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.key not in STAGES)
    launches = sum(e.count for e in ev if e.key == "cudaLaunchKernel")
    print(f"window: {n_frames} frames ({n_kf} keyframes), wall "
          f"{wall_ms:.1f} ms = {wall_ms / n_frames:.2f} ms/frame; device "
          f"kernel time {kernel_us / 1e3:.1f} ms, busy share "
          f"{kernel_us / 1e3 / wall_ms:.3f}; cudaLaunchKernel calls "
          f"{launches} ({launches / n_frames:.0f} per frame)")
    # a span appears twice: its host range and its range on the device
    for name in STAGES:
        rows = [e for e in ev if e.key == name]
        if rows:
            print(f"stage {name:14s} calls {rows[0].count:4d} host "
                  f"{max(e.cpu_time_total for e in rows) / 1e3:9.2f} ms  "
                  f"device span "
                  f"{max(e.device_time_total for e in rows) / 1e3:9.2f} ms")
    syncs = {e.key: e.count for e in ev
             if "Synchronize" in e.key or "Memcpy" in e.key}
    print(f"sync/copy calls in window ({n_frames} frames): {syncs}")
    print(ev.table(sort_by="self_device_time_total", row_limit=20))
    print(ev.table(sort_by="self_cpu_time_total", row_limit=20))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--dynamic", action="store_true",
                      help="the chunked path on the dynamic scene only")
    mode.add_argument("--stereo", action="store_true",
                      help="both paths on the stereo pair")
    ap.add_argument("--batched-levels", action="store_true",
                    help="extract all pyramid levels in one batch")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_track: needs a CUDA device")
    bl = args.batched_levels
    if args.dynamic:
        trace(CHUNK, dynamic=True, batched_levels=bl)
        return
    trace(1, stereo=args.stereo, batched_levels=bl)
    trace(CHUNK, stereo=args.stereo, batched_levels=bl)


if __name__ == "__main__":
    main()
