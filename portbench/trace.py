"""The traced slice: ``torch.profiler`` over whole steps inside the window,
and the reduction of its events to what the per-layer metrics read.

The slice starts after ``skip_steps`` steps of the window and ends with
the step at which it holds at least ``min_frames`` lane-frames and
``min_keyframes`` keyframes, or ``max_frames``. Events stay in memory;
nothing is written to disk. The profiler slows the host by its cost per
operator and per launch (a step takes 2-3x as long in the slice), so
host times read in the slice are upper values, and the device's idle
share is taken against the steps outside it (``device_idle_pct``).

The reduction works on plain tuples, so its arithmetic is tested on
synthetic event lists: ``Event(kind, name, start_ns, end_ns, thread,
corr)`` with ``kind`` one of "op" (a host operator or span), "launch" (a
runtime call that launches device work), "device" (a kernel, copy or
set on the device).
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import List, NamedTuple

import torch

# the runtime and driver calls that launch device work
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch")
# the program's kernel ops and spans
K1_OP = "slam_dynamic_tpu_torch::gated_match"
K2_OP = "slam_dynamic_tpu_torch::hamming_matrix"
SPANS = ("frame_build", "mm_track", "local_map", "local_track", "classify",
         "box3d", "mapping_stage", "triangulate", "fuse", "local_ba",
         "portbench.entry")


class Event(NamedTuple):
    kind: str
    name: str
    start: int
    end: int
    thread: int = 0
    corr: int = 0


class Profile:
    """Decides the slice and holds its profiler."""

    def __init__(self, spec: dict):
        self.skip = int(spec.get("skip_steps", 2))
        self.min_frames = int(spec.get("min_frames", 12))
        self.min_kf = int(spec.get("min_keyframes", 1))
        self.max_frames = int(spec.get("max_frames", 48))
        self.frames = self.keyframes = 0
        self.prof = None
        self.active = self.done = False
        self.t0 = self.t1 = None

    def should_start(self, steps_done: int) -> bool:
        return not self.done and not self.active and steps_done >= self.skip

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.active = True
        self.t0 = time.perf_counter()

    def count(self, frames: int, keyframes: int):
        self.frames += frames
        self.keyframes += keyframes

    def enough(self) -> bool:
        return (self.frames >= self.min_frames
                and self.keyframes >= self.min_kf) \
            or self.frames >= self.max_frames

    def stop(self):
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.active, self.done = False, True

    def finish(self):
        """End the window's tracing: stop the slice if it still runs, and
        never start it after."""
        if self.active:
            self.stop()
        self.done = True

    def events(self) -> List[Event]:
        """The slice's events as ``Event`` tuples (none where it did not
        run)."""
        if self.prof is None:
            return []
        out = []
        CUDA = torch.autograd.DeviceType.CUDA
        raw = self.prof.profiler.kineto_results.events()
        host_names = {e.name() for e in raw if e.device_type() != CUDA}
        for e in raw:
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == CUDA:
                if name in host_names:
                    continue      # a span's range repeated on the device
                out.append(Event("device", name, start, end, 0,
                                 e.correlation_id()))
            elif name in LAUNCH_NAMES:
                out.append(Event("launch", name, start, end,
                                 e.start_thread_id(), e.correlation_id()))
            else:
                out.append(Event("op", name, start, end,
                                 e.start_thread_id(), 0))
        return out


# -- reduction ----------------------------------------------------------------
def union_ns(intervals) -> int:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: int, hi: int):
    """(start, end) of the stretches of [lo, hi] no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def op_device_ns(events: List[Event], op: str):
    """(device ns, calls) of the work launched under the host events
    named ``op``: each launch call inside such an event, on its thread,
    and the device events that share its correlation id."""
    ops = [e for e in events if e.kind == "op" and e.name == op]
    if not ops:
        return 0, 0
    launches = defaultdict(list)
    for e in events:
        if e.kind == "launch":
            launches[e.thread].append((e.start, e.corr))
    for v in launches.values():
        v.sort()
    corr = set()
    for o in ops:
        v = launches.get(o.thread, [])
        k = bisect.bisect_left(v, (o.start, -1))
        while k < len(v) and v[k][0] <= o.end:
            corr.add(v[k][1])
            k += 1
    dev = sum(e.end - e.start for e in events
              if e.kind == "device" and e.corr in corr)
    return dev, len(ops)


def span_host_ns(events: List[Event]):
    """name -> (host ns, calls) of the spans in ``SPANS``."""
    out = defaultdict(lambda: [0, 0])
    for e in events:
        if e.kind == "op" and e.name in SPANS:
            out[e.name][0] += e.end - e.start
            out[e.name][1] += 1
    return {k: tuple(v) for k, v in out.items()}


HOST = "host (no span)"


def innermost_spans(spans):
    """The timeline cut at every span boundary: (cuts, labels), where
    labels[k] names the shortest span covering [cuts[k], cuts[k + 1])."""
    cuts = sorted({t for a, b, _ in spans for t in (a, b)})
    labels = []
    for k, t in enumerate(cuts):
        nxt = cuts[k + 1] if k + 1 < len(cuts) else t + 1
        best, width = HOST, None
        for a, b, name in spans:
            if a <= t and b >= nxt and (width is None or b - a < width):
                best, width = name, b - a
        labels.append(best)
    return cuts, labels


def summarize(events: List[Event], top: int = 10):
    """What the readers and the breakdown take from a slice, which spans
    its events (ns): device busy time (the union of device intervals), launches,
    the K1 and K2 ops' device time, the spans' host time, the device
    operations that took most time and the longest idle gaps by the
    innermost host span they fall under."""
    if not events:
        return None
    lo = min(e.start for e in events)
    hi = max(e.end for e in events)
    dev = [(e.start, e.end) for e in events if e.kind == "device"]
    busy = union_ns(dev)
    by_kernel = defaultdict(int)
    for e in events:
        if e.kind == "device":
            by_kernel[e.name] += e.end - e.start
    cuts, labels = innermost_spans(
        [(e.start, e.end, e.name) for e in events
         if e.kind == "op" and e.name in SPANS])
    idle = defaultdict(int)
    for s, e in gaps(dev, lo, hi):
        k = bisect.bisect_right(cuts, (s + e) // 2) - 1
        idle[labels[k] if 0 <= k < len(labels) else HOST] += e - s
    k1 = op_device_ns(events, K1_OP)
    k2 = op_device_ns(events, K2_OP)
    return dict(
        window_ns=hi - lo, busy_ns=busy,
        launches=sum(1 for e in events if e.kind == "launch"),
        k1_device_ns=k1[0], k1_calls=k1[1],
        k2_device_ns=k2[0], k2_calls=k2[1],
        spans=span_host_ns(events),
        device_ops=[[n, t / 1e9] for n, t in sorted(
            by_kernel.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[n, t / 1e9] for n, t in sorted(
            idle.items(), key=lambda kv: -kv[1])[:top]])
