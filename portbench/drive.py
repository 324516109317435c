"""The entries the cells drive, their warm-up and the timed window.

Three entries, named in each cell's workload file:

- ``chunk``: ``System.track_chunk``, C frames a call, one chunk in flight;
- ``frame``: ``System.track_rgbd`` / ``track_stereo``, a frame a call,
  one frame in flight;
- ``fleet``: ``MultiSystem.track_rgbd_batch`` / ``track_stereo_batch``,
  B lanes a call, one step in flight, lane b at phase b * P / B; with
  ``chunk`` C > 1, ``track_rgbd_chunk_batch`` / ``track_stereo_chunk_batch``,
  B lanes x C frames a call.

The warm-up is ``slam_dynamic_tpu_torch/bench.py``'s, copied: the
per-frame bootstrap until tracking is OK, warm steps with a keyframe at
least every 3 frames, the configured cadence back, one loop-detection
scoring; then the frames in flight are finalized, so every frame the
window reports was submitted in it.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_loop_detect(system):
    """One loop-detection scoring on keyframe 0, so the first real one is
    not the first of its ops on the device (``bench._warm_loop_detect``)."""
    from slam_dynamic_tpu_torch.backend.loop_closing import _detect_device
    from slam_dynamic_tpu_torch.models import vocabulary as voc_mod
    if system.loop is None:
        return
    m = system.tracker.map
    bv = voc_mod.transform(system.voc, m.kf_kp_desc[0], m.kf_kp_valid[0])
    sb = voc_mod.sparse_bow(bv, top_w=system.loop.db.word.shape[1])
    _detect_device(system.loop.db, sb, m.covis, m.kf_valid, 0).cpu()


def _cadence(cfg, every: int):
    return cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, max_frames_between_kf=every))


class Driver:
    """One cell's program and the world it sees. ``frames_per_step``
    lane-frames are submitted by each ``step()``."""

    def __init__(self, wl: dict, cfg, world, device, boxed=None):
        self.wl = wl
        self.cfg = cfg
        self.world = world
        self.device = torch.device(device)
        self.entry = wl["entry"]
        self.C = int(wl.get("chunk", 1)) if self.entry != "frame" else 1
        self.B = int(wl.get("lanes", 1)) if self.entry == "fleet" else 1
        self.boxed = boxed
        self.i = 0                     # next run frame of every lane
        self.fps = world.fps
        self.offsets = [b * world.period // self.B for b in range(self.B)]
        self.stats = []                # every stat returned, in order
        warm = _cadence(cfg, 3)
        from slam_dynamic_tpu_torch.parallel.multi_system import MultiSystem
        from slam_dynamic_tpu_torch.system import System
        if self.entry == "fleet":
            self.ms = MultiSystem(warm, self.B, pipeline=True,
                                  device=self.device)
            self.systems = self.ms.systems
        else:
            self.ms = None
            self.systems = [System(warm, device=self.device)]
        self.stereo = cfg.sensor == "stereo"

    # -- frames -----------------------------------------------------------
    def frame(self, i: int, lane: int = 0):
        w = self.world.index(i + self.offsets[lane])
        return self.world.gray[w], self.world.aux[w], i / self.fps

    def dets(self, i: int):
        if self.boxed is None:
            return None
        return self.world.detections(i, self.boxed)

    # -- steps --------------------------------------------------------------
    def _solo_frame(self, i: int):
        s = self.systems[0]
        g, a, ts = self.frame(i)
        entry = s.track_stereo if self.stereo else s.track_rgbd
        with record_function("portbench.entry"):
            return [entry(g, a, ts, detections=self.dets(i))]

    def step(self):
        """Submit the next step; returns the stats it finalized."""
        i = self.i
        if self.entry == "fleet":
            fr = [[self.frame(i + j, b) for j in range(self.C)]
                  for b in range(self.B)]
            if self.C == 1:
                call = self.ms.track_stereo_batch if self.stereo \
                    else self.ms.track_rgbd_batch
                args = [[f[0][k] for f in fr] for k in range(3)]
            else:
                call = self.ms.track_stereo_chunk_batch if self.stereo \
                    else self.ms.track_rgbd_chunk_batch
                args = [[[f[k] for f in lane] for lane in fr]
                        for k in range(3)]
            with record_function("portbench.entry"):
                out = call(*args)
            new = [st for st in out if st is not None]
        elif self.entry == "chunk":
            fr = [self.frame(i + j) for j in range(self.C)]
            dets = [self.dets(i + j) for j in range(self.C)] \
                if self.boxed is not None else None
            with record_function("portbench.entry"):
                new = self.systems[0].track_chunk(
                    [f[0] for f in fr], [f[1] for f in fr],
                    [f[2] for f in fr], dets)
        else:
            new = self._solo_frame(i)
        self.i += self.C
        self.stats.extend(new)
        return new

    @property
    def frames_per_step(self) -> int:
        return self.C * self.B

    def drain(self):
        """Finalize what is in flight; returns its stats."""
        if self.ms is not None:
            out = self.ms.flush()
            new = [st for st in (out or []) if st is not None]
        else:
            new = self.systems[0].tracker.drain()
        self.stats.extend(new)
        return new

    # -- set-up -------------------------------------------------------------
    def warm_up(self, steps: int):
        """Bootstrap, ``steps`` warm steps at a keyframe every 3 frames,
        the configured cadence back, loop detection warmed, nothing in
        flight."""
        if self.entry == "chunk":
            s = self.systems[0]
            while s.tracker.state != "OK" and self.i < 6:
                self._solo_frame(self.i)
                self.i += 1
        for _ in range(steps):
            self.step()
        if self.ms is not None:
            self.ms.cfg = self.ms.cfg.replace(tracking=dataclasses.replace(
                self.ms.cfg.tracking,
                max_frames_between_kf=self.cfg.tracking
                .max_frames_between_kf))
            for s in self.systems:
                s.cfg = s.tracker.cfg = self.ms.cfg
        else:
            s = self.systems[0]
            s.cfg = s.tracker.cfg = self.cfg
        warm_loop_detect(self.systems[0])
        self.drain()
        _sync(self.device)

    # -- what the window produced --------------------------------------------
    def trajectories(self):
        """Per lane, (timestamp, R_cw, t_cw) of every tracked frame."""
        if self.ms is not None:
            return self.ms.trajectories()
        return [self.systems[0].trajectory]

    def last_frames(self):
        """Per lane, the tracker's newest frame (timestamp, data)."""
        out = []
        for b, s in enumerate(self.systems):
            f = s.tracker.last_frame
            out.append(None if f is None else (b, f.timestamp, f.data))
        return out

    def loop_counts(self):
        """(loop candidates, loops closed) so far, over every lane."""
        lcs = [s.loop for s in self.systems if s.loop is not None]
        return (sum(lc.n_candidates for lc in lcs),
                sum(lc.n_closed for lc in lcs))

    def box_state(self):
        s = self.systems[0]
        return np.array(s.boxes.boxes, np.float32).reshape(-1, 4), \
            np.array(s.boxes.status, np.int32)


def run_window(drv: Driver, seconds: float, rec, seed: int, sample: dict,
               profile=None):
    """Step for ``seconds`` of host time, then finalize what is in flight.
    Returns the host times of the calls, the window, the frames submitted,
    and what was kept for the check: frame samples, box snapshots.
    ``profile``, when given, is entered around a steady slice of whole
    steps (``Profile``)."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 7])
    depth_share = float(sample.get("depth_share", 0.2))
    depth_max = int(sample.get("depth_max", 16))
    starts, ends, in_slice, frames_samples, snaps = [], [], [], [], []
    seen = set()
    first = drv.i
    n_stats0 = len(drv.stats)
    rec.on = True
    t0 = time.perf_counter()
    # a slice that runs at the close goes on to its end: it holds whole
    # steps and a keyframe, and a traced run reports no rate
    while time.perf_counter() - t0 < seconds or (
            profile is not None and profile.active):
        if profile is not None and profile.should_start(len(starts)):
            # no sample is copied inside the slice, which keeps what the
            # kernels' least time needs
            rec.on, rec.slice = False, True
            profile.start()
        sliced = profile is not None and profile.active
        s0 = time.perf_counter()
        new = drv.step()
        s1 = time.perf_counter()
        starts.append(s0)
        ends.append(s1)
        in_slice.append(sliced)
        if sliced:
            profile.count(drv.frames_per_step,
                          sum(bool(st.is_keyframe) for st in new))
            if profile.enough():
                _sync(drv.device)
                profile.stop()
                rec.on, rec.slice = True, False
            continue
        if len(frames_samples) < depth_max and rng.random() < depth_share:
            for item in drv.last_frames():
                # a lane's newest frame, once, and only from the window (a
                # batched lane keeps the frame of its last own event)
                if item is not None and item[1] * drv.fps >= first - 0.5 \
                        and item[:2] not in seen:
                    b, ts, data = item
                    seen.add((b, ts))
                    frames_samples.append((b, ts, data.xy_raw.clone(),
                                           data.valid.clone(),
                                           data.depth.clone()))
        if drv.boxed is not None:
            snaps.append((drv.i - 1,) + drv.box_state())
    if profile is not None:
        # a slice that never started never starts after the window
        _sync(drv.device)
        profile.finish()
        rec.slice = False
    drv.drain()
    _sync(drv.device)
    t_end = time.perf_counter()
    rec.on = False
    return dict(t0=t0, t_end=t_end, starts=np.asarray(starts),
                ends=np.asarray(ends), in_slice=in_slice, first=first,
                last=drv.i,
                stats=drv.stats[n_stats0:], frames=frames_samples,
                snaps=snaps)


def latencies_ms(win: dict, depth: int, frames_per_call: int):
    """Per frame of the window, the time (ms) from its call's start until
    its pose is on the host: the end of the call ``depth`` calls later,
    or the end of the window's final drain."""
    starts, ends = win["starts"], win["ends"]
    n = len(starts)
    out = []
    for j in range(n):
        done = ends[j + depth] if j + depth < n else win["t_end"]
        out += [(done - starts[j]) * 1e3] * frames_per_call
    return np.asarray(out)

