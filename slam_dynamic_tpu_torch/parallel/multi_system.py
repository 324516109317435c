"""MultiSystem: B SLAM frontends tracked as ONE batched device step.

Port of ``slam_dynamic_tpu/parallel/multi_system.py:68-655``. B
independent sequences (several cameras served from one card) share one
batched fused tracking call (``frontend/fused.py:fused_track_step_batch``,
``torch.func.vmap`` of the one-lane step, with kernels K1 and K2 launched
once for all lanes through their vmap rules) and one packed [B, 28]
readback per step. Each lane keeps the single System's host state
machine: keyframe decisions, mapping, loop closing and relocalization are
that System's code. A lane outside the steady OK state runs its own
System's per-frame path for that frame and rejoins the batch once it is
OK again.

The B maps live as ONE stacked ``MapState`` of [B, ...] tensors, stacked
once at construction: the batched step reads it as it is, and a keyframe
event copies out the one affected lane, runs the mapping stage on the
copy, and writes the result back (``_map_dirty`` marks a lane whose
System map is newer than its row of the stack). A lane read is always a
copy, never a view of the stack.

With ``mesh=`` (a ``parallel/mesh.py`` Mesh; JAX's :78, :99-101 and
``_put`` :125-131, the "dp" layout) the lanes are split into contiguous
groups, one per device of the mesh's "dp" axis. Each group keeps its own
stacked ``MapState`` and batched recurrent state on its device, and its
lanes' Systems live there. A call dispatches every group's batched step
before it reads any group's packet, so the devices overlap, then reads
each group's [B_g, 28] packet and runs the lanes' host state machines as
without a mesh. ``mesh=None`` is one group of all the lanes.

A difference by design from the JAX package: a localization-only lane's
relocalizer result is sliced to its first four values, as the single
Tracker does (the JAX MultiSystem unpacks four of the five values and
raises).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import SystemConfig
from ..frontend.frame import Frame
from ..frontend.fused import fused_track_chunk_batch, fused_track_step_batch
from ..frontend.tracking import TrackStats
from ..system import System


def _read_lane(tree, b: int):
    """Lane ``b`` of a stacked NamedTuple of tensors, as a copy."""
    return type(tree)(*[x[b].clone() for x in tree])


def _write_lane(tree, lane, idx: torch.Tensor):
    """A new stacked tree whose lane ``idx`` ([1] int64 on the device) is
    ``lane``; the input stays as it was."""
    return type(tree)(*[full.index_copy(0, idx, one.unsqueeze(0))
                        for full, one in zip(tree, lane)])


def _merge_counters(maps, vis, fnd, lane_mask: torch.Tensor):
    """Adopt the batched step's landmark counters for the masked lanes
    only."""
    return maps._replace(
        lm_visible=torch.where(lane_mask[:, None], vis, maps.lm_visible),
        lm_found=torch.where(lane_mask[:, None], fnd, maps.lm_found))


def _csrc_refresh(vis, fnd, mvis, mfnd, idx: torch.Tensor):
    """Reset one lane's rows of the counter chain from the map's."""
    return (vis.index_copy(0, idx, mvis.index_select(0, idx)),
            fnd.index_copy(0, idx, mfnd.index_select(0, idx)))


class _LaneGroup:
    """The lanes [start, stop) on one device: their stacked map, their
    batched recurrent state and the counter chain of their dispatches."""

    def __init__(self, index: int, lanes: range, device, maps):
        self.index = index
        self.lanes = lanes
        self.device = device
        self.n = len(lanes)
        self.maps = maps                 # stacked MapState [n_g, ...]
        self.lane_idx = [torch.tensor([j], device=device)
                         for j in range(self.n)]
        self.ref_kf_batch = None   # (lane ref-KF tuple, device [n_g])
        # the recurrent tracking state, batched on the device between
        # steps (last_ids, R_last, t_last, R_p2, t_p2, has_vel: [n_g, ...]);
        # a steady step touches it with no per-lane work
        self.bst = None
        self.ones = None
        self.bmask_cache = None
        # landmark-counter chain of the dispatches: in pipelined mode the
        # step in flight's output counters feed the next dispatch, so the
        # counts accumulate C_i = C_{i-1} + b_i
        self.csrc = None                 # (lm_visible, lm_found)


class MultiSystem:
    """Track B sequences with one batched device step per frame:
    ``MultiSystem(cfg, n).track_rgbd_batch(grays, depths, timestamps)``
    (or ``track_stereo_batch``, and the chunked ``track_*_chunk_batch``),
    on the card unless ``device="cpu"``.

    The detector must be off (the dynamic-scene path keeps per-lane
    reference frames: run such scenes on per-lane Systems), and the
    System's own pipelining is off (``pipeline_depth`` 0): with
    ``pipeline=True`` the batch itself is pipelined one step deep, so
    each call returns the previous step's stats while this step runs.
    Call ``flush`` (or ``trajectories``) before reading trajectories.
    ``mesh``: lay the lanes out over the devices of its ``dp_axis``, in
    contiguous groups (``device`` is then ignored).
    """

    def __init__(self, cfg: SystemConfig, n: int, pipeline: bool = False,
                 device=None, mesh=None, dp_axis: str = "dp"):
        if cfg.detector.mode != "off":
            raise ValueError("MultiSystem batches the static-scene path; "
                             "run dynamic scenes on per-lane Systems")
        cfg = dataclasses.replace(
            cfg, tracking=dataclasses.replace(cfg.tracking, pipeline_depth=0))
        self.cfg = cfg
        self.n = n
        self.pipeline = pipeline
        self.mesh = mesh
        self._pending = None
        if mesh is None:
            devices, bounds = [device], [0, n]
        else:
            devices = mesh.axis_devices(dp_axis)
            if n < len(devices):
                raise ValueError(f"{n} lanes over {len(devices)} devices")
            bounds = [g * n // len(devices) for g in range(len(devices) + 1)]
        self.systems: List[System] = []
        self.groups: List[_LaneGroup] = []
        self._group_of: List[_LaneGroup] = []
        for g, dev in enumerate(devices):
            lanes = range(bounds[g], bounds[g + 1])
            systems = [System(cfg, device=dev) for _ in lanes]
            # the group's maps as ONE stacked MapState (its batched step's
            # input)
            maps = type(systems[0].tracker.map)(
                *[torch.stack(xs) for xs in
                  zip(*[s.tracker.map for s in systems])])
            grp = _LaneGroup(g, lanes, systems[0].device, maps)
            self.systems += systems
            self.groups.append(grp)
            self._group_of += [grp] * len(lanes)
        self.device = self.systems[0].device
        self._map_dirty = [False] * n     # lane map newer than its stack
        self._np_last = [None] * n   # (np_R, np_t) per lane, for velocity
        # batched device steps (one per call, whatever the group count)
        # and their packet readbacks (equal once flushed)
        self.dispatches = 0
        self.packet_reads = 0

    def _lane(self, b: int):
        """(lane b's group, its index in the group)."""
        g = self._group_of[b]
        return g, b - g.lanes.start

    # ------------------------------------------------------------------
    def _sync_lane_to_batch(self, b: int):
        if self._map_dirty[b]:
            g, j = self._lane(b)
            m = self.systems[b].tracker.map
            g.maps = _write_lane(g.maps, m, g.lane_idx[j])
            self._map_dirty[b] = False
            if g.csrc is not None:
                # the counter chain restarts from the lane's new map row
                # (new landmarks' counters; a per-frame step's bumps)
                g.csrc = _csrc_refresh(g.csrc[0], g.csrc[1],
                                       g.maps.lm_visible, g.maps.lm_found,
                                       g.lane_idx[j])

    def _materialize_lane(self, b: int):
        """tracker.map <- a copy of lane b's row of its group's stack."""
        g, j = self._lane(b)
        tr = self.systems[b].tracker
        tr.map = _read_lane(g.maps, j)
        tr._kf_pose_cache.clear()

    def _patch_lane_state(self, b: int):
        """Write lane b's per-frame tracker state into the batched state
        (on lane events only: a rejoin, a relocalization)."""
        tr = self.systems[b].tracker
        g, j = self._lane(b)
        st = g.bst
        idx = g.lane_idx[j]
        lf = tr.last_frame
        ids = lf.obs_lm if lf.obs_lm is not None else torch.full(
            (self.cfg.capacity.max_keypoints,), -1, dtype=torch.int32,
            device=g.device)
        p2 = tr._prev2_pose
        rows = {"last_ids": ids, "R_last": lf.R, "t_last": lf.t,
                "R_p2": p2[0] if p2 is not None else lf.R,
                "t_p2": p2[1] if p2 is not None else lf.t,
                "has_vel": torch.tensor(0.0 if p2 is None else 1.0,
                                        device=g.device)}
        for k, v in rows.items():
            st[k] = st[k].index_copy(0, idx, v.to(st[k].dtype)[None])
        self._np_last[b] = (
            np.asarray(lf.np_R) if lf.np_R is not None
            else lf.R.cpu().numpy(),
            np.asarray(lf.np_t) if lf.np_t is not None
            else lf.t.cpu().numpy())

    def _init_bstate(self):
        N = self.cfg.capacity.max_keypoints
        for g in self.groups:
            n, dev = g.n, g.device
            g.bst = {
                "last_ids": torch.full((n, N), -1, dtype=torch.int32,
                                       device=dev),
                "R_last": torch.eye(3, device=dev).repeat(n, 1, 1),
                "t_last": torch.zeros((n, 3), device=dev),
                "R_p2": torch.eye(3, device=dev).repeat(n, 1, 1),
                "t_p2": torch.zeros((n, 3), device=dev),
                "has_vel": torch.zeros(n, device=dev),
            }
            g.ones = torch.ones(n, device=dev)

    def _ref_kf_dev(self, g: _LaneGroup):
        """(the group's lane reference-KF tuple, its device [n_g] int64),
        rebuilt only when a lane's reference keyframe changed."""
        ref_ks = tuple(max(self.systems[b].tracker.last_kf_id, 0)
                       for b in g.lanes)
        if g.ref_kf_batch is None or g.ref_kf_batch[0] != ref_ks:
            g.ref_kf_batch = (ref_ks, torch.tensor(
                ref_ks, dtype=torch.int64, device=g.device))
        return g.ref_kf_batch

    def _empty_boxes(self, g: _LaneGroup, lead: tuple):
        """The empty box set broadcast to ``lead`` (the lane, or lane and
        chunk, axes), on the group's device."""
        dc = self.systems[g.lanes.start].tracker._scalar_consts()
        return (dc["bx_empty"].expand(*lead, *dc["bx_empty"].shape),
                dc["ba_empty"].expand(*lead, *dc["ba_empty"].shape))

    def _dispatch_args(self, g: _LaneGroup):
        """The group's batched step's map (with the counter chain's
        counters), its recurrent state and its reference keyframes."""
        if g.csrc is None:
            g.csrc = (g.maps.lm_visible, g.maps.lm_found)
        maps_in = g.maps._replace(lm_visible=g.csrc[0],
                                  lm_found=g.csrc[1])
        st = g.bst
        ref_ks, ref_dev = self._ref_kf_dev(g)
        return (maps_in, (st["last_ids"], st["R_last"], st["t_last"],
                          st["R_p2"], st["t_p2"], st["has_vel"], ref_dev),
                ref_ks)

    # ------------------------------------------------------------------
    def track_rgbd_batch(self, grays: Sequence[np.ndarray],
                         depths: Sequence[np.ndarray],
                         timestamps: Sequence[float]) -> List[TrackStats]:
        """One RGB-D frame for each of the B lanes. A steady step costs one
        stacked image upload, one batched device step and one packed
        [B, 28] readback; the recurrent state stays batched on the device,
        and per-lane device work happens only on lane events (keyframe,
        LOST, rejoin)."""
        if self.cfg.sensor != "rgbd":
            raise ValueError(f"track_rgbd_batch on a {self.cfg.sensor} "
                             "MultiSystem")
        return self._track_batch(grays, depths, timestamps)

    def track_stereo_batch(self, lefts: Sequence[np.ndarray],
                           rights: Sequence[np.ndarray],
                           timestamps: Sequence[float]) -> List[TrackStats]:
        """One stereo pair for each of the B lanes: both extractions and
        the row-band matcher run in the batched step."""
        if self.cfg.sensor != "stereo":
            raise ValueError(f"track_stereo_batch on a {self.cfg.sensor} "
                             "MultiSystem")
        return self._track_batch(lefts, rights, timestamps)

    def _track_batch(self, grays, auxes, timestamps) -> List[TrackStats]:
        if len(grays) != self.n:
            raise ValueError(f"{len(grays)} frames for {self.n} lanes")
        cfg = self.cfg
        batched: List[int] = []
        stats: List[Optional[TrackStats]] = [None] * self.n
        if self.groups[0].bst is None:
            self._init_bstate()

        early = None
        if self.pipeline and self._pending is not None and any(
                s.tracker.state != "OK" for s in self.systems):
            # a lane is about to run its per-frame path, which appends
            # trajectory entries: drain the step in flight first so its
            # (older) entries land in timestamp order
            prev, self._pending = self._pending, None
            fin = self._finalize_any(prev)
            early = fin[-1] if prev[0] == "chunk" else fin

        # lanes outside the steady state run their own per-frame path
        # (initialization, relocalization); they write their map and
        # recurrent state back into the batch when they recover
        for b, s in enumerate(self.systems):
            if s.tracker.state == "OK":
                batched.append(b)
                continue
            self._materialize_lane(b)
            self._map_dirty[b] = True
            track1 = s.track_rgbd if cfg.sensor == "rgbd" else s.track_stereo
            stats[b] = track1(np.asarray(grays[b]), np.asarray(auxes[b]),
                              float(timestamps[b]))
            self._sync_lane_to_batch(b)
            if s.tracker.state == "OK":     # rejoins at the next step
                self._patch_lane_state(b)
        if not batched:
            return stats

        # every group's batch spans all its lanes (the stacked map's shape
        # never changes); a lane outside the batch computes rows that are
        # ignored. Every group's step is queued before any packet is read.
        outs, ref_ks = [], ()
        for grp in self.groups:
            lo, hi = grp.lanes.start, grp.lanes.stop
            tr = self.systems[lo].tracker
            g, d, depth_scale = tr._stage_inputs(
                np.stack([np.asarray(x) for x in grays[lo:hi]]),
                np.stack([np.asarray(x) for x in auxes[lo:hi]]))
            bx, ba = self._empty_boxes(grp, (grp.n,))
            maps_in, chain, ks = self._dispatch_args(grp)
            out = fused_track_step_batch(
                maps_in, tr.cam, tr.bounds, g, d, bx, ba, *chain,
                depth_scale=depth_scale, **tr._track_kwargs())
            self.dispatches += 1
            st = grp.bst
            # rotate the batched recurrent state by reference (no device
            # work)
            grp.bst = {"last_ids": out.obs_lm, "R_last": out.R,
                       "t_last": out.t, "R_p2": st["R_last"],
                       "t_p2": st["t_last"], "has_vel": grp.ones}
            # the next dispatch continues the counter chain from this
            # step's output (lanes outside the batch are refreshed from
            # the map by _sync_lane_to_batch before their next use)
            grp.csrc = (out.lm_visible, out.lm_found)
            outs.append(out)
            ref_ks += ks

        step = ("frame", (outs, [float(t) for t in timestamps], ref_ks,
                          batched))
        if self.pipeline:
            prev, self._pending = self._pending, step
            if prev is None:
                # nothing in flight (the first step, or drained early
                # above): lanes this step did not cover report the drained
                # step's stats; a lane that ran its per-frame path keeps
                # its own and carries the drained ones in drained_prev
                if early is not None:
                    for b in range(self.n):
                        if stats[b] is None:
                            stats[b] = early[b]
                        elif early[b] is not None:
                            stats[b].drained_prev = early[b]
                return stats
            # the previous step's stats (decisions lag one step); a lane
            # that ran its per-frame path this step reports that instead
            prev_stats = self._finalize_any(prev)
            if prev[0] == "chunk":
                prev_stats = prev_stats[-1]
            for b in range(self.n):
                if stats[b] is not None:
                    prev_stats[b] = stats[b]
            return prev_stats
        fin = self._finalize_step(step[1])
        for b in range(self.n):
            if fin[b] is not None:
                stats[b] = fin[b]
        return stats

    # ------------------------------------------------------------------
    def track_rgbd_chunk_batch(self, grays, depths, timestamps):
        """B lanes x C consecutive frames in one batched call and one
        packed [B, C, 28] readback (``fused_track_chunk_batch``).
        ``grays``, ``depths``, ``timestamps``: [B][C] nested sequences.
        Decisions lag one chunk per lane; while a lane is not OK the chunk
        runs as C per-frame batched steps. Returns the flat list of the
        stats finalized in this call."""
        if self.cfg.sensor != "rgbd":
            raise ValueError(f"track_rgbd_chunk_batch on a {self.cfg.sensor}"
                             " MultiSystem")
        return self._track_chunk_batch(grays, depths, timestamps)

    def track_stereo_chunk_batch(self, lefts, rights, timestamps):
        """``track_rgbd_chunk_batch`` for stereo pairs."""
        if self.cfg.sensor != "stereo":
            raise ValueError(f"track_stereo_chunk_batch on a "
                             f"{self.cfg.sensor} MultiSystem")
        return self._track_chunk_batch(lefts, rights, timestamps)

    def _track_chunk_batch(self, grays, auxes, timestamps):
        C = len(grays[0])
        sts: List[TrackStats] = []
        if C == 1 or any(s.tracker.state != "OK" for s in self.systems):
            for j in range(C):
                row = self._track_batch(
                    [np.asarray(g[j]) for g in grays],
                    [np.asarray(a[j]) for a in auxes],
                    [float(t[j]) for t in timestamps])
                sts.extend(st for st in row if st is not None)
            return sts
        if self.groups[0].bst is None:
            self._init_bstate()
        per, ref_ks = [], ()
        for grp in self.groups:
            lo, hi = grp.lanes.start, grp.lanes.stop
            tr = self.systems[lo].tracker
            g, d, depth_scale = tr._stage_inputs(
                np.stack([np.stack([np.asarray(x) for x in gl])
                          for gl in grays[lo:hi]]),
                np.stack([np.stack([np.asarray(x) for x in al])
                          for al in auxes[lo:hi]]))
            bx, ba = self._empty_boxes(grp, (grp.n, C))
            maps_in, chain, ks = self._dispatch_args(grp)
            outs, packed_dev = fused_track_chunk_batch(
                maps_in, tr.cam, tr.bounds, g, d, bx, ba, *chain,
                depth_scale=depth_scale, **tr._track_kwargs())
            self.dispatches += 1
            grp.bst = {"last_ids": outs[-1].obs_lm, "R_last": outs[-1].R,
                       "t_last": outs[-1].t, "R_p2": outs[-2].R,
                       "t_p2": outs[-2].t, "has_vel": grp.ones}
            grp.csrc = (outs[-1].lm_visible, outs[-1].lm_found)
            per.append((outs, packed_dev))
            ref_ks += ks
        ts = [[float(t) for t in tl] for tl in timestamps]
        step = ("chunk", (per, ts, ref_ks, C))
        if self.pipeline:
            prev, self._pending = self._pending, step
            if prev is not None:
                # prev is a chunk step ([C][B] rows) or a frame step (a
                # flat [B] row: the cold start runs per-frame batches
                # through the same pipeline slot)
                sts.extend(self._flat_stats(self._finalize_any(prev)))
            return sts
        sts.extend(self._flat_stats(self._finalize_any(step)))
        return sts

    @staticmethod
    def _flat_stats(fin):
        """A finalize's stats, [B] (frame step) or [C][B] (chunk step), as
        one flat list without the Nones."""
        out = []
        for row in fin:
            if isinstance(row, list):
                out.extend(st for st in row if st is not None)
            elif row is not None:
                out.append(row)
        return out

    def _read_packet(self, packed_dev: torch.Tensor) -> np.ndarray:
        self.packet_reads += 1
        return packed_dev.cpu().numpy()

    def _finalize_chunk(self, step):
        """A chunk step: ONE [B_g, C, 28] readback per group, then each
        lane's host state machine frame by frame (a lane that goes LOST
        within the chunk skips its remaining frames, which chained on the
        device from a lost pose). Returns [C][B] stats rows."""
        per, ts, ref_ks, C = step
        for grp, (outs, _) in zip(self.groups, per):
            grp.maps = grp.maps._replace(lm_visible=outs[-1].lm_visible,
                                         lm_found=outs[-1].lm_found)
        packed = [self._read_packet(p) for _, p in per]   # [B_g, C, 28]
        rows = []
        for j in range(C):
            row: List[Optional[TrackStats]] = [None] * self.n
            for b in range(self.n):
                if self.systems[b].tracker.state != "OK":
                    continue
                g, lane = self._lane(b)
                row[b] = self._lane_post(b, per[g.index][0][j],
                                         packed[g.index][lane, j], ts[b][j],
                                         ref_ks[b], allow_obs_patch=False)
            rows.append(row)
        return rows

    def _finalize_any(self, step):
        kind, payload = step
        if kind == "chunk":
            return self._finalize_chunk(payload)
        return self._finalize_step(payload)

    def flush(self):
        """Drain the pipelined step in flight (before reading
        trajectories): its stats, [B] for a frame step or flat for a
        chunk step, or None when none was in flight."""
        if self._pending is None:
            return None
        prev, self._pending = self._pending, None
        fin = self._finalize_any(prev)
        if prev[0] == "chunk":
            return [st for row in fin for st in row if st is not None]
        return fin

    def _finalize_step(self, step) -> List[Optional[TrackStats]]:
        outs, ts, ref_ks, batched = step
        for grp, out in zip(self.groups, outs):
            # the batched landmark counters, but only for the lanes that
            # were in the batch: the others' rows were computed from stale
            # state and would drive their found/visible ratios towards
            # culling
            mine = tuple(b - grp.lanes.start for b in sorted(batched)
                         if b in grp.lanes)
            if len(mine) == grp.n:
                grp.maps = grp.maps._replace(lm_visible=out.lm_visible,
                                             lm_found=out.lm_found)
            else:
                if grp.bmask_cache is None or grp.bmask_cache[0] != mine:
                    m = np.zeros(grp.n, bool)
                    m[list(mine)] = True
                    grp.bmask_cache = (mine, torch.from_numpy(m).to(
                        grp.device))
                grp.maps = _merge_counters(grp.maps, out.lm_visible,
                                           out.lm_found, grp.bmask_cache[1])
        packed = [self._read_packet(out.packed) for out in outs]  # [B_g, 28]
        stats: List[Optional[TrackStats]] = [None] * self.n
        for b in batched:
            g, lane = self._lane(b)
            stats[b] = self._lane_post(b, outs[g.index],
                                       packed[g.index][lane], ts[b],
                                       ref_ks[b])
        return stats

    def _lane_post(self, b: int, out, pk, ts: float, ref_k: int,
                   allow_obs_patch: bool = True) -> TrackStats:
        """Lane b's host state machine from its packet row (``out`` is its
        group's step); device work (the lane's frame, its map) happens
        only on keyframe and LOST events."""
        cfg = self.cfg
        sys_b = self.systems[b]
        tr = sys_b.tracker
        grp, j = self._lane(b)
        n_mm, n_map = int(pk[0]), int(pk[1])
        np_R = pk[4:13].reshape(3, 3)
        np_t = pk[13:16]
        np_Rk = pk[16:25].reshape(3, 3)
        np_tk = pk[25:28]
        lost = (n_mm < cfg.tracking.min_inliers_track
                or n_map < cfg.tracking.min_inliers_localmap)

        def make_frame():
            frame = Frame(data=_read_lane(out.fd, j),
                          frame_id=sys_b.frame_id, timestamp=ts,
                          ref_kf=ref_k, np_R=np_R, np_t=np_t, np_Rk=np_Rk,
                          np_tk=np_tk)
            frame.R, frame.t = out.R[j].clone(), out.t[j].clone()
            frame.obs_lm = out.obs_lm[j].clone()
            return frame

        # velocity (host mirror, for the per-frame path on a fallback)
        last_np = self._np_last[b]
        if last_np is not None:
            Rv = np_R @ last_np[0].T
            tr.velocity = (Rv, np_t - Rv @ last_np[1])
        self._np_last[b] = (np_R, np_t)
        # the trajectory entry, relative to the packet's reference KF pose
        R_rel = np_R @ np_Rk.T
        t_rel = np_t - R_rel @ np_tk
        tr.trajectory.append((ts, ref_k, R_rel, t_rel))

        if lost:
            tr.state = "LOST"
            frame = make_frame()        # the relocalizer needs the frame
            tr.last_frame = frame
            tr._prev2_pose = None
            sys_b.frame_id += 1
            return TrackStats("LOST", n_inliers_mm=n_mm,
                              n_inliers_map=n_map, frame_id=frame.frame_id)

        tr.frames_since_kf += 1
        st = TrackStats("OK", n_inliers_mm=n_mm, n_inliers_map=n_map,
                        frame_id=sys_b.frame_id, np_R=np_R, np_t=np_t)
        if tr.localization_only:
            # VO mode's two hypotheses, as the Tracker's _vo_arbitrate:
            # while map tracking is weak, also relocalize and prefer that
            relocated = False
            if tr.vo_mode and tr.relocalizer is not None:
                self._materialize_lane(b)
                frame = make_frame()
                tr.last_frame = frame
                ok_r, Rr, tr_r, obs = tr.relocalizer(frame)[:4]
                if ok_r:
                    r_R = Rr.cpu().numpy()
                    r_t = tr_r.cpu().numpy()
                    frame.R, frame.t = Rr, tr_r
                    frame.np_R, frame.np_t = r_R, r_t
                    if obs is not None:
                        frame.obs_lm = obs
                    st.np_R, st.np_t = r_R, r_t
                    tr._prev2_pose = None       # the velocity is void now
                    # this frame's trajectory entry and the batched state
                    # follow the preferred pose
                    R_rel = r_R @ np_Rk.T
                    tr.trajectory[-1] = (ts, ref_k, R_rel,
                                         r_t - R_rel @ np_tk)
                    self._np_last[b] = (r_R, r_t)
                    self._patch_lane_state(b)
                    relocated = True
            tr.vo_mode = (not relocated
                          and n_map < cfg.tracking.vo_mode_inliers)
        elif tr._need_keyframe_counts(n_map, int(pk[2]), int(pk[3])):
            self._materialize_lane(b)
            frame = make_frame()
            tr.last_frame = frame
            pre_map = tr.map
            before = tr.kf_seq
            tr._create_keyframe(frame, n_map)
            st.is_keyframe = tr.kf_seq > before
            if st.is_keyframe:
                # the new reference KF enters the batch at the next
                # dispatch; the refreshed observation row only in sync
                # mode (pipelined, the batch state already rotated to a
                # newer frame: the single System's pipeline skew)
                if not self.pipeline and allow_obs_patch:
                    grp.bst["last_ids"] = grp.bst["last_ids"].index_copy(
                        0, grp.lane_idx[j], frame.obs_lm[None])
                grp.ref_kf_batch = None
            if tr.map is not pre_map:
                self._map_dirty[b] = True
                self._sync_lane_to_batch(b)
        sys_b.frame_id += 1
        if sys_b._gba is not None:
            # the global BA's merge applies to the lane's current map, and
            # its correction goes back into the batch (else the next lane
            # event's _materialize_lane would drop it)
            self._materialize_lane(b)
            pre = tr.map
            sys_b._gba_step()
            if tr.map is not pre:
                self._map_dirty[b] = True
                self._sync_lane_to_batch(b)
        return st

    # ------------------------------------------------------------------
    def trajectories(self):
        """Each lane's trajectory (the pipelined step drained first)."""
        self.flush()
        return [s.trajectory for s in self.systems]
