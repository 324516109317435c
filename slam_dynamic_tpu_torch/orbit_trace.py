"""Where two runs of the chunked orbit part: the card against the CPU, or
the card against itself.

    python -m slam_dynamic_tpu_torch.orbit_trace run --device cuda \
        [--frames 200] [--chunk 6] [--repeats 1] [--deterministic] \
        [--profile-closure] [--until-closure] [--threads N] [--cold] \
        [--cpu-extract] [--in-flight] --out DIR
    python -m slam_dynamic_tpu_torch.orbit_trace extract [--frames 200] \
        --out DIR
    python -m slam_dynamic_tpu_torch.orbit_trace compare A.npz B.npz

``run`` tracks the 640x480 orbit world of ``chip_smoke.py`` phase 8
(``io/bench_world.py`` with ``trajectory="orbit"``, a keyframe at least
every 5 frames) through ``System.track_chunk`` at C frames, each chunk
finalized before the next is dispatched (``pipeline_depth=0``), with loop
closing on, and writes ``DIR/orbit_<device>[_det]_<r>.npz``: every
finalized frame's timestamp, pose and map inliers, and after every
keyframe its slot, insertion count, loop result and all keyframe poses.
``--deterministic`` switches on ``torch.use_deterministic_algorithms``
(the deterministic scatter-adds; the line names any operator that has
no deterministic implementation). ``--profile-closure`` runs the first
closing keyframe's loop closing under ``torch.profiler`` and writes the
operators that took the most host and device time to
``DIR/closure_profile.txt``. ``--until-closure`` stops after the chunk
that closes the first loop, as ``chip_smoke.py`` phase 8b does.
``--threads`` sets torch's CPU threads (the CPU's sums follow their
split: runs that differ only in it show how far such rounding moves the
result); the file is then ``orbit_<device>_t<N>_<r>.npz``. ``--cold``
skips the System's warm-up of the loop-closing numerics
(``backend/loop_closing.warm_up``), to time what it saves; each keyframe's
loop-closing wall time is in the file and, for closing keyframes, on the
printed line. ``--cpu-extract`` runs the ORB extractor on the CPU and
moves its keypoints to the device: the rest of the run is the card's,
its input the CPU's keypoints. Each keyframe's loop candidate (or -1)
and the Sim3 gate that rejected it are recorded too. ``--in-flight``
keeps one chunk in flight (``pipeline_depth=1``, ``bench.py``'s form)
and stops at the first LOST frame; the line then gives the frames'
map inliers and the keyframes' frames up to it.

``extract`` runs the extractor on the card and on the CPU on every frame
of the same orbit and writes ``DIR/extract_stages.json``: for each frame
whose keypoints differ, how many differ and, for the first 8 such
frames, each level's stages (pyramid, blur, FAST score, selected cells,
IC angle, descriptors).

``compare`` prints the first frame and keyframe at which two ``run``
files part (pose differences of 1e-6, 1e-4 and 1e-3), and each file's
closures, LOST frames and unaligned ATE.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def _orbit(frames: int):
    from .io.bench_world import bench_world
    return bench_world(frames, 0, trajectory="orbit")


def run(device: str, frames: int, chunk: int, out_path: str,
        profile_to: str | None = None, until_closure: bool = False,
        cold: bool = False, cpu_extract: bool = False,
        in_flight: bool = False) -> dict:
    """One chunked orbit run, recorded into ``out_path`` (.npz); with
    ``until_closure`` it stops after the chunk that closes the first
    loop (and its frames in flight)."""
    import torch
    from .io.evo import ate_rmse
    from .system import System

    seq, gray8, depth16, cfg = _orbit(frames)
    cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, max_frames_between_kf=5,
        pipeline_depth=int(in_flight)))
    from .backend import loop_closing
    from .frontend import extractor, fused
    saved = loop_closing.warm_up
    if cold:
        loop_closing.warm_up = lambda *a: None
    t0 = time.perf_counter()
    try:
        system = System(cfg, device=device)
    finally:
        loop_closing.warm_up = saved
    construct_ms = (time.perf_counter() - t0) * 1e3
    if cpu_extract:
        def extract_on_cpu(image, orb_cfg):
            kp = extractor.extract(image.cpu(), orb_cfg)
            return type(kp)(*(x.to(image.device) for x in kp))
        fused.extract = extract_on_cpu
    detected = {}
    detect = loop_closing.LoopCloser._detect

    def record_detect(self, m, k, hist, seq=None):
        c = detect(self, m, k, hist, seq)
        detected[k] = c
        return c
    loop_closing.LoopCloser._detect = record_detect
    kf_rows, profiled = [], []
    orig = system._on_keyframe

    def on_keyframe(k):
        in_flight = len(system.tracker._pending)
        t_kf = time.perf_counter()
        if profile_to and not profiled and system.tracker.kf_seq >= 10:
            # the first keyframe scored for a loop and every one after it
            # until the first closure
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device == "cuda" else [])
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                orig(k)
                torch.cuda.synchronize() if device == "cuda" else None
                wall = (time.perf_counter() - t0) * 1e3
            if system.last_loop.closed or wall > 1000.0:
                # the first closure, or a slower keyframe before it
                profiled.append(wall)
                _write_profile(prof, wall, profile_to, device)
        else:
            orig(k)
        if device == "cuda":
            torch.cuda.synchronize()
        kf_ms = (time.perf_counter() - t_kf) * 1e3
        m = system.tracker.map
        r = system.last_loop
        lc = system.loop
        kf_rows.append(dict(
            detected=detected.pop(k, -1),
            sim3_fail=lc._last_sim3_fail if lc is not None and not (
                r is not None and r.closed) else "",
            slot=k, seq=system.tracker.kf_seq,
            closed=bool(r is not None and r.closed),
            cand=int(r.matched_kf) if r is not None else -1,
            inliers=int(r.n_inliers) if r is not None else 0,
            in_flight=in_flight, ms=kf_ms,
            kf_R=m.kf_R.cpu().numpy(), kf_t=m.kf_t.cpu().numpy(),
            kf_valid=m.kf_valid.cpu().numpy()))
    system.tracker.on_keyframe = on_keyframe
    ts = [float(t) for t in seq.timestamps]
    stats, i = [], 0
    t0 = time.perf_counter()
    try:
        while i < frames and not (until_closure and any(
                r["closed"] for r in kf_rows)) and not (
                in_flight and any(s.state == "LOST" for s in stats)):
            if system.tracker.state != "OK" or i + chunk > frames:
                stats.append(system.track_rgbd(gray8[i], depth16[i], ts[i]))
                i += 1
            else:
                stats += system.track_chunk(gray8[i:i + chunk],
                                            depth16[i:i + chunk],
                                            ts[i:i + chunk])
                i += chunk
        stats += system.tracker.flush()
    finally:
        fused.extract = extractor.extract
        loop_closing.LoopCloser._detect = detect
    wall = time.perf_counter() - t0
    traj = system.trajectory
    est = np.stack([-np.asarray(R).T @ np.asarray(t) for _, R, t in traj])
    est_w = (seq.R_wc[0] @ est.T).T + seq.t_wc[0]
    ate = float(ate_rmse(est_w, seq.t_wc[:len(est)], align=False))
    fr_ts = np.array([s.frame_id for s in stats])
    np.savez_compressed(
        out_path,
        frame_id=fr_ts,
        state=np.array([s.state for s in stats]),
        inliers=np.array([s.n_inliers_map for s in stats]),
        traj_t=np.array([t for t, _, _ in traj]),
        traj_R=np.stack([np.asarray(R) for _, R, _ in traj]),
        traj_tv=np.stack([np.asarray(t) for _, _, t in traj]),
        kf_slot=np.array([r["slot"] for r in kf_rows]),
        kf_seq=np.array([r["seq"] for r in kf_rows]),
        kf_closed=np.array([r["closed"] for r in kf_rows]),
        kf_cand=np.array([r["cand"] for r in kf_rows]),
        kf_inliers=np.array([r["inliers"] for r in kf_rows]),
        kf_ms=np.array([r["ms"] for r in kf_rows]),
        kf_detected=np.array([r["detected"] for r in kf_rows]),
        kf_R=np.stack([r["kf_R"] for r in kf_rows]),
        kf_t=np.stack([r["kf_t"] for r in kf_rows]),
        kf_valid=np.stack([r["kf_valid"] for r in kf_rows]),
        ate=ate)
    return dict(out=out_path, wall_s=wall, ate_mm=ate * 1e3,
                construct_ms=construct_ms,
                lost=sum(s.state == "LOST" for s in stats),
                closures=[(r["seq"], r["cand"], r["inliers"],
                           r["in_flight"], round(r["ms"], 1))
                          for r in kf_rows if r["closed"]],
                candidates=[(r["seq"], r["detected"], r["sim3_fail"])
                            for r in kf_rows if r["detected"] >= 0],
                **(dict(inliers=[(s.frame_id, s.state, s.n_inliers_map)
                                 for s in stats],
                        keyframe_frames=[s.frame_id for s in stats
                                         if s.is_keyframe])
                   if in_flight else {}),
                closure_ms=profiled)


def _write_profile(prof, wall_ms: float, path: str, device: str):
    ka = prof.key_averages()
    lines = [f"the first closing keyframe's loop closing: {wall_ms:.1f} ms "
             f"wall, under torch.profiler"]
    key = "self_cpu_time_total"
    lines.append("top operators by self host time (ms, calls):")
    for e in sorted(ka, key=lambda e: -getattr(e, key))[:25]:
        lines.append(f"  {e.key}: {getattr(e, key) / 1e3:.1f}, {e.count}")
    if device == "cuda":
        dkey = next((k for k in ("self_device_time_total",
                                 "self_cuda_time_total")
                     if hasattr(ka[0], k)), None)
        if dkey:
            tot = sum(getattr(e, dkey) for e in ka) / 1e3
            lines.append(f"device time, all operators: {tot:.1f} ms; top "
                         f"by self device time (ms, calls):")
            for e in sorted(ka, key=lambda e: -getattr(e, dkey))[:15]:
                lines.append(f"  {e.key}: {getattr(e, dkey) / 1e3:.2f}, "
                             f"{e.count}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def extract_stages(frames: int, dev: str = "cuda", staged: int = 8
                   ) -> list:
    """The extractor on ``dev`` and the CPU on each frame of the
    ``frames``-frame orbit: one dict per frame whose keypoints differ,
    the first ``staged`` of them stage by stage."""
    import torch
    from .frontend.extractor import extract, level_budgets
    from .ops import fast, orb, pyramid

    _, gray8, _, cfg = _orbit(frames)
    oc = cfg.orb
    out = []
    for i in range(frames):
        img = {"cpu": torch.from_numpy(gray8[i]).float(),
               "dev": torch.from_numpy(gray8[i]).to(dev).float()}
        kp = {d: extract(img[d], oc) for d in img}
        a, b = kp["cpu"], kp["dev"]
        same = [bool(torch.equal(getattr(a, f), getattr(b, f).cpu()))
                for f in ("xy", "level", "angle", "desc", "valid")]
        if all(same):
            continue
        row = dict(frame=i, fields_equal=dict(zip(
            ("xy", "level", "angle", "desc", "valid"), same)),
            n_diff=int(((a.xy != b.xy.cpu()).any(-1)
                        | (a.desc != b.desc.cpu()).any(-1)
                        | (a.angle != b.angle.cpu())).sum()))
        out.append(row)
        if len(out) > staged:
            continue
        lv = {d: pyramid.build_pyramid(img[d], oc.n_levels, oc.scale_factor)
              for d in img}
        for l, budget in enumerate(level_budgets(oc)):
            la, lb = lv["cpu"][l], lv["dev"][l].cpu()
            st = dict(level=l, pyramid_max_abs=float((la - lb).abs().max()))
            ba = pyramid.gaussian_blur(la)
            bb = pyramid.gaussian_blur(lv["dev"][l]).cpu()
            st["blur_max_abs"] = float((ba - bb).abs().max())
            sa = fast.detect(la, oc.ini_th_fast, oc.min_th_fast,
                             border=oc.edge_threshold, cell=oc.cell_size)
            sb = fast.detect(lv["dev"][l], oc.ini_th_fast, oc.min_th_fast,
                             border=oc.edge_threshold, cell=oc.cell_size)
            st["fast_max_abs"] = float((sa - sb.cpu()).abs().max())
            xa, _, _ = orb.select_topk_cells(sa, budget, cell=oc.cell_size,
                                             per_cell=4)
            xb, _, _ = orb.select_topk_cells(sb, budget, cell=oc.cell_size,
                                             per_cell=4)
            st["cells_equal"] = bool(torch.equal(xa, xb.cpu()))
            # the IC angle and descriptors on the CPU's keypoints, each
            # device on its own image
            an_a = orb.ic_angles(la, xa)
            an_b = orb.ic_angles(lv["dev"][l], xa.to(dev)).cpu()
            st["angle_max_abs"] = float((an_a - an_b).abs().max())
            da = orb.brief_descriptors(ba, xa, an_a)
            db = orb.brief_descriptors(
                pyramid.gaussian_blur(lv["dev"][l]), xa.to(dev),
                an_a.to(dev)).cpu()
            st["desc_rows_differ_same_angle"] = int(
                (da != db).any(-1).sum())
            row.setdefault("levels", []).append(st)
    return out


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def compare(a_path: str, b_path: str) -> dict:
    a, b = _load(a_path), _load(b_path)
    res = {}
    for name, z in (("a", a), ("b", b)):
        res[name] = dict(
            ate_mm=float(z["ate"]) * 1e3,
            lost=int((z["state"] == "LOST").sum()),
            closures=[(int(s), int(c), int(n)) for s, c, n, x in zip(
                z["kf_seq"], z["kf_cand"], z["kf_inliers"], z["kf_closed"])
                if x])
    n = min(len(a["traj_t"]), len(b["traj_t"]))
    d = np.maximum(np.abs(a["traj_R"][:n] - b["traj_R"][:n]).max((1, 2)),
                   np.abs(a["traj_tv"][:n] - b["traj_tv"][:n]).max(1))
    for th in (1e-6, 1e-4, 1e-3, 1e-2):
        idx = np.nonzero(d > th)[0]
        res[f"first_frame_pose_diff_gt_{th:g}"] = (
            float(a["traj_t"][idx[0]]) if len(idx) else None)
    nk = min(len(a["kf_seq"]), len(b["kf_seq"]))
    same_slots = [int(j) for j in range(nk)
                  if a["kf_slot"][j] != b["kf_slot"][j]
                  or a["kf_seq"][j] != b["kf_seq"][j]]
    res["first_keyframe_event_differs"] = same_slots[0] if same_slots \
        else None
    kd = []
    for j in range(nk):
        v = a["kf_valid"][j] & b["kf_valid"][j]
        kd.append(float(max(np.abs(a["kf_R"][j][v] - b["kf_R"][j][v]).max(
            initial=0.0), np.abs(a["kf_t"][j][v] - b["kf_t"][j][v]).max(
            initial=0.0))))
    res["keyframe_pose_max_abs_by_seq"] = {
        int(a["kf_seq"][j]): round(x, 7) for j, x in enumerate(kd)}
    res["max_frame_pose_diff_by_10_frames"] = [
        round(float(d[j:j + 10].max()), 7) for j in range(0, n, 10)]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--device", default="cuda")
    r.add_argument("--frames", type=int, default=200)
    r.add_argument("--chunk", type=int, default=6)
    r.add_argument("--repeats", type=int, default=1)
    r.add_argument("--deterministic", action="store_true")
    r.add_argument("--profile-closure", action="store_true")
    r.add_argument("--until-closure", action="store_true")
    r.add_argument("--threads", type=int, default=0)
    r.add_argument("--cold", action="store_true")
    r.add_argument("--cpu-extract", action="store_true")
    r.add_argument("--in-flight", action="store_true")
    r.add_argument("--out", required=True)
    e = sub.add_parser("extract")
    e.add_argument("--frames", type=int, default=200)
    e.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "compare":
        print(json.dumps(compare(args.a, args.b)))
        return 0
    os.makedirs(args.out, exist_ok=True)
    if args.cmd == "extract":
        rows = extract_stages(args.frames)
        with open(os.path.join(args.out, "extract_stages.json"), "w") as f:
            json.dump(rows, f, indent=1)
        print(json.dumps(dict(
            frames=args.frames, frames_differing=len(rows),
            keypoints_differing=sum(r["n_diff"] for r in rows),
            first=rows[0] if rows else None)))
        return 0
    if args.deterministic:
        import torch
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    tag = args.device + ("_det" if args.deterministic else "") + (
        "_cold" if args.cold else "") + (
        "_cpuext" if args.cpu_extract else "") + (
        "_inflight" if args.in_flight else "")
    if args.threads:
        import torch
        torch.set_num_threads(args.threads)
        tag += f"_t{args.threads}"
    import warnings
    for rep in range(args.repeats):
        prof = os.path.join(args.out, "closure_profile.txt") \
            if args.profile_closure and rep == 0 else None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = run(args.device, args.frames, args.chunk,
                      os.path.join(args.out, f"orbit_{tag}_{rep}.npz"), prof,
                      args.until_closure, args.cold, args.cpu_extract,
                      args.in_flight)
        # the operators that have no deterministic implementation
        res["nondeterministic_ops"] = sorted({
            str(w.message).split(" does not have")[0] for w in caught
            if "deterministic implementation" in str(w.message)})
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
