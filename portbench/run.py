"""Run one cell of the port's benchmark once.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration and workload files, renders the cell's
world on the device from the seed, builds the program
(``slam_dynamic_tpu_torch``), warms up the cell's own shapes, then drives
the cell's entry for ``--seconds`` seconds and finalizes what is in
flight. After the window it frees the program's state, checks what the
window produced against ``portbench/reference.py`` and prints one JSON
line: ``correct``, ``attempted`` (lane-frames submitted in the window),
``failed`` (those not tracked OK), ``metrics`` (with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones, read in
a profiled slice of the window), ``device`` and, traced, ``breakdown``;
``checks`` last, each number compared beside its limit, also printed as
the last lines of standard error.

It needs CUDA and exits nonzero, printing no result, without it, when the
program or its files are missing, or when JAX or the JAX package was
imported.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"
# every build and kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
os.environ["USE_FLAX"] = "0"

# modules that no process of the benchmark may hold, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "slam_dynamic_tpu")


def forbidden_modules(modules=None):
    """The forbidden top-level names present in ``modules`` (default
    ``sys.modules``), each compared whole."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def one_thread():
    """Load from one process with few threads: the program is bound by
    its host thread, and idle worker threads only add noise on a shared
    host. Call before torch is imported."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def _checks(wl: dict, readings: dict) -> dict:
    """Each compared number beside its limit: ``max`` (at most) or
    ``min`` (at least), from the workload's ``limits``."""
    out = {}
    for name, lim in wl["limits"].items():
        v = readings.get(name)
        kind, bound = ("min", lim["min"]) if "min" in lim \
            else ("max", lim["max"])
        out[name] = {"value": v, kind: bound}
    return out


def _holds(check: dict) -> bool:
    v = check["value"]
    if v is None or v != v:
        return False
    return v >= check["min"] if "min" in check else v <= check["max"]


class _GcPauses:
    """A ``gc.callbacks`` entry that sums the collector's pauses."""

    def __init__(self):
        self.total_s, self._t = 0.0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.total_s += time.perf_counter() - self._t
            self._t = None


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", bench=None, override=None, t_start=None):
    """One run of cell ``name``. ``override(wl, cfg)`` may change the
    workload and configuration dicts (the tests shrink the world).
    Returns the result dict (without printing)."""
    import resource

    import numpy as np
    import torch

    from portbench import drive, reference, spec
    from portbench.record import Recorder
    from portbench.trace import Profile, summarize
    from portbench.world import Renderer

    t_start = T_START if t_start is None else t_start
    bench = bench or spec.load_benchmark()
    c = spec.cell(bench, name)
    wl, cfg_file = c["workload"], c["config"]
    if override is not None:
        wl, cfg_file = override(wl, cfg_file)
    dev = torch.device(device)
    cfg = spec.system_config(cfg_file, wl)
    cam = spec.camera_dict(cfg_file)

    # -- set-up: the world, the program, its warm-up -------------------
    rgbd = cfg_file["sensor"] == "rgbd"
    world = Renderer(cam, wl["world"], seed, dev).render(
        cfg_file.get("DepthMapFactor") if rgbd else None,
        baseline=cam["bf"] / cam["fx"])
    world.depth_m = world.depth_m.cpu()
    boxed = None
    if wl.get("boxed") is not None:
        boxed = np.zeros(len(world.moving), bool)
        boxed[wl["boxed"]] = True
    rec = Recorder(seed, wl.get("sample", {}))
    rec.install()
    try:
        drv = drive.Driver(wl, cfg, world, dev, boxed=boxed)
        drv.warm_up(int(wl.get("warm_steps", 3)))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        # what set-up made stays: the collector's passes in the window
        # walk only what the window makes
        gc.collect()
        gc.freeze()
        profile = Profile(wl.get("trace", {})) if trace else None
        setup_s = time.perf_counter() - t_start
        loops0 = drv.loop_counts()
        pauses = _GcPauses()
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.append(pauses)
        try:
            win = drive.run_window(drv, seconds, rec, seed,
                                   wl.get("sample", {}), profile=profile)
        finally:
            gc.callbacks.remove(pauses)
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
    finally:
        rec.uninstall()
        gc.unfreeze()

    # -- what the window produced, read from the program ----------------
    mem_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    lanes = drv.B
    first, last = win["first"], win["last"]
    attempted = (last - first) * lanes
    n_ok = sum(st.state == "OK" for st in win["stats"])
    failed = max(0, attempted - n_ok)
    wall = win["t_end"] - win["t0"]
    loops1 = drv.loop_counts()
    trajs = drv.trajectories()
    traj_lanes, lane_rows = [], []
    for b, traj in enumerate(trajs):
        rows = [(round(ts * world.fps), R, t) for ts, R, t in traj]
        rows = [r for r in rows if first <= r[0] < last]
        lane_rows.append(len({r[0] for r in rows}))
        idx = np.array([r[0] for r in rows], np.int64)
        w = np.array([world.index(i + drv.offsets[b]) for i in idx],
                     np.int64)
        w0 = world.index(drv.offsets[b])
        traj_lanes.append((np.array([r[1] for r in rows], np.float64)
                           .reshape(-1, 3, 3),
                           np.array([r[2] for r in rows], np.float64)
                           .reshape(-1, 3),
                           world.R_wc[w], world.t_wc[w], idx,
                           world.R_wc[w0], world.t_wc[w0]))
    samples = []
    for b, ts, xy, valid, depth in win["frames"]:
        w = world.index(round(ts * world.fps) + drv.offsets[b])
        samples.append((xy.cpu(), valid.cpu(), depth.cpu(),
                        world.depth_m[w]))
    snaps = [(world.index(i), boxes, status)
             for i, boxes, status in win["snaps"]]
    step_ms = (win["ends"] - win["starts"]) * 1e3
    in_slice = np.asarray(win["in_slice"], bool)
    n_steps = len(step_ms)
    drv_frames_per_step = drv.frames_per_step
    lat = drive.latencies_ms(win, int(wl.get("pipeline_depth", 1)),
                             drv_frames_per_step) if n_steps else []
    summary = None
    if profile is not None:
        summary = summarize(profile.events())
        k1_work = rec.k1_slice_work()
        profile.prof = None
    del drv
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    leaked = forbidden_modules()

    # -- the check -------------------------------------------------------
    readings = reference.trajectory_check(traj_lanes)
    # every lane answers every frame of the window, and answers OK
    readings["failed"] = int(failed)
    readings["untracked_frames"] = int(sum(
        (last - first) - n for n in lane_rows))
    readings["lane_frames_min"] = int(min(lane_rows)) if lane_rows else 0
    smp = wl.get("sample", {})
    readings.update(reference.depth_check(
        samples, float(smp.get("depth_quantile", 0.9)),
        bf=None if rgbd else cam["bf"],
        disparity_quantile=float(smp.get("disparity_quantile", 0.5))))
    k1 = [reference.k1_mismatches(call) for call in rec.k1_calls]
    readings["k1_calls"] = len(k1)
    readings["k1_mismatch"] = int(sum(k1))
    readings["control_k1_mismatch"] = int(sum(
        reference.k1_mismatches(call, gate_dtype=torch.bfloat16)
        for call in rec.k1_calls))
    k2 = [reference.k2_mismatches(call) for call in rec.k2_calls]
    readings["k2_calls"] = len(k2)
    readings["k2_mismatch"] = int(sum(k2))
    readings["control_k2_mismatch"] = int(sum(
        reference.k2_mismatches(call, int8=True) for call in rec.k2_calls))
    if boxed is not None:
        readings.update(reference.status_check(
            snaps, world.boxes, world.box_valid, world.moving))
    checks = _checks(wl, readings)
    correct = all(_holds(ch) for ch in checks.values())

    # -- metrics ---------------------------------------------------------
    metrics = {}
    if not trace:
        values = {"fps": attempted / wall if wall > 0 else None,
                  "setup_s": setup_s}
        for m in c["end_to_end"]:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    elif summary is not None:
        ctx = dict(cell=name, workload=wl, trace=summary,
                   slice_frames=profile.frames, k1_work=k1_work,
                   frames_per_step=drv_frames_per_step,
                   k2_work=list(rec.k2_work),
                   step_ms=step_ms[~in_slice],
                   latency_ms=np.asarray(lat)[~np.repeat(
                       in_slice, drv_frames_per_step)] if n_steps else [])
        for m in c["per_layer"]:
            v = spec.load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": int(c["entry"]["chips"]),
                   "memory_peak_bytes": int(mem_peak)}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_ns"] / 1e9
        device_info["window_s"] = summary["window_ns"] / 1e9
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        readings["slice_frames"] = profile.frames
        readings["slice_host_s"] = profile.t1 - profile.t0
        # the profiler's own cost shows in the slice's steps, and in the
        # idle share of the slice itself
        readings["slice_step_ms_mean"] = float(step_ms[in_slice].mean()) \
            if in_slice.any() else None
        readings["slice_idle_pct"] = 100.0 * (
            1.0 - summary["busy_ns"] / summary["window_ns"]) \
            if summary["window_ns"] else None
    readings["keyframes"] = int(sum(bool(st.is_keyframe)
                                    for st in win["stats"]))
    readings["step_ms_mean"] = float(step_ms.mean()) if n_steps else None
    readings["step_ms_max"] = float(step_ms.max()) if n_steps else None
    readings["setup_s"] = setup_s
    readings["window_s"] = wall
    readings["steps"] = n_steps
    # what moves a run's rate besides the program: the process's own CPU
    # time (below the window when it waits), the collector's pauses
    readings["window_cpu_s"] = (ru1.ru_utime + ru1.ru_stime
                                - ru0.ru_utime - ru0.ru_stime)
    readings["gc_pause_ms"] = pauses.total_s * 1e3
    readings["loop_candidates"] = loops1[0] - loops0[0]
    readings["loops_closed"] = loops1[1] - loops0[1]
    result["readings"] = readings
    result["checks"] = checks
    result["forbidden_modules"] = leaked
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    one_thread()
    import torch

    from portbench import spec
    bench = spec.load_benchmark()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"portbench: no cell {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        print(f"portbench: the cell needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), bench=bench)
    leaked = result.pop("forbidden_modules")
    if leaked:
        print(f"portbench: the process imported {', '.join(leaked)}",
              file=sys.stderr)
        return 3
    for k, ch in result["checks"].items():
        lim = ("<= " + str(ch["max"])) if "max" in ch \
            else (">= " + str(ch["min"]))
        print(f"check {k}: {ch['value']} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
