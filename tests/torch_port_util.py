"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
stays on the CPU (tests/conftest.py) and the port runs with
``device="cpu"``, where every kernel wrapper takes its plain version.

Run as a script, it drives the JAX package (or, with ``--package
port``, the port) on the CPU over the 640x480 worlds that
``chip_smoke.py`` phases 10b and 11 drive through the port on the card,
for the reference numbers beside the card's:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_port_util.py \\
        --world stereo-dynamic|mono [--frames N] [--package jax|port]
"""
import dataclasses

import numpy as np
import pytest
import torch

from slam_dynamic_tpu import config as JC
from slam_dynamic_tpu_torch import config as TC
from slam_dynamic_tpu_torch.bench import drive_per_frame, track_entry
from slam_dynamic_tpu_torch.convert import frame_data_from_numpy
from slam_dynamic_tpu_torch.frontend.frame import FrameData as TFrameData
from slam_dynamic_tpu_torch.io.bench_world import detections
from slam_dynamic_tpu_torch.io.synthetic import SynthConfig, generate

# The tests run in several worker processes at once; torch's own thread
# pool per worker only oversubscribes the cores the JAX reference needs.
torch.set_num_threads(1)

SMALL = dict(n_frames=12, width=320, height=240, fx=260.0, fy=260.0,
             cx=159.5, cy=119.5)


def small_world(n_frames=12):
    """The 320x240 synthetic RGB-D world in camera-native dtypes."""
    scfg = SynthConfig(**{**SMALL, "n_frames": n_frames})
    seq = generate(scfg)
    gray8 = np.clip(seq.gray, 0, 255).astype(np.uint8)
    depth16 = np.clip(seq.depth * 1000.0, 0, 65535).astype(np.uint16)
    return scfg, seq, gray8, depth16


def system_config(C, scfg, n_features=600, max_keypoints=1024):
    """The same RGB-D config in either package's dataclasses (``C`` is the
    config module)."""
    return C.SystemConfig(
        camera=C.CameraConfig(fx=scfg.fx, fy=scfg.fy, cx=scfg.cx, cy=scfg.cy,
                              bf=scfg.fx * scfg.baseline, width=scfg.width,
                              height=scfg.height, th_depth=120.0,
                              fps=scfg.fps, depth_map_factor=1000.0),
        orb=C.ORBConfig(n_features=n_features),
        detector=C.DetectorConfig(mode="off"),
        capacity=C.CapacityConfig(max_keyframes=32, max_landmarks=8192,
                                  max_keypoints=max_keypoints,
                                  local_ba_keyframes=8,
                                  local_ba_landmarks=2048),
        sensor="rgbd")


def configs(scfg, **kw):
    return system_config(JC, scfg, **kw), system_config(TC, scfg, **kw)


def to_t(x, dtype=None):
    """numpy/JAX array -> CPU tensor; uint32 becomes its int32 bit view."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def frame_to_t(fd) -> TFrameData:
    """A JAX FrameData -> the port's FrameData."""
    return frame_data_from_numpy(
        {f: np.asarray(getattr(fd, f)) for f in TFrameData._fields}, "cpu")


def map_arrays(m) -> dict:
    """A JAX MapState -> name -> numpy (the input of convert.py)."""
    return {f: np.asarray(getattr(m, f)) for f in m._fields}


def f32(v):
    return torch.tensor(v, dtype=torch.float32)


def asdict(cfg):
    return dataclasses.asdict(cfg)


# --- chunked System runs (tests/test_torch_chunk.py,
# tests/test_torch_bench_world.py) ---

def with_tracking(cfg, **kw):
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking, **kw))


def record_detect(mp, cls, log):
    """Patch ``cls._detect`` (a LoopCloser of either package) to append
    (slot, seq, result, streaks) of every call to ``log``."""
    orig = cls._detect

    def detect(self, m, k, hist, seq=None):
        r = orig(self, m, k, hist, seq)
        log.append((k, seq, r, dict(self.streaks)))
        return r
    mp.setattr(cls, "_detect", detect)


def run_chunked(system, world, n_frames, C=6):
    """``bench.py``'s chunked drive of either package's System: per frame
    until tracking is OK, then chunks of C, then the frames in flight.
    ``world`` is (_, seq, gray8, aux), aux the depth maps, the right
    images (stereo) or None (mono)."""
    _, seq, gray8, aux = world
    track = track_entry(system)
    ts = [float(t) for t in seq.timestamps]
    stats, i = [], 0
    while system.tracker.state != "OK":
        stats.append(track(gray8[i], None if aux is None else aux[i], ts[i]))
        i += 1
    n_chunks = 0
    while i + C <= n_frames:
        stats += system.track_chunk(gray8[i:i + C],
                                    [None] * C if aux is None
                                    else aux[i:i + C], ts[i:i + C])
        i += C
        n_chunks += 1
    while system.tracker._pending:     # flush, keeping every frame's stats
        stats.append(system.tracker._finalize_one())
    est = np.stack([-R.T @ t for _, R, t in system.trajectory])
    return dict(stats=stats, est=est, n_chunks=n_chunks, system=system)


def run_pair(jsystem, tsystem, world, n_frames):
    """run_chunked of the JAX and the port System, each run with its
    ``_detect`` calls under ``"detects"``."""
    from slam_dynamic_tpu.backend.loop_closing import LoopCloser as JLC
    from slam_dynamic_tpu_torch.backend.loop_closing import LoopCloser as TLC
    detects = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        record_detect(mp, JLC, detects["jax"])
        record_detect(mp, TLC, detects["port"])
        runs = {"jax": run_chunked(jsystem, world, n_frames),
                "port": run_chunked(tsystem, world, n_frames)}
    for name in runs:
        runs[name]["detects"] = detects[name]
    return runs


def decisions(run):
    """(frame id, state, keyframe) of every finalized frame."""
    return [(s.frame_id, s.state, s.is_keyframe) for s in run["stats"]]


def check_kfdb(js, ts):
    """Database rows equal where the keyframe's descriptors are equal in
    both maps; the extractors agree on about 99.9% of keypoints, and a
    keyframe with d differing descriptors differs in at most 2d words."""
    bj, bt = js.loop.db, ts.loop.db
    jm, tm = js.tracker.map, ts.tracker.map
    np.testing.assert_array_equal(bt.valid.numpy(), np.asarray(bj.valid))
    n_equal = 0
    for k in np.flatnonzero(np.asarray(bj.valid)):
        dj = np.asarray(jm.kf_kp_desc[k]).view(np.int32)
        vj = np.asarray(jm.kf_kp_valid[k])
        vt = tm.kf_kp_valid[k].numpy()
        differ = (vj != vt) | ((dj != tm.kf_kp_desc[k].numpy()).any(1) & vj)
        wj, wt = np.asarray(bj.word[k]), bt.word[k].numpy()
        if not differ.any():
            n_equal += 1
            np.testing.assert_array_equal(wt, wj)
            np.testing.assert_allclose(bt.weight[k].numpy(),
                                       np.asarray(bj.weight[k]), atol=1e-6,
                                       rtol=0)
        else:
            sj, st = set(wj[wj >= 0]), set(wt[wt >= 0])
            assert len(sj ^ st) <= 2 * int(differ.sum()), k
    assert n_equal >= 0.8 * int(bt.valid.sum())


# --- dynamic-scene System runs (tests/test_torch_dynamic_chunk.py,
# tests/test_torch_dynamic_frame.py) ---

# the 320x240 worlds of tests/test_e2e_dynamic.py
DYNAMIC_WORLDS = {
    "moving": dict(dynamic_object=True, obj_size=1.6, obj_depth=3.0,
                   obj_speed=0.09),
    "static_box": dict(dynamic_object=True, obj_size=1.4, obj_depth=3.5,
                       obj_speed=0.0, obj_x0=0.0, obj_bob=0.0),
}


def dynamic_world(kind, n_frames, **synth):
    """(scfg, seq, gray8, aux): aux the uint16 millimetre depth, or with
    ``stereo=True`` among ``synth`` the uint8 right images."""
    scfg = SynthConfig(**{**SMALL, "n_frames": n_frames},
                       **DYNAMIC_WORLDS[kind], **synth)
    seq = generate(scfg)
    gray8 = np.clip(seq.gray, 0, 255).astype(np.uint8)
    if scfg.stereo:
        return scfg, seq, gray8, np.clip(seq.right, 0, 255).astype(np.uint8)
    depth16 = np.clip(seq.depth * 1000.0, 0, 65535).astype(np.uint16)
    return scfg, seq, gray8, depth16


def dynamic_configs(scfg, detector="precomputed", **dynamic):
    """The RGB-D config of both packages with the detector's mode and the
    dynamic-object options set."""
    out = []
    for C, cfg in zip((JC, TC), configs(scfg)):
        cfg = cfg.replace(detector=C.DetectorConfig(mode=detector))
        out.append(cfg.replace(dynamic=dataclasses.replace(cfg.dynamic,
                                                           **dynamic)))
    return out


def run_dynamic(system, world, n_frames, chunk, use_boxes=True):
    """Either package's System on a dynamic world with its boxes (none
    unless ``use_boxes``): per frame (chunk 1), or per frame until
    tracking is OK and then in chunks of ``chunk``, then the frames in
    flight. Returns the stats, the box statuses after every call with the
    frames finalized in it (``history``: [(frame ids, statuses)]) and the
    trajectory. ``world`` as ``dynamic_world`` returns it; the System's
    sensor picks its entry."""
    _, seq, gray8, aux = world
    track = track_entry(system)
    ts = [float(t) for t in seq.timestamps]
    stats, history, i = [], [], 0

    def boxes(i):
        return detections(seq, i) if use_boxes else None

    def record(new):
        stats.extend(new)
        history.append(([s.frame_id for s in new],
                        tuple(int(x) for x in system.boxes.status)))
    while i < n_frames and (chunk == 1 or system.tracker.state != "OK"):
        record([track(gray8[i], aux[i], ts[i], detections=boxes(i))])
        i += 1
    while i + chunk <= n_frames and chunk > 1:
        record(system.track_chunk(
            gray8[i:i + chunk], aux[i:i + chunk], ts[i:i + chunk],
            detections=[boxes(i + j) for j in range(chunk)]))
        i += chunk
    tail = []
    while system.tracker._pending:
        tail.append(system.tracker._finalize_one())
    record(tail)
    est = np.stack([-R.T @ t for _, R, t in system.trajectory])
    return dict(stats=stats, history=history, est=est, system=system)


def status_by_frame(run):
    """frame id -> the box statuses once that frame was finalized."""
    return {f: st for fids, st in run["history"] for f in fids}


def first_status_difference(rj, rt):
    """The first finalized frame at which the two runs' box statuses
    differ (past the last frame when they never do)."""
    sj, st = status_by_frame(rj), status_by_frame(rt)
    diff = [f for f in sorted(sj) if sj[f] != st.get(f)]
    return diff[0] if diff else max(sj) + 1


def first_status(run, value):
    """Index of the first call after which some box has ``value``."""
    return next(k for k, (_, st) in enumerate(run["history"])
                if value in st)


# --- the orbit world to its first loop closure
# (tests/test_torch_loop_correction.py, tests/test_torch_orbit_chunk.py) ---

def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def orbit_until_closure(system, seq, gray8, depth16, n, chunk=1):
    """Track until the first keyframe that closes a loop, per frame
    (``chunk`` 1) or in chunks after the first OK frame, then the frames
    in flight: [(slot, seq, candidate)] of the closure, the frames'
    states, the unaligned world-frame trajectory, and the keyframe poses
    [K, 3, 3], [K, 3] just before the closing keyframe's loop closing
    with the frames still in flight then (finalized by now)."""
    closed, at_closure = [], {}
    orig = system._on_keyframe

    def hook(k):
        m = system.tracker.map
        before = (_np(m.kf_R), _np(m.kf_t))
        pending = [fr for fr, _, _ in system.tracker._pending]
        orig(k)
        if system.last_loop is not None and system.last_loop.closed:
            closed.append((k, system.tracker.kf_seq,
                           system.last_loop.matched_kf))
            at_closure.update(kf_pose=before, in_flight=pending)
    system.tracker.on_keyframe = hook
    ts = [float(t) for t in seq.timestamps]
    states, i = [], 0
    while i < n and not closed:
        if chunk == 1 or system.tracker.state != "OK" or i + chunk > n:
            states.append(system.track_rgbd(gray8[i], depth16[i], ts[i])
                          .state)
            i += 1
        else:
            states += [s.state for s in system.track_chunk(
                gray8[i:i + chunk], depth16[i:i + chunk], ts[i:i + chunk])]
            i += chunk
    while system.tracker._pending:
        states.append(system.tracker._finalize_one().state)
    est = np.stack([-R.T @ t for _, R, t in system.trajectory])
    return (closed, states, (seq.R_wc[0] @ est.T).T + seq.t_wc[0],
            at_closure)


def check_in_flight_corrected(system, at_closure):
    """The frames in flight when the loop was corrected were finalized
    afterwards: each exported pose is its tracked pose relative to its
    reference keyframe (at dispatch), composed with that keyframe's
    corrected pose; the correction moved those keyframes. Returns the
    number of such frames."""
    t0 = at_closure["kf_pose"][1]
    m = system.tracker.map
    kf_R, kf_t = _np(m.kf_R), _np(m.kf_t)
    poses = {t: (np.asarray(R), np.asarray(tt))
             for t, R, tt in system.trajectory}
    for fr in at_closure["in_flight"]:
        k = fr.ref_kf
        R_rel = fr.np_R @ fr.np_Rk.T
        t_rel = fr.np_t - R_rel @ fr.np_tk
        R, t = poses[fr.timestamp]
        np.testing.assert_allclose(R, R_rel @ kf_R[k], atol=1e-5)
        np.testing.assert_allclose(t, R_rel @ kf_t[k] + t_rel, atol=1e-5)
        # the correction moved the reference keyframe, and the frame with
        # it
        moved = np.linalg.norm(kf_t[k] - t0[k])
        assert moved > 1e-3, (fr.timestamp, k, moved)
        assert np.linalg.norm(t - fr.np_t) > 0.5 * moved
    return len(at_closure["in_flight"])


def check_orbit_closure(chunk):
    """The 320x240 orbit world of tests/test_e2e_loop_reloc.py (100
    frames, a keyframe at least every 5 frames), per frame or in chunks
    (each finalized before the next is dispatched: with a chunk in flight
    the JAX package itself loses this 3.6-degree-a-frame orbit): the first
    loop closes at the same keyframe (slot and insertion count) against
    the same candidate in both packages, every frame OK, and the
    unaligned ATE up to there within max(1 mm, 20%) of JAX's and under
    the JAX test's 0.15 m. Chunked, the closing keyframe is not its
    chunk's last, so the correction runs with frames in flight: as many
    in both packages, each exported with its keyframe's corrected pose
    (check_in_flight_corrected)."""
    from slam_dynamic_tpu.io.evo import ate_rmse as jate
    from slam_dynamic_tpu.system import System as JSystem
    from slam_dynamic_tpu_torch.io.evo import ate_rmse
    from slam_dynamic_tpu_torch.system import System
    n = 100
    seq = generate(SynthConfig(**{**SMALL, "n_frames": n},
                               trajectory="orbit"))
    gray8 = np.clip(seq.gray, 0, 255).astype(np.uint8)
    depth16 = np.clip(seq.depth * 1000.0, 0, 65535).astype(np.uint16)
    jcfg, tcfg = (with_tracking(c, max_frames_between_kf=5)
                  for c in configs(seq.cfg))
    js, tsys = JSystem(jcfg), System(tcfg, device="cpu")
    cj, sj, ej, aj = orbit_until_closure(js, seq, gray8, depth16, n, chunk)
    ct, st, et, at = orbit_until_closure(tsys, seq, gray8, depth16, n, chunk)
    assert ct == cj and len(ct) == 1, (ct, cj)
    # chunked, the loop is corrected with frames of the chunk in flight
    n_flight = [check_in_flight_corrected(s, a)
                for s, a in ((js, aj), (tsys, at))]
    assert n_flight[0] == n_flight[1] and (chunk == 1) == (n_flight[1] == 0)
    assert st == sj == ["OK"] * len(sj)
    ate_j = jate(ej, seq.t_wc[:len(ej)], align=False)
    ate_t = ate_rmse(et, seq.t_wc[:len(et)], align=False)
    assert ate_t < 0.15 and abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), \
        (ate_t, ate_j)


# --- the JAX package on the 640x480 worlds of chip_smoke.py's phases 10b
# and 11 (python tests/torch_port_util.py, below) ---

def jax_config(cfg):
    """Either package's ``SystemConfig`` as the JAX package's, field for
    field."""
    import typing

    def build(cls, value):
        hints = typing.get_type_hints(cls, vars(JC))
        kw = {}
        for f in dataclasses.fields(cls):
            v = value[f.name]
            if dataclasses.is_dataclass(hints[f.name]):
                v = build(hints[f.name], v)
            elif isinstance(v, list):
                v = tuple(v)
            kw[f.name] = v
        return cls(**kw)
    return build(JC.SystemConfig, dataclasses.asdict(cfg))


def jax_init_samples(seed, ok):
    """The H and F minimal sets JAX's mono bootstrap draws from ``seed``
    (``jax.random.split(PRNGKey(seed))``) given the port's match mask
    ``ok``: the port Tracker's ``init_sample_fn``."""
    import jax
    import jax.numpy as jnp
    from slam_dynamic_tpu.ops import ransac as jr
    kh, kf = jax.random.split(jax.random.PRNGKey(seed))
    m = jnp.asarray(ok.cpu().numpy())
    P = ok.shape[0]
    return tuple(torch.from_numpy(np.array(
        jr._sample_indices(key, 256, k, P, m))).to(ok.device)
        for key, k in ((kh, 4), (kf, 8)))


def _reference(argv=None):
    """The JAX package (or the port), on the CPU, on the worlds chip_smoke.py
    drives per frame: ``--world stereo-dynamic`` (phase 10b: the stereo
    pair of the moving-object world, ``track_stereo(detections=)``,
    classification on every 2nd frame, one frame in flight) or ``--world
    mono`` (phase 11: ``track_mono``). Prints one JSON line: LOST and
    not-OK frames, the first OK frame, the first frame with a box
    confirmed dynamic, and the ATE in metres (Sim3-aligned for mono, as
    chip_smoke.py reports it)."""
    import argparse
    import json
    import time

    import jax
    jax.config.update("jax_platforms", "cpu")
    from slam_dynamic_tpu.io.evo import ate_rmse
    from slam_dynamic_tpu.system import System
    from slam_dynamic_tpu_torch.io.bench_world import bench_world
    from slam_dynamic_tpu_torch.system import System as PortSystem

    ap = argparse.ArgumentParser(description=_reference.__doc__)
    ap.add_argument("--world", choices=("stereo-dynamic", "mono"),
                    required=True)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--jax-samples", action="store_true",
                    help="the port's mono bootstrap draws JAX's samples")
    args = ap.parse_args(argv)
    dynamic = args.world == "stereo-dynamic"
    n = args.frames or (30 if dynamic else 50)
    world = bench_world(n, dynamic=dynamic,
                        sensor="stereo" if dynamic else "mono")
    cfg = world[3]
    if dynamic:
        cfg = cfg.replace(
            tracking=dataclasses.replace(cfg.tracking, pipeline_depth=1),
            dynamic=dataclasses.replace(cfg.dynamic, classify_every=2))
    t0 = time.perf_counter()
    system = System(jax_config(cfg)) if args.package == "jax" else \
        PortSystem(cfg, device="cpu")
    if args.jax_samples:
        system.tracker.init_sample_fn = jax_init_samples
    r = drive_per_frame(system, world, n, dynamic)
    seq, est = world[0], r["est"]
    i0 = n - len(est)
    ate = ate_rmse(est, seq.t_wc[i0:i0 + len(est)], with_scale=not dynamic)
    print(json.dumps({
        "package": args.package, "world": args.world, "frames": n,
        "lost": r["states"].count("LOST"),
        "not_ok": sum(s != "OK" for s in r["states"]),
        "first_ok": r["first_ok"], "first_dynamic": r["first_dynamic"],
        "ate_m": float(ate), "cpu_s": round(time.perf_counter() - t0, 1)}))


if __name__ == "__main__":
    _reference()
