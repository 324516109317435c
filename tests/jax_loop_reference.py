"""The JAX package on the 640x480 orbit world that ``chip_smoke.py``
phase 8 runs through the port: the reference outcome of a loop closure
at full width, on the CPU.

    python tests/jax_loop_reference.py [--frames 100] [--turns 0]
        [--chunk 1] [--in-flight 0|1] [--closing on|off|both]

The world is ``SynthConfig(trajectory="orbit")`` (640x480, fx 525;
``--turns`` sets ``orbit_turns``, 0 the single circuit) with
the bench configuration (1000 ORB features, 128 keyframes, 32768
landmarks, 2048 keypoint slots) and a keyframe at least every 5 frames
(``tests/test_e2e_loop_reloc.py:dense_kf``), tracked per frame (the
defaults, phase 8's form) or, with ``--chunk C``, by
``System.track_chunk`` at C frames, each chunk finalized before the
next is dispatched (``--in-flight 0``) or with one chunk in flight
(``1``, bench.py's form); with loop closing on, off or both.
Prints, for each, the keyframes that closed a loop (slot, seq, the
candidate, inliers), the LOST frames, the frame of the first LOST and
the unaligned ATE in metres, as one JSON line.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from slam_dynamic_tpu import config as C  # noqa: E402
from slam_dynamic_tpu.io.evo import ate_rmse  # noqa: E402
from slam_dynamic_tpu.io.synthetic import SynthConfig, generate  # noqa: E402
from slam_dynamic_tpu.system import System  # noqa: E402


def orbit_config(scfg, loop_on: bool, in_flight: int):
    return C.SystemConfig(
        camera=C.CameraConfig(fx=scfg.fx, fy=scfg.fy, cx=scfg.cx,
                              cy=scfg.cy, bf=scfg.fx * scfg.baseline,
                              width=scfg.width, height=scfg.height,
                              th_depth=120.0, fps=scfg.fps,
                              depth_map_factor=1000.0),
        orb=C.ORBConfig(n_features=1000),
        detector=C.DetectorConfig(mode="off"),
        capacity=C.CapacityConfig(max_keyframes=128, max_landmarks=32768,
                                  max_keypoints=2048, local_ba_keyframes=8,
                                  local_ba_landmarks=2048),
        tracking=C.TrackingConfig(max_frames_between_kf=5,
                                  pipeline_depth=in_flight),
        loop=C.LoopConfig(enabled=loop_on),
        sensor="rgbd")


def run(n_frames: int, chunk: int, loop_on: bool, in_flight: int,
        turns: float = 0.0) -> dict:
    scfg = SynthConfig(n_frames=n_frames, trajectory="orbit",
                       orbit_turns=turns)
    seq = generate(scfg)
    gray8 = np.clip(seq.gray, 0, 255).astype(np.uint8)
    depth16 = np.clip(seq.depth * 1000.0, 0, 65535).astype(np.uint16)
    system = System(orbit_config(scfg, loop_on, in_flight))
    ts = [float(t) for t in seq.timestamps]
    closed, stats, i = [], [], 0
    orig = system._on_keyframe

    def on_keyframe(k):
        orig(k)
        r = system.last_loop
        if r.closed:
            closed.append(dict(slot=int(k), seq=system.tracker.kf_seq,
                               cand=r.matched_kf, inliers=r.n_inliers,
                               total=r.n_total))
    system.tracker.on_keyframe = on_keyframe
    while system.tracker.state != "OK":
        stats.append(system.track_rgbd(gray8[i], depth16[i], ts[i]))
        i += 1
    while i + chunk <= n_frames:
        stats += system.track_chunk(gray8[i:i + chunk], depth16[i:i + chunk],
                                    ts[i:i + chunk])
        i += chunk
    stats += [system.tracker._finalize_one()
              for _ in range(len(system.tracker._pending))]
    est = np.stack([-R.T @ t for _, R, t in system.trajectory])
    est_w = (seq.R_wc[0] @ est.T).T + seq.t_wc[0]
    lost = [s.frame_id for s in stats if s.state == "LOST"]
    return dict(closed=closed, frames=len(est), lost=len(lost),
                first_lost=lost[0] if lost else None,
                keyframes=system.tracker.kf_seq,
                ate_m=float(ate_rmse(est_w, seq.t_wc[:len(est)],
                                     align=False)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--turns", type=float, default=0.0)
    ap.add_argument("--chunk", type=int, default=1)
    ap.add_argument("--in-flight", type=int, choices=(0, 1), default=0)
    ap.add_argument("--closing", choices=("on", "off", "both"),
                    default="both")
    args = ap.parse_args(argv)
    modes = {"on": [True], "off": [False], "both": [True, False]}
    out = {f"closing_{'on' if on else 'off'}": run(
        args.frames, args.chunk, on, args.in_flight, args.turns)
        for on in modes[args.closing]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
