"""Why the chunked orbit with a chunk in flight makes no keyframe after a
point: the 320x240 orbit world of ``tests/test_e2e_loop_reloc.py`` (100
frames, a keyframe at least every 5 frames) through ``track_chunk`` at
C = 6 with one chunk in flight (``pipeline_depth=1``), in either package,
on the CPU, up to its first LOST frame.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/orbit_in_flight.py \
        --package jax|port

Prints one JSON line: every finalized frame's (frame, state, map
inliers, keyframe), every keyframe decision the Tracker evaluated
(frames since the last keyframe, map inliers, the last keyframe's, the
close bound and unbound counts, the answer) and every keyframe made, and
the frames that went through the BoW fallback (``_bow_fallback``: their
local-map inliers under ``min_inliers_localmap``, recovered against the
reference keyframe, no keyframe decision).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--chunk", type=int, default=6)
    args = ap.parse_args(argv)
    from torch_port_util import SMALL, configs, drain, with_tracking
    from slam_dynamic_tpu_torch.io.synthetic import SynthConfig, generate
    n, C = args.frames, args.chunk
    seq = generate(SynthConfig(**{**SMALL, "n_frames": n},
                               trajectory="orbit"))
    gray8 = np.clip(seq.gray, 0, 255).astype(np.uint8)
    depth16 = np.clip(seq.depth * 1000.0, 0, 65535).astype(np.uint16)
    jcfg, tcfg = (with_tracking(c, max_frames_between_kf=5,
                                pipeline_depth=1)
                  for c in configs(seq.cfg))
    if args.package == "jax":
        from slam_dynamic_tpu.system import System as JSystem
        system = JSystem(jcfg)
    else:
        from slam_dynamic_tpu_torch.system import System
        system = System(tcfg, device="cpu")
    tr = system.tracker
    decisions, made, fallback = [], [], []
    need, create, bow = (tr._need_keyframe_counts, tr._create_keyframe,
                         tr._bow_fallback)

    def need_spy(n_map, close_bound, close_unbound):
        r = need(n_map, close_bound, close_unbound)
        decisions.append(dict(
            since_kf=tr.frames_since_kf, n_map=int(n_map),
            last_kf_inliers=int(tr.last_kf_inliers),
            close_bound=int(close_bound), close_unbound=int(close_unbound),
            need=bool(r)))
        return r

    def create_spy(frame, n_map):
        before = tr.kf_seq
        create(frame, n_map)
        made.append((int(frame.frame_id), tr.kf_seq > before))

    def bow_spy(frame, *a):
        rec = bow(frame, *a)
        fallback.append((int(frame.frame_id), rec is not None))
        return rec
    tr._need_keyframe_counts = need_spy
    tr._create_keyframe = create_spy
    tr._bow_fallback = bow_spy
    ts = [float(t) for t in seq.timestamps]
    sts, i = [], 0
    t0 = time.time()
    while i < n and not any(s.state == "LOST" for s in sts):
        if tr.state != "OK" or i + C > n:
            sts.append(system.track_rgbd(gray8[i], depth16[i], ts[i]))
            i += 1
        else:
            sts += system.track_chunk(gray8[i:i + C], depth16[i:i + C],
                                      ts[i:i + C])
            i += C
    sts += drain(tr)
    print(json.dumps(dict(
        package=args.package, seconds=round(time.time() - t0, 1),
        frames=[(s.frame_id, s.state, s.n_inliers_map, s.is_keyframe)
                for s in sts],
        decisions=decisions, keyframes=made, bow_fallback=fallback)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
