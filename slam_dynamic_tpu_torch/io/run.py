"""The dataset CLI: SLAM over a dataset, with its exports.

Port of ``slam_dynamic_tpu/io/run.py`` (``build_config`` :25,
``make_dataset`` :43, ``_write_synth_groundtruth`` :75, ``main`` :89),
the reference's example programs (stereo_kitti.cc, rgbd_my.cc,
mono_tum.cc): a per-frame loop through the sensor's track entry, the
median and mean track time, the frame and keyframe trajectories, the
dense map (``--ply``, RGB-D), the map checkpoint (``--save-map``,
resumed by ``--load-map``), the headless AR overlay (``--ar``) and, on
the synthetic world, its ground truth and the ATE. The files, the
``summary.json`` keys and the JSON line on standard output are the JAX
CLI's. It runs on the card; ``--device cpu`` (in place of the JAX CLI's
``--cpu``) runs the plain PyTorch path on the CPU.

Usage:
  python -m slam_dynamic_tpu_torch.io.run --dataset synthetic --frames 60 \\
      --sensor rgbd --dynamic --out runs/run1
  python -m slam_dynamic_tpu_torch.io.run --dataset tum --path <dir> \\
      --yaml <cfg>
  python -m slam_dynamic_tpu_torch.io.run --dataset kitti --path <seq_dir> \\
      --yaml Examples/Stereo/KITTI04-12.yaml --sensor stereo

``--dataset rosbag`` is not ported yet (ROADMAP item 21).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch


def build_config(args):
    from ..config import CameraConfig, SystemConfig, load_yaml
    if args.yaml:
        cfg = load_yaml(args.yaml)
    elif args.dataset == "synthetic":
        from .synthetic import SynthConfig
        s = SynthConfig()
        cfg = SystemConfig(camera=CameraConfig(
            fx=s.fx, fy=s.fy, cx=s.cx, cy=s.cy, bf=s.fx * s.baseline,
            width=s.width, height=s.height, th_depth=120.0))
    else:
        cfg = SystemConfig()
    det_mode = "precomputed" if args.dynamic else "off"
    return cfg.replace(sensor=args.sensor,
                       detector=cfg.detector.__class__(mode=det_mode))


def make_dataset(args, cfg):
    from .datasets import (EurocDataset, KittiStereo, SyntheticDataset,
                           TumRGBD)
    if args.dataset == "tum":
        return TumRGBD(args.path, cfg.camera.depth_map_factor,
                       boxes_dir=args.boxes, masks_dir=args.masks)
    if args.dataset == "kitti":
        return KittiStereo(args.path, boxes_dir=args.boxes)
    if args.dataset == "euroc":
        return EurocDataset(args.path, stereo=(args.sensor == "stereo"),
                            yaml_path=args.yaml or None)
    if args.dataset == "rosbag":
        raise NotImplementedError(
            "the rosbag reader is not ported yet (ROADMAP item 21)")
    from .synthetic import SynthConfig, generate
    s = SynthConfig(n_frames=args.frames,
                    dynamic_object=args.dynamic,
                    stereo=(args.sensor == "stereo"),
                    trajectory=args.trajectory)
    return SyntheticDataset(generate(s), use_boxes=args.dynamic,
                            stereo=(args.sensor == "stereo"))


def _write_synth_groundtruth(path: str, seq):
    """TUM-format ground truth from the synthetic world's exact poses
    (R_wc / t_wc are world-from-camera already: no inversion)."""
    from ..utils import se3
    q_all = se3.quat_from_rot(torch.as_tensor(
        np.asarray(seq.R_wc), dtype=torch.float32)).numpy()
    with open(path, "w") as f:
        for i in range(len(seq.timestamps)):
            q, t = q_all[i], seq.t_wc[i]
            f.write(f"{float(seq.timestamps[i]):.6f} "
                    f"{t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m slam_dynamic_tpu_torch.io.run",
        description="SLAM over a dataset on the card (or the CPU), with "
                    "its trajectory, dense map and map checkpoint.")
    ap.add_argument("--dataset",
                    choices=["synthetic", "tum", "kitti", "euroc",
                             "rosbag"],
                    default="synthetic")
    ap.add_argument("--path", default="")
    ap.add_argument("--yaml", default="")
    ap.add_argument("--sensor", choices=["mono", "stereo", "rgbd"],
                    default="rgbd")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--dynamic", action="store_true")
    ap.add_argument("--trajectory", default="sweep")
    ap.add_argument("--rgb-topic", default="/camera/rgb/image_raw",
                    help="rosbag: gray/rgb image topic (ref ros_rgbd.cc; "
                         "the rosbag reader is not ported yet)")
    ap.add_argument("--depth-topic",
                    default="/camera/depth_registered/image_raw",
                    help="rosbag: registered depth topic")
    ap.add_argument("--left-topic", default="/camera/left/image_raw",
                    help="rosbag stereo: left topic (ref ros_stereo.cc)")
    ap.add_argument("--right-topic", default="/camera/right/image_raw",
                    help="rosbag stereo: right topic")
    ap.add_argument("--boxes", default=None, help="precomputed boxes dir")
    ap.add_argument("--masks", default=None, help="precomputed masks dir")
    ap.add_argument("--out", default="slam_run",
                    help="output directory (default: ./slam_run)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (the default) needs a card; cpu runs the "
                         "plain PyTorch path")
    ap.add_argument("--ply", action="store_true", help="export dense map")
    ap.add_argument("--save-map", default=None, metavar="NPZ",
                    help="write the sparse map checkpoint after the run")
    ap.add_argument("--load-map", default=None, metavar="NPZ",
                    help="resume from a map checkpoint (starts in "
                         "relocalization)")
    ap.add_argument("--skip", type=int, default=0,
                    help="skip the first N frames (pair with --load-map to "
                         "resume mid-sequence)")
    ap.add_argument("--log-frames", action="store_true",
                    help="write per-frame metrics (state, inliers, ms) to "
                         "<out>/frames.jsonl")
    ap.add_argument("--realtime", action="store_true",
                    help="pace frames to the dataset timestamps (the "
                         "reference examples' usleep pacing, "
                         "Examples/Stereo/stereo_kitti.cc:147-154)")
    ap.add_argument("--ar", type=int, default=0, metavar="N",
                    help="AR demo (headless ViewerAR analog, ref Examples/"
                         "ROS/ORB_SLAM2/src/AR/): detect a dominant plane "
                         "from the map, anchor a virtual cube on it, and "
                         "write every Nth frame with the cube wireframe "
                         "rendered through the live pose to <out>/ar/")
    return ap


class _AR:
    """The headless ViewerAR: a plane found once the map has two
    keyframes, then the cube drawn through every Nth tracked frame's pose
    (frames matched to their finalized stats by frame id)."""

    def __init__(self, out: str, every: int, cam):
        self.dir = os.path.join(out, "ar")
        os.makedirs(self.dir, exist_ok=True)
        self.every, self.cam = max(every, 1), cam
        self.verts, self.grays, self.n = None, {}, 0

    def frame(self, system, gray, st):
        from ..viz import ar as ar_mod
        from ..viz.headless import write_png
        self.grays[system.frame_id - 1] = gray
        while len(self.grays) > 8:
            self.grays.pop(next(iter(self.grays)))
        if st.state != "OK" or st.np_R is None:
            return
        if self.verts is None and system.tracker.n_kf_host >= 2:
            m = system.tracker.map
            plane = ar_mod.detect_plane(m.lm_pos.cpu().numpy(),
                                        m.lm_valid.cpu().numpy())
            if plane is not None:
                self.verts = ar_mod.cube_vertices(plane)
        g = self.grays.get(st.frame_id)
        if self.verts is not None and g is not None \
                and st.frame_id % self.every == 0:
            c = self.cam
            rgb = ar_mod.render_cube(g, st.np_R, st.np_t, c.fx, c.fy, c.cx,
                                     c.cy, self.verts)
            write_png(os.path.join(self.dir, f"{st.frame_id:06d}.png"), rgb)
            self.n += 1


def _track(system, sensor: str, pkt):
    if sensor == "rgbd":
        return system.track_rgbd(pkt.gray, pkt.depth, pkt.timestamp,
                                 detections=pkt.detections, mask=pkt.mask)
    if sensor == "stereo":
        return system.track_stereo(pkt.gray, pkt.right, pkt.timestamp,
                                   detections=pkt.detections)
    return system.track_mono(pkt.gray, pkt.timestamp)


def _synthetic_ate(out: str, seq, summary: dict):
    """The synthetic world's ground truth in TUM format beside the run,
    and the ATE against it in the summary (evaluation never fails the
    run)."""
    gt_path = os.path.join(out, "groundtruth.txt")
    _write_synth_groundtruth(gt_path, seq)
    try:
        from .evo import _load, associate, ate_rmse
        est_t, est_p, _ = _load(os.path.join(out, "FrameTrajectory.txt"),
                                "tum")
        gt_t, gt_p, _ = _load(gt_path, "tum")
        ia, ib = associate(est_t, gt_t)
        if len(ia) >= 3:
            summary["ate_m"] = round(
                float(ate_rmse(est_p[ia], gt_p[ib])), 5)
            summary["ate_unaligned_m"] = round(
                float(ate_rmse(est_p[ia], gt_p[ib], align=False)), 5)
    except Exception as e:
        summary["ate_error"] = str(e)


def main(argv=None):
    args = _parser().parse_args(argv)
    from ..system import System
    cfg = build_config(args)
    if args.ply and args.sensor == "rgbd":
        cfg = cfg.replace(pointcloud=dataclasses.replace(
            cfg.pointcloud, enabled=True))
    data = make_dataset(args, cfg)
    sys_ = System(cfg, device=args.device)
    if args.load_map:
        sys_.load_map(args.load_map)
        print(json.dumps({"loaded_map": args.load_map,
                          "keyframes": int(sys_.tracker.map.n_kf),
                          "state": sys_.tracker.state}))

    os.makedirs(args.out, exist_ok=True)
    frame_log = open(os.path.join(args.out, "frames.jsonl"), "w") \
        if args.log_frames else None
    ar = _AR(args.out, args.ar, cfg.camera) if args.ar else None
    times = []
    n_lost = 0
    prev_ts = None
    for i, pkt in enumerate(data):
        if i < args.skip:
            continue
        t0 = time.time()
        if args.realtime and prev_ts is not None and times:
            # sleep off the rest of the frame interval (the reference's
            # pacing: track, then usleep(T - ttrack))
            spare = pkt.timestamp - prev_ts - times[-1]
            if 0 < spare < 5.0:
                time.sleep(spare)
        prev_ts = pkt.timestamp
        st = _track(sys_, args.sensor, pkt)
        times.append(time.time() - t0)
        n_lost += st.state != "OK"
        if ar is not None:
            ar.frame(sys_, pkt.gray, st)
        if frame_log is not None:
            frame_log.write(json.dumps({
                "i": i, "t": pkt.timestamp, "state": st.state,
                "mm": st.n_inliers_mm, "map": st.n_inliers_map,
                "kf": bool(st.is_keyframe),
                "ms": round(times[-1] * 1e3, 2)}) + "\n")

    if frame_log is not None:
        frame_log.close()
    sys_.save_trajectory_tum(os.path.join(args.out, "FrameTrajectory.txt"))
    sys_.save_trajectory_kitti(os.path.join(args.out,
                                            "CameraTrajectory_kitti.txt"))
    sys_.save_keyframe_trajectory_tum(
        os.path.join(args.out, "KeyFrameTrajectory.txt"))
    if sys_.dense is not None:
        sys_.save_dense_ply(os.path.join(args.out, "map.ply"))
        sys_.save_pcd(os.path.join(args.out, "map.pcd"))
    if args.save_map:
        sys_.save_map(args.save_map)
    # timing as the reference's examples print it (stereo_kitti.cc:161-170)
    ts = np.sort(np.asarray(times))
    summary = {
        "frames": len(times),
        "lost": n_lost,
        "median_track_s": float(np.median(ts)),
        "mean_track_s": float(ts.mean()),
        "fps": float(1.0 / max(ts.mean(), 1e-9)),
        "keyframes": int(sys_.tracker.map.n_kf),
        "landmarks": int(sys_.tracker.map.n_lm),
    }
    if ar is not None:
        summary["ar_frames"] = ar.n
    if args.dataset == "synthetic":
        _synthetic_ate(args.out, data.seq, summary)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
