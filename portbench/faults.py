"""Faults planted under the timed path, to show that the check refuses
them (``tests/test_portbench_check.py`` on the CPU; ``calibrate.py
--fault`` on the card at a cell's own size).

- ``state``: every pose the program answers is its first one, a step
  that returns its state unchanged;
- ``half``: half of the lanes of a batched step see the frame they saw
  first, over and over, so their share of the batch is left out;
- ``lanes``: the results of every other lane of a batched step dropped
  (no stats, no trajectory), as a step that stops tracking lanes;
- ``altered``: one element of every K1 output altered where it is
  produced;
- ``disparity``: every stereo match placed one pixel off in the right
  image where the row-band matcher produces it (depth bf / (d + 1)).

A cell on one chip has no exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def planted(name: str):
    if name == "state":
        from slam_dynamic_tpu_torch.frontend.tracking import Tracker
        orig = Tracker.trajectory_poses

        def frozen(self):
            poses = orig(self)
            return [(ts, poses[0][1], poses[0][2]) for ts, _, _ in poses]
        Tracker.trajectory_poses = frozen
        try:
            yield
        finally:
            Tracker.trajectory_poses = orig
    elif name == "half":
        from slam_dynamic_tpu_torch.parallel.multi_system import MultiSystem
        orig_b = MultiSystem._track_batch
        first = {}

        def half(self, grays, auxes, timestamps):
            grays, auxes = list(grays), list(auxes)
            for b in range(1, len(grays), 2):
                g, a = first.setdefault(b, (grays[b], auxes[b]))
                grays[b], auxes[b] = g, a
            return orig_b(self, grays, auxes, timestamps)
        MultiSystem._track_batch = half
        try:
            yield
        finally:
            MultiSystem._track_batch = orig_b
    elif name == "lanes":
        from slam_dynamic_tpu_torch.parallel.multi_system import MultiSystem
        orig_b, orig_t = MultiSystem._track_batch, MultiSystem.trajectories

        def dropped(self, *args, **kw):
            out = list(orig_b(self, *args, **kw))
            return [None if b % 2 else st for b, st in enumerate(out)]

        def trajectories(self):
            return [[] if b % 2 else tr
                    for b, tr in enumerate(orig_t(self))]
        MultiSystem._track_batch = dropped
        MultiSystem.trajectories = trajectories
        try:
            yield
        finally:
            MultiSystem._track_batch = orig_b
            MultiSystem.trajectories = orig_t
    elif name == "disparity":
        import torch

        from slam_dynamic_tpu_torch.frontend import frame as fr
        orig_m = fr.match_stereo

        def off_by_one(*args, **kw):
            sm = orig_m(*args, **kw)
            ok = sm.valid
            depth = torch.where(ok, sm.depth / (1.0 + sm.depth
                                                / args[4]), sm.depth)
            return sm._replace(u_right=torch.where(ok, sm.u_right - 1.0,
                                                   sm.u_right),
                               depth=depth)
        fr.match_stereo = off_by_one
        try:
            yield
        finally:
            fr.match_stereo = orig_m
    elif name == "altered":
        from slam_dynamic_tpu_torch.ops import gated_match as gm
        saved = {k: getattr(gm, k) for k in
                 ("_launch_k1", "gated_match_plain",
                  "gated_match_batched_plain")}

        def alter(fn):
            def wrapped(*args, **kw):
                idx, best, second = fn(*args, **kw)
                best = best.clone()
                best.view(-1)[0] += 1
                return idx, best, second
            return wrapped
        for k, fn in saved.items():
            setattr(gm, k, alter(fn))
        try:
            yield
        finally:
            for k, fn in saved.items():
                setattr(gm, k, fn)
    else:
        raise ValueError(f"no fault {name!r}")

