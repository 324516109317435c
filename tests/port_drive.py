"""The one driver of a System of either package over a dynamic world,
per frame or chunked, that the CPU parity tests (through
``tests/torch_port_util.py``) and ``chip_smoke.py``'s online-detector
phase both run. It imports neither JAX nor the JAX package, so the card
script loads it by path.
"""
import contextlib
import time

import numpy as np

from slam_dynamic_tpu_torch.bench import track_entry
from slam_dynamic_tpu_torch.io.bench_world import detections


def run_dynamic(system, world, n_frames, chunk, use_boxes=True, sync=None,
                call_ctx=None):
    """Either package's System on a dynamic world with its boxes (none
    unless ``use_boxes``: an online detector finds them): per frame
    (chunk 1), or per frame until tracking is OK and then in chunks of
    ``chunk``, then the frames in flight. ``world`` is (anything, seq,
    gray8, aux); the System's sensor picks its entry. ``call_ctx(i)``,
    when given, is a context manager entered around the call whose first
    frame is i.

    Returns the stats; the box statuses after every call with the frames
    finalized in it (``history``: [(frame ids, statuses)]); the
    trajectory's camera centres (``est``); the host time of every call
    (``times``, each ending in ``sync()`` when given); the first frame of
    the first call after which a box is confirmed dynamic
    (``first_dynamic``, None if none is); the most boxes tracked at once
    (``max_boxes``) and the frames tracked (``n_frames``)."""
    _, seq, gray8, aux = world
    track = track_entry(system)
    ts = [float(t) for t in seq.timestamps]
    stats, history, times = [], [], []
    out = dict(first_dynamic=None, max_boxes=0)

    def boxes(i):
        return detections(seq, i) if use_boxes else None

    def record(new):
        stats.extend(new)
        status = tuple(int(x) for x in system.boxes.status)
        history.append(([s.frame_id for s in new], status))
        return status

    def call(i, fn):
        t0 = time.perf_counter()
        with call_ctx(i) if call_ctx is not None \
                else contextlib.nullcontext():
            new = fn()
            if sync is not None:
                sync()
        times.append(time.perf_counter() - t0)
        status = record(new)
        out["max_boxes"] = max(out["max_boxes"], len(status))
        if out["first_dynamic"] is None and 2 in status:
            out["first_dynamic"] = i

    i = 0
    while i < n_frames and (chunk == 1 or system.tracker.state != "OK"):
        call(i, lambda: [track(gray8[i], aux[i], ts[i],
                               detections=boxes(i))])
        i += 1
    while i + chunk <= n_frames and chunk > 1:
        call(i, lambda: system.track_chunk(
            gray8[i:i + chunk], aux[i:i + chunk], ts[i:i + chunk],
            detections=[boxes(i + j) for j in range(chunk)]))
        i += chunk
    # one by one: the JAX Tracker's flush returns the last frame's stats
    tail = []
    while system.tracker._pending:
        tail.append(system.tracker._finalize_one())
    record(tail)
    est = np.stack([-R.T @ t for _, R, t in system.trajectory])
    return dict(out, stats=stats, history=history, est=est, system=system,
                times=times, n_frames=i)
