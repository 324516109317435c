"""Device layer: the share of the time in which no kernel, copy or set ran
on the device. The device's busy time per lane-frame is the union of the
device intervals of the traced slice over its lane-frames; the time per
lane-frame is the host clock's, over the window's steps outside the
slice, which the profiler does not slow (in the slice a step takes 2-3x
as long, so the slice's own idle share reads high)."""


def read(ctx):
    tr, frames = ctx["trace"], ctx["slice_frames"]
    steps = ctx["step_ms"]
    if not tr["busy_ns"] or not frames or not len(steps):
        return None
    busy_ms = tr["busy_ns"] / 1e6 / frames
    wall_ms = sum(steps) / (len(steps) * ctx["frames_per_step"])
    return 100.0 * (1.0 - busy_ms / wall_ms)
