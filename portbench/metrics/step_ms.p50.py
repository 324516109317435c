"""System / serving layer: the median host time of one entry call (a
chunk, a frame, or a batched step of every lane), on the host clock,
over the window's calls outside the traced slice."""
import numpy as np


def read(ctx):
    steps = ctx["step_ms"]
    return float(np.median(steps)) if len(steps) else None
