"""System and serving layer: the 90th percentile over the window's frames
outside the traced slice of the time (ms) from a frame's submission until
its pose is on the host (with one frame in flight, the end of the next
call, or of the window's final drain)."""
import numpy as np


def read(ctx):
    lat = ctx["latency_ms"]
    return float(np.percentile(lat, 90)) if len(lat) else None
