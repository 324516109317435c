"""Kernels layer: K1's share of its roofline in the traced slice. The
least time of every K1 call of the slice, from its shapes and its
gated-in pairs at the H100's published peaks (``portbench/peaks.py``),
over the device time of the work launched under the
``slam_dynamic_tpu_torch::gated_match`` op events."""
from portbench.peaks import k1_bound_s


def read(ctx):
    dev_ns = ctx["trace"]["k1_device_ns"]
    work = ctx["k1_work"]
    if not dev_ns or not work:
        return None
    return 100.0 * sum(k1_bound_s(*w) for w in work) / (dev_ns / 1e9)
