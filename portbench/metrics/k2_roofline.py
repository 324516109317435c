"""Kernels layer: K2's share of its roofline in the traced slice. The
least time of every K2 call of the slice, from its shapes at the H100's
published peaks (``portbench/peaks.py``), over the device time of the
work launched under the ``slam_dynamic_tpu_torch::hamming_matrix`` op
events."""
from portbench.peaks import k2_bound_s


def read(ctx):
    dev_ns = ctx["trace"]["k2_device_ns"]
    work = ctx["k2_work"]
    if not dev_ns or not work:
        return None
    return 100.0 * sum(k2_bound_s(*w) for w in work) / (dev_ns / 1e9)
