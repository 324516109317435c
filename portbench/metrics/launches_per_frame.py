"""Device layer: calls of every launch API (kernels, cooperative kernels,
graphs) in the traced slice per lane-frame."""


def read(ctx):
    n = ctx["trace"]["launches"]
    return n / ctx["slice_frames"] if n else None
