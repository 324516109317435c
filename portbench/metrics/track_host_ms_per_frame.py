"""Tracker layer: host time of the ``mm_track``, ``local_map`` and
``local_track`` spans per lane-frame of the traced slice."""


def read(ctx):
    spans = ctx["trace"]["spans"]
    names = ("mm_track", "local_map", "local_track")
    if not any(n in spans for n in names):
        return None
    ns = sum(spans[n][0] for n in names if n in spans)
    return ns / 1e6 / ctx["slice_frames"]
