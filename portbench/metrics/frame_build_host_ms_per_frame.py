"""Extractor and sensors layer: host time of the ``frame_build`` span per
lane-frame of the traced slice."""


def read(ctx):
    span = ctx["trace"]["spans"].get("frame_build")
    return None if span is None else span[0] / 1e6 / ctx["slice_frames"]
