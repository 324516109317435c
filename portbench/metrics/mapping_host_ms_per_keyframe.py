"""Mapping-stage layer: host time of the ``mapping_stage`` span per call,
one call per keyframe, in the traced slice."""


def read(ctx):
    span = ctx["trace"]["spans"].get("mapping_stage")
    if span is None or span[1] == 0:
        return None
    return span[0] / 1e6 / span[1]
