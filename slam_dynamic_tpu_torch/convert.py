"""Carry state between the JAX package and the port.

This system has no learned weights on the tracking path: what a run
carries is the map, the frames, the box tracker, the ORB pattern and the
config. These helpers take a JAX ``MapState``
(``slam_dynamic_tpu/worldmap/state.py:27``) as a dict of numpy arrays
into the port's ``MapState`` and back (a MultiSystem's stacked [B] map
too, stacked or lane by lane), a ``FrameData``
(``frontend/frame.py:25``) likewise (the map's persistent loop edges and
their cursor ``n_loop`` included), a loop closer's keyframe database
(``worldmap/kfdb.py:30``), the box tracker's state
(``frontend/boxtrack.py:18``) by its fields, and rebuild the config
dataclass tree from a plain dict (``dataclasses.asdict`` of either
package's ``SystemConfig``). Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from . import config as cfg_mod
from . import resolve_device
from .frontend.boxtrack import BoxTrackerState
from .frontend.frame import FrameData
from .worldmap.kfdb import KFDatabase
from .worldmap.state import MapState

_DESC_FIELDS = ("kf_kp_desc", "lm_desc")


def map_state_from_numpy(arrays: dict, device=None) -> MapState:
    """JAX map arrays (name -> numpy) -> the port's MapState on ``device``
    (``cuda`` unless given, see ``resolve_device``). Packed uint32
    descriptors become their int32 bit views."""
    device = resolve_device(device)
    out = {}
    for name in MapState._fields:
        a = np.asarray(arrays[name])
        if name in _DESC_FIELDS:
            a = a.astype(np.uint32).view(np.int32)
        out[name] = torch.from_numpy(np.array(a)).to(device)  # keeps 0-d
    return MapState(**out)


def lane_maps_from_numpy(arrays: dict, device=None) -> list:
    """A JAX MultiSystem's stacked map (``MultiSystem.maps``: name ->
    numpy [B, ...]) -> the port's B lane MapStates, lane by lane;
    ``map_state_from_numpy`` of the same arrays is the port's stack
    (``parallel/multi_system.py``'s ``maps``)."""
    lanes = np.asarray(arrays["n_kf"]).shape[0]
    return [map_state_from_numpy({k: np.asarray(v)[b]
                                  for k, v in arrays.items()}, device)
            for b in range(lanes)]


def map_state_to_numpy(m: MapState) -> dict:
    """The inverse: name -> numpy, descriptors back as uint32."""
    out = {}
    for name, t in zip(MapState._fields, m):
        a = t.detach().cpu().numpy()
        if name in _DESC_FIELDS:
            a = a.view(np.uint32)
        out[name] = a
    return out


def frame_data_from_numpy(arrays: dict, device=None) -> FrameData:
    """FrameData arrays (name -> numpy, e.g. a JAX FrameData's fields) ->
    the port's FrameData; uint32 descriptors become int32 bit views."""
    device = resolve_device(device)
    out = {}
    for name in FrameData._fields:
        a = np.asarray(arrays[name])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[name] = torch.from_numpy(np.array(a)).to(device)
    return FrameData(**out)


def kfdb_from_numpy(arrays: dict, device=None) -> KFDatabase:
    """A keyframe database's arrays (name -> numpy: ``word``, ``weight``,
    ``valid``, e.g. a JAX ``LoopCloser.db``'s fields) -> the port's
    ``KFDatabase`` on ``device``."""
    device = resolve_device(device)
    return KFDatabase(*(torch.from_numpy(np.array(arrays[f])).to(device)
                        for f in KFDatabase._fields))


def box_state_from_numpy(state) -> BoxTrackerState:
    """A box tracker state of either package (an object with the fields of
    ``BoxTrackerState``) -> the port's, as fresh numpy copies."""
    kw = {f.name: np.array(getattr(state, f.name))
          for f in dataclasses.fields(BoxTrackerState) if f.name != "next_id"}
    return BoxTrackerState(**kw, next_id=int(state.next_id))


def _build(cls, value):
    if not dataclasses.is_dataclass(cls):
        return value
    hints = typing.get_type_hints(cls, vars(cfg_mod))
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in value:
            continue
        v = value[f.name]
        hint = hints[f.name]
        if dataclasses.is_dataclass(hint):
            v = _build(hint, v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)


def config_from_dict(d: dict) -> cfg_mod.SystemConfig:
    """A ``SystemConfig`` of the port from ``dataclasses.asdict`` output
    (of this package's or the JAX package's config)."""
    return _build(cfg_mod.SystemConfig, d)


# the detector's flax module names -> the port's CenterDetector modules
_DETECTOR_HEADS = {"Conv_0": "heat", "Conv_1": "size", "Conv_2": "off"}
_DETECTOR_BLOCKS = 7


def detector_params_from_numpy(tree: dict) -> dict:
    """The JAX detector's params tree (``{"params": {"ConvBlock_i":
    {"Conv_0": {"kernel"}, "GroupNorm_0": {"scale", "bias"}}, "Conv_j":
    {"kernel", "bias"}}}``, numpy leaves) -> a state dict of the port's
    ``models.detector.CenterDetector``; kernels HWIO -> OIHW."""
    p = tree.get("params", tree)

    def conv(k):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(k, np.float32).transpose(3, 2, 0, 1)))

    def vec(v):
        return torch.from_numpy(np.array(v, np.float32))
    sd = {}
    for i in range(_DETECTOR_BLOCKS):
        b = p[f"ConvBlock_{i}"]
        sd[f"blocks.{i}.conv.weight"] = conv(b["Conv_0"]["kernel"])
        sd[f"blocks.{i}.norm.weight"] = vec(b["GroupNorm_0"]["scale"])
        sd[f"blocks.{i}.norm.bias"] = vec(b["GroupNorm_0"]["bias"])
    for flax_name, name in _DETECTOR_HEADS.items():
        sd[f"{name}.weight"] = conv(p[flax_name]["kernel"])
        sd[f"{name}.bias"] = vec(p[flax_name]["bias"])
    return sd


def detector_params_to_numpy(sd: dict) -> dict:
    """The inverse: a CenterDetector state dict -> the JAX params tree."""
    def conv(t):
        return np.ascontiguousarray(
            t.detach().cpu().numpy().transpose(2, 3, 1, 0))

    def vec(t):
        return t.detach().cpu().numpy().copy()
    p = {}
    for i in range(_DETECTOR_BLOCKS):
        p[f"ConvBlock_{i}"] = {
            "Conv_0": {"kernel": conv(sd[f"blocks.{i}.conv.weight"])},
            "GroupNorm_0": {"bias": vec(sd[f"blocks.{i}.norm.bias"]),
                            "scale": vec(sd[f"blocks.{i}.norm.weight"])}}
    for flax_name, name in _DETECTOR_HEADS.items():
        p[flax_name] = {"bias": vec(sd[f"{name}.bias"]),
                        "kernel": conv(sd[f"{name}.weight"])}
    return {"params": p}
