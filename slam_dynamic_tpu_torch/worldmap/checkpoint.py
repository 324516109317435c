"""Map checkpoints.

Port of ``slam_dynamic_tpu/worldmap/checkpoint.py`` (``save_map`` :18,
``load_map`` :23). The reference declares SaveMap / LoadMap and never
implements them; here the map is one tuple of fixed-shape tensors, so a
checkpoint is one npz with a key per ``MapState`` field. The keys and
dtypes are the JAX package's (descriptors as uint32, the port's int32
bit views turned back), so a map saved by either package loads in the
other.
"""
from __future__ import annotations

import numpy as np

from ..convert import map_state_from_numpy, map_state_to_numpy
from .state import MapState


def save_map(path: str, m: MapState):
    np.savez_compressed(path, **map_state_to_numpy(m))


def load_map(path: str, device=None) -> MapState:
    """A checkpoint -> MapState on ``device`` (``cuda`` unless given)."""
    with np.load(path) as z:
        return map_state_from_numpy({f: z[f] for f in MapState._fields},
                                    device)
