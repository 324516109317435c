"""Device meshes of the port: named axes over a grid of devices.

Port of ``slam_dynamic_tpu/parallel/mesh.py`` (``make_mesh`` :22,
``make_mesh_2d`` :30, ``shard_leading`` :35, ``replicated`` :41). The JAX
package lays arrays out over a ``jax.sharding.Mesh`` and lets XLA run
each block on its device; PyTorch has no such layout, so a ``Mesh`` here
is the list of devices, the axis names, and which process owns each
entry. The sharded solvers (``parallel/sharded_ba.py``,
``parallel/sharded_pose_graph.py``) run the shards this process owns and
sum across processes on the mesh's process group; ``MultiSystem(mesh=)``
splits its lanes into one contiguous group per device of its "dp" axis.

Axes, as in the JAX package:
  "lm" - the landmark axis of bundle adjustment (the edge axis of the
         pose graph);
  "dp" - the lane (frame batch) axis of batched serving.

A mesh of this process (``make_mesh``) may name one device several times,
so that a mesh of two entries runs on the CPU or on one card; a mesh
over processes (``distributed.global_mesh``) has one entry per rank.
``torch.distributed.DeviceMesh`` is not used: it has one entry per
process, and cannot express one process driving several entries.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device


class Mesh:
    """Named axes over an n-d grid of devices.

    ``devices``: the grid (nested lists or an object array of devices);
    ``owners``: the rank owning each entry (None: this process owns all);
    ``group``: the process group the solvers' all-reduces run on (None
    within one process)."""

    def __init__(self, devices, axis_names: Sequence[str], group=None,
                 owners=None, rank: int = 0):
        devs = np.empty(np.shape(np.asarray(devices, dtype=object)),
                        dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            devs[idx] = torch.device(d)
        if devs.ndim != len(axis_names):
            raise ValueError(f"{devs.ndim}-d devices for axes {axis_names}")
        self.devices = devs
        self.axis_names = tuple(axis_names)
        self.group = group
        self.rank = rank
        self.owners = (np.zeros(devs.shape, np.int64) if owners is None
                       else np.asarray(owners, np.int64).reshape(devs.shape))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis`` (the first entry of every other
        axis)."""
        a = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[a]):
            idx[a] = i
            out.append(self.devices[tuple(idx)])
        return out

    def local_shards(self, axis: str) -> range:
        """The indices along ``axis`` whose entries this process owns (a
        contiguous block: ranks own consecutive entries)."""
        a = self.axis_names.index(axis)
        own = np.moveaxis(self.owners, a, 0).reshape(
            self.devices.shape[a], -1)[:, 0]
        mine = np.flatnonzero(own == self.rank)
        if not len(mine):
            return range(0)
        return range(int(mine[0]), int(mine[-1]) + 1)

    def __repr__(self):
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.reshape(-1)]}, "
                f"group={'none' if self.group is None else 'world'})")


def _local_devices(devices) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    resolve_device(None)            # raises without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "lm",
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-d mesh over this process's devices: every CUDA device, or the
    first ``n_devices``; ``devices`` names them instead, and may repeat
    one (``make_mesh(2, "dp", devices=["cpu", "cpu"])``)."""
    devs = _local_devices(devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"a mesh of {n_devices} entries over "
                             f"{len(devs)} devices: name them in devices=")
        devs = devs[:n_devices]
    return Mesh(devs, (axis_name,))


def make_mesh_2d(n_lm: int, n_dp: int,
                 devices: Optional[Sequence] = None) -> Mesh:
    """An ("lm", "dp") mesh of n_lm x n_dp entries, row-major over the
    devices (as the JAX package reshapes ``jax.devices()``)."""
    devs = _local_devices(devices)
    if n_lm * n_dp > len(devs):
        raise ValueError(f"a {n_lm} x {n_dp} mesh over {len(devs)} devices")
    grid = np.empty((n_lm, n_dp), dtype=object)
    for i, d in enumerate(devs[:n_lm * n_dp]):
        grid[i // n_dp, i % n_dp] = d
    return Mesh(grid, ("lm", "dp"))


def shard_leading(mesh: Mesh, x: torch.Tensor, axis_name: str = "lm"):
    """``x`` cut along its leading dimension into one contiguous block per
    entry of ``axis_name``, each block on its entry's device; only the
    blocks this process owns are returned (with their indices), as a
    process of the JAX package holds only its addressable shards.
    Returns [(index, block)]."""
    n = mesh.shape[axis_name]
    if x.shape[0] % n:
        raise ValueError(f"leading dimension {x.shape[0]} over {n} shards")
    b = x.shape[0] // n
    devs = mesh.axis_devices(axis_name)
    return [(i, x[i * b:(i + 1) * b].to(devs[i]))
            for i in mesh.local_shards(axis_name)]


def replicated(mesh: Mesh, x: torch.Tensor) -> list:
    """A copy of ``x`` on each distinct device of this process's entries."""
    own = mesh.devices[mesh.owners == mesh.rank].reshape(-1)
    seen = []
    for d in own:
        if d not in seen:
            seen.append(d)
    return [x.to(d) for d in seen]
