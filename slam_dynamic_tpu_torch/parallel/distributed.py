"""The multi-process runtime: process group bring-up and the mesh over
every rank.

Port of ``slam_dynamic_tpu/parallel/distributed.py`` (``init_distributed``
:44, ``global_mesh`` :62, ``host_sharded_array`` :67). Every process runs
the same program; ``init_distributed`` joins them in one
``torch.distributed`` process group (NCCL when the port runs on the card,
gloo on the CPU), and the heavy map solves (the global BA of
``parallel/sharded_ba.py``, the essential graph of
``parallel/sharded_pose_graph.py``) run over ``global_mesh()``: each rank
solves its landmarks (BA) or edges (pose graph), an all-reduce sums the
ranks' partial systems (two a GN iteration: the system, then the error
after the step), and the small replicated state (the poses) is updated
alike on every rank.

Launch (N processes, rank i of them):

    from slam_dynamic_tpu_torch.parallel.distributed import (
        init_distributed, global_mesh)
    init_distributed("tcp://HOST0:29500", N, i)   # or "file:///shared/f"
    mesh = global_mesh("lm")

With no arguments ``init_distributed`` reads torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), the analog
of the JAX package's TPU-pod auto-detection.

Unlike JAX, torch has no global array: a tensor lives on one device of
one process. ``host_sharded_array`` therefore returns this rank's block
together with its global offset and the global shape (``HostShard``),
where JAX assembles one ``jax.Array`` whose blocks live on every host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from .. import resolve_device
from .mesh import Mesh


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None,
                     backend: Optional[str] = None,
                     device=None) -> torch.device:
    """Join this process to the process group; call before any
    collective. ``coordinator``: "host:port" (TCP) or an init URL
    ("tcp://...", "file://..."); None reads torchrun's environment.
    ``device``: where this rank runs (the card unless "cpu"; on the card,
    ``cuda:local_device_ids[0]``, else the rank modulo the card count).
    ``backend``: NCCL on the card and gloo on the CPU unless given (gloo
    also takes CUDA tensors, and runs several ranks on one card, which
    NCCL refuses). Returns this rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        idx = (local_device_ids[0] if local_device_ids
               else (process_id or 0) % torch.cuda.device_count())
        dev = torch.device("cuda", idx)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    return dev


def global_mesh(axis_name: str = "lm", device=None) -> Mesh:
    """A 1-d mesh over every rank of the process group, entry r owned by
    rank r; ``device`` is this rank's (default: the current card, or the
    CPU without one)."""
    if not dist.is_initialized():
        raise RuntimeError("global_mesh: call init_distributed first")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    world, rank = dist.get_world_size(), dist.get_rank()
    names = [None] * world
    dist.all_gather_object(names, str(device))
    return Mesh(names, (axis_name,), group=dist.group.WORLD,
                owners=list(range(world)), rank=rank)


class HostShard(NamedTuple):
    """This rank's block of a globally sharded array."""

    block: torch.Tensor     # [global_shape[0] / world, ...] on this rank
    offset: int             # the global row of block[0]
    global_shape: tuple


def host_sharded_array(mesh: Mesh, global_shape, local_block,
                       axis_name: str = "lm") -> HostShard:
    """This rank's ``local_block`` of an array of ``global_shape`` sharded
    along its leading dimension over the mesh's ``axis_name``: the block
    on this rank's device, with its global offset (the rank's share of
    the leading dimension, as JAX's callback computes it)."""
    shards = mesh.local_shards(axis_name)
    n = mesh.shape[axis_name]
    if global_shape[0] % n:
        raise ValueError(f"leading dimension {global_shape[0]} over {n}")
    rows = global_shape[0] // n * len(shards)
    block = torch.as_tensor(local_block)
    if tuple(block.shape) != (rows, *global_shape[1:]):
        raise ValueError(f"block {tuple(block.shape)} for this rank's "
                         f"{rows} rows of {tuple(global_shape)}")
    dev = mesh.axis_devices(axis_name)[shards[0]]
    return HostShard(block.to(dev), shards[0] * (global_shape[0] // n),
                     tuple(global_shape))
