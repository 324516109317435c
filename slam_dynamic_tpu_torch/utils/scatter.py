"""Deterministic scatter helpers for the fixed-capacity map tensors.

JAX's ``x.at[idx].set(v)`` applies duplicate indices in order on the CPU
backend (the last write wins); ``index_put_`` leaves the winner unspecified
on CUDA. ``set_last`` makes every writer to a slot write the last writer's
value, so the result is the same on every device.

Every helper is out of place (``index_put``, ``index_add``,
``scatter_reduce``, never their in-place forms into a fresh tensor), so
``torch.func.vmap`` batches it: the batched tracking step
(``frontend/fused.py``) runs them with a leading lane axis.
"""
from __future__ import annotations

import torch


def set_last(base: torch.Tensor, idx: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """A copy of ``base`` with ``base[idx[i]] = vals[i]`` along dim 0; for
    duplicate indices the last i wins."""
    idx = idx.long()
    pos = torch.arange(idx.shape[0], device=idx.device)
    winner = torch.full((base.shape[0],), -1, dtype=torch.long,
                        device=idx.device)
    winner = winner.scatter_reduce(0, idx, pos, "amax")
    return base.index_put((idx,), vals[winner[idx]])


def count_at(n: int, idx: torch.Tensor, weights=None) -> torch.Tensor:
    """[n] int32 histogram of ``idx`` (optionally weighted), i.e.
    ``zeros(n).at[idx].add(weights)``."""
    idx = idx.reshape(-1).long()
    w = (torch.ones_like(idx, dtype=torch.int32) if weights is None
         else weights.reshape(-1).to(torch.int32))
    return torch.zeros(n, dtype=torch.int32, device=idx.device).index_add(
        0, idx, w)


def mark(n: int, idx: torch.Tensor) -> torch.Tensor:
    """[n] bool with True at ``idx`` (``zeros(n, bool).at[idx].set(True)``)."""
    idx = idx.reshape(-1).long()
    return torch.zeros(n, dtype=torch.bool, device=idx.device).index_put(
        (idx,), torch.ones_like(idx, dtype=torch.bool))


def nonzero_fixed(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)[0]`` without a host
    sync: the first ``size`` True positions in order, padded with ``fill``."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    dst = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    return out.index_put((dst,), torch.arange(n, device=mask.device))[:size]
