"""The few ``torch.distributed`` primitives that both the data-parallel
layer (``parallel/mesh.py``) and the deployment loader (``export.py``)
need. This module imports only torch, so a host that loads an artifact
does not pull in the evaluators or the model modules."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """True on rank 0, or without a process group: the rank that prints
    and writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def gather_rows(x: torch.Tensor, group=None,
                keep: Optional[int] = None) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` (the world by default) concatenated
    along the leading axis in rank order, on every rank; ``keep``: only
    the first ``keep`` ranks' parts. Each rank passes the same shape."""
    dtype = x.dtype
    if dtype == torch.bool:   # gloo gathers no bool
        x = x.to(torch.uint8)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts[:keep]).to(dtype)
