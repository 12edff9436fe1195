"""The few ``torch.distributed`` primitives that both the data-parallel
layer (``parallel/mesh.py``) and the deployment loader (``export.py``)
need. This module imports only torch, so a host that loads an artifact
does not pull in the evaluators or the model modules."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

# Replica size → (the default process group it was made in, the name its
# group is registered under): see replica_group.
_REPLICAS: dict = {}


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


def replica_group(n: int) -> str:
    """The name under which this rank's replica group is registered: the
    ``n`` consecutive ranks ``n·⌊rank/n⌋ …`` of the world (all of it when
    the world has ``n`` ranks). The name is the same on every rank, so a
    program that one rank traces with collectives over that name (a
    frame-sharded video artifact) runs on any rank over the rank's own
    replica. Collective over the world the first time for each ``n``:
    every rank must call it. Raises ValueError without a process group,
    or when ``n`` does not divide the world."""
    if not dist.is_initialized():
        raise ValueError(
            "a frame-sharded video program runs its collectives in a "
            "process group: create one first (parallel/mesh.make_mesh)")
    size = dist.get_world_size()
    if size % n:
        raise ValueError(
            f"a world of {size} ranks does not split into replicas of "
            f"{n} ranks")
    default = dist.distributed_c10d._get_default_group()
    name = f"tpu_pose_replica_{n}"
    if _REPLICAS.get(n) is not default:
        if size == n:
            group = default
        else:
            # new_group is collective: every rank makes every replica's.
            groups = [dist.new_group(list(range(s, s + n)))
                      for s in range(0, size, n)]
            group = groups[dist.get_rank() // n]
        from torch._C._distributed_c10d import (_register_process_group,
                                                _unregister_process_group)
        if n in _REPLICAS:
            _unregister_process_group(name)
        _register_process_group(name, group)
        _REPLICAS[n] = default
    return name
