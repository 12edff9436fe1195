"""Data-parallel mesh utilities (port of ``tpu_pose/parallel/mesh.py``).

The model is small, so parameters are replicated and the batch (frames,
people) is split over a 1-D ``data`` mesh: pure data parallelism.

The process model differs from the JAX package's. JAX is single-
controller: one process sees every device and a sharded program takes and
returns global arrays. Here it is SPMD over ``torch.distributed``, one
process per GPU (``torchrun --nproc_per_node N``): every rank calls the
same function on the same global batch, computes its own rows and
gathers the rest, so each rank returns what the JAX function returns.

- :func:`make_mesh` — a 1-D ``DeviceMesh`` over the world (NCCL on CUDA,
  or gloo on the CPU when asked for), initializing the process group from
  the launcher's environment when none exists;
- :func:`batch_sharding`, :func:`replicated` — the DTensor placements of
  JAX's ``P("data")`` and ``P()``;
- :func:`shard_batch` — this rank's contiguous rows of every leaf;
- :func:`gather_batch` — every rank's rows back in rank order (a sharded
  output made global);
- :func:`replicate` — rank 0's values on every rank;
- :func:`pmean` — the mean of tensors over the mesh (JAX's ``pmean``);
- :func:`pad_to_multiple` — edge-pad an uneven final batch;
- :class:`FrameShard`, :func:`frame_shard`, :func:`psum`,
  :func:`halo_exchange` — the collectives of a frame-sharded video fit
  (``fitting/temporal.py``): this rank's place among the ranks, a sum over
  them, its neighbours' edge rows. They are functional collectives, so the
  same code runs eagerly and inside an exported program.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import functools
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree

from tpu_pose_torch.utils.world import (  # noqa: F401
    gather_rows, is_main_process, replica_group, world_size)

DATA_AXIS = "data"
_TIMEOUT = datetime.timedelta(minutes=10)
# Calls of the frame-sharded collectives by kind ("halo", "psum",
# "gather"), counted where Python calls them: an eager call's, or a
# trace's (a loaded program's runs are not counted).
COLLECTIVES: collections.Counter = collections.Counter()


def _backend_for(device: str) -> str:
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: CUDA is not available; pass device='cpu' for a "
                "gloo mesh on the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("make_mesh: this torch has no NCCL backend")
        return "nccl"
    if device == "cpu":
        if not dist.is_gloo_available():
            raise RuntimeError("make_mesh: this torch has no gloo backend")
        return "gloo"
    raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")


def init_world(device: str = "cuda") -> None:
    """Initialize the default process group unless one exists: from the
    launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``torchrun`` sets them) when present, else a world
    of this one process. On CUDA each rank takes the GPU of its
    ``LOCAL_RANK``."""
    backend = _backend_for(device)
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if dist.is_initialized():
        return
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=_TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=_TIMEOUT)


def make_mesh(devices: Optional[Sequence[int]] = None,
              axis_name: str = DATA_AXIS, device: str = "cuda"):
    """1-D data-parallel ``DeviceMesh`` over every rank of the world (or
    the given ranks), its one dimension named ``axis_name``. ``device``:
    ``"cuda"`` (NCCL) or ``"cpu"`` (gloo). Without CUDA or NCCL a CUDA
    mesh raises; it never falls back to the CPU. An existing process
    group must have the device's backend."""
    from torch.distributed.device_mesh import DeviceMesh

    init_world(device)
    backend = dist.get_backend()
    if _backend_for(device) not in backend:
        raise RuntimeError(
            f"make_mesh(device={device!r}) needs the "
            f"{_backend_for(device)} backend; the process group has "
            f"{backend!r}")
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    return DeviceMesh(device, ranks, mesh_dim_names=(axis_name,))


def launcher_mesh(device: str = "cuda"):
    """The command-line tools' mesh: :func:`make_mesh` over the world when
    the launcher started more than one rank (``torchrun --nproc_per_node
    N``, N > 1), else None (one device, as the JAX tools build a mesh
    only for more than one device)."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 or world_size() > 1:
        return make_mesh(device=torch.device(device).type)
    return None


def rank0_print(*args, **kw) -> None:
    """``print`` on rank 0 only (always without a process group)."""
    if is_main_process():
        print(*args, **kw)


def batch_sharding(mesh=None, axis_name: str = DATA_AXIS) -> list:
    """The leading (batch, frames) axis split over the mesh: ``[Shard(0)]``
    (JAX's ``P("data")``)."""
    from torch.distributed.tensor import Shard
    return [Shard(0)]


def replicated(mesh=None) -> list:
    """Every rank holds the whole value: ``[Replicate()]`` (JAX's
    ``P()``)."""
    from torch.distributed.tensor import Replicate
    return [Replicate()]


def _rank_and_size(mesh) -> tuple:
    return mesh.get_local_rank(), mesh.size()


def shard_rows(n: int, mesh) -> slice:
    """Rows ``r·n/w … (r+1)·n/w`` of this rank ``r`` of ``w``; ``n`` must
    divide by ``w``."""
    r, w = _rank_and_size(mesh)
    if n % w:
        raise ValueError(f"batch {n} is not divisible by the mesh size {w}")
    per = n // w
    return slice(r * per, (r + 1) * per)


def shard_batch(tree, mesh, axis_name: str = DATA_AXIS):
    """This rank's contiguous rows of every leaf's leading axis, in JAX's
    ``P("data")`` order; numpy leaves stay numpy, tensors stay on their
    device. Parameters and model tensors use :func:`replicate` instead."""
    del axis_name
    return _pytree.tree_map(lambda x: x[shard_rows(x.shape[0], mesh)], tree)


def gather_batch(tree, mesh):
    """Every rank's rows of each tensor leaf concatenated in rank order:
    the global batch on every rank (the out-sharding of a sharded program
    made whole). Each rank must pass leaves of the same shapes."""
    return _pytree.tree_map(
        lambda x: (gather_rows(x, mesh.get_group())
                   if isinstance(x, torch.Tensor) else x),
        tree)


def pmean(tensors: Sequence[torch.Tensor], mesh) -> list:
    """Each tensor's mean over the mesh (JAX's ``lax.pmean``): one
    ``all_reduce`` sum of the tensors flattened into one buffer, divided
    by the mesh size. The tensors share a dtype and a device."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.get_group())
    flat = flat / torch.full((), float(mesh.size()), dtype=flat.dtype,
                             device=flat.device)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def _broadcast_(t: torch.Tensor, mesh) -> None:
    """Rank 0's ``t`` written into ``t`` in place on every rank."""
    dtype = torch.uint8 if t.dtype == torch.bool else t.dtype
    buf = t.detach().to(mesh.device_type, dtype).contiguous()
    dist.broadcast(buf, group=mesh.get_group(), group_src=0)
    if buf.data_ptr() != t.data_ptr():
        with torch.no_grad():
            t.copy_(buf.to(t.device, t.dtype))


def replicate(tree, mesh):
    """Rank 0's values on every rank, so each holds the controller's copy
    (JAX's ``device_put`` of a replicated value). An ``nn.Module`` has its
    parameters and buffers overwritten in place; in a pytree, tensors are
    overwritten in place, numpy arrays and Python scalars returned as rank
    0's. Other objects with tensor fields (``SMPLData``, a prior) have
    those fields overwritten and their cached derived values dropped."""
    if mesh.size() == 1:
        return tree
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                _broadcast_(t, mesh)
        return tree
    if hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            v = getattr(tree, name)
            if isinstance(v, torch.Tensor):
                _broadcast_(v, mesh)
        for name, attr in vars(type(tree)).items():   # derived from them
            if isinstance(attr, functools.cached_property):
                tree.__dict__.pop(name, None)
        return tree

    def leaf(x):
        if isinstance(x, torch.Tensor):
            _broadcast_(x, mesh)
            return x
        box = [x]
        dist.broadcast_object_list(box, group=mesh.get_group(), group_src=0)
        return box[0]

    return _pytree.tree_map(leaf, tree)


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Edge-pad ``axis`` up to a multiple (an uneven final eval batch);
    returns (padded, original size). A tensor is padded on its device."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    if isinstance(x, torch.Tensor):
        idx = torch.arange(n + rem, device=x.device).clamp_(max=n - 1)
        return x.index_select(axis, idx), n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(np.asarray(x), pad, mode="edge"), n


def _functional(op, *args) -> torch.Tensor:
    """A ``_c10d_functional`` collective and its wait: what
    ``torch.distributed._functional_collectives`` emits, which runs
    eagerly and traces into an exported program."""
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(getattr(c10d, op)(*args))


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (JAX's ``lax.psum``): one
    functional ``all_reduce``. ``group``: a :class:`FrameShard`, a mesh,
    or a registered process group's name."""
    COLLECTIVES["psum"] += 1
    return _functional("all_reduce", x.contiguous(), "sum",
                       _group_name(group))


def _group_name(group) -> str:
    if isinstance(group, FrameShard):
        return group.group
    if isinstance(group, str):
        return group
    return group.get_group().group_name


@dataclasses.dataclass(frozen=True)
class FrameShard:
    """This rank's place in a frame-sharded call: the frames are split
    over ``size`` ranks in contiguous blocks, as JAX's ``P("data")``, and
    this rank holds block ``index``. ``group`` is the registered name of
    the ranks' process group; ``index`` is a (1,) int64 tensor, not an
    int, so that a per-rank program exported by one rank takes it as an
    input and runs on any rank (``export.py``)."""
    group: str
    size: int
    index: torch.Tensor

    def rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of ``x``, whose ``dim`` holds every rank's
        rows in rank order."""
        per = x.shape[dim] // self.size
        return x.unflatten(dim, (self.size, per)).index_select(
            dim, self.index).flatten(dim, dim + 1)

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order
        (one functional ``all_gather``); each rank passes the same
        shape."""
        COLLECTIVES["gather"] += 1
        y = _functional("all_gather_into_tensor",
                        x.movedim(dim, 0).contiguous(), self.size,
                        self.group)
        return y.movedim(0, dim)

    def edges(self, dtype=torch.float32) -> dict:
        """0-d 0/1 flags: whether this rank has a left and a right
        neighbour, and whether it holds frame 0."""
        i = self.index[0]
        return {"has_left": (i > 0).to(dtype),
                "has_right": (i < self.size - 1).to(dtype),
                "first": (i == 0).to(dtype)}


def frame_shard(mesh, device) -> FrameShard:
    """This rank's :class:`FrameShard` on a live 1-D mesh."""
    return FrameShard(mesh.get_group().group_name, mesh.size(),
                      torch.tensor([mesh.get_local_rank()],
                                   device=torch.device(device)))


def halo_exchange(first: torch.Tensor, last: torch.Tensor,
                  shard: FrameShard) -> tuple:
    """This rank's edge rows traded with its neighbours: given its
    ``first`` and ``last`` rows, (the left neighbour's last row, the
    right neighbour's first row, has_left, has_right), the flags 0-d 0/1
    tensors of ``first``'s dtype. A missing neighbour's row is this
    rank's own edge row (``first``, ``last``). One functional
    ``all_gather`` of the two rows: a point-to-point send cannot be
    traced. A rank of one frame passes that row as both."""
    COLLECTIVES["halo"] += 1
    rows = _functional("all_gather_into_tensor",
                       torch.stack([first, last]).contiguous(),
                       shard.size, shard.group)
    i, n = shard.index, shard.size
    edges = shard.edges(first.dtype)
    left = rows.index_select(0, 2 * (i - 1).clamp(min=0) + 1)[0]
    right = rows.index_select(0, 2 * (i + 1).clamp(max=n - 1))[0]
    left = torch.where(edges["has_left"] > 0, left, first)
    right = torch.where(edges["has_right"] > 0, right, last)
    return left, right, edges["has_left"], edges["has_right"]
