"""Batched readers over npz shards (port of ``tpu_pose/data/pipeline.py``).

On-disk layout: a directory of ``.npz`` shards, each holding aligned
arrays (``images`` (N, S, S, 3) uint8 and any label arrays), the
interchange the dataset converters (``data/datasets.py``) write and
either package reads.

The JAX package orders records with grain's ``IndexSampler`` when grain
imports and with a numpy loop otherwise. The port has no grain: it always
takes the numpy order (one ``RandomState(seed)`` permutation per epoch,
then every ``world``-th record from this rank's offset). Unshuffled, both
orders are the record order.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def write_npz_shards(out_dir: str, arrays: Dict[str, np.ndarray],
                     shard_size: int = 256) -> List[str]:
    """Write aligned arrays into numbered compressed npz shards
    (``shard-00000.npz`` …) of ``shard_size`` records; returns the
    paths."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(next(iter(arrays.values())))
    paths = []
    for s, start in enumerate(range(0, n, shard_size)):
        sl = slice(start, min(start + shard_size, n))
        path = os.path.join(out_dir, f"shard-{s:05d}.npz")
        np.savez_compressed(path, **{k: v[sl] for k, v in arrays.items()})
        paths.append(path)
    return paths


class NpzShardSource:
    """Random-access records over a directory of npz shards:
    ``len(source)`` and ``source[i]`` → ``{key: array}``, with an LRU of
    the last four shards read. The LRU (``functools.lru_cache``) is safe
    under concurrent readers: at worst a shard is loaded twice on a racing
    miss, never returned for another index."""

    def __init__(self, data_dir: str, keys: Optional[Sequence[str]] = None):
        self.paths = sorted(
            os.path.join(data_dir, f) for f in os.listdir(data_dir)
            if f.endswith(".npz"))
        if not self.paths:
            raise FileNotFoundError(f"no .npz shards under {data_dir}")
        self._sizes = []
        for p in self.paths:
            with np.load(p) as z:
                first = keys[0] if keys else z.files[0]
                self._sizes.append(len(z[first]))
        self._offsets = np.cumsum([0] + self._sizes)
        self.keys = keys
        self._shard = functools.lru_cache(maxsize=4)(self._load_shard)

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def _load_shard(self, shard_idx: int) -> Dict[str, np.ndarray]:
        with np.load(self.paths[shard_idx]) as z:
            keys = self.keys or z.files
            return {k: z[k] for k in keys}

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        # Indices past the end wrap, as in the JAX package's source.
        idx = int(idx) % len(self)
        shard_idx = int(np.searchsorted(self._offsets, idx, "right") - 1)
        local = idx - self._offsets[shard_idx]
        shard = self._shard(shard_idx)
        return {k: v[local] for k, v in shard.items()}


def _stack(examples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = examples[0].keys()
    return {k: np.stack([e[k] for e in examples]) for k in keys}


def process_shard() -> tuple:
    """(rank, world size) of this process in the ``torch.distributed``
    group when one is initialized, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def batches(
    data_dir: str,
    batch_size: int,
    *,
    keys: Optional[Sequence[str]] = None,
    shuffle: bool = False,
    seed: int = 0,
    num_epochs: int = 1,
    drop_remainder: bool = True,
    shard_by_process: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic batched iterator over npz shards: per epoch the
    records in order (or one ``RandomState(seed)`` permutation with
    ``shuffle``), every world-size-th record from this process's rank
    (``shard_by_process``, :func:`process_shard`), batches of
    ``batch_size`` stacked along a new leading axis; a short last batch
    is dropped with ``drop_remainder``."""
    source = NpzShardSource(data_dir, keys)
    shard_idx, shard_cnt = process_shard() if shard_by_process else (0, 1)
    idx = np.arange(len(source))
    rng = np.random.RandomState(seed)
    for _ in range(num_epochs):
        order = rng.permutation(idx) if shuffle else idx
        order = order[shard_idx::shard_cnt]
        stop = (len(order) - len(order) % batch_size
                if drop_remainder else len(order))
        for start in range(0, stop, batch_size):
            sel = order[start:start + batch_size]
            yield _stack([source[int(i)] for i in sel])
