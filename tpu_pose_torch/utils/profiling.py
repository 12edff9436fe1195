"""Tracing and timing (port of ``tpu_pose/utils/profiling.py``):

- :func:`sync` — a device fence over every tensor of a result;
- :func:`trace` — a ``torch.profiler`` region exported as a Chrome trace;
- :class:`Timer` — host seconds per call, warm-up and fence built in;
- :func:`cost_analysis` — the FLOPs of a call, counted by
  ``torch.utils.flop_counter.FlopCounterMode``;
- :func:`utilization` — achieved rates against :data:`PEAKS`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode


def _tensors(tree: Any) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def sync(tree: Any) -> float:
    """Wait for the work that produces ``tree`` (tensors, possibly nested
    in tuples, NamedTuples, lists or dicts): ``torch.cuda.synchronize()``
    on each CUDA device they live on. Returns the sum of one element of
    every non-empty tensor, read on the host, as JAX's fence does."""
    leaves = [t for t in _tensors(tree) if t.numel() > 0]
    for dev in {t.device for t in leaves if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return float(sum(float(t.detach().reshape(-1)[0]) for t in leaves))


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region with ``torch.profiler`` (the CPU, and the GPU when
    CUDA is available) and write ``trace.json``, a Chrome trace, to
    ``log_dir``. Yields the profiler (``.key_averages()`` for sums by
    kernel)::

        with profiling.trace("trace_out"):
            profiling.sync(est.estimate_and_fit(images))
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Host seconds per call of ``fn(*args)``, after ``warmup`` calls,
    with :func:`sync` fencing the warm-up and the timed calls."""

    def __init__(self, fn: Callable, *args, warmup: int = 2, iters: int = 5):
        self.fn = fn
        self.args = args
        self.warmup = warmup
        self.iters = iters

    def run(self) -> float:
        """Mean seconds per call (after the warm-up, fenced)."""
        out = None
        for _ in range(self.warmup):
            out = self.fn(*self.args)
        sync(out)
        t0 = time.perf_counter()
        for _ in range(self.iters):
            out = self.fn(*self.args)
        sync(out)
        return (time.perf_counter() - t0) / self.iters


def cost_analysis(fn: Callable, *args) -> Dict[str, float]:
    """``{"flops": n}``: the floating-point operations of one call of
    ``fn(*args)``, counted by ``FlopCounterMode`` from the shapes of the
    matmuls, convolutions and attention it runs (2·m·n·k for an (m, k) ×
    (k, n) matmul; elementwise ops count 0). It runs the call once.
    Bytes accessed are not counted: PyTorch has no counterpart of XLA's
    cost model for them."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops())}


# Published peaks per card (NVIDIA H100 SXM data sheet, dense rates
# without sparsity): float32 outside the tensor cores, bf16 on the tensor
# cores (989 TFLOP/s) and HBM bandwidth, at the full 700 W limit.
PEAKS = {
    "h100 sxm": {"flops_f32": 67e12, "flops_bf16": 989e12,
                 "hbm_bytes_per_s": 3.35e12},
}


def utilization(seconds_per_call: float, cost: Dict[str, float],
                chip: str = "h100 sxm",
                peak: str = "flops_f32") -> Dict[str, float]:
    """Achieved FLOP/s and bytes/s of a timed call with ``cost`` (from
    :func:`cost_analysis`; ``"bytes accessed"`` when the caller knows
    them), and their fractions of ``PEAKS[chip]``'s ``peak`` rate
    (``"flops_f32"`` or ``"flops_bf16"``) as ``mfu`` and of its HBM
    bandwidth."""
    peaks = PEAKS[chip]
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    out = {
        "flops_per_s": flops / seconds_per_call if seconds_per_call else 0.0,
        "hbm_bytes_per_s": (byts / seconds_per_call
                            if seconds_per_call else 0.0),
    }
    out["mfu"] = out["flops_per_s"] / peaks[peak]
    out["hbm_frac"] = out["hbm_bytes_per_s"] / peaks["hbm_bytes_per_s"]
    return out
