#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpu_pose_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

From the repository root on a machine with a CUDA GPU, ``nvcc`` and the
port's dependencies (torch, numpy). It

1. prints the card (``nvidia-smi`` name and power limit) and versions;
2. builds the CUDA kernels in ``tpu_pose_torch/csrc/`` with ``nvcc`` into
   ``build/``, one compiler per source, all at once;
3. times an empty CUDA-graph replay (``graph_replay``), the floor under
   every kernel time below;
4. holds each kernel against its plain PyTorch version at the main
   paths' shapes (the soft-argmax decode in both heatmap layouts within
   the reference's tolerance, B2's quantizer and its fused
   quantize-and-gather bit for bit on every tile of every int8 conv
   input), and times both with CUDA events, with L2 flushed (the kernels
   line, against the HBM byte bound) and with the inputs L2-resident; the
   gather also beside the unfused route to the same rows (quantize pass,
   ``F.pad``, ``unfold`` copy);
5. drives the main path, ``PoseEstimator.estimate_and_fit``, at the full
   default model width (CPMConfig(), FitConfig(), full-size synthetic SMPL
   and GMM-8 prior, random weights from seed 0) on an (8, 368, 368, 3)
   uint8 batch, with every kernel's launch count set to 0 just before and
   read just after; then times its phases;
6. drives the int8 serving path the same way: ``quantize=True`` with 8
   calibration frames and ``cpm_microbatch=16`` on a (32, 368, 368, 3)
   batch (two chunks), a dynamic-scale estimator at batch 16, and a
   batch-8 call that the precision policy sends to the bf16 CPM, each
   with B2's launches checked against the count computed from the conv
   layers and ``int8_conv``'s tiles; then the int8 and bf16 CPM one after
   the other, and the int8 CPM's device time by kernel;
7. checks the outputs: shapes and finiteness, the kernel decode against
   the plain decode end to end, the GPU path against the CPU path on a
   small float32 model (float and int8), and fit recovery of known
   bodies;
8. drives the accuracy front end (letterbox, refine_scale, flip and
   scale TTA) through ``estimate_and_fit`` on (8, 480, 640, 3) frames
   (``front_end_main_path``, 12 B1 launches per call, and its
   ``front_end_breakdown``); the single-person video path at T = 32 with
   4 yaw hypotheses (``video_main_path``, smooth; ``video_modes``,
   temporal and independent), the int8 video path (``video_int8``:
   ``quantize=True``, ``cpm_microbatch=16``, refine_scale, its B1 and B2
   launches against the computed counts, no non-NHWC conv input), and
   the stream form against ``VideoSession`` over 48 frames
   (``video_stream``); then holds the GPU front end and video paths
   against the CPU ones on a small float32 model
   (``front_end_small_reference``, ``video_small_reference``);
9. drives the multi-person paths on frames of two planted people
   (``two_people_frames``): ``estimate_and_fit_multi`` bf16 at batch 8
   (``multi_main_path``), with letterbox, refine_scale and flip on
   (8, 480, 640, 3) frames and three slots (``multi_front_end``), and int8
   at batch 16 (``multi_int8``, B2 on the 32-hypothesis fold);
   ``estimate_and_fit_video_multi`` at T = 32 with 4 yaw hypotheses
   (``video_multi_main_path``) and with every knob at T = 16
   (``video_multi_knobs``); the stream form against
   ``MultiPersonVideoSession`` over 48 frames (``video_multi_stream``);
   each with B1's (and B2's) launches against the computed counts; then
   holds them against the CPU on a small float32 model
   (``multi_small_reference``);
10. drives the fit extras at full width (``fit_extras_main_path``: an
   init head trained on the card, then ``estimate_and_fit`` with L-BFGS
   stages, the interpenetration term and the head, batch 8, one B1
   launch per call) and recovers known bodies with L-BFGS too
   (``fit_recovery``); holds the capsules, the head and an L-BFGS fit on
   the GPU against the CPU (``fit_extras_small_reference``);
11. builds the native host letterbox (``g++``) and holds it within 1
   LSB of the numpy path on camera frames (``native_letterbox_check``);
   serves the bf16 estimator over HTTP (``serving_main_path``: one
   bucket-8 batch against a direct call, then 24 mixed-resolution frames
   from 8 client threads, closed loop and open loop at half the measured
   capacity, and from 16 closed-loop threads, with the pipeline's
   readiness check on and off, one B1 launch per batch),
   the int8 estimator in process
   (``serving_int8``: a bucket-32 batch with B2's launches of two chunks,
   a bucket-1 batch without B2), ``fn="fit_smpl"`` over ``/fit`` with
   COCO-17 joints of planted bodies (``serving_fit``) and
   ``fn="estimate_and_fit_multi"`` (``serving_multi``);
12. trains the CPM at full width, batch 32, with the CLI's schedule and
   clip (``train_main_path``: the loss on one fixed batch, seconds per
   step, images/s, the device's busy share, TFLOP/s against the bf16
   peak, peak memory, the synthetic generator's host seconds per batch;
   no kernel of the port runs), takes QAT steps, saves and restores the
   train state bit for bit and serves the exported npz in bf16 and int8
   (``train_qat_and_resume``), drives the three evaluators over synthetic
   batches of 32 (``eval_main_path``: ``evaluate_h36m_style`` with the
   perspective camera, ``evaluate_pckh``, ``evaluate_oks``, and
   ``evaluate_pckh`` on the int8 estimator, each with its B1/B2 launches
   as computed, frames/s and a cursor resume), and holds the train step,
   the optimizer and two evaluators on the GPU against the CPU on a
   small float32 model (``train_eval_small_reference``);
13. times the hard synthetic generator at 368² (``hard_data_check``),
   runs ``tools/selfcheck_e2e``'s sections 1–5 and 8 at full width with the
   depth cut (``selfcheck_main_path``: the easy and the hard CPM trained
   on the card, the fused evaluations, the fitted prior, the init head,
   the video fits, two-person frames, the whole hard ladder with
   calibrated int8 at int8_min_batch 0, hard multi-person stills, the
   tracked crossing video, the empty-frame operating point, k = 3
   stills, the deployment artifact (section 8); every section's B1/B2
   launches against the computed counts),
   ``tools/track_bench`` on its hard weights (crossing, and enterleave
   through the session windows), a two-row ``tools/hard_sweep``, the demo
   and ``tools/profile_entry`` (``tools_main_path``), and holds the
   ladder and track_bench's metrics on the GPU against the CPU on a small
   float32 model (``hard_small_reference``); the selfcheck's sections 9
   and 10 write JPEGs through PIL, which the card's machine lacks, and
   run in the CPU tests only;
14. exports deployment artifacts (``tpu_pose_torch/export.py``) and runs
   them loaded, with no estimator, against the live calls on the same
   inputs: the full-width bf16 ``estimate_and_fit`` with a symbolic
   batch (``export_main_path``: export, save and load seconds, size,
   seconds per call beside the live call's, section 8's rule, B1 once per
   call), served by ``BatchingServer(ServableProgram)``
   (``serving_artifact``); the int8 path at batch 32 with its B2
   launches as computed (``export_int8``); ``fit_smpl``, the
   multi-person path and both streaming sessions (``export_fit_smpl``,
   ``export_multi``, ``export_streams``: the same perms and frame masks
   as the live sessions); the GPU artifact against the CPU artifact of a
   small model (``export_small_reference``); and the selfcheck's section
   8 inside ``selfcheck_main_path``; and, in a process of their own
   beside the hard-set phases (``phase_export_new_paths``), the exports
   of L-BFGS fits, of the int8 CPM with a symbolic batch and of the video
   fits with a symbolic T: the fit-extras estimator's L-BFGS
   ``estimate_and_fit`` at batch 8 against the live call under
   deterministic algorithms, with its linesearch iterations
   (``export_lbfgs``), the int8 ``estimate_2d`` with a symbolic batch at
   1, 8 and 16, bit-equal to live, with B2's grouped launches as computed
   and B2's functional gather held against the in-place one
   (``export_int8_symbolic``), and the video fits with a symbolic T,
   smooth at T = 8 and 16, temporal at 8 (``export_video_symbolic``);
15. runs the parity harness's tools: where tensorflow imports, writes
   the full-width CPM's weights as TF1 checkpoints in each naming style
   and converts them back bit for bit (``tf_converter_check``, else one
   line that says it skipped); the parity-sweep CLI on the full-size
   synthetic SMPL with the oracle's gmof_sigma mismatched
   (``parity_sweep_main_path``); and the day-one CLI on a reference
   directory fabricated from the full-width weights and the full-size
   SMPL (``day_one_main_path``: the port's L-BFGS certification on the
   card against the float64 host oracle within 1 mm, then the smoke
   eval, B1 once per batch);
16. runs the data-parallel layer (``tpu_pose_torch/parallel/mesh.py``)
   in a process of its own beside the sweep, in a world of this one card
   over NCCL (the day-one CLI, the streaming exports and the exports of
   ``phase_export_new_paths`` also run in processes of their own, from
   the start of the hard-set phases):
   ``sharded_fused_fn`` against the live call (``sharded_main_path``),
   ``evaluate_h36m_style`` and ``evaluate_pckh`` with the mesh against
   them without it (``sharded_eval``), ``make_train_step(mesh=)``
   against the single-device step at batch 32 (``dp_train_step``), the
   sharded 2D artifact against the live sharded call (``sharded_export``),
   then ``torchrun --standalone --nproc_per_node 1`` of the train CLI and
   ``tools/multiprocess_smoke`` with one rank (``parallel_cli``), B1
   counted on every sharded path;
17. prints a ``{"kernels": [...]}`` line and, last,
   ``{"ok": true, "device": {...}}``.

Every phase prints one JSON object per line. Any failed check raises, so
the script exits non-zero and prints no result line. Without CUDA it
exits 2 at once. It imports torch, numpy, the standard library and
``tpu_pose_torch``, and scipy and tensorflow inside the phases that
write the reference's files.
"""

from __future__ import annotations

import collections
import concurrent.futures
import copy
import dataclasses
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

from tpu_pose_torch import api as api_lib
from tpu_pose_torch import export as export_lib
from tpu_pose_torch import native, serving
from tpu_pose_torch.api import (MultiPersonVideoSession, PoseEstimator,
                                VideoSession)
from tpu_pose_torch.client import PoseClient
from tpu_pose_torch.data import synthetic, synthetic_hard
from tpu_pose_torch.fitting import fit as fit_lib
from tpu_pose_torch.fitting import init_head as init_head_lib
from tpu_pose_torch.fitting import interpenetration as interp_lib
from tpu_pose_torch.fitting import lbfgs as lbfgs_lib
from tpu_pose_torch.fitting import priors as priors_lib
from tpu_pose_torch.fitting import temporal, tracking
from tpu_pose_torch.models import cpm as cpm_lib
from tpu_pose_torch.models import cpm_train
from tpu_pose_torch.models import joints as joints_lib
from tpu_pose_torch.models import smpl as smpl_lib
from tpu_pose_torch.models import smpl_data as smpl_data_lib
from tpu_pose_torch.ops import cuda_kernels
from tpu_pose_torch.ops import preprocess as pre
from tpu_pose_torch.ops import quantize as quantize_lib
from tpu_pose_torch.ops import softargmax as softargmax_lib
from tpu_pose_torch.parallel import eval as eval_lib
from tpu_pose_torch.serving_http import PoseHTTPServer
from tpu_pose_torch.tools import (demo, hard_sweep, parity_sweep,
                                  profile_entry, reference_day_one,
                                  selfcheck_e2e, track_bench)
from tpu_pose_torch.utils import checkpoint
from tpu_pose_torch.utils import metrics as metrics_lib
from tpu_pose_torch.utils import profiling, tf_converter
from tpu_pose_torch.utils.config import CPMConfig, FitConfig, StageConfig

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bandwidth and
# the float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
L2_FLUSH_BYTES = 256 * 2 ** 20  # read before a cold-L2 timing (L2: 50 MB)
L2_BYTES = 50 * 2 ** 20

DEVICE = "cuda"
MAIN_BATCH = 8
MAIN_CPM = CPMConfig()  # the repo's default model, full width
# Soft-argmax tolerances: the reference's own Pallas-vs-XLA bounds
# (tests/test_pallas.py) — float32 sums over 2116 cells in another order.
SA_JOINT_TOL = dict(rtol=1e-5, atol=1e-4)
SA_CONF_TOL = dict(rtol=1e-6, atol=1e-6)

INT8_CHUNK = 16                   # cpm_microbatch of the int8 path
INT8_BATCH = 2 * INT8_CHUNK       # two chunks per call
# Every conv input of the int8 path, per chunk of 16 frames: each gets
# B2's abs-max pass with dynamic scales; the 1×1 convs' inputs (46²×128,
# 46²×512) also its standalone quantize pass, the others its gather.
QUANT_SHAPES = {
    "images_368x368x3_f32": ((16, 368, 368, 3), torch.float32),
    "trunk_184x184x128_bf16": ((16, 184, 184, 128), torch.bfloat16),
    "trunk_92x92x128_bf16": ((16, 92, 92, 128), torch.bfloat16),
    "stage_46x46x32_bf16": ((16, 46, 46, 32), torch.bfloat16),
    "stage_46x46x128_bf16": ((16, 46, 46, 128), torch.bfloat16),
    "head_46x46x512_bf16": ((16, 46, 46, 512), torch.bfloat16),
    "mconv1_46x46x48_f32": ((16, 46, 46, 48), torch.float32),
}
QUANT_TIMED = ("stage_46x46x128_bf16", "head_46x46x512_bf16")
QUANT_KERNEL_ROW = "stage_46x46x128_bf16"   # 10 of the 12 1×1 convs


_T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``t_s``, the script's
    seconds when it was printed."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T_START}
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def close(a: torch.Tensor, b: torch.Tensor, rtol: float, atol: float):
    """(ok, max |a - b|) under numpy's allclose rule."""
    a, b = a.double().cpu(), b.double().cpu()
    ok = bool(((a - b).abs() <= atol + rtol * b.abs()).all())
    return ok, float((a - b).abs().max())


class NoTF32:
    """TF32 off for float32 convs and matmuls for the duration, as on the
    CPU, for the GPU-against-CPU comparisons."""

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.prev


def cuda_ms(fn, cold_l2: bool, reps: int = 60) -> float:
    """Median device milliseconds of one call, captured in a CUDA graph
    whose replays are bracketed by CUDA events, so the host's launch
    overhead (Python, ctypes) is not in the number.

    ``cold_l2``: one call per replay, each after a read of a buffer far
    larger than the 50 MB L2, so the inputs come from HBM as the byte
    bound assumes (the events are enqueued while the flush runs, so they
    time the call alone). Otherwise 20 calls per replay on the same
    inputs, which stay L2-resident, as on the main path, where the decode
    reads heatmaps the last conv has just written."""
    per_graph = 1 if cold_l2 else 20
    for _ in range(3):  # warm-up outside capture (allocator, lazy init)
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    flush = torch.ones(L2_FLUSH_BYTES // 4, device=DEVICE) if cold_l2 \
        else None
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        if flush is not None:
            flush.sum()
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) / per_graph


def eager_ms(fn, reps: int = 60) -> float:
    """Median milliseconds of one eagerly issued call, events around each:
    includes the host's launch overhead when the GPU waits for it."""
    for _ in range(3):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_s(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def kernel_rows(events):
    """(name, launches, device µs) of the device kernels in a profiler's
    ``key_averages()``, longest first. Only rows whose device type is the
    GPU count: an operator's row also carries the device time of the
    kernels it launched, so summing every row counts that time twice."""
    rows = [(e.key, e.count, e.self_device_time_total) for e in events
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[2])


COUNTED = {"soft_argmax": cuda_kernels.soft_argmax_cuda,
           "quantize_act": cuda_kernels.quantize_act_cuda,
           "quantize_act_absmax": cuda_kernels.act_scale_cuda,
           "quantize_im2col": cuda_kernels.quantize_im2col_cuda}


def zero_counts() -> None:
    for wrapper in COUNTED.values():
        wrapper.launches = 0


def read_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in COUNTED.items()}


TRUNK_POOLS = {"conv1": 0, "conv2": 1, "conv3": 2}  # pools before them
REFINE_TRUNK = ("conv1_stage2", "conv2_stage2", "conv3_stage2")


def conv_input_hw(cfg: CPMConfig) -> dict:
    """Each conv layer's input height (= width): the input size through
    the trunk's SAME 3×3/2 pools (ceil halving), 1/8 of it after."""
    hw = {}
    for name, *_ in cpm_lib._layer_defs(cfg):
        base, stage = name.split("_")
        trunk = stage in ("stage1", "stage2")
        n = cfg.input_size
        for _ in range(TRUNK_POOLS.get(base, 3) if trunk else 3):
            n = -(-n // 2)
        hw[name] = n
    return hw


def scan_first_step_repeats() -> int:
    """How many extra times this torch's eager ``scan`` runs its first
    step (torch 2.11: once, to learn its outputs' shapes; later versions:
    0): an exported program's loops run their first step that much more
    often."""
    from torch._higher_order_ops.scan import scan_op
    calls = [0]

    def body(carry, x):
        calls[0] += 1
        return carry + x, x.clone()

    scan_op(body, [torch.zeros(())], [torch.ones(3)], ())
    return calls[0] - 3


def int8_launches(qcpm, cfg: CPMConfig, batch: int, dynamic: bool,
                  stage1_runs: int = 1, people: int = 1,
                  crop: bool = False, grouped: bool = False,
                  scan_repeats: int = 0) -> dict:
    """B2's launches in one int8 CPM pass over ``batch`` frames: one
    quantize pass per 1×1 conv, one fused gather per tile of every k×k
    conv (``ops/quantize._tiles`` at the batch the conv runs at, as
    ``int8_conv`` cuts it), and with dynamic scales one abs-max pass per
    conv. ``stage1_runs``: how often the pass runs stage 1
    (``refine_scale`` runs it once more per crop round before the
    refinement stages). ``people`` > 1: an ``estimate_2d_multi`` pass,
    whose refinement stages run on the batch·people fold (stage 1 and the
    refinement trunk at the batch); ``crop``: its crop pass, the whole
    network once more at batch·people. ``grouped``: a pass with a symbolic
    batch (an artifact exported with ``batch=None``), whose gathers are
    the tiles of one group of ``ops/quantize._group_tiles`` for each group
    of the batch padded to whole groups, and ``scan_repeats`` more times
    (:func:`scan_first_step_repeats`)."""
    hw = conv_input_hw(cfg)
    count = {"quantize_act": 0, "quantize_im2col": 0,
             "quantize_act_absmax": 0}
    for name, layer in qcpm.named_children():
        if name.endswith("_stage1"):
            batches = [batch] * stage1_runs
        elif name in REFINE_TRUNK:
            batches = [batch]
        else:
            batches = [batch * people]
        if crop:
            batches.append(batch * people)
        for b in batches:
            count["quantize_act_absmax"] += int(dynamic)
            if layer.kernel_size == 1:
                count["quantize_act"] += 1
                continue
            n_pad, k_pad = layer.w_int8.shape
            h = hw[name]
            row_bytes = h * (k_pad + 8 * n_pad)
            if grouped:
                g, tiles = quantize_lib._group_tiles(h, row_bytes)
                count["quantize_im2col"] += (-(-b // g) + scan_repeats) \
                    * len(tiles)
            else:
                count["quantize_im2col"] += len(list(quantize_lib._tiles(
                    b, h, row_bytes)))
    return count


def multi_b1_launches(crop: bool, flip_tta: bool) -> int:
    """B1's launches in one ``estimate_2d_multi`` call: the final decode
    of the hypotheses, and one more with a crop pass (``refine_scale``, or
    ``hint_crop`` with hints), all twice with ``flip_tta``."""
    return (1 + int(crop)) * (2 if flip_tta else 1)


def check_result(res, b: int) -> None:
    shapes = {"joints2d": (b, 14, 2), "conf": (b, 14), "theta": (b, 72),
              "beta": (b, 10), "cam": (b, 3), "vertices": (b, 6890, 3),
              "joints3d": (b, 24, 3), "energy": (b,)}
    for k, shape in shapes.items():
        v = getattr(res, k)
        check(tuple(v.shape) == shape, f"{k} shape {tuple(v.shape)}")
        check(bool(torch.isfinite(v).all()), f"{k} finite")


# -- phases -----------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = cuda_kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": [str(lib) for lib in libs]})


def phase_graph_replay() -> dict:
    """An empty captured graph timed as cuda_ms times every kernel: what a
    replay alone costs, with one call per replay after an L2 flush (cold)
    and spread over 20 calls per replay (warm)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
        replay = {"cold_ms": cuda_ms(lambda: None, cold_l2=True),
                  "warm_ms": cuda_ms(lambda: None, cold_l2=False)}
    emit({"phase": "graph_replay", **replay})
    return replay


def _planted(batch: int, seed: int) -> torch.Tensor:
    """(B, 46, 46, 15) maps with one planted peak per part, as an NHWC
    view of NCHW memory (``_layout`` makes them NHWC memory)."""
    rng = np.random.RandomState(seed)
    hm = rng.rand(batch, 15, 46, 46).astype(np.float32)
    for b in range(batch):
        for j in range(14):
            hm[b, j, (7 * b + j) % 46, (3 * j + 5) % 46] = 3.0
    return torch.from_numpy(hm).to(DEVICE).permute(0, 2, 3, 1)


def soft_argmax_bound_ms(batch: int, h: int = 46, w: int = 46,
                         c: int = 15):
    """Least time for the decode on this card: every part map's bytes
    read once from HBM (the background map is never read) and every
    output byte written once, against ~8 float32 operations per part cell
    (max, subtract, scale, exp, three multiply-adds)."""
    bytes_moved = batch * h * w * (c - 1) * 4 + batch * (c - 1) * 3 * 4
    ops = batch * (c - 1) * h * w * 8
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _delta(layout: str) -> torch.Tensor:
    """One 10.0 in part 0 of a zero map: decodes exactly to its cell."""
    hm = torch.zeros(1, 15, 46, 46, device=DEVICE)
    hm[0, 0, 20, 33] = 10.0
    return _layout(hm.permute(0, 2, 3, 1), layout)


def _layout(hm: torch.Tensor, layout: str) -> torch.Tensor:
    """NHWC memory ("nhwc"), what both paths' CPMs give on the card
    (``breakdown.heatmaps_layout``), or an NHWC view of NCHW memory
    ("nchw_view"), where each map is one contiguous run."""
    return hm.contiguous() if layout == "nhwc" else hm


SA_LAYOUTS = ("nhwc", "nchw_view")


def phase_soft_argmax_check() -> dict:
    """Kernel vs plain version in both heatmap layouts: the main paths'
    batches (1, 8, 16, 128), an odd batch, the delta peak (exact) and a
    NaN in one map (NaN in that part only, as the plain version)."""
    cases = {}
    for layout in SA_LAYOUTS:
        for b in (1, 8, 16, 128):
            cases[f"{layout}_b{b}"] = (_layout(_planted(b, b), layout), 100.0)
        cases[f"{layout}_odd_b3_beta50"] = (_layout(_planted(3, 3), layout),
                                            50.0)
        cases[f"{layout}_delta_peak"] = (_delta(layout), 100.0)
        nan = _layout(_planted(2, 4), layout)
        nan[1, 7, 9, 3] = float("nan")
        cases[f"{layout}_nan_map"] = (nan, 100.0)
    worst = 0.0
    for name, (hm, beta) in cases.items():
        j_k, c_k = cuda_kernels.soft_argmax_cuda(hm, beta=beta, stride=8)
        torch.cuda.synchronize()
        j_p, c_p = softargmax_lib.soft_argmax(hm, beta=beta, stride=8)
        if name.endswith("nan_map"):
            check(bool(torch.isnan(c_k[1, 3]) and torch.isnan(j_k[1, 3]).all()
                       and int(torch.isnan(c_k).sum()) == 1),
                  f"{name}: NaN reaches that part's joint and conf only")
            keep = ~torch.isnan(c_p)
            j_k, j_p, c_k, c_p = j_k[keep], j_p[keep], c_k[keep], c_p[keep]
        ok_j, err_j = close(j_k, j_p, **SA_JOINT_TOL)
        ok_c, err_c = close(c_k, c_p, **SA_CONF_TOL)
        emit({"phase": "soft_argmax_check", "case": name,
              "shape": list(hm.shape), "max_abs_err_joints_px": err_j,
              "max_abs_err_conf": err_c, "ok": ok_j and ok_c})
        check(ok_j and ok_c, f"soft_argmax kernel vs plain, {name}")
        if name.endswith("delta_peak"):
            check(j_k[0, 0].tolist() == [33.0 * 8, 20.0 * 8],
                  f"{name} decodes exactly to its cell corner: "
                  f"{j_k[0, 0].tolist()}")
        worst = max(worst, err_j, err_c)
    return {"max_abs_err": worst}


def phase_soft_argmax_timing(replay: dict) -> dict:
    """B1 and its plain version in both layouts: NHWC memory at the paths'
    batches (the bf16 path decodes B = 1..128 at once, the int8 path a
    chunk of 16), and the NCHW view."""
    rows = {}
    for layout, b in (("nhwc", 1), ("nhwc", 8), ("nhwc", 16), ("nhwc", 128),
                      ("nchw_view", 8), ("nchw_view", 128)):
        hm = _layout(_planted(b, 100 + b), layout)
        def kernel():
            return cuda_kernels.soft_argmax_cuda(hm, 100.0, 8)

        def plain():
            return softargmax_lib.soft_argmax(hm, 100.0, 8)

        bound, bound_by = soft_argmax_bound_ms(b)
        rows[layout, b] = {
            "ms": cuda_ms(kernel, cold_l2=True),
            "plain_ms": cuda_ms(plain, cold_l2=True),
            "bound_ms": bound, "bound_by": bound_by,
            "l2_warm_ms": cuda_ms(kernel, cold_l2=False),
            "plain_l2_warm_ms": cuda_ms(plain, cold_l2=False),
            "eager_ms": eager_ms(kernel), "plain_eager_ms": eager_ms(plain),
            "replay_ms": replay["cold_ms"],
            "replay_l2_warm_ms": replay["warm_ms"]}
        emit({"phase": "soft_argmax_timing", "layout": layout, "batch": b,
              **rows[layout, b], "library_ms": None})
    return rows


def _frames(t: int, h: int, w: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        0, 256, (t, h, w, 3)).astype(np.uint8)


B2_NONE = {"quantize_act": 0, "quantize_im2col": 0, "quantize_act_absmax": 0}


def phase_main_path(est: PoseEstimator, images: np.ndarray,
                    phase: str = "main_path", b2_launches: dict = B2_NONE):
    """One warm-up and three timed estimate_and_fit calls, with the launch
    counts zeroed just before and read just after. ``b2_launches``: the
    launches of B2's kernels the four calls must make."""
    calls = 4
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res = est.estimate_and_fit(images)           # warm-up
    torch.cuda.synchronize()
    seconds = []
    for _ in range(calls - 1):
        t0 = time.perf_counter()
        res = est.estimate_and_fit(images)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = read_counts()
    b = images.shape[0]
    check_result(res, b)
    check(launches["soft_argmax"] >= calls,
          f"soft_argmax launched {launches['soft_argmax']} times in "
          f"{calls} estimate_and_fit calls")
    b2 = {k: launches[k] for k in b2_launches}
    check(b2 == b2_launches, f"{phase}: B2 launched {b2}, expected "
          f"{b2_launches}")
    emit({"phase": phase, "batch": b, "calls": calls,
          "launches": launches, "seconds_per_call": seconds,
          "frames_per_s": [b / s for s in seconds],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return res, launches


def phase_breakdown(est: PoseEstimator, images: np.ndarray) -> None:
    """The main path's phases one at a time, each bracketed by a
    synchronize (host clock)."""
    cfg = est.cpm_cfg
    x_u8 = torch.from_numpy(images).to(DEVICE)
    out = {}
    with torch.no_grad():
        def cpm():
            x = pre.preprocess(x_u8, cfg.input_size)
            cm = pre.gaussian_center_map(cfg.input_size, cfg.center_sigma,
                                         device=x.device)
            out["hm"] = cpm_lib.cpm_forward(
                est.cpm, x, cm.expand(x.shape[0], *cm.shape), cfg)[-1]
        t_cpm = host_s(cpm)
        t_dec = host_s(lambda: out.update(
            jc=cpm_lib._decode(out["hm"], cfg, 100.0)))
    j, c = out["jc"]
    t_fit = host_s(lambda: out.update(fit=fit_lib.fit_smpl_batch(
        est.smpl_model, j, c, est.fit_cfg, est.prior)))
    with torch.no_grad():
        t_mesh = host_s(lambda: smpl_lib.smpl_forward(
            est.smpl_model, out["fit"].beta, out["fit"].theta,
            precision=smpl_lib.EXACT_PRECISION))
    emit({"phase": "breakdown", "batch": images.shape[0],
          "heatmaps_layout": ("nhwc" if out["hm"].is_contiguous()
                              else "nchw_view"),
          "preprocess_cpm_s": t_cpm, "decode_s": t_dec, "fit_s": t_fit,
          "mesh_s": t_mesh,
          "fit_steps": sum(s.iters for s in est.fit_cfg.stages)})


def phase_profile(est: PoseEstimator, images: np.ndarray) -> None:
    """One estimate_and_fit call under torch.profiler, device activity
    only (what the rows read; tracing every host operator too took ≈ 40 s
    for the call's 65,815 launches): device time by kernel and the
    device's busy share of the wall time (the profiler's own overhead
    lengthens the wall time, so the share is a lower bound). Reports
    "not measured" if the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.estimate_and_fit(images)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows = kernel_rows(prof.key_averages())
    device_s = sum(r[2] for r in rows) / 1e6
    emit({"phase": "profile", "batch": images.shape[0], "wall_s": wall_s,
          "device_s": device_s if rows else "not measured",
          "device_busy_share": device_s / wall_s if rows else "not measured",
          "device_kernels": sum(r[1] for r in rows),
          "top": [{"name": k[:80], "count": n, "device_ms": t / 1e3}
                  for k, n, t in rows[:8]]})


def _act(shape, dtype, seed: int) -> torch.Tensor:
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return (2.0 * torch.randn(shape, generator=g, device=DEVICE)).to(dtype)


def _quant_cases():
    """(name, input, static scale or None): every B2 input shape of the
    int8 path at batch 16, static and dynamic; an odd element count;
    values exactly half-way between two steps; all zeros."""
    for i, (name, (shape, dtype)) in enumerate(QUANT_SHAPES.items()):
        x = _act(shape, dtype, i)
        yield f"{name}_dynamic", x, None
        yield f"{name}_static", x, torch.tensor(0.05, device=DEVICE)
    yield "odd_count_3x37x41x5_dynamic", _act((3, 37, 41, 5),
                                              torch.float32, 50), None
    g = torch.Generator(device=DEVICE).manual_seed(51)
    k = torch.randint(-120, 120, (16, 46, 46, 48), generator=g,
                      device=DEVICE).float()
    for dtype in (torch.float32, torch.bfloat16):
        yield (f"halfway_{str(dtype)[6:]}_static",
               ((k + 0.5) * 0.25).to(dtype),
               torch.tensor(0.25, device=DEVICE))
    yield "zeros_dynamic", torch.zeros(16, 46, 46, 48, device=DEVICE), None


def phase_quantize_act_check() -> dict:
    """Kernel B2 against its plain version, bit for bit: the int8 values
    (torch.equal) and the scale (==)."""
    worst = 0
    for name, x, a_scale in _quant_cases():
        q_k, s_k = cuda_kernels.quantize_act_cuda(x, a_scale)
        torch.cuda.synchronize()
        q_p, s_p = quantize_lib.quantize_act(x, a_scale)
        err = int((q_k.int() - q_p.int()).abs().max())
        exact = torch.equal(q_k, q_p) and s_k.item() == s_p.item()
        emit({"phase": "quantize_act_check", "case": name,
              "shape": list(x.shape), "dtype": str(x.dtype)[6:],
              "scale": s_k.item(), "max_abs_err_int8": err,
              "scale_equal": s_k.item() == s_p.item(), "ok": exact})
        check(exact, f"quantize_act kernel vs plain, {name}")
        if name == "zeros_dynamic":
            check(s_k.item() == np.float32(1e-12), "the 1e-12 scale floor")
        worst = max(worst, err)
    return {"max_abs_err": worst}


def quantize_bound_ms(numel: int, in_bytes: int, reads: int = 1):
    """Least time for one quantize on this card: the input read ``reads``
    times and one int8 byte written per value over HBM, against ~6
    float32 operations per value (convert, divide, round, two clamps,
    convert)."""
    t_bytes = (reads * numel * in_bytes + numel) / HBM_BYTES_PER_S * 1e3
    t_ops = 6 * numel / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_quantize_act_timing(replay: dict) -> dict:
    """The 1×1 convs' inputs at batch 16: the quantize pass with a static
    and a dynamic scale, its plain version, and torch.quantize_per_tensor —
    the nearest single library call, not the same function (range
    −128..127; takes float32 only, so it reads a float32 copy of a bf16
    input); the count of its values that differ from the kernel's is
    reported, not held."""
    rows = {}
    for name in QUANT_TIMED:
        shape, dtype = QUANT_SHAPES[name]
        x = _act(shape, dtype, 100)
        a = quantize_lib.quantize_act(x)[1]    # its dynamic scale, static
        x32, s = x.float(), a.item()

        def static():
            return cuda_kernels.quantize_act_cuda(x, a)

        def dynamic():
            return cuda_kernels.quantize_act_cuda(x)

        def plain():
            return quantize_lib.quantize_act(x, a)

        def library():
            return torch.quantize_per_tensor(x32, s, 0, torch.qint8)

        diff = int((torch.int_repr(library()) != static()[0]).sum())
        numel, size = x.numel(), x.element_size()
        bound, bound_by = quantize_bound_ms(numel, size)
        row = {"ms": cuda_ms(static, cold_l2=True),
               "l2_warm_ms": cuda_ms(static, cold_l2=False),
               "dynamic_ms": cuda_ms(dynamic, cold_l2=True),
               "dynamic_l2_warm_ms": cuda_ms(dynamic, cold_l2=False),
               "plain_ms": cuda_ms(plain, cold_l2=True),
               "plain_l2_warm_ms": cuda_ms(plain, cold_l2=False),
               "library_ms": cuda_ms(library, cold_l2=True),
               "library_l2_warm_ms": cuda_ms(library, cold_l2=False),
               "library_values_differing": diff,
               "bound_ms": bound, "bound_by": bound_by,
               "dynamic_bound_ms": (quantize_bound_ms(numel, size, 2)[0]
                                    if numel * size > L2_BYTES else bound),
               "replay_ms": replay["cold_ms"],
               "replay_l2_warm_ms": replay["warm_ms"],
               "input_mb": numel * size / 1e6}
        rows[name] = row
        emit({"phase": "quantize_act_timing", "shape": list(shape),
              "dtype": str(dtype)[6:], "name": name, **row})
    return rows


# Every k×k conv input of the int8 path per chunk of 16 frames, the input
# of kernel B2's fused gather: (shape, dtype, k, output channels).
IM2COL_SHAPES = {
    "conv1_368x368x3_f32_k9": ((16, 368, 368, 3), torch.float32, 9, 128),
    "trunk_184x184x128_bf16_k9": ((16, 184, 184, 128), torch.bfloat16, 9,
                                  128),
    "trunk_92x92x128_bf16_k9": ((16, 92, 92, 128), torch.bfloat16, 9, 128),
    "conv4_46x46x128_bf16_k5": ((16, 46, 46, 128), torch.bfloat16, 5, 32),
    "conv5_46x46x32_bf16_k9": ((16, 46, 46, 32), torch.bfloat16, 9, 512),
    "mconv1_46x46x48_f32_k11": ((16, 46, 46, 48), torch.float32, 11, 128),
    "mconv2_46x46x128_bf16_k11": ((16, 46, 46, 128), torch.bfloat16, 11,
                                  128),
}
IM2COL_TIMED = ("trunk_184x184x128_bf16_k9", "mconv2_46x46x128_bf16_k11",
                "conv1_368x368x3_f32_k9")
IM2COL_KERNEL_ROW = "trunk_184x184x128_bf16_k9"   # the kernels line's


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def im2col_tiles(shape, k: int, n: int) -> list:
    """The tiles ``int8_conv`` cuts a conv of this input into."""
    b, h, w, c = shape
    return list(quantize_lib._tiles(b, h, w * (_pad8(k * k * c)
                                               + 8 * _pad8(n))))


def _rows_buffer(x: torch.Tensor, k: int, tile) -> torch.Tensor:
    b0, b1, h0, h1 = tile
    return torch.empty(((b1 - b0) * (h1 - h0) * x.shape[2],
                        _pad8(k * k * x.shape[3])), dtype=torch.int8,
                       device=x.device)


def _im2col_cases():
    """(name, input, static scale or None, k, tiles): every k×k input of
    the int8 path at batch 16 with all of its tiles, static and dynamic;
    row-split tiles; a channels-last view with an odd row stride and an
    unaligned start; half-way values; all zeros; int8 input."""
    for i, (name, (shape, dtype, k, n)) in enumerate(IM2COL_SHAPES.items()):
        x = _act(shape, dtype, 200 + i)
        tiles = im2col_tiles(shape, k, n)
        yield f"{name}_static", x, torch.tensor(0.05, device=DEVICE), k, tiles
        yield f"{name}_dynamic", x, None, k, tiles
    x = _act((16, 184, 184, 128), torch.bfloat16, 210)
    yield "row_split_tiles", x, None, 9, [(3, 4, 50, 61), (15, 16, 170, 184)]
    x = _act((16, 46, 46, 131), torch.bfloat16, 211)[..., 3:]
    yield "strided_view_46x46x128", x, None, 11, [(0, 16, 0, 46)]
    g = torch.Generator(device=DEVICE).manual_seed(212)
    half = torch.randint(-120, 120, (16, 46, 46, 48), generator=g,
                         device=DEVICE).float() + 0.5
    for dtype in (torch.float32, torch.bfloat16):
        yield (f"halfway_{str(dtype)[6:]}", (half * 0.25).to(dtype),
               torch.tensor(0.25, device=DEVICE), 11, [(0, 16, 0, 46)])
    yield ("zeros_dynamic", torch.zeros(16, 46, 46, 48, device=DEVICE), None,
           11, [(0, 16, 0, 46)])
    q = torch.randint(-127, 128, (16, 46, 46, 128), generator=g,
                      device=DEVICE).to(torch.int8)
    yield "int8_input", q, None, 11, im2col_tiles(q.shape, 11, 128)


def phase_quantize_im2col_check() -> dict:
    """B2's fused quantize-and-gather against its plain version, bit for
    bit, on every tile of every case: the rows (torch.equal) and, with a
    dynamic scale, the scale of the whole tensor (==)."""
    worst = 0
    for name, x, a_scale, k, tiles in _im2col_cases():
        scale = None
        if x.dtype != torch.int8:
            scale = cuda_kernels.act_scale_cuda(x, a_scale)
            check(scale.item() == quantize_lib.act_scale(x, a_scale).item(),
                  f"quantize_im2col {name}: scale")
        exact, err = True, 0
        for tile in tiles:
            got = cuda_kernels.quantize_im2col_cuda(
                x, scale, k, tile, _rows_buffer(x, k, tile).fill_(99))
            torch.cuda.synchronize()
            want = quantize_lib.quantize_im2col(x, scale, k, tile,
                                                _rows_buffer(x, k, tile))
            exact = exact and torch.equal(got, want)
            err = max(err, int((got.int() - want.int()).abs().max()))
        emit({"phase": "quantize_im2col_check", "case": name,
              "shape": list(x.shape), "dtype": str(x.dtype)[6:], "k": k,
              "tiles": len(tiles),
              "scale": None if scale is None else scale.item(),
              "max_abs_err_int8": err, "ok": exact})
        check(exact, f"quantize_im2col kernel vs plain, {name}")
        if name == "zeros_dynamic":
            check(scale.item() == np.float32(1e-12), "the 1e-12 scale floor")
        worst = max(worst, err)
    return {"max_abs_err": worst}


def im2col_bound_ms(x: torch.Tensor, k: int, tile):
    """Least time for one tile's fused gather on this card: the tile's
    rows written once and the input rows they cover read once, over HBM,
    against ~6 float32 operations per value read (quantize)."""
    b0, b1, h0, h1 = tile
    _, h, w, c = x.shape
    p = k // 2
    read = (b1 - b0) * (min(h1 + p, h) - max(h0 - p, 0)) * w * c
    write = (b1 - b0) * (h1 - h0) * w * _pad8(k * k * c)
    t_bytes = (read * x.element_size() + write) / HBM_BYTES_PER_S * 1e3
    t_ops = 6 * read / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def unfused_route(x: torch.Tensor, scale, k: int, tile,
                  out: torch.Tensor):
    """The unfused route to the same rows, which ``int8_conv`` took
    before the gather: B2's standalone quantize pass over the tile's
    images, ``F.pad``, and the ``unfold`` copy."""
    b0, b1, h0, h1 = tile
    p, c = k // 2, x.shape[3]
    q = F.pad(cuda_kernels.quantize_act_cuda(x[b0:b1], scale)[0],
              (0, 0, p, p, p, p))
    win = q[:, h0:h1 + k - 1].unfold(1, k, 1).unfold(2, k, 1)
    out[:, :k * k * c].view(b1 - b0, h1 - h0, x.shape[2], k, k, c).copy_(
        win.permute(0, 1, 2, 4, 5, 3))
    return out


def phase_quantize_im2col_timing(replay: dict) -> dict:
    """The fused gather at three tiles of the int8 path (batch 16): the
    first tile of conv2 (one 184² image, 9×9×128), of Mconv2 (15 images
    of 46², 11×11×128) and of conv1 (three 368² f32 images, C = 3);
    against its byte bound, the unfused route for the same tile and the
    plain version, L2 flushed and warm."""
    rows = {}
    for name in IM2COL_TIMED:
        shape, dtype, k, n = IM2COL_SHAPES[name]
        x = _act(shape, dtype, 300)
        scale = quantize_lib.act_scale(x)
        tile = im2col_tiles(shape, k, n)[0]
        out = _rows_buffer(x, k, tile)
        k_real = k * k * shape[3]           # the route leaves K_pad alone
        route_rows = unfused_route(x, scale, k, tile, out.clone())
        gathered = cuda_kernels.quantize_im2col_cuda(x, scale, k, tile, out)
        check(torch.equal(route_rows[:, :k_real], gathered[:, :k_real]),
              f"the unfused route gives the kernel's rows, {name}")

        def kernel():
            return cuda_kernels.quantize_im2col_cuda(x, scale, k, tile, out)

        def route():
            return unfused_route(x, scale, k, tile, out)

        def plain():
            return quantize_lib.quantize_im2col(x, scale, k, tile, out)

        bound, bound_by = im2col_bound_ms(x, k, tile)
        rows[name] = {"ms": cuda_ms(kernel, cold_l2=True),
                      "l2_warm_ms": cuda_ms(kernel, cold_l2=False),
                      "unfused_route_ms": cuda_ms(route, cold_l2=True),
                      "unfused_route_l2_warm_ms": cuda_ms(route,
                                                          cold_l2=False),
                      "plain_ms": cuda_ms(plain, cold_l2=True),
                      "plain_l2_warm_ms": cuda_ms(plain, cold_l2=False),
                      "bound_ms": bound, "bound_by": bound_by,
                      "library_ms": None, "replay_ms": replay["cold_ms"],
                      "tile": list(tile), "rows_mb": out.numel() / 1e6}
        emit({"phase": "quantize_im2col_timing", "name": name,
              "shape": list(shape), "dtype": str(dtype)[6:], "k": k,
              **rows[name]})
    return rows


def phase_int8_dynamic(images: np.ndarray) -> None:
    """A quantize=True estimator without calibration frames (dynamic
    scales) at batch 16: one call; one abs-max pass per conv, then a
    quantize pass per 1×1 conv and a fused gather per tile of the
    others."""
    est = PoseEstimator.create_synthetic(seed=0, cpm_cfg=MAIN_CPM,
                                         quantize=True, device=DEVICE)
    want = {"soft_argmax": 1, **int8_launches(est.cpm, MAIN_CPM,
                                                 images.shape[0], True)}
    zero_counts()
    t0 = time.perf_counter()
    res = est.estimate_and_fit(images)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    check_result(res, images.shape[0])
    check(launches == want, f"dynamic-scale int8 call launched {launches}, "
          f"expected {want}")
    emit({"phase": "int8_dynamic", "batch": images.shape[0],
          "launches": launches, "seconds": seconds})


def phase_int8_small_batch(est: PoseEstimator, images: np.ndarray) -> None:
    """A batch below int8_min_batch on the quantize=True estimator runs
    the bf16 CPM: no B2 launch."""
    zero_counts()
    res = est.estimate_and_fit(images)
    torch.cuda.synchronize()
    launches = read_counts()
    check_result(res, images.shape[0])
    check(launches == {"soft_argmax": 1, **B2_NONE},
          f"batch-{images.shape[0]} call on the int8 estimator launched "
          f"{launches}")
    emit({"phase": "int8_small_batch", "batch": images.shape[0],
          "int8_min_batch": est.int8_min_batch, "launches": launches})


def phase_int8_breakdown(est: PoseEstimator, images: np.ndarray) -> None:
    """Preprocess + CPM at batch 16 through the int8 and the bf16 CPM of
    the same estimator, in turns (int8, bf16, bf16, int8 after a warm-up
    of each), host clock around synchronized calls; then one int8 CPM
    forward under torch.profiler, device time by kernel, and the conv
    inputs that are not NHWC memory (which B2 would copy: the gather
    reads any channels-last strides, the abs-max pass dense memory)."""
    cfg = est.cpm_cfg
    x_u8 = torch.from_numpy(images).to(DEVICE)

    def cpm(module):
        with torch.no_grad():
            x = pre.preprocess(x_u8, cfg.input_size)
            cm = pre.gaussian_center_map(cfg.input_size, cfg.center_sigma,
                                         device=x.device)
            return cpm_lib.cpm_forward(module, x,
                                       cm.expand(x.shape[0], *cm.shape),
                                       cfg)[-1]

    modules = {"int8": est.cpm, "bf16": est.cpm_bf16}
    for m in modules.values():
        cpm(m)
    dense = {}
    with torch.no_grad():
        x = pre.preprocess(x_u8, cfg.input_size)
        cm = pre.gaussian_center_map(cfg.input_size, cfg.center_sigma,
                                     device=x.device)
        cpm_lib.cpm_forward(est.cpm, x, cm.expand(x.shape[0], *cm.shape),
                            cfg, on_conv_input=lambda n, h: dense.update(
                                {n: h.permute(0, 2, 3, 1).is_contiguous()}))
    not_nhwc = [name for name, ok in dense.items() if not ok]
    times = {"int8": [], "bf16": []}
    for name in ("int8", "bf16", "bf16", "int8"):
        times[name].append(host_s(lambda: cpm(modules[name])))
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cpm(est.cpm)
        torch.cuda.synchronize()
    rows = kernel_rows(prof.key_averages())
    emit({"phase": "int8_breakdown", "batch": images.shape[0],
          "int8_preprocess_cpm_s": times["int8"],
          "bf16_preprocess_cpm_s": times["bf16"],
          "int8_over_bf16": statistics.mean(times["int8"])
          / statistics.mean(times["bf16"]),
          "int8_cpm_device_s": (sum(r[2] for r in rows) / 1e6 if rows
                                else "not measured"),
          "conv_inputs_not_nhwc": not_nhwc,
          "int8_cpm_b2_device_ms": {
              name: sum(t for k, _, t in rows if name in k) / 1e3
              for name in ("im2col_kernel", "quantize_kernel",
                           "scale_kernel")},
          "int8_cpm_top": [{"name": k[:80], "count": n, "device_ms": t / 1e3}
                           for k, n, t in rows[:12]]})


def phase_int8_small_reference() -> None:
    """The GPU int8 path against the CPU int8 path (which the CPU tests
    hold against the JAX package) on a small model with float32
    activations: one QuantizedCPM quantized and calibrated on the CPU and
    copied to the card, the same preprocessed input and center map, TF32
    off. The int32 sums are exact and B2 is bit-exact, so any difference
    enters through float arithmetic outside them; the first conv input
    that differs says where."""
    cfg = CPMConfig(input_size=64, features=16, stage1_head_width=32,
                    refine_width=16, num_stages=3, compute_dtype="float32")
    cpu_float = cpm_lib.init_cpm_params(0, cfg, device="cpu")
    x = pre.preprocess(torch.from_numpy(_frames(4, 80, 80, seed=8)), 64)
    cm = pre.gaussian_center_map(64, cfg.center_sigma)
    cm = cm.expand(x.shape[0], *cm.shape).contiguous()
    scales = cpm_lib.calibrate_act_scales(cpu_float, x, cm, cfg)
    with NoTF32():
        for mode, act in (("static", scales), ("dynamic", None)):
            q_cpu = cpm_lib.quantize_params(cpu_float, act)
            q_gpu = copy.deepcopy(q_cpu).to(DEVICE)
            taps = {"cpu": {}, "gpu": {}}
            outs = {}
            with torch.no_grad():
                for dev, q, where in (("cpu", q_cpu, "cpu"),
                                      ("gpu", q_gpu, DEVICE)):
                    hm = cpm_lib.cpm_forward(
                        q, x.to(where), cm.to(where), cfg,
                        on_conv_input=lambda n, h, d=dev:
                        taps[d].update({n: h.float().cpu()}))[-1]
                    outs[dev] = (hm.cpu(), cpm_lib._decode(hm, cfg, 100.0))
            first = next((n for n in taps["cpu"]
                          if not torch.equal(taps["cpu"][n], taps["gpu"][n])),
                         None)
            hm_err = float((outs["gpu"][0] - outs["cpu"][0]).abs().max())
            j_err = float((outs["gpu"][1][0].cpu()
                           - outs["cpu"][1][0]).abs().max())
            ok = j_err <= 0.5
            emit({"phase": "int8_small_reference", "scales": mode,
                  "max_abs_err_heatmaps": hm_err,
                  "max_abs_heatmap": float(outs["cpu"][0].abs().max()),
                  "max_abs_err_joints2d_px": j_err,
                  "first_differing_conv_input": first,
                  "first_difference": (None if first is None else float(
                      (taps["gpu"][first] - taps["cpu"][first]).abs().max())),
                  "ok": ok})
            check(ok, f"GPU vs CPU int8 path ({mode} scales): {j_err} px")


def phase_plain_decode(est: PoseEstimator, images: np.ndarray,
                       res) -> None:
    """The same batch with decode_impl="torch" (outside the counted run):
    the decoded joints must agree with the kernel's within 1e-3 px."""
    cfg = dataclasses.replace(est.cpm_cfg, decode_impl="torch")
    plain = PoseEstimator(est.cpm, est.smpl_model, est.prior, cfg,
                          est.fit_cfg, device=DEVICE)
    before = cuda_kernels.soft_argmax_cuda.launches
    ref = plain.estimate_and_fit(images)
    check(cuda_kernels.soft_argmax_cuda.launches == before,
          "decode_impl='torch' launched the kernel")
    ok, err = close(res.joints2d, ref.joints2d, 0.0, 1e-3)
    emit({"phase": "plain_decode", "max_abs_err_joints2d_px": err, "ok": ok})
    check(ok, "kernel vs plain decode end to end")


def phase_small_reference() -> None:
    """The GPU path against the CPU path (which the CPU tests hold against
    the JAX package) on a small float32 model, TF32 off."""
    cpm_cfg = CPMConfig(input_size=64, features=16, stage1_head_width=32,
                        refine_width=16, num_stages=2,
                        compute_dtype="float32")
    fit_cfg = FitConfig(
        stages=(StageConfig(iters=20, lr=0.05, opt_pose=False,
                            opt_shape=False, w_pose_prior=0,
                            w_shape_prior=0, w_angle_prior=0),
                StageConfig(iters=40, lr=0.02, w_pose_prior=0.5,
                            w_shape_prior=1.0)), img_size=64)
    images = _frames(2, 64, 64, seed=7)
    with NoTF32():
        gpu = PoseEstimator.create_synthetic(0, cpm_cfg, fit_cfg,
                                             device=DEVICE)
        cpu = PoseEstimator.create_synthetic(0, cpm_cfg, fit_cfg,
                                             device="cpu")
        g, c = gpu.estimate_and_fit(images), cpu.estimate_and_fit(images)
    ok_j, err_j = close(g.joints2d, c.joints2d, 0.0, 1e-2)
    mpjpe_mm = 1000.0 * float(
        (g.joints3d.cpu() - c.joints3d).norm(dim=-1).mean())
    v_mm = 1000.0 * float((g.vertices.cpu() - c.vertices).norm(dim=-1).mean())
    ok = ok_j and mpjpe_mm <= 1.0 and v_mm <= 1.0
    emit({"phase": "small_reference", "max_abs_err_joints2d_px": err_j,
          "joints3d_mpjpe_mm": mpjpe_mm, "vertices_mean_mm": v_mm,
          "ok": ok})
    check(ok, "GPU vs CPU path on the small float32 model")


def phase_fit_recovery(est: PoseEstimator) -> None:
    """Project known bodies (θ*, β*) through a known camera and fit them
    with ``fit_smpl``, as tests/test_fit.py's recovery tests do. Adam
    (priors off, a longer schedule than the default): the mean
    reprojection error must fall ≥100× from the init. L-BFGS
    (tests/test_fit.py:142's schedule: 20 + 60 steps, only a 0.1 shape
    prior): it must end below 3 px, as there."""
    b = MAIN_BATCH
    off = dict(w_pose_prior=0.0, w_shape_prior=0.0, w_angle_prior=0.0)
    cases = {
        "adam": (FitConfig(stages=(
            StageConfig(iters=60, lr=0.05, opt_pose=False, opt_shape=False,
                        **off),
            StageConfig(iters=300, lr=0.02, **off),
            StageConfig(iters=300, lr=0.005, **off),
            StageConfig(iters=200, lr=0.001, **off))),
            lambda e0, e1: e1 * 100.0 <= e0),
        "lbfgs": (FitConfig(optimizer="lbfgs", stages=(
            StageConfig(iters=20, lr=0.0, opt_pose=False, opt_shape=False,
                        **off),
            StageConfig(iters=60, lr=0.0, **dict(off, w_shape_prior=0.1)))),
            lambda e0, e1: e1 < 3.0)}
    model = est.smpl_model
    rng = np.random.RandomState(3)
    theta = torch.from_numpy((0.2 * rng.randn(b, 72)).astype(np.float32))
    beta = torch.from_numpy(rng.randn(b, 10).astype(np.float32))
    cam = torch.tensor([[0.8, 0.05, -0.1]]).repeat(b, 1).to(DEVICE)
    with torch.no_grad():
        j3d = joints_lib.select_smpl_joints(smpl_lib.smpl_joints(
            model, beta.to(DEVICE), theta.to(DEVICE)))
        norm = j3d[..., :2] * cam[:, None, :1] + cam[:, None, 1:]
    for name, (cfg, passes) in cases.items():
        fitter = PoseEstimator(est.cpm, model, None, est.cpm_cfg, cfg,
                               device=DEVICE)
        half = cfg.img_size / 2.0
        px = norm * half + half
        conf = torch.ones(b, 14, device=DEVICE)

        def reproj_px(theta, beta, cam, cfg=cfg, half=half):
            r = fit_lib.FitResult(theta, beta, cam, None, None)
            with torch.no_grad():
                pred = fit_lib.reproject(model, r, cfg)
            return float(((pred - norm) * half).norm(dim=-1).mean())

        init = fit_lib.default_init(model, norm, conf, cfg)
        t0 = time.perf_counter()
        res = fitter.fit_smpl(px, conf)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        e0 = reproj_px(init["theta"], init["beta"], init["cam"])
        e1 = reproj_px(res.theta, res.beta, res.cam)
        ok = passes(e0, e1)
        emit({"phase": "fit_recovery", "optimizer": name, "batch": b,
              "steps": sum(s.iters for s in cfg.stages),
              "seconds": seconds, "init_reproj_px": e0,
              "final_reproj_px": e1, "ratio": e0 / max(e1, 1e-12),
              "ok": ok})
        check(ok, f"fit recovery ({name}): reprojection {e0} px -> {e1} px")


# -- the accuracy front end and video (ROADMAP A.10, A.11) --------------------

FRONT_END = dict(letterbox=True, refine_scale=True, flip_tta=True,
                 scale_tta=(0.8, 1.25))
FRONT_END_HW = (480, 640)          # non-square frames: the letterbox pads
# B1 per front-end pass with refine_scale: the β = 30 geometry decode and
# the final decode. Passes: base, 2 scales, each also mirrored.
FRONT_END_B1 = 2 * (1 + len(FRONT_END["scale_tta"])) * 2
# Crops per front-end call: one refine_scale crop per pass, plus one
# centered zoom per TTA scale.
FRONT_END_CROPS = (1 + len(FRONT_END["scale_tta"])) * 2 \
    + len(FRONT_END["scale_tta"])
VIDEO_T = 32                      # BASELINE.json configuration 4: 64
TEMPORAL_T = 16                   # temporal mode's frames (sequential fits)
VIDEO_RESTARTS = 4
STREAM_T, STREAM_CHUNK, STREAM_PUSH = 48, 32, 7


def _smooth_frames(t: int, h: int, w: int, seed: int) -> np.ndarray:
    """uint8 frames of a 6×5 random field interpolated up (bilinear,
    numpy): the small-reference inputs, on which the random-weight
    network's crop geometry is well conditioned (tests/
    test_torch_front_end.py)."""
    lo = np.random.RandomState(seed).rand(t, 6, 5, 3) * 255.0
    ys, xs = np.linspace(0, 5, h), np.linspace(0, 4, w)
    y0, x0 = np.minimum(ys.astype(int), 4), np.minimum(xs.astype(int), 3)
    fy = (ys - y0)[None, :, None, None]
    fx = (xs - x0)[None, None, :, None]
    top = lo[:, y0][:, :, x0] * (1 - fx) + lo[:, y0][:, :, x0 + 1] * fx
    bot = lo[:, y0 + 1][:, :, x0] * (1 - fx) + lo[:, y0 + 1][:, :, x0 + 1] * fx
    return np.clip(np.round(top * (1 - fy) + bot * fy), 0, 255).astype(
        np.uint8)


# A stick figure's 14 joints in CPM order, (x, y) in units of its height
# from its center.
FIGURE = np.array([[0, -.45], [0, -.33], [-.12, -.3], [-.17, -.12],
                   [-.2, .03], [.12, -.3], [.17, -.12], [.2, .03],
                   [-.07, .05], [-.08, .27], [-.09, .48], [.07, .05],
                   [.08, .27], [.09, .48]], np.float32)
FIGURE_COLORS = np.array([[230, 40, 40], [40, 60, 230]], np.float32)


def two_people_frames(t: int, h: int, w: int, seed: int,
                      spread: float = 0.5) -> np.ndarray:
    """uint8 (t, h, w, 3) frames of two people standing apart, ``spread``
    of the width from each other around the middle, drifting half a pixel
    per frame: each a stick figure 0.6·min(h, w) tall of 14 Gaussian
    joint blobs in one color over the dimmed ``_smooth_frames`` field.
    Smooth images, so that the random-weight network's peaks and crops are
    well conditioned."""
    img = 0.4 * _smooth_frames(t, h, w, seed).astype(np.float32)
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    side = min(h, w)
    sigma = 0.05 * side
    for f in range(t):
        for i, color in enumerate(FIGURE_COLORS):
            center = (w * (0.5 + (i - 0.5) * spread) + (i - 0.5) * f,
                      h * 0.5 + 0.3 * f)
            j = FIGURE * 0.6 * side + center
            d2 = ((gx[None] - j[:, :1, None]) ** 2
                  + (gy[None] - j[:, 1:, None]) ** 2)
            g = np.exp(-d2 / (2 * sigma * sigma)).max(0)[..., None]
            img[f] = img[f] * (1 - g) + g * color
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _timed_calls(fn, calls: int):
    """``calls`` synchronized calls of ``fn`` (the first a warm-up): the
    last result and the host seconds of the timed ones."""
    res = fn()
    torch.cuda.synchronize()
    seconds = []
    for _ in range(calls - 1):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return res, seconds


def phase_front_end_main_path(est: PoseEstimator,
                              frames: np.ndarray) -> dict:
    """estimate_and_fit with letterbox, refine_scale, flip and scale TTA
    on non-square uint8 frames: one warm-up and three timed calls with
    the launch counts zeroed just before and read just after; 12 B1
    launches per call, no B2. The joints come back in source pixels:
    each image's median joint lies inside the frame."""
    calls = 4
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res, seconds = _timed_calls(lambda: est.estimate_and_fit(frames), calls)
    launches = read_counts()
    b, h, w = frames.shape[:3]
    check_result(res, b)
    want = {"soft_argmax": FRONT_END_B1 * calls, **B2_NONE}
    check(launches == want, f"front end launched {launches}, expected "
          f"{want}")
    med = res.joints2d.median(dim=1).values.cpu()
    inside = bool(((med >= 0) & (med < torch.tensor([w, h]))).all())
    j = res.joints2d.cpu()
    share = float(((j[..., 0] >= 0) & (j[..., 0] < w) & (j[..., 1] >= 0)
                   & (j[..., 1] < h)).float().mean())
    emit({"phase": "front_end_main_path", "batch": b, "frame_hw": [h, w],
          "knobs": {k: list(v) if isinstance(v, tuple) else v
                    for k, v in FRONT_END.items()},
          "calls": calls, "launches": launches,
          "b1_per_call": launches["soft_argmax"] // calls,
          "seconds_per_call": seconds,
          "frames_per_s": [b / t for t in seconds],
          "median_joint_inside_frame": inside,
          "joints_inside_frame_share": share,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    check(inside, "front end: each image's median joint inside the "
          "source frame")
    return launches


def phase_front_end_breakdown(est: PoseEstimator,
                              frames: np.ndarray) -> None:
    """The front-end call's parts one at a time (host clock around
    synchronized calls): the 2D front end with every knob, the same with
    only the letterbox (one plain pass), the fit, and the device time of
    one crop (``_crop_zoom`` of the batch, eager, events around it) times
    the crops a call makes."""
    out = {}
    t_front = host_s(lambda: out.update(fe=est._front_end(frames)))
    t_plain = host_s(lambda: est._front_end(
        frames, refine_scale=False, flip_tta=False, scale_tta=()))
    _, j, c = out["fe"]
    t_fit = host_s(lambda: fit_lib.fit_smpl_batch(
        est.smpl_model, j, c, est.fit_cfg, est.prior))
    x = pre.preprocess(torch.from_numpy(frames).to(DEVICE),
                       est.cpm_cfg.input_size, letterbox=True)
    b = x.shape[0]
    s = torch.linspace(0.7, 2.5, b, device=DEVICE)
    t = torch.full((b, 2), 40.0, device=DEVICE)
    crop_ms = eager_ms(lambda: cpm_lib._crop_zoom(x, s, t), reps=20)
    emit({"phase": "front_end_breakdown", "batch": b,
          "front_end_cpm_s": t_front, "plain_pass_cpm_s": t_plain,
          "front_end_over_plain": t_front / t_plain, "fit_s": t_fit,
          "crop_ms_each": crop_ms, "crops_per_call": FRONT_END_CROPS,
          "crop_s_per_call": crop_ms * FRONT_END_CROPS / 1e3,
          "fit_steps": sum(st.iters for st in est.fit_cfg.stages)})


def phase_video_main_path(est: PoseEstimator, frames: np.ndarray) -> dict:
    """estimate_and_fit_video(mode="smooth") over VIDEO_T frames with 4
    yaw hypotheses per frame (BASELINE.json configuration 4, cut from
    T = 64 to 32): one
    warm-up and two timed calls, launch counts zeroed before and read
    after (one B1 launch per call: the CPM runs the 64 frames at once);
    then the CPM and the fit one at a time."""
    calls = 3
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res, seconds = _timed_calls(
        lambda: est.estimate_and_fit_video(frames, "smooth"), calls)
    launches = read_counts()
    t = frames.shape[0]
    check_result(res, t)
    want = {"soft_argmax": calls, **B2_NONE}
    check(launches == want, f"video launched {launches}, expected {want}")
    check(bool((res.beta == res.beta[:1]).all()), "video: one shared β")
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = {}
    t_cpm = host_s(lambda: out.update(fe=est._front_end(frames)))
    _, j, c = out["fe"]
    t_fit = host_s(lambda: temporal.fit_video_smooth(
        est.smpl_model, j, c, est.fit_cfg, est.prior,
        restarts=est.fit_restarts))
    emit({"phase": "video_main_path", "frames": t, "mode": "smooth",
          "restarts": est.fit_restarts, "calls": calls,
          "launches": launches, "seconds_per_call": seconds,
          "frames_per_s": [t / x for x in seconds],
          "cpm_s": t_cpm, "fit_s": t_fit,
          "cpm_share": t_cpm / (t_cpm + t_fit),
          "fit_share": t_fit / (t_cpm + t_fit),
          "adam_steps": (sum(st.iters for st in est.fit_cfg.stages) + 100),
          "peak_mem_gb": peak})
    return launches


def _not_nhwc_conv_inputs(est: PoseEstimator, call) -> list:
    """The int8 conv inputs of ``call()`` (one front-end or multi pass of
    ``est``) that are not NHWC memory, which B2's gather refuses and its
    other passes would copy: ``_conv_q`` is wrapped for the call."""
    names = {id(m): n for n, m in est.cpm.named_children()}
    bad = []
    conv_q = cpm_lib._conv_q

    def tap(x, layer, relu, act_dtype):
        if not x.permute(0, 2, 3, 1).is_contiguous():
            bad.append(names[id(layer)])
        return conv_q(x, layer, relu, act_dtype)

    cpm_lib._conv_q = tap
    try:
        call()
    finally:
        cpm_lib._conv_q = conv_q
    return sorted(set(bad))


def phase_video_int8(est: PoseEstimator, frames: np.ndarray) -> dict:
    """The int8 video path: quantize=True, 8 calibration frames,
    cpm_microbatch=16, refine_scale, smooth mode, T = VIDEO_T. One warm-up and
    one timed call with the counts zeroed before and read after, held
    against the computed launches: per chunk of 16, B1 twice (geometry
    and final decode), B2's quantize passes and gathers with stage 1
    counted twice (the refine_scale crop round)."""
    calls = 2
    t = frames.shape[0]
    chunks = -(-t // est.cpm_microbatch)
    per_chunk = int8_launches(est.cpm, est.cpm_cfg, est.cpm_microbatch,
                              False, stage1_runs=2)
    want = {"soft_argmax": 2 * chunks * calls,
            **{k: n * chunks * calls for k, n in per_chunk.items()}}
    zero_counts()
    res, seconds = _timed_calls(
        lambda: est.estimate_and_fit_video(frames, "smooth"), calls)
    launches = read_counts()
    check_result(res, t)
    check(launches == want, f"int8 video launched {launches}, expected "
          f"{want}")
    not_nhwc = _not_nhwc_conv_inputs(
        est, lambda: est._front_end(frames[:est.cpm_microbatch]))
    emit({"phase": "video_int8", "frames": t, "chunks": chunks,
          "calls": calls, "launches": launches, "expected": want,
          "seconds_per_call": seconds,
          "frames_per_s": [t / x for x in seconds],
          "conv_inputs_not_nhwc": not_nhwc})
    check(not_nhwc == [], f"int8 conv inputs not NHWC memory: {not_nhwc}")
    return launches


def phase_video_modes(est: PoseEstimator, frames: np.ndarray) -> None:
    """The temporal (warm-start) and independent modes, one call each;
    temporal mode, ≈ 20 sequential eager Adam steps per frame, on the
    first ``TEMPORAL_T`` frames only."""
    for mode, clip in (("temporal", frames[:TEMPORAL_T]),
                       ("independent", frames)):
        zero_counts()
        t0 = time.perf_counter()
        res = est.estimate_and_fit_video(clip, mode)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check_result(res, clip.shape[0])
        launches = read_counts()
        check(launches["soft_argmax"] == 1, f"{mode}: {launches}")
        emit({"phase": "video_modes", "mode": mode,
              "frames": clip.shape[0], "seconds": seconds,
              "frames_per_s": clip.shape[0] / seconds,
              "launches": launches})


def _fit_gap(a, b, model) -> dict:
    """θ (without the leaf joints' rotations, which only the prior moves
    and float noise steers; tests/test_torch_temporal.py), β and cam max
    differences, and joints3d MPJPE and mean vertex error in mm, of two
    results on the same frames (any leading axes)."""
    gap = {k: float((getattr(a, k).cpu()[..., ix]
                     - getattr(b, k).cpu()[..., ix]).abs().max())
           for k, ix in (("theta", DRIVEN_THETA), ("beta", slice(None)),
                         ("cam", slice(None)))}
    with torch.no_grad():
        fa, fb = (smpl_lib.smpl_forward(model.to("cpu"),
                                        r.beta.cpu().reshape(-1, 10),
                                        r.theta.cpu().reshape(-1, 72),
                                        precision=smpl_lib.EXACT_PRECISION)
                  for r in (a, b))
    gap["joints3d_mpjpe_mm"] = 1000.0 * float(
        (fa.joints - fb.joints).norm(dim=-1).mean())
    gap["vertices_mean_mm"] = 1000.0 * float(
        (fa.vertices - fb.vertices).norm(dim=-1).mean())
    return gap


LEAF_THETA = [3 * j + a for j in (10, 11, 22, 23) for a in range(3)]
DRIVEN_THETA = [i for i in range(72) if i not in LEAF_THETA]


def phase_video_stream(est: PoseEstimator, frames: np.ndarray) -> None:
    """estimate_and_fit_video_stream(chunk=32) over STREAM_T frames (one
    full window and one padded), and a VideoSession(chunk=32) fed the same
    frames in pushes of 7, then flush(): the same windows and anchors, so
    the two agree (joints2d within 1e-3 px, joints3d and vertices within
    1 mm; the fits' float sums on the card are not bitwise repeatable)."""
    zero_counts()
    t0 = time.perf_counter()
    ref = est.estimate_and_fit_video_stream(frames, chunk=STREAM_CHUNK)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    stream_launches = read_counts()
    check_result(ref, frames.shape[0])
    session = VideoSession(est, chunk=STREAM_CHUNK)
    outs, t0 = [], time.perf_counter()
    for i in range(0, frames.shape[0], STREAM_PUSH):
        r = session.push(frames[i:i + STREAM_PUSH])
        if r is not None:
            outs.append(r)
    buffered = session.frames_buffered
    outs.append(session.flush())
    torch.cuda.synchronize()
    t_session = time.perf_counter() - t0
    got = api_lib._concat(outs)
    check_result(got, frames.shape[0])
    j_err = float((got.joints2d - ref.joints2d).abs().max())
    gap = _fit_gap(got, ref, est.smpl_model)
    ok = (j_err <= 1e-3 and gap["joints3d_mpjpe_mm"] <= 1.0
          and gap["vertices_mean_mm"] <= 1.0)
    emit({"phase": "video_stream", "frames": frames.shape[0],
          "chunk": STREAM_CHUNK, "push": STREAM_PUSH,
          "stream_s": t_stream, "session_s": t_session,
          "stream_launches": stream_launches,
          "buffered_before_flush": buffered,
          "max_abs_err_joints2d_px": j_err, **gap, "ok": ok})
    check(buffered == frames.shape[0] % STREAM_CHUNK,
          f"session buffered {buffered} frames before flush")
    check(ok, "VideoSession vs estimate_and_fit_video_stream")


def _small_cfgs():
    cpm_cfg = CPMConfig(input_size=64, features=16, stage1_head_width=32,
                        refine_width=16, num_stages=3,
                        compute_dtype="float32")
    fit_cfg = FitConfig(
        stages=(StageConfig(iters=15, lr=0.05, opt_pose=False,
                            opt_shape=False, w_pose_prior=0,
                            w_shape_prior=0, w_angle_prior=0),
                StageConfig(iters=25, lr=0.02, w_pose_prior=0.5,
                            w_shape_prior=1.0)), img_size=64)
    return cpm_cfg, fit_cfg


# The cases of tests/test_torch_front_end.py's KNOBS. On the small
# random-weight model the front end's sensitivity to float rounding
# depends on the case: "everything" at the default zoom (max_zoom 3,
# target 0.6) moves the joints by 0.03 px under 1e-6 relative weight
# noise on the CPU, so the case uses the CPU test's max_zoom 2 and
# target 0.7 (0.002 px).
SMALL_KNOBS = {
    "refine_center": dict(refine_center=True),
    "refine_scale": dict(refine_scale=True),
    "refine_scale_iters2": dict(refine_scale=True, scale_iters=2),
    "scale_from_refined": dict(refine_scale=True, scale_from_refined=True),
    "flip_tta": dict(flip_tta=True),
    "scale_tta": dict(scale_tta=(0.8, 1.25)),
    "flip_x_scale": dict(flip_tta=True, scale_tta=(0.8, 1.0, 1.25)),
    "flip_x_scale_refine_scale": dict(flip_tta=True, scale_tta=(0.8, 1.25),
                                      refine_scale=True),
    "letterbox_source_frame": dict(letterbox=True),
    "letterbox_network_frame": dict(letterbox=True, source_frame=False),
    "everything": dict(letterbox=True, refine_scale=True, flip_tta=True,
                       scale_tta=(0.8, 1.25), max_zoom=2.0,
                       scale_target_frac=0.7),
}


def phase_front_end_small_reference() -> None:
    """The GPU front end against the CPU one (which
    tests/test_torch_front_end.py holds against JAX) on a small float32
    CPM, TF32 off, one case per knob, 80×60 smooth frames: heatmaps and
    conf within 1e-4·max|b|, joints within 1e-2 px (the CPU tests'
    bounds). On the card every decode, the geometry's included, is a B1
    launch."""
    cfg, _ = _small_cfgs()
    cpu = cpm_lib.init_cpm_params(0, cfg, device="cpu")
    gpu = copy.deepcopy(cpu).to(DEVICE)
    images = torch.from_numpy(_smooth_frames(2, 80, 60, seed=2))
    with NoTF32(), torch.no_grad():
        for name, kw in SMALL_KNOBS.items():
            want = cpm_lib.estimate_2d_from_images(cpu, images, cfg, **kw)
            before = cuda_kernels.soft_argmax_cuda.launches
            got = cpm_lib.estimate_2d_from_images(gpu, images.to(DEVICE),
                                                  cfg, **kw)
            launched = cuda_kernels.soft_argmax_cuda.launches - before
            scale = float(want[0].abs().max())
            errs = [float((g.cpu() - w).abs().max())
                    for g, w in zip(got, want)]
            ok = (errs[0] <= 1e-4 * scale and errs[1] <= 1e-2
                  and errs[2] <= 1e-4 * scale and launched > 0)
            emit({"phase": "front_end_small_reference", "case": name,
                  "max_abs_err_heatmaps": errs[0], "max_abs_heatmap": scale,
                  "max_abs_err_joints2d_px": errs[1],
                  "max_abs_err_conf": errs[2], "b1_launches": launched,
                  "ok": ok})
            check(ok, f"GPU vs CPU front end, {name}")


def phase_video_small_reference() -> None:
    """The GPU video paths against the CPU ones (which
    tests/test_torch_temporal.py holds against JAX) on a small float32
    model, TF32 off: each mode of estimate_and_fit_video and the stream
    form, within the CPU tests' bounds (joints2d 1e-2 px; θ without the
    leaf rotations, β and cam 1e-3; joints3d and vertices 1 mm)."""
    cpm_cfg, fit_cfg = _small_cfgs()
    frames = _smooth_frames(5, 64, 64, seed=3)
    with NoTF32():
        ests = {dev: PoseEstimator.create_synthetic(
            0, cpm_cfg, fit_cfg, device=dev, fit_restarts=2)
            for dev in ("cpu", DEVICE)}
        calls = {m: (lambda e, m=m: e.estimate_and_fit_video(frames, m))
                 for m in ("smooth", "temporal", "independent")}
        calls["stream"] = lambda e: e.estimate_and_fit_video_stream(
            frames, chunk=2)
        for name, call in calls.items():
            want, got = call(ests["cpu"]), call(ests[DEVICE])
            j_err = float((got.joints2d.cpu() - want.joints2d).abs().max())
            gap = _fit_gap(got, want, ests["cpu"].smpl_model)
            ok = (j_err <= 1e-2 and max(gap["theta"], gap["beta"],
                                        gap["cam"]) <= 1e-3
                  and gap["joints3d_mpjpe_mm"] <= 1.0
                  and gap["vertices_mean_mm"] <= 1.0)
            emit({"phase": "video_small_reference", "case": name,
                  "max_abs_err_joints2d_px": j_err, **gap, "ok": ok})
            check(ok, f"GPU vs CPU video path, {name}")


# -- multi-person frames and tracked video (ROADMAP A.12, A.13) --------------

MULTI_PEOPLE = 2
MULTI_FRONT_END = dict(letterbox=True, refine_scale=True, flip_tta=True)
MULTI_FRONT_END_PEOPLE = 3
VIDEO_MULTI_T, VIDEO_MULTI_KNOBS_T = 32, 16
# Every knob of the tracked path: B1 runs once for the NMS pass, then per
# hint pass once for the hinted decode and once for its hint-centered crop.
VIDEO_MULTI_KNOBS = dict(hint_passes=2, hint_crop=True,
                         hint_crop_min_conf=0.5, track_reassociate=True,
                         allow_empty=True, track_death_frames=8,
                         track_anchor_refresh=0.1, presence_keep_frac=0.7)


def check_multi_result(res, b: int, k: int) -> None:
    shapes = {"joints2d": (b, k, 14, 2), "conf": (b, k, 14),
              "person_scores": (b, k), "person_mask": (b, k),
              "theta": (b, k, 72), "beta": (b, k, 10), "cam": (b, k, 3),
              "vertices": (b, k, 6890, 3), "joints3d": (b, k, 24, 3),
              "energy": (b, k)}
    for name, shape in shapes.items():
        v = getattr(res, name)
        check(tuple(v.shape) == shape, f"{name} shape {tuple(v.shape)}")
        if name not in ("person_mask", "person_scores"):
            check(bool(torch.isfinite(v).all()), f"{name} finite")
    check(bool(res.person_mask.any(1).all()), "a person in every frame")


def check_video_multi_result(res, t: int, k: int) -> None:
    shapes = {"joints2d": (t, k, 14, 2), "conf": (t, k, 14),
              "person_scores": (t, k), "frame_mask": (t, k),
              "track_mask": (k,), "perm": (t, k), "theta": (k, t, 72),
              "beta": (k, t, 10), "cam": (k, t, 3),
              "vertices": (k, t, 6890, 3), "joints3d": (k, t, 24, 3),
              "energy": (k, t)}
    for name, shape in shapes.items():
        v = getattr(res, name)
        check(tuple(v.shape) == shape, f"{name} shape {tuple(v.shape)}")
        if v.dtype.is_floating_point and name != "person_scores":
            check(bool(torch.isfinite(v).all()), f"{name} finite")
    check(torch.equal(res.perm.sort(1).values.cpu(),
                      torch.arange(k, dtype=torch.int32).expand(t, k)),
          "every perm row is a permutation")


def phase_multi_main_path(est: PoseEstimator, images: np.ndarray,
                          phase: str = "multi_main_path",
                          people: int = MULTI_PEOPLE, crop: bool = False,
                          flip_tta: bool = False) -> dict:
    """estimate_and_fit_multi: one warm-up and three timed calls, launch
    counts zeroed just before and read just after, B1 as
    ``multi_b1_launches`` computes it and no B2 (bf16); people kept per
    frame and peak memory."""
    calls = 4
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res, seconds = _timed_calls(
        lambda: est.estimate_and_fit_multi(images, max_people=people),
        calls)
    launches = read_counts()
    b = images.shape[0]
    check_multi_result(res, b, people)
    want = {"soft_argmax": multi_b1_launches(crop, flip_tta) * calls,
            **B2_NONE}
    check(launches == want, f"{phase} launched {launches}, expected {want}")
    emit({"phase": phase, "batch": b, "frame_hw": list(images.shape[1:3]),
          "max_people": people, "calls": calls, "launches": launches,
          "b1_per_call": launches["soft_argmax"] // calls,
          "seconds_per_call": seconds,
          "frames_per_s": [b / x for x in seconds],
          "people_kept_per_frame": res.person_mask.sum(1).tolist(),
          "person_scores": res.person_scores.tolist(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def phase_multi_int8(est: PoseEstimator, images: np.ndarray) -> dict:
    """The int8 multi path at batch 16 (``quantize=True``, 8 calibration
    frames): one warm-up and one timed call, counts zeroed before and read
    after, held against the computed launches (stage 1 and the refinement
    trunk at 16, the refinement stages on the 32-hypothesis fold, static
    scales); no non-NHWC conv input; then the int8 and the bf16 CPM's
    multi pass one after the other (int8, bf16, bf16, int8)."""
    calls = 3
    b, k = images.shape[0], MULTI_PEOPLE
    per_call = int8_launches(est.cpm, est.cpm_cfg, b, False, people=k)
    want = {"soft_argmax": calls,
            **{name: n * calls for name, n in per_call.items()}}
    zero_counts()
    res, seconds = _timed_calls(
        lambda: est.estimate_and_fit_multi(images, max_people=k), calls)
    launches = read_counts()
    check_multi_result(res, b, k)
    check(launches == want, f"int8 multi launched {launches}, expected "
          f"{want}")
    not_nhwc = _not_nhwc_conv_inputs(
        est, lambda: est._multi_2d(images, max_people=k))
    times = {"int8": [], "bf16": []}
    cpms = {"int8": est.cpm, "bf16": est.cpm_bf16}
    for name in ("int8", "bf16", "bf16", "int8"):
        times[name].append(host_s(lambda: est._multi_2d(
            images, cpm=cpms[name], max_people=k)))
    emit({"phase": "multi_int8", "batch": b, "max_people": k,
          "calls": calls, "launches": launches, "expected": want,
          "seconds_per_call": seconds,
          "int8_multi_cpm_s": times["int8"], "bf16_multi_cpm_s": times["bf16"],
          "int8_over_bf16": statistics.mean(times["int8"])
          / statistics.mean(times["bf16"]),
          "conv_inputs_not_nhwc": not_nhwc})
    check(not_nhwc == [], f"int8 multi conv inputs not NHWC: {not_nhwc}")
    return launches


def phase_video_multi_main_path(est: PoseEstimator,
                                frames: np.ndarray) -> dict:
    """estimate_and_fit_video_multi over T = VIDEO_MULTI_T frames, two
    people, ``fit_restarts`` yaw hypotheses per frame and track (2·T·4
    hypothesis fits), temporal hints: one warm-up and two timed calls,
    counts zeroed before and read after (B1 twice per call: the NMS pass
    and the hinted pass); then one multi pass, the tracker and the
    per-track fit one at a time, and the device time by kernel of a pass
    and the tracker under torch.profiler."""
    calls = 3
    t, k = frames.shape[0], MULTI_PEOPLE
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res, seconds = _timed_calls(
        lambda: est.estimate_and_fit_video_multi(frames, max_people=k),
        calls)
    launches = read_counts()
    check_video_multi_result(res, t, k)
    want = {"soft_argmax": 2 * calls, **B2_NONE}
    check(launches == want, f"video multi launched {launches}, expected "
          f"{want}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = {}
    t_cpm = host_s(lambda: out.update(d=est._multi_2d(frames, max_people=k)))
    _, joints, conf, scores = out["d"]
    size = est.cpm_cfg.input_size

    def tracker():
        x = pre.preprocess(est._tensor(frames), size)
        perm, _ = tracking.associate_tracks_viterbi(
            joints.reshape(t, k, -1) / size,
            tracking.appearance_features(x, joints), scores,
            score_gate=0.05, return_state=True)
        tj, ts = (tracking.gather_tracks(v, perm) for v in (joints, scores))
        out["hints"] = tracking.smooth_track_centers(
            tj.mean(-2), torch.clamp_min(ts, 0.0))

    t_track = host_s(tracker)
    t_fit = host_s(lambda: temporal.fit_video_smooth_tracks(
        est.smpl_model, joints.transpose(0, 1), conf.transpose(0, 1),
        est.fit_cfg, est.prior, restarts=est.fit_restarts))
    total = 2 * t_cpm + t_track + t_fit
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        est._multi_2d(frames, max_people=k)
        tracker()
        torch.cuda.synchronize()
    rows = kernel_rows(prof.key_averages())
    emit({"phase": "video_multi_main_path", "frames": t, "max_people": k,
          "restarts": est.fit_restarts, "calls": calls,
          "launches": launches, "seconds_per_call": seconds,
          "frames_per_s": [t / x for x in seconds],
          "cpm_pass_s": t_cpm, "tracker_s": t_track, "fit_s": t_fit,
          "cpm_share": 2 * t_cpm / total, "tracker_share": t_track / total,
          "fit_share": t_fit / total,
          "pass_and_tracker_device_s": (sum(r[2] for r in rows) / 1e6
                                        if rows else "not measured"),
          "pass_and_tracker_kernels": sum(r[1] for r in rows),
          "pass_and_tracker_top": [
              {"name": n[:80], "count": c, "device_ms": t / 1e3}
              for n, c, t in rows[:8]],
          "tracks_present": res.track_mask.tolist(),
          "frames_present_per_track": res.frame_mask.sum(0).tolist(),
          "peak_mem_gb": peak})
    return launches


def phase_video_multi_knobs(est: PoseEstimator, frames: np.ndarray) -> dict:
    """estimate_and_fit_video_multi with every knob over T =
    VIDEO_MULTI_KNOBS_T frames:
    one call, counts zeroed before and read after; B1 five times (the NMS
    pass, then two hint passes each with its hint-centered crop)."""
    t, k = frames.shape[0], MULTI_PEOPLE
    zero_counts()
    t0 = time.perf_counter()
    res = est.estimate_and_fit_video_multi(frames, max_people=k,
                                           **VIDEO_MULTI_KNOBS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    check_video_multi_result(res, t, k)
    passes = VIDEO_MULTI_KNOBS["hint_passes"]
    want = {"soft_argmax": 1 + passes * multi_b1_launches(True, False),
            **B2_NONE}
    check(launches == want, f"video multi knobs launched {launches}, "
          f"expected {want}")
    emit({"phase": "video_multi_knobs", "frames": t, "max_people": k,
          "knobs": VIDEO_MULTI_KNOBS, "launches": launches,
          "seconds": seconds, "frames_per_s": t / seconds,
          "frames_present_per_track": res.frame_mask.sum(0).tolist()})
    return launches


def phase_video_multi_stream(est: PoseEstimator, frames: np.ndarray) -> dict:
    """estimate_and_fit_video_multi_stream(chunk=32) over STREAM_T frames
    (one full window and one padded) and a MultiPersonVideoSession(chunk=32)
    fed the same frames in pushes of 7, then flush(): the same windows and
    carries, so identical perm and frame_mask, joints3d within 1 mm (the
    fits' float sums on the card are not bitwise repeatable)."""
    k = MULTI_PEOPLE
    zero_counts()
    t0 = time.perf_counter()
    ref = est.estimate_and_fit_video_multi_stream(frames, max_people=k,
                                                  chunk=STREAM_CHUNK)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    launches = read_counts()
    check_video_multi_result(ref, frames.shape[0], k)
    session = MultiPersonVideoSession(est, max_people=k, chunk=STREAM_CHUNK)
    outs, t0 = [], time.perf_counter()
    for i in range(0, frames.shape[0], STREAM_PUSH):
        r = session.push(frames[i:i + STREAM_PUSH])
        if r is not None:
            outs.append(r)
    buffered = session.frames_buffered
    outs.append(session.flush())
    torch.cuda.synchronize()
    t_session = time.perf_counter() - t0
    got = api_lib._concat_video_multi(outs)
    check_video_multi_result(got, frames.shape[0], k)
    same_perm = torch.equal(got.perm, ref.perm)
    same_mask = torch.equal(got.frame_mask, ref.frame_mask)
    mpjpe_mm = 1000.0 * float(
        (got.joints3d - ref.joints3d).norm(dim=-1).mean())
    windows = -(-frames.shape[0] // STREAM_CHUNK)
    ok = same_perm and same_mask and mpjpe_mm <= 1.0
    emit({"phase": "video_multi_stream", "frames": frames.shape[0],
          "chunk": STREAM_CHUNK, "push": STREAM_PUSH, "max_people": k,
          "stream_s": t_stream, "session_s": t_session,
          "stream_launches": launches, "windows": windows,
          "buffered_before_flush": buffered, "same_perm": same_perm,
          "same_frame_mask": same_mask, "joints3d_mpjpe_mm": mpjpe_mm,
          "ok": ok})
    check(launches["soft_argmax"] == 2 * windows,
          f"stream launched {launches}")
    check(buffered == frames.shape[0] % STREAM_CHUNK,
          f"session buffered {buffered} frames before flush")
    check(ok, "MultiPersonVideoSession vs the stream form")
    return launches


def phase_multi_small_reference() -> None:
    """The GPU multi-person paths against the CPU ones (which
    tests/test_torch_multiperson.py and tests/test_torch_tracking.py hold
    against JAX) on the tests' small float32 model, TF32 off, within the
    CPU tests' bounds: estimate_and_fit_multi and
    estimate_and_fit_video_multi (T = 4), each with the defaults and with
    every knob, on frames of two people: identical person masks, perms
    and frame masks, joints2d 1e-2 px, θ (leaf rotations aside), β and cam
    1e-3, joints3d and vertices 1 mm. The NMS radius is 32 px: the default
    96 px covers a whole 64 px frame. On larger maps the random-weight
    decode's flat maxima move the joints by ≈ 1e-2 px under 1e-6 relative
    weight noise, which would test the noise's conditioning, not the
    port."""
    cpm_cfg, fit_cfg = _small_cfgs()
    cases = {
        "multi_defaults": ({}, dict(nms_radius_px=32.0)),
        "multi_everything": (dict(MULTI_FRONT_END, fit_restarts=2),
                             dict(max_people=3, nms_radius_px=24.0,
                                  allow_empty=True, dup_joint_frac=0.5)),
        "video_multi_defaults": (dict(fit_restarts=2),
                                 dict(nms_radius_px=32.0)),
        "video_multi_everything": (dict(fit_restarts=2),
                                   dict(VIDEO_MULTI_KNOBS, nms_radius_px=32.0,
                                        track_death_frames=2)),
    }
    images = two_people_frames(2, 72, 96, seed=3)
    frames = two_people_frames(4, 64, 64, seed=3)
    with NoTF32():
        for name, (knobs, kw) in cases.items():
            ests = {dev: PoseEstimator.create_synthetic(
                0, cpm_cfg, fit_cfg, device=dev, **knobs)
                for dev in ("cpu", DEVICE)}
            before = cuda_kernels.soft_argmax_cuda.launches
            if name.startswith("multi"):
                want, got = (ests[d].estimate_and_fit_multi(images, **kw)
                             for d in ("cpu", DEVICE))
                masks = ("person_mask",)
            else:
                want, got = (ests[d].estimate_and_fit_video_multi(frames,
                                                                  **kw)
                             for d in ("cpu", DEVICE))
                masks = ("perm", "frame_mask", "track_mask")
            launched = cuda_kernels.soft_argmax_cuda.launches - before
            same = all(torch.equal(getattr(got, m).cpu(), getattr(want, m))
                       for m in masks)
            j_err = float((got.joints2d.cpu() - want.joints2d).abs().max())
            gap = _fit_gap(got, want, ests["cpu"].smpl_model)
            ok = (same and j_err <= 1e-2
                  and max(gap["theta"], gap["beta"], gap["cam"]) <= 1e-3
                  and gap["joints3d_mpjpe_mm"] <= 1.0
                  and gap["vertices_mean_mm"] <= 1.0 and launched > 0)
            emit({"phase": "multi_small_reference", "case": name,
                  "masks_equal": same, "max_abs_err_joints2d_px": j_err,
                  **gap, "b1_launches": launched, "ok": ok})
            check(ok, f"GPU vs CPU multi-person path, {name}")


# -- the fit extras (ROADMAP A.14) ------------------------------------------

# The init head is trained on the card at train_init_head's default width
# (hidden 256, depth 3) for 300 steps at batch 256, cut from its default
# 2000 steps to stay within half a minute.
HEAD_STEPS, HEAD_BATCH = 300, 256
W_INTERPENETRATION = 5e3          # tests/test_interpenetration.py's weight


def extras_fit_cfg() -> FitConfig:
    """The default schedule as L-BFGS stages, with the interpenetration
    term on the stages that optimize the body pose."""
    return FitConfig(optimizer="lbfgs", stages=tuple(
        dataclasses.replace(s, w_interpenetration=W_INTERPENETRATION)
        if s.opt_pose else s for s in FitConfig().stages))


def phase_fit_extras_main_path(est: PoseEstimator,
                               images: np.ndarray) -> dict:
    """The fit extras at the default model's full width: a learned init
    head trained here (``train_init_head``), then ``estimate_and_fit``
    with L-BFGS stages, the interpenetration term and the head: one
    warm-up and two timed calls, with the launch and L-BFGS counts zeroed
    just before and read just after; then the fit alone, for its share."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    head, losses = init_head_lib.train_init_head(
        est.smpl_model, steps=HEAD_STEPS, batch=HEAD_BATCH, seed=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    cfg = extras_fit_cfg()
    ext = PoseEstimator(est.cpm, est.smpl_model, est.prior, est.cpm_cfg,
                        cfg, init_head=head, device=DEVICE)
    calls = 3
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    lbfgs_lib.reset_counts()
    res, seconds = _timed_calls(lambda: ext.estimate_and_fit(images), calls)
    launches = read_counts()
    counts = dict(lbfgs_lib.COUNTS)
    b = images.shape[0]
    check_result(res, b)
    check(launches["soft_argmax"] == calls,
          f"fit_extras_main_path: B1 launched {launches['soft_argmax']} "
          f"times in {calls} calls")
    check({k: launches[k] for k in B2_NONE} == B2_NONE,
          f"fit_extras_main_path: B2 launched {launches}")
    with torch.no_grad():
        _, joints, conf = ext._front_end(images)
        init = ext._head_init(joints, conf)
    fit_s = host_s(lambda: fit_lib.fit_smpl_batch(
        est.smpl_model, joints, conf, cfg, est.prior, init))
    steps = sum(s.iters for s in cfg.stages)
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    emit({"phase": "fit_extras_main_path", "batch": b, "calls": calls,
          "launches": launches, "seconds_per_call": seconds,
          "frames_per_s": [b / s for s in seconds], "fit_s": fit_s,
          "fit_share": fit_s / statistics.median(seconds),
          "lbfgs_steps_per_call": steps,
          "linesearch_evaluations_per_step_mean":
              counts["evaluations"] / counts["steps"],
          "linesearch_evaluations_per_step_max":
              counts["max_step_evaluations"],
          "linesearch_iterations_per_step":
              counts["host_reads"] / (calls * steps),
          "host_reads_per_call": counts["host_reads"] / calls,
          "b1_launches_per_call": launches["soft_argmax"] / calls,
          "w_interpenetration": W_INTERPENETRATION,
          "head_train_s": train_s, "head_steps": HEAD_STEPS,
          "head_batch": HEAD_BATCH, "head_loss_first10": first,
          "head_loss_last10": last,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    check(last < first, f"init head training: loss {first} -> {last}")
    return launches


def _clean_fit_observations(model, seeds, img: int):
    """Pixel joints of known bodies, one per seed (θ 0.25σ, β 0.3σ, drawn
    as tests/test_fit.py's make_observation draws them) under its fixed
    weak-perspective camera, confidence 1, on ``model``'s device."""
    draws = [np.random.RandomState(s) for s in seeds]
    draws = [(r.randn(72) * 0.25, r.randn(10) * 0.3) for r in draws]
    theta = torch.from_numpy(np.float32([t for t, _ in draws]))
    beta = torch.from_numpy(np.float32([b for _, b in draws]))
    b = len(seeds)
    dev = model.device
    with torch.no_grad():
        j3d = joints_lib.select_smpl_joints(smpl_lib.smpl_joints(
            model, beta.to(dev), theta.to(dev), smpl_lib.EXACT_PRECISION))
    px = (j3d[..., :2] * 0.9 + torch.tensor([0.05, -0.1], device=dev)
          + 1.0) * (img / 2.0)
    return px, torch.ones(b, 14, device=dev)


def phase_fit_extras_small_reference() -> None:
    """The fit extras on the GPU against the CPU (which
    tests/test_torch_interpenetration.py, test_torch_init_head.py and
    test_torch_lbfgs.py hold against JAX), TF32 off, within the CPU
    tests' bounds: the capsule spec (radii 1e-6, thresholds 2e-6) and the
    penalty with its gradient on the CPU spec's geometry (1e-5); a head's
    predictions (1e-5) and its training loss with the gradient (1e-4
    relative) on one batch; an
    L-BFGS fit with the interpenetration term on clean observations
    (tests/test_torch_lbfgs.py's 10 + 10-step schedule; joints3d ≤ 1 mm,
    and the first step where the two energy traces part by more than
    1e-4 relative); estimate_and_fit with the head on the small float32
    model (joints2d 1e-2 px; θ without the leaf rotations, β, cam 1e-3;
    joints3d and vertices 1 mm)."""
    devs = ("cpu", DEVICE)
    with NoTF32():
        models = {d: smpl_data_lib.synthetic_smpl(seed=0, device=d)
                  for d in devs}
        specs = {d: interp_lib.build_capsule_spec(models[d]) for d in devs}
        errs = {k: float((getattr(specs[DEVICE], k).cpu()
                          - getattr(specs["cpu"], k)).abs().max())
                for k in ("radius", "threshold")}
        rng = np.random.RandomState(0)
        j = torch.from_numpy(np.float32(
            models["cpu"].joint_basis[0].numpy()[None]
            + 0.1 * rng.randn(5, 24, 3)))
        # The penalty on one geometry (the CPU spec's): at deep overlaps it
        # moves by Σ 2·overlap·Δthreshold, the spec's rounding.
        same = dataclasses.replace(
            specs[DEVICE], radius=specs["cpu"].radius.to(DEVICE),
            threshold=specs["cpu"].threshold.to(DEVICE))
        pen = {}
        for d, spec in (("cpu", specs["cpu"]), (DEVICE, same)):
            x = j.to(d).requires_grad_(True)
            p = interp_lib.interpenetration_penalty(x, spec)
            pen[d] = (p.detach().cpu(), torch.autograd.grad(p.sum(), x)[0]
                      .cpu())
        ok_p = [close(pen[DEVICE][i], pen["cpu"][i], 1e-5, 1e-5)
                for i in (0, 1)]
        ok = (errs["radius"] <= 1e-6 and errs["threshold"] <= 2e-6
              and all(o for o, _ in ok_p))
        emit({"phase": "fit_extras_small_reference", "case": "capsules",
              "max_abs_err_radius": errs["radius"],
              "max_abs_err_threshold": errs["threshold"],
              "max_abs_err_penalty": ok_p[0][1],
              "max_abs_err_penalty_grad": ok_p[1][1], "ok": ok})
        check(ok, "GPU vs CPU capsule spec and penalty")

        gen = torch.Generator().manual_seed(0)
        head = init_head_lib.init_head_params(gen)
        head["w3"] = head["w3"] * 30.0
        batch = init_head_lib._sample_batch(gen, models["cpu"], 64)
        out = {}
        for d in devs:
            hp = {k: v.to(d).requires_grad_(True) for k, v in head.items()}
            data = [t.to(d) for t in batch]
            theta, _ = init_head_lib.init_head_apply(hp, data[0], data[1])
            loss = init_head_lib._loss(hp, models[d], *data)
            grads = torch.autograd.grad(loss, list(hp.values()))
            out[d] = (theta.detach().cpu(), loss.detach().cpu(),
                      [g.cpu() for g in grads])
        ok_t = close(out[DEVICE][0], out["cpu"][0], 1e-5, 1e-5)
        loss_rel = float(abs(out[DEVICE][1] - out["cpu"][1])
                         / out["cpu"][1].abs())
        grad_ok = all(close(g, c, 1e-4, 1e-4 * float(c.abs().max()))[0]
                      for g, c in zip(out[DEVICE][2], out["cpu"][2]))
        ok = ok_t[0] and loss_rel <= 1e-4 and grad_ok
        emit({"phase": "fit_extras_small_reference", "case": "init_head",
              "max_abs_err_theta": ok_t[1], "loss_rel_err": loss_rel,
              "grads_ok": grad_ok, "ok": ok})
        check(ok, "GPU vs CPU init head")

        small = {d: smpl_data_lib.synthetic_smpl(seed=3, num_verts=500,
                                                 device=d) for d in devs}
        prior = {d: priors_lib.synthetic_gmm_prior(0, device=d)
                 for d in devs}
        cfg = FitConfig(optimizer="lbfgs", keep_history=True, stages=(
            StageConfig(iters=10, lr=0.0, opt_pose=False, opt_shape=False,
                        w_pose_prior=0.0, w_shape_prior=0.0,
                        w_angle_prior=0.0),
            StageConfig(iters=10, lr=0.0, w_pose_prior=4.0,
                        w_shape_prior=5.0, w_angle_prior=15.0,
                        w_interpenetration=W_INTERPENETRATION)))
        px, conf = _clean_fit_observations(small["cpu"], (4, 5, 6, 7),
                                           cfg.img_size)
        fits = {d: fit_lib.fit_smpl_batch(small[d], px.to(d), conf.to(d),
                                          cfg, prior[d]) for d in devs}
        gap = _fit_gap(fits[DEVICE], fits["cpu"], small["cpu"])
        rel = ((fits[DEVICE].energy_history.cpu()
                - fits["cpu"].energy_history).abs()
               / fits["cpu"].energy_history.abs()).amax(0)
        parted = int(torch.nonzero(rel > 1e-4)[0]) if (rel > 1e-4).any() \
            else None
        ok = gap["joints3d_mpjpe_mm"] <= 1.0
        emit({"phase": "fit_extras_small_reference", "case": "lbfgs_fit",
              **gap, "energy_traces_part_at_step": parted, "ok": ok})
        check(ok, f"GPU vs CPU L-BFGS fit: {gap}, traces part at step "
                  f"{parted}")

        cpm_cfg, fit_cfg = _small_cfgs()
        small_head = init_head_lib.init_head_params(
            torch.Generator().manual_seed(1), hidden=32, depth=2)
        small_head["w2"] = small_head["w2"] * 30.0
        ests = {d: PoseEstimator.create_synthetic(
            0, cpm_cfg, fit_cfg, device=d, init_head=small_head)
            for d in devs}
        frames = _smooth_frames(2, 64, 64, seed=5)
        before = cuda_kernels.soft_argmax_cuda.launches
        want, got = (ests[d].estimate_and_fit(frames) for d in devs)
        launched = cuda_kernels.soft_argmax_cuda.launches - before
        j_err = float((got.joints2d.cpu() - want.joints2d).abs().max())
        gap = _fit_gap(got, want, ests["cpu"].smpl_model)
        ok = (j_err <= 1e-2 and max(gap["theta"], gap["beta"],
                                    gap["cam"]) <= 1e-3
              and gap["joints3d_mpjpe_mm"] <= 1.0
              and gap["vertices_mean_mm"] <= 1.0 and launched == 1)
        emit({"phase": "fit_extras_small_reference",
              "case": "estimate_and_fit_init_head",
              "max_abs_err_joints2d_px": j_err, **gap,
              "b1_launches": launched, "ok": ok})
        check(ok, "GPU vs CPU estimate_and_fit with the init head")


# -- serving (ROADMAP A.16) ----------------------------------------------------

SERVE_BATCH = 8                    # max_batch of the served bf16 estimator
SERVE_WAIT_MS = 20.0
SERVE_FIELDS = ("joints2d", "conf", "theta", "beta", "cam", "joints3d",
                "energy")
SERVE_LOAD_HW = ((368, 368), (480, 640), (720, 1280))
SERVE_LOAD_FRAMES = 24
# The loads with the readiness check off run on the first half of the
# frames: they take ≈ 2.5× the time per frame of the loads with it on
# (17 small batches), and the script's time limit binds (cut from 48 and
# 24 frames to make room for the export phases). At 8 frames for 8
# clients the loads degenerate into one batch each, so no comparison.
SERVE_LOAD_FRAMES_OFF = 12
SERVE_CLIENTS = 8                  # client threads of the load
LETTERBOX_HW = ((480, 640), (720, 1280), (1080, 1920))
# COCO-17 slot of each CPM-14 joint (head → nose; the neck has no COCO
# keypoint and comes back as the shoulders' midpoint).
CPM_TO_COCO = {0: 0, **joints_lib.COCO_TO_CPM_DIRECT}


def serving_b1_per_batch(bucket: int, microbatch: int) -> int:
    """B1's launches in one served estimate_and_fit batch: one decode per
    CPM chunk (``cpm_microbatch`` frames; 0 = the whole bucket)."""
    return -(-bucket // microbatch) if microbatch else 1


def serving_b2_launches(qcpm, cfg: CPMConfig, bucket: int, microbatch: int,
                        min_batch: int) -> dict:
    """B2's launches in one served batch on a ``quantize=True`` estimator
    with static scales: none below ``int8_min_batch`` (the float CPM),
    else ``int8_launches`` of each CPM chunk."""
    total = dict(B2_NONE)
    if bucket < min_batch:
        return total
    step = microbatch or bucket
    for start in range(0, bucket, step):
        n = min(step, bucket - start)
        for k, v in int8_launches(qcpm, cfg, n, False).items():
            total[k] += v
    return total


def cpm_to_coco(joints14: np.ndarray, conf14: np.ndarray):
    """CPM-14 joints as a COCO-17 detector would give them (eyes and ears
    at the head), for the /fit route's ``coco_to_cpm``."""
    j = np.repeat(joints14[..., :1, :], 17, axis=-2)
    c = np.repeat(conf14[..., :1], 17, axis=-1)
    for cpm_i, coco_i in CPM_TO_COCO.items():
        j[..., coco_i, :] = joints14[..., cpm_i, :]
        c[..., coco_i] = conf14[..., cpm_i]
    return j, c


def source_frame_bounds(h: int, w: int, size: int) -> tuple:
    """(x0, y0, x1, y1): the network frame mapped to an (h, w) frame's
    source pixels, where its letterboxed joints can land."""
    a = pre.letterbox_affine(h, w, size).astype(np.float64)
    return (-a[2] / a[0], -a[3] / a[1], (size - a[2]) / a[0],
            (size - a[3]) / a[1])


def phase_native_letterbox_check() -> dict:
    """The native letterbox must build here (g++ comes with nvcc): within
    1 LSB of the numpy path on camera frames letterboxed to the network
    size, host ms per frame for both."""
    check(native.available(), "native letterbox did not build or load")
    size = MAIN_CPM.input_size
    rows = {}
    for h, w in LETTERBOX_HW:
        img = _frames(1, h, w, seed=h)[0]
        out = native.letterbox_u8(img, size)
        ref = pre.letterbox_numpy(img, size)
        err = int(np.abs(out.astype(int) - ref.astype(int)).max())
        check(err <= 1, f"native letterbox {h}x{w}: {err} LSB from numpy")
        ms = {}
        for name, fn in (("native", native.letterbox_u8),
                         ("numpy", pre.letterbox_numpy)):
            reps = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn(img, size)
                reps.append((time.perf_counter() - t0) * 1e3)
            ms[name] = statistics.median(reps)
        rows[f"{h}x{w}"] = {"max_lsb": err, "native_ms": ms["native"],
                            "numpy_ms": ms["numpy"]}
    emit({"phase": "native_letterbox_check", "size": size,
          "library": str(native.library_path()), "frames": rows,
          "pil": importlib.util.find_spec("PIL") is not None})
    return rows


def _load_frames(seed: int) -> list:
    """``SERVE_LOAD_FRAMES`` uint8 frames cycling through
    ``SERVE_LOAD_HW``."""
    return [_frames(1, *SERVE_LOAD_HW[i % len(SERVE_LOAD_HW)],
                    seed=seed + i)[0] for i in range(SERVE_LOAD_FRAMES)]


def _serve_load(est: PoseEstimator, frames: list, clients: int,
                finish_ready_first: bool, rate: float = 0.0) -> dict:
    """An HTTP server around ``est`` and ``clients`` threads sharing the
    port's PoseClient. Closed loop (``rate`` 0): each thread sends its
    share of ``frames`` one after the other. Open loop: request i is sent
    at i / ``rate`` seconds, whatever is still in flight. Counts are
    zeroed just before and read just after. Checks every response (shape,
    finite, joints where the letterboxed frame can put them) and one B1
    launch per batch."""
    srv = PoseHTTPServer(est, max_batch=SERVE_BATCH,
                         max_wait_ms=SERVE_WAIT_MS, max_queue=0,
                         fields=SERVE_FIELDS)
    srv.server.finish_ready_first = finish_ready_first
    client = PoseClient(f"http://{srv.host}:{srv.port}")
    outs = [None] * len(frames)
    size = est.cpm_cfg.input_size

    def send(i):
        outs[i] = client.predict(frames[i])

    def worker(k):
        for i in range(k, len(frames), clients):
            send(i)

    try:
        zero_counts()
        t0 = time.perf_counter()
        if rate:
            with concurrent.futures.ThreadPoolExecutor(clients) as pool:
                futs = []
                for i in range(len(frames)):
                    time.sleep(max(0.0, t0 + i / rate - time.perf_counter()))
                    futs.append(pool.submit(send, i))
                for f in futs:
                    f.result(timeout=600)
        else:
            threads = [threading.Thread(target=worker, args=(k,))
                       for k in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            check(not any(t.is_alive() for t in threads),
                  "a load client hung")
        seconds = time.perf_counter() - t0
        launches = read_counts()
        snap = srv.server.telemetry()
    finally:
        client.close()
        srv.shutdown()
    inside = 0
    for img, out in zip(frames, outs):
        check(out is not None, "a load request got no response")
        h, w = img.shape[:2]
        for k, shape in (("joints2d", (14, 2)), ("theta", (72,)),
                         ("joints3d", (24, 3))):
            check(out[k].shape == shape and np.isfinite(out[k]).all(),
                  f"served {k} of a {h}x{w} frame: {out[k].shape}")
        x0, y0, x1, y1 = source_frame_bounds(h, w, size)
        j = out["joints2d"]
        check(bool(((j[:, 0] >= x0 - 1e-3) & (j[:, 0] <= x1 + 1e-3)
                    & (j[:, 1] >= y0 - 1e-3) & (j[:, 1] <= y1 + 1e-3))
                   .all()), f"served joints outside the {h}x{w} frame's "
              f"letterbox: {j.min(0)}, {j.max(0)}")
        if (h, w) == (size, size):
            check(bool(((j >= 0) & (j <= size)).all()),
                  "served joints of a network-sized frame outside it")
        inside += int(((j[:, 0] >= 0) & (j[:, 0] <= w) & (j[:, 1] >= 0)
                       & (j[:, 1] <= h)).sum())
    check(launches["soft_argmax"] == snap["batches"]
          and launches == {**B2_NONE, "soft_argmax": snap["batches"]},
          f"served load launched {launches} in {snap['batches']} batches")
    return {"clients": clients, "finish_ready_first": finish_ready_first,
            "open_loop_rate": rate,
            "requests": snap["requests"], "seconds": seconds,
            "requests_per_s": snap["requests"] / seconds,
            "latency_ms_p50": snap["latency_ms_p50"],
            "latency_ms_p99": snap["latency_ms_p99"],
            "batches": snap["batches"], "mean_batch": snap["mean_batch"],
            "occupancy": snap["occupancy"],
            "seconds_per_batch": seconds / snap["batches"],
            "service_s_ema": snap["service_s_ema"], "launches": launches,
            "pipeline_counts": srv.server.pipeline_counts,
            "joints_inside_source_frame": inside / (14 * len(frames))}


def phase_serving_main_path(est: PoseEstimator) -> dict:
    """The served main path: a PoseHTTPServer around the bf16 full-width
    estimator (max_batch 8, default buckets, max_wait 20 ms).

    Exactness: one /predict_batch of 8 network-sized frames forms one
    bucket-8 batch, held against a direct estimate_and_fit on the same
    frames (tests/test_torch_api.py's bf16 bounds: joints2d 8 px, joints3d
    25 mm), the gap reported. Load: SERVE_LOAD_FRAMES mixed-resolution
    frames from 8 client threads (one B1 per batch), closed loop, then
    open loop at half the capacity (8 frames per direct call; requests
    arrive during a launch), then from 16 closed-loop threads (a full
    batch queues during each launch), each with the pipeline's readiness
    check on and (on the first SERVE_LOAD_FRAMES_OFF frames) off, beside
    a direct call's seconds at bucket 8."""
    size = est.cpm_cfg.input_size
    frames = _frames(SERVE_BATCH, size, size, seed=21)
    direct, direct_s = _timed_calls(lambda: est.estimate_and_fit(frames), 3)
    again = est.estimate_and_fit(frames)
    torch.cuda.synchronize()
    with PoseHTTPServer(est, max_batch=SERVE_BATCH,
                        max_wait_ms=SERVE_WAIT_MS,
                        fields=SERVE_FIELDS) as srv:
        zero_counts()
        with PoseClient(f"http://{srv.host}:{srv.port}") as client:
            got = client.predict_batch(frames)
        launches = read_counts()
        snap = srv.server.telemetry()
    check(snap["batches"] == 1 and snap["occupancy"] == 1.0,
          f"/predict_batch of {SERVE_BATCH} formed {snap['batches']} "
          f"batches at occupancy {snap['occupancy']}")
    check(launches == {**B2_NONE, "soft_argmax": 1},
          f"one served batch launched {launches}")
    gap = {k: float(np.abs(got[k] - getattr(direct, k).cpu().numpy()).max())
           for k in SERVE_FIELDS}
    # The fit is not bit-reproducible on the card from one call to the
    # next: the same direct call twice, for scale.
    self_gap = {k: float((getattr(again, k) - getattr(direct, k)).abs()
                         .max()) for k in SERVE_FIELDS}
    mpjpe_mm = 1000.0 * float(np.linalg.norm(
        got["joints3d"] - direct.joints3d.cpu().numpy(), axis=-1).mean())
    check(gap["joints2d"] <= 8.0 and mpjpe_mm <= 25.0,
          f"served batch vs direct call: joints2d {gap['joints2d']} px, "
          f"joints3d {mpjpe_mm} mm")
    # Open loop at half the capacity a direct call measures on this host.
    open_rate = 0.5 * SERVE_BATCH / statistics.median(direct_s)
    loads = [_serve_load(est, _load_frames(100)[
                 :SERVE_LOAD_FRAMES if on else SERVE_LOAD_FRAMES_OFF],
                 clients, on, rate)
             for clients, rate in ((SERVE_CLIENTS, 0.0),
                                   (SERVE_CLIENTS, open_rate),
                                   (2 * SERVE_CLIENTS, 0.0))
             for on in (True, False)]
    emit({"phase": "serving_main_path", "max_batch": SERVE_BATCH,
          "max_wait_ms": SERVE_WAIT_MS, "buckets": list(
              serving.default_buckets(SERVE_BATCH)),
          "exact": {"max_abs_gap": gap, "joints3d_mpjpe_mm": mpjpe_mm,
                    "bit_equal": all(v == 0.0 for v in gap.values()),
                    "direct_twice_max_abs_gap": self_gap,
                    "launches": launches},
          "direct_s_bucket8": direct_s, "loads": loads})
    return loads[0]["launches"]


def phase_serving_int8(est: PoseEstimator, per_chunk: dict) -> dict:
    """An in-process BatchingServer around the int8 estimator (max_batch
    32, cpm_microbatch 16): a burst of 32 requests forms one bucket-32
    batch, with B2's launches of its two chunks; a lone request forms a
    bucket-1 batch on the bf16 CPM, no B2."""
    size = est.cpm_cfg.input_size
    frames = _frames(INT8_BATCH, size, size, seed=22)
    out = {}
    with serving.BatchingServer(est, max_batch=INT8_BATCH,
                                max_wait_ms=200.0,
                                fields=("joints2d", "theta")) as srv:
        for name, burst in (("bucket32", frames), ("bucket1", frames[:1])):
            bucket = len(burst)
            before = srv.stats.snapshot()["batches"]
            zero_counts()
            t0 = time.perf_counter()
            res = [f.result(timeout=600) for f in srv.submit_many(burst)]
            seconds = time.perf_counter() - t0
            launches = read_counts()
            want = {"soft_argmax": serving_b1_per_batch(
                bucket, est.cpm_microbatch), **serving_b2_launches(
                est.cpm, est.cpm_cfg, bucket, est.cpm_microbatch,
                est.int8_min_batch)}
            check(srv.stats.snapshot()["batches"] == before + 1,
                  f"serving_int8 {name}: not one batch")
            check(launches == want, f"serving_int8 {name} launched "
                  f"{launches}, expected {want}")
            check(all(np.isfinite(r["theta"]).all() for r in res),
                  f"serving_int8 {name}: non-finite θ")
            out[name] = {"launches": launches, "seconds": seconds}
    check(out["bucket32"]["launches"]["quantize_im2col"]
          == 2 * per_chunk["quantize_im2col"], "bucket 32 is two chunks")
    emit({"phase": "serving_int8", "max_batch": INT8_BATCH,
          "cpm_microbatch": est.cpm_microbatch,
          "int8_min_batch": est.int8_min_batch, **out})
    return out["bucket32"]["launches"]


def phase_serving_fit(est: PoseEstimator) -> dict:
    """A fn="fit_smpl" HTTP server: planted bodies' projected joints, as
    a COCO-17 detector would give them, through coco_to_cpm to /fit in
    one request of 8 rows; held against a direct fit_smpl on the same
    joints (joints3d within 1 mm, the reprojection error as
    fit_recovery's Adam case measures it), no kernel launched."""
    model = est.smpl_model
    px, conf = _clean_fit_observations(model, range(40, 48),
                                       est.fit_cfg.img_size)
    coco, coco_conf = cpm_to_coco(px.cpu().numpy(), conf.cpu().numpy())
    j14, c14 = joints_lib.coco_to_cpm(coco, coco_conf)
    direct = est.fit_smpl(j14, c14)
    torch.cuda.synchronize()
    with PoseHTTPServer(est, max_batch=SERVE_BATCH, max_wait_ms=200.0,
                        fn="fit_smpl") as srv:
        zero_counts()
        t0 = time.perf_counter()
        with PoseClient(f"http://{srv.host}:{srv.port}") as client:
            got = client.fit(j14, c14)
        seconds = time.perf_counter() - t0
        launches = read_counts()
        batches = srv.server.stats.snapshot()["batches"]
    half = est.fit_cfg.img_size / 2.0
    obs = torch.from_numpy(j14).to(DEVICE)

    def reproj_px(theta, beta, cam):
        r = fit_lib.FitResult(torch.as_tensor(theta, device=DEVICE),
                              torch.as_tensor(beta, device=DEVICE),
                              torch.as_tensor(cam, device=DEVICE),
                              None, None)
        with torch.no_grad():
            pred = fit_lib.reproject(model, r, est.fit_cfg)
        return float(((pred * half + half) - obs).norm(dim=-1).mean())

    with torch.no_grad():
        j3d = [smpl_lib.smpl_joints(model, torch.as_tensor(b, device=DEVICE),
                                    torch.as_tensor(t, device=DEVICE),
                                    smpl_lib.EXACT_PRECISION).cpu().numpy()
               for t, b in ((got["theta"], got["beta"]),
                            (direct.theta, direct.beta))]
    mpjpe_mm = 1000.0 * float(np.linalg.norm(j3d[0] - j3d[1],
                                             axis=-1).mean())
    e_served = reproj_px(got["theta"], got["beta"], got["cam"])
    e_direct = reproj_px(direct.theta, direct.beta, direct.cam)
    theta_gap = float(np.abs(got["theta"]
                             - direct.theta.cpu().numpy()).max())
    emit({"phase": "serving_fit", "rows": len(j14), "batches": batches,
          "seconds": seconds, "launches": launches,
          "joints3d_mpjpe_mm": mpjpe_mm, "theta_max_gap": theta_gap,
          "reproj_px_served": e_served, "reproj_px_direct": e_direct})
    check(batches == 1, f"/fit of {len(j14)} rows formed {batches} batches")
    check(launches == {**B2_NONE, "soft_argmax": 0},
          f"serving_fit launched {launches}")
    check(mpjpe_mm <= 1.0 and abs(e_served - e_direct) <= 0.5,
          f"served fit vs direct: {mpjpe_mm} mm, reprojection "
          f"{e_served} vs {e_direct} px")
    return launches


def phase_serving_multi(est: PoseEstimator) -> dict:
    """fn="estimate_and_fit_multi" with max_people 2 on frames of two
    planted people: one batch of 8, person_mask equal to a direct call's,
    B1 as ``multi_b1_launches`` per batch, no B2."""
    size = est.cpm_cfg.input_size
    frames = two_people_frames(SERVE_BATCH, size, size, seed=23)
    direct = est.estimate_and_fit_multi(frames, max_people=MULTI_PEOPLE)
    torch.cuda.synchronize()
    with serving.BatchingServer(
            est, max_batch=SERVE_BATCH, max_wait_ms=200.0,
            fn="estimate_and_fit_multi",
            fn_kwargs={"max_people": MULTI_PEOPLE},
            fields=("joints2d", "person_mask", "theta")) as srv:
        zero_counts()
        t0 = time.perf_counter()
        res = [f.result(timeout=600) for f in srv.submit_many(frames)]
        seconds = time.perf_counter() - t0
        launches = read_counts()
        batches = srv.stats.snapshot()["batches"]
    mask = np.stack([r["person_mask"] for r in res])
    want = {**B2_NONE,
            "soft_argmax": multi_b1_launches(False, False) * batches}
    emit({"phase": "serving_multi", "batch": SERVE_BATCH,
          "batches": batches, "seconds": seconds, "launches": launches,
          "person_mask": mask.tolist(),
          "joints2d_max_gap": float(np.abs(
              np.stack([r["joints2d"] for r in res])
              - direct.joints2d.cpu().numpy()).max())})
    check(batches == 1, f"serving_multi formed {batches} batches")
    check(np.array_equal(mask, direct.person_mask.cpu().numpy()),
          "served person_mask differs from the direct call's")
    check(launches == want, f"serving_multi launched {launches}, expected "
          f"{want}")
    return launches


# -- training and dataset-scale evaluation (ROADMAP A.19) ---------------------

TRAIN_BATCH = 32         # tools/train_cpm.py's default --batch
TRAIN_STEPS = 24         # total_steps of the schedule (warmup: 1 step)
TRAIN_LR = 1e-4          # the CLI's default --lr
TRAIN_TIMED = 8          # steps timed on batches made in advance
TRAIN_PROFILED = 3       # steps under torch.profiler
TRAIN_GEN_STEPS = 3      # steps with the synthetic generator in the loop
QAT_STEPS = 3
EVAL_BATCH = 32
EVAL_BATCHES = 2
CKPT_DIR = "build/chip_smoke_train"   # gitignored; removed at the end
# The CPU tests' tolerances (tests/test_torch_cpm_train.py,
# tests/test_torch_eval.py), for the GPU-against-CPU phase.
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # max |Δg| / max |g| per parameter tensor
PARAM_ATOL = 1e-6        # after optimizer updates given equal gradients
MM = 1e-3                # 3D metrics of fitted joints (BASELINE budget)


def train_losses(cpm, opt_state, opt, batches, cfg: CPMConfig,
                 fake_quant: bool = False):
    """Train steps over ``batches``; the loss of each, read on the host
    (one sync per step). Returns (cpm, opt_state, losses)."""
    step = cpm_train.make_train_step(cfg, opt, fake_quant=fake_quant)
    losses = []
    for b in batches:
        cpm, opt_state, loss = step(cpm, opt_state, b)
        losses.append(float(loss))
    return cpm, opt_state, losses


def train_state_equal(cpm_a, state_a, cpm_b, state_b) -> bool:
    """Parameters, Adam moments and step count equal bit for bit."""
    if state_a["count"] != state_b["count"]:
        return False
    pa, pb = dict(cpm_a.named_parameters()), dict(cpm_b.named_parameters())
    if pa.keys() != pb.keys() or any(not torch.equal(pa[k], pb[k])
                                     for k in pa):
        return False
    return all(torch.equal(state_a[m][k], state_b[m][k])
               for m in ("mu", "nu") for k in state_a[m])


def int8_matches_fake_quant(qcpm, cpm) -> list:
    """The layers whose int8 serving weights (dequantized: w_int8 ·
    w_scale) or bias differ from ``fake_quant_params``' view of the float
    CPM; empty when all are bit-equal."""
    view = cpm_train.fake_quant_params(cpm)
    bad = []
    for name, layer in qcpm.named_children():
        deq = (layer.weight_hwio().float() * layer.w_scale).permute(3, 2, 0, 1)
        if not (torch.equal(deq, view[f"{name}.weight"].detach())
                and torch.equal(layer.b, view[f"{name}.bias"].detach())):
            bad.append(name)
    return bad


def eval_metrics_gap(got: dict, want: dict, n2d: int) -> dict:
    """Per key, |got − want| of two evaluator results, and whether each is
    within the CPU tests' bounds: frame counts equal, PCKh within one
    joint's hit of ``n2d`` frames, every 3D metric within 1 mm."""
    if set(got) != set(want):
        return {"keys_differ": sorted(set(got) ^ set(want)), "ok": False}
    gap, ok = {}, True
    for k, w in want.items():
        if not isinstance(w, (int, float)):
            continue
        gap[k] = abs(got[k] - w)
        if k.startswith("num_frames"):
            ok &= gap[k] == 0
        elif k in ("pckh", "auc"):
            ok &= gap[k] <= 1.0 / (14 * max(n2d, 1)) + 1e-12
        else:
            ok &= gap[k] <= MM
    return {"gap": gap, "ok": bool(ok)}


def phase_train_main_path() -> tuple:
    """CPM training at full width (CPMConfig(): 368², 6 stages, bf16
    compute, float32 parameters and Adam moments), batch 32, the CLI's
    optimizer (warmup-cosine schedule over TRAIN_STEPS, global-norm clip
    1.0, lr 1e-4), synthetic cpm_train_batches. TRAIN_STEPS steps on one
    fixed batch: the loss finite at each and lower at the end than at step
    2 (step 1 has lr 0). Then the step alone on batches made in advance
    (median seconds per step, images/s), three steps under torch.profiler
    (the device's busy share), one step under FlopCounterMode (achieved
    TFLOP/s against the bf16 peak), and steps with the generator in the
    loop (host seconds per batch). No kernel of the port runs: the train
    step does not decode, and its convs are cuDNN's."""
    from torch.profiler import ProfilerActivity, profile
    model = smpl_data_lib.synthetic_smpl(seed=0, device="cpu")
    t0 = time.perf_counter()
    made = list(synthetic.cpm_train_batches(
        model, TRAIN_BATCH, 1 + TRAIN_TIMED, MAIN_CPM, seed=0))
    gen_s = (time.perf_counter() - t0) / len(made)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    cpm, opt_state, opt = cpm_train.init_train_state(
        0, MAIN_CPM, lr=TRAIN_LR, total_steps=TRAIN_STEPS, device=DEVICE)
    cpm, opt_state, losses = train_losses(
        cpm, opt_state, opt, [made[0]] * TRAIN_STEPS, MAIN_CPM)
    check(all(np.isfinite(losses)), f"train losses finite: {losses}")
    check(losses[1] == losses[0] and losses[-1] < losses[1],
          f"fixed-batch loss: step 1 {losses[0]}, step 2 {losses[1]}, "
          f"end {losses[-1]}")
    # The step alone (a fresh schedule: the fixed-batch run used it up).
    opt_t = cpm_train.TrainOptimizer(TRAIN_LR, 10 * TRAIN_STEPS)
    train_step = cpm_train.make_train_step(MAIN_CPM, opt_t)
    state = {"opt": opt_t.init(dict(cpm.named_parameters()))}

    def step(b):
        _, state["opt"], loss = train_step(cpm, state["opt"], b)
        return loss

    seconds = [host_s(lambda b=b: step(b)) for b in made[1:]]
    step_s = statistics.median(seconds[1:])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in made[1:1 + TRAIN_PROFILED]:
            step(b)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows = kernel_rows(prof.key_averages())
    device_s = sum(r[2] for r in rows) / 1e6
    flops = profiling.cost_analysis(step, made[1])["flops"]
    util = profiling.utilization(step_s, {"flops": flops},
                                 peak="flops_bf16")
    # With the generator in the loop, as train_cpm --synthetic runs it.
    gen = synthetic.cpm_train_batches(model, TRAIN_BATCH, TRAIN_GEN_STEPS,
                                      MAIN_CPM, seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in gen:
        step(b)
    torch.cuda.synchronize()
    loop_s = (time.perf_counter() - t0) / TRAIN_GEN_STEPS
    launches = read_counts()
    check(all(n == 0 for n in launches.values()),
          f"the train step launched {launches}")
    emit({"phase": "train_main_path", "batch": TRAIN_BATCH,
          "total_steps": TRAIN_STEPS, "lr": TRAIN_LR,
          "losses": losses, "launches": launches,
          "seconds_per_step": seconds, "median_step_s": step_s,
          "images_per_s": TRAIN_BATCH / step_s,
          "profiled_wall_s": wall_s,
          "device_s": device_s if rows else "not measured",
          "device_busy_share": (device_s / wall_s if rows
                                else "not measured"),
          "device_kernels_per_step": sum(r[1] for r in rows)
          / TRAIN_PROFILED,
          "top": [{"name": k[:80], "count": n, "device_ms": t / 1e3}
                  for k, n, t in rows[:6]],
          "flops_per_step": flops,
          "achieved_tflops": util["flops_per_s"] / 1e12,
          "bf16_peak_share": util["mfu"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "host_generator_s_per_batch": gen_s,
          "generator_in_loop_s_per_step": loop_s,
          "params": sum(p.numel() for p in cpm.parameters())})
    return cpm, opt_state, opt, made[0], launches


def phase_train_qat_and_resume(cpm, opt_state, opt, batch) -> tuple:
    """QAT steps on the trained CPM; the train state saved, restored into
    a fresh CPM and state, equal bit for bit; the weights exported as the
    CPM npz and loaded with PoseEstimator.from_numpy in bf16 (its
    heatmaps equal the trained module's forward bit for bit) and with
    quantize=True (8 calibration frames, cpm_microbatch 16; its int8
    weights equal fake_quant_params' view bit for bit). Returns the int8
    estimator for eval_main_path."""
    cpm, opt_state, losses = train_losses(
        cpm, opt_state, opt, [batch] * QAT_STEPS, MAIN_CPM, fake_quant=True)
    check(all(np.isfinite(losses)), f"QAT losses finite: {losses}")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    checkpoint.save_train_state(CKPT_DIR, opt_state["count"], cpm,
                                opt_state)
    save_s = time.perf_counter() - t0
    fresh = cpm_lib.init_cpm_params(1, MAIN_CPM, device=DEVICE)
    t0 = time.perf_counter()
    step, fresh, fresh_st = checkpoint.restore_train_state(CKPT_DIR, fresh)
    restore_s = time.perf_counter() - t0
    check(step == opt_state["count"] and
          train_state_equal(cpm, opt_state, fresh, fresh_st),
          "restored train state equals the saved one bit for bit")
    npz = f"{CKPT_DIR}/cpm.npz"
    checkpoint.save_cpm_params(npz, cpm)
    params = tf_converter.load_params_npz(npz)
    smpl = smpl_data_lib.synthetic_smpl(seed=0, device="cpu").to_numpy()
    prior = priors_lib.synthetic_gmm_prior(0, device="cpu")
    prior = {k: getattr(prior, k).numpy()
             for k in ("means", "precisions", "log_consts")}
    est = PoseEstimator.from_numpy(params, smpl, prior, MAIN_CPM,
                                   device=DEVICE)
    size = MAIN_CPM.input_size
    images = _frames(MAIN_BATCH, size, size, seed=31)
    with torch.no_grad():
        got = est.estimate_2d(images, refine_center=False).heatmaps
        x = pre.preprocess(torch.from_numpy(images).to(DEVICE), size)
        cm = pre.gaussian_center_map(size, MAIN_CPM.center_sigma,
                                     device=DEVICE)
        want = cpm_lib.cpm_forward(cpm, x, cm.expand(MAIN_BATCH, *cm.shape),
                                   MAIN_CPM)[-1]
    hm_err = float((got - want).abs().max())
    check(hm_err == 0.0, f"bf16 estimator vs trained module heatmaps: "
          f"{hm_err}")
    est8 = PoseEstimator.from_numpy(
        params, smpl, prior, MAIN_CPM, quantize=True,
        calibration_images=_frames(8, size, size, seed=1),
        cpm_microbatch=INT8_CHUNK, device=DEVICE)
    bad = int8_matches_fake_quant(est8.cpm, cpm)
    check(not bad, f"int8 weights differ from the fake-quant view: {bad}")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    emit({"phase": "train_qat_and_resume", "qat_losses": losses,
          "saved_step": step, "save_s": save_s, "restore_s": restore_s,
          "state_bit_equal": True, "heatmaps_max_abs_err": hm_err,
          "int8_layers_bit_equal": len(list(est8.cpm.children()))})
    return est8


def eval_launches(per_chunk: dict, batch: int, chunk: int) -> tuple:
    """Kernel launches per evaluated batch: (bf16 estimator, int8
    estimator with ``cpm_microbatch=chunk``). B1 runs once per
    estimate_2d or estimate_and_fit call on the bf16 CPM and once per
    chunk on the int8 one, whose chunks each make ``per_chunk``'s B2
    launches (``int8_launches``)."""
    chunks = -(-batch // chunk)
    return ({**B2_NONE, "soft_argmax": 1},
            {"soft_argmax": chunks,
             **{k: n * chunks for k, n in per_chunk.items()}})


def _counted(fn):
    """(result, launches, seconds) of ``fn()``, counts zeroed before."""
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(), time.perf_counter() - t0


def phase_eval_main_path(est: PoseEstimator, est8: PoseEstimator,
                         per_chunk: dict) -> dict:
    """The three evaluators at full width over EVAL_BATCHES synthetic
    eval_batches of 32: evaluate_h36m_style (the perspective camera, as
    eval_h36m --protocol p1 sets it), evaluate_pckh and evaluate_oks with
    the bf16 estimator, and evaluate_pckh with the int8 one; each with
    the counts zeroed before and read after (B1: one per batch, one per
    16-frame chunk on int8; B2: the computed count per chunk × chunks),
    and its frames per second. Then each resumes from a cursor written
    after batch 1 and gives the uninterrupted result (the 2D evaluators
    exactly; the 3D one within 1 mm, as the fit is not bit-reproducible
    on the card from call to call)."""
    est_p1 = PoseEstimator(est.cpm, est.smpl_model, est.prior, MAIN_CPM,
                           FitConfig(camera_model="perspective"),
                           device=DEVICE)
    model = smpl_data_lib.synthetic_smpl(seed=0, device="cpu")
    batches = list(synthetic.eval_batches(model, EVAL_BATCH, EVAL_BATCHES,
                                          MAIN_CPM))
    frames = EVAL_BATCH * EVAL_BATCHES
    bf16, int8 = eval_launches(per_chunk, EVAL_BATCH, INT8_CHUNK)
    runs = {"h36m": (eval_lib.evaluate_h36m_style, est_p1, bf16),
            "pckh": (eval_lib.evaluate_pckh, est, bf16),
            "oks": (eval_lib.evaluate_oks, est, bf16),
            "pckh_int8": (eval_lib.evaluate_pckh, est8, int8)}
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    out, launches = {}, {}
    for name, (evaluate, target, per_batch) in runs.items():
        res, counts, seconds = _counted(
            lambda: evaluate(target, iter(batches)))
        want = {k: n * EVAL_BATCHES for k, n in per_batch.items()}
        check(counts == want, f"eval {name}: launched {counts}, expected "
              f"{want}")
        cursor = os.path.join(CKPT_DIR, f"{name}.json")
        evaluate(target, iter(batches[:1]), checkpoint_path=cursor,
                 save_every=1)
        resumed = evaluate(target, iter(batches), checkpoint_path=cursor,
                           save_every=1)
        gap = eval_metrics_gap(resumed, res, frames) if name == "h36m" \
            else {"gap": None, "ok": resumed == res}
        check(gap["ok"], f"eval {name}: resumed {resumed} vs {res}")
        out[name] = {"result": {k: v for k, v in res.items()
                                if not isinstance(v, dict)},
                     "launches": counts, "seconds": seconds,
                     "frames_per_s": frames / seconds,
                     "resume_gap": gap["gap"]}
        launches[name] = counts
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    emit({"phase": "eval_main_path", "batch": EVAL_BATCH,
          "batches": EVAL_BATCHES, "camera_h36m": "perspective", **out})
    return launches


def phase_train_eval_small_reference() -> None:
    """The GPU path against the CPU path on a small float32 model, TF32
    off, with the CPU tests' tolerances: one train step's loss and
    gradients; the optimizer's two scheduled updates given the same
    gradients; evaluate_h36m_style and evaluate_pckh results."""
    cpm_cfg, fit_cfg = _small_cfgs()
    model = smpl_data_lib.synthetic_smpl(seed=0, device="cpu")
    batch = next(synthetic.cpm_train_batches(model, 2, 1, cpm_cfg, seed=5,
                                             raw_images=True))
    out = {}
    with NoTF32():
        grads, losses, cpms = {}, {}, {}
        for dev in ("cpu", DEVICE):
            cpm = cpm_lib.init_cpm_params(0, cpm_cfg, device=dev)
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            loss = cpm_train.stage_supervision_loss(
                cpm, b["images"], b["center_maps"], b["heatmaps"], cpm_cfg)
            grads[dev] = dict(zip(
                [n for n, _ in cpm.named_parameters()],
                torch.autograd.grad(loss, list(cpm.parameters()))))
            losses[dev], cpms[dev] = float(loss.detach()), cpm
        loss_rel = abs(losses[DEVICE] - losses["cpu"]) / abs(losses["cpu"])
        grad_err = max(
            float((grads[DEVICE][k].cpu() - g).abs().max())
            / max(float(g.abs().max()), 1e-30)
            for k, g in grads["cpu"].items())
        # The same (CPU) gradients through each device's optimizer.
        param_err = 0.0
        states = {}
        opt = cpm_train.TrainOptimizer(1e-3, 10)
        for dev in ("cpu", DEVICE):
            params = dict(cpms[dev].named_parameters())
            st = opt.init(params)
            for _ in range(2):
                st = opt.apply(params, {k: g.to(dev) for k, g in
                                        grads["cpu"].items()}, st)
            states[dev] = params
        for k, p in states["cpu"].items():
            param_err = max(param_err, float(
                (states[DEVICE][k].detach().cpu() - p.detach()).abs().max()))
        out["train"] = {"loss_rel_err": loss_rel, "grad_rel_err": grad_err,
                        "param_max_abs_err": param_err}
        ok_train = (loss_rel <= LOSS_RTOL and grad_err <= GRAD_TOL
                    and param_err <= PARAM_ATOL)
        ests = {dev: PoseEstimator.create_synthetic(0, cpm_cfg, fit_cfg,
                                                    device=dev)
                for dev in ("cpu", DEVICE)}
        bs = list(synthetic.eval_batches(model, 2, 2, cpm_cfg, seed=9))
        res = {dev: (eval_lib.evaluate_h36m_style(e, iter(bs)),
                     eval_lib.evaluate_pckh(e, iter(bs)))
               for dev, e in ests.items()}
    h36m = eval_metrics_gap(res[DEVICE][0], res["cpu"][0], 4)
    pckh = eval_metrics_gap(
        {k: v for k, v in res[DEVICE][1].items() if k in ("pckh", "auc",
                                                           "num_frames")},
        {k: v for k, v in res["cpu"][1].items() if k in ("pckh", "auc",
                                                         "num_frames")}, 4)
    ok = ok_train and h36m["ok"] and pckh["ok"]
    emit({"phase": "train_eval_small_reference", **out,
          "eval_h36m_gap": h36m["gap"], "eval_pckh_gap": pckh["gap"],
          "ok": ok})
    check(ok, "GPU vs CPU train step, optimizer and evaluators")


# -- the hard synthetic set and the tools that run on it (ROADMAP A.19b) ------

SC_OUT = "build/chip_smoke_selfcheck"     # gitignored; removed at the end
SWEEP_OUT = "build/chip_smoke_sweep"
DEMO_OUT = "build/chip_smoke_demo"
# selfcheck_e2e's flags at full width (CPMConfig()), depth cut: 60 + 60
# train steps at batch 16, a hard pool of 4 batches, 16 eval and hard eval
# frames, 8 video frames.
SC_ARGS = ["--steps", "60", "--hard_steps", "60", "--train_batch", "16",
           "--hard_pool", "4", "--eval_frames", "16",
           "--hard_eval_frames", "16", "--video_frames", "8"]
# Depths the tool fixes in its code, cut: the easy pool (16 → 4 batches),
# the prior's EM corpus (4000 → 1000 poses: EM is host float64, 30 s at
# 4000), the init head's steps (2000 → 100) and the operating point's
# frames (32 → 8, 4 per count call). The fit is the default schedule's
# last stage (section 8 exports it: one scan, not three).
SC_DEPTH = {"EASY_POOL": 4, "PRIOR_CORPUS": 1000, "HEAD_STEPS": 100,
            "EMPTY_FRAMES": 8, "COUNT_FRAMES": 4}
# results.json keys of sections 1–5 and 8 (sections 9 and 10 write JPEGs
# through PIL, which the card's machine lacks).
SC_KEYS = ("train_final_loss", "fused_random_weights",
           "fused_trained_weights", "fused_fitted_prior",
           "init_head_final_loss", "fused_meanpose_init",
           "fused_learned_init", "video_temporal", "video_independent",
           "video_smooth", "multi_person", "hard_train_final_loss",
           *(rung[0] for rung in selfcheck_e2e.HARD_LADDER),
           "scale_robustness", "hard_multi_person", "hard_multi_video",
           "empty_frame_operating_point", "hard_multi_person_k3",
           "export_artifact")
HARD_DATA_FRAMES = 32
TRACK_FRAMES = 26                  # track_bench's default --frames
SWEEP_GRID = "plain:20:2:0.0,union:20:2:0.35:0:0:1:2"
PROFILE_CALLS = 2 + 1 + 1          # Timer warm-up, timed iterations, FLOPs
# demo --synthetic frames: the single-person demo rasterizes a mesh overlay
# per frame in host numpy (≈ 6 s a frame at 368²), so it runs 2 frames;
# --multi, which draws skeletons only, 8.
DEMO_FRAMES, DEMO_MULTI_FRAMES = 1, 8


def front_end_b1_launches(refine_center: bool = False,
                          refine_scale: bool = False, flip_tta: bool = False,
                          scale_tta: tuple = (), scale_iters: int = 1,
                          **_) -> int:
    """B1's launches in one ``estimate_2d_from_images`` call: per pass the
    final decode, plus the β = 30 geometry decode of refine_center or of
    each refine_scale round; a pass per TTA scale (other than 1) and all
    mirrored with flip TTA."""
    per_pass = 1 + (max(1, scale_iters) if refine_scale
                    else int(refine_center))
    views = 1 + sum(float(s) != 1.0 for s in scale_tta)
    return per_pass * views * (2 if flip_tta else 1)


def video_multi_b1_launches(hint_passes: int = 1, hint_crop=False,
                            temporal_hints: bool = True) -> int:
    """B1's launches in one ``estimate_and_fit_video_multi`` call (or
    window): the NMS pass, then per hint pass the hinted decode and, with
    ``hint_crop``, its hint-centered crop."""
    if not temporal_hints:
        return 1
    return 1 + hint_passes * (2 if hint_crop else 1)


# B1 per selfcheck section, from the calls each makes: estimate_and_fit
# (one plain pass), estimate_2d, estimate_and_fit_multi; the crossing video
# with two hint passes; the operating point's two estimate_2d_multi calls
# and six counted multi calls; section 8's export (its eager run), the
# loaded artifact and the live call, one each. No section but the ladder
# runs B2.
SELFCHECK_B1 = {
    "train_easy": 0, "fused_section": 2, "fitted_prior_section": 1,
    "init_head_section": 2, "video_section": 1,
    "multi_section": 2 * multi_b1_launches(False, False),
    "hard_weights": 0,
    "hard_multi_section": multi_b1_launches(False, False),
    "hard_video_section": video_multi_b1_launches(hint_passes=2),
    "empty_frame_section": (2 + 6) * multi_b1_launches(False, False),
    "hard_k3_section": multi_b1_launches(False, False),
    "export_section": 3}


def _sum_counts(counts) -> dict:
    """Launch counts added up by kernel."""
    total = dict.fromkeys(COUNTED, 0)
    for c in counts:
        for k, n in c.items():
            total[k] += n
    return total


def _finite_tree(x) -> bool:
    if isinstance(x, dict):
        return all(_finite_tree(v) for v in x.values())
    if isinstance(x, (bool, int)):
        return True
    return bool(np.isfinite(x))


def phase_hard_data_check() -> dict:
    """The hard generator at full size (368², the full synthetic SMPL):
    one hard_train_batches batch of 32 with the selfcheck's recipe
    (distractors 0.35 × 1..2, union stage-1 targets, flips 0.5), its host
    seconds and schema: uint8 frames, center maps, targets and union
    targets of the model's shapes, finite, the union ≥ the target on
    every joint channel."""
    model = smpl_data_lib.synthetic_smpl(seed=0, device="cpu")
    size, cfg = MAIN_CPM.input_size, MAIN_CPM
    t0 = time.perf_counter()
    b = next(synthetic_hard.hard_train_batches(
        model, HARD_DATA_FRAMES, 1, cfg, seed=0, raw_images=True,
        distractor_prob=0.35, max_distractors=2, union_stage1=True))
    seconds = time.perf_counter() - t0
    h = size // cfg.stride
    want = {"images": ((HARD_DATA_FRAMES, size, size, 3), np.uint8),
            "center_maps": ((HARD_DATA_FRAMES, size, size, 1), np.float32),
            "heatmaps": ((HARD_DATA_FRAMES, h, h, cfg.num_joints + 1),
                         np.float32),
            "heatmaps_stage1": ((HARD_DATA_FRAMES, h, h, cfg.num_joints + 1),
                                np.float32)}
    got = {k: (v.shape, v.dtype) for k, v in b.items()}
    check(set(got) == set(want) and all(
        got[k][0] == s and got[k][1] == d for k, (s, d) in want.items()),
        f"hard batch schema {got}")
    check(all(np.isfinite(b[k]).all() for k in want if k != "images"),
          "hard batch finite")
    union_ok = bool((b["heatmaps_stage1"][..., :-1]
                     >= b["heatmaps"][..., :-1] - 1e-6).all())
    check(union_ok, "union stage-1 targets ≥ the target's")
    emit({"phase": "hard_data_check", "frames": HARD_DATA_FRAMES,
          "host_seconds": seconds,
          "host_seconds_per_frame": seconds / HARD_DATA_FRAMES,
          "schema": {k: [list(s), np.dtype(d).name]
                     for k, (s, d) in got.items()},
          "union_frames": int((np.abs(b["heatmaps_stage1"]
                                      - b["heatmaps"]).max((1, 2, 3))
                               > 0).sum())})
    return {"seconds": seconds}


def phase_selfcheck_main_path() -> tuple:
    """selfcheck_e2e's sections 1–5 and 8 at full width through the tool's
    section functions, in its order (SC_ARGS, SC_DEPTH): the easy and the
    hard CPM trained on the card, the fused eval with random and trained
    weights, the fitted GMM-8 prior, the init head, the three video fits,
    two-person frames, the whole hard ladder (calibrated int8 at
    int8_min_batch 0 included), hard multi-person stills, the tracked
    crossing video, the empty-frame operating point, k = 3 stills, the
    deployment artifact (section 8, ``export_artifact`` ok). Each
    section (each ladder rung) with the counts zeroed before and read
    after: B1 as SELFCHECK_B1 and front_end_b1_launches compute, B2 only on
    the int8 rung, as int8_launches computes. Checks every key of SC_KEYS
    finite and the hard loss falling (the mean of the last pool cycle
    below the first's). Returns (the hard weights' npz, launches by
    section)."""
    shutil.rmtree(SC_OUT, ignore_errors=True)
    sc = selfcheck_e2e
    seconds, launches = {}, {}
    real_setup = sc.default_setup

    def setup(device):
        cpm_cfg, fit_cfg, model = real_setup(device)
        return cpm_cfg, temporal.warmstart_schedule(
            fit_cfg, fit_cfg.stages[-1].iters), model

    with mock.patch.multiple(sc, default_setup=setup, **SC_DEPTH):
        run = sc.Run(sc.parse_args(SC_ARGS + ["--out", SC_OUT,
                                              "--device", DEVICE]))

        def section(name, fn, *args, b1=None, b2=None, **kw):
            out, counts, sec = _counted(lambda: fn(run, *args, **kw))
            want = {**B2_NONE, **(b2 or {}),
                    "soft_argmax": SELFCHECK_B1[name] if b1 is None else b1}
            check(counts == want, f"selfcheck {name}: launched {counts}, "
                  f"expected {want}")
            seconds[name], launches[name] = sec, counts
            return out

        rand_cpm, cpm = section("train_easy", sc.train_easy)
        ex = sc.eval_examples(run)
        section("fused_section", sc.fused_section, rand_cpm, cpm, ex)
        prior = section("fitted_prior_section", sc.fitted_prior_section, cpm,
                        ex)
        section("init_head_section", sc.init_head_section, cpm, ex)
        section("video_section", sc.video_section, cpm, prior)
        section("multi_section", sc.multi_section, cpm, prior)
        cpm_h = section("hard_weights", sc.hard_weights)
        q8 = int8_launches(cpm_lib.quantize_params(cpm_h, None), MAIN_CPM,
                           run.args.hard_eval_frames, False)
        for tag, scale_range, truncation, kw in sc.HARD_LADDER:
            section(tag, sc.hard_eval, tag, cpm_h, prior, scale_range,
                    truncation, b1=front_end_b1_launches(**kw),
                    b2=q8 if kw.get("quantize") else None, **kw)
        sc.scale_robustness(run)
        mh = sc.hard_multi_examples(run)
        est_mh = run.estimator(cpm_h, prior=prior,
                               fit_restarts=run.args.restarts)
        section("hard_multi_section", sc.hard_multi_section, est_mh, mh)
        section("hard_video_section", sc.hard_video_section, est_mh)
        section("empty_frame_section", sc.empty_frame_section, cpm_h, prior,
                mh)
        section("hard_k3_section", sc.hard_k3_section, est_mh)
        section("export_section", sc.export_section, cpm, ex)
    res = run.results
    missing = [k for k in SC_KEYS if k not in res]
    check(not missing, f"selfcheck results lack {missing}")
    bad = [k for k in SC_KEYS if not _finite_tree(res[k])]
    check(not bad, f"selfcheck results not finite: {bad}")
    check(res["export_artifact"]["ok"],
          f"section 8's artifact vs the live call: {res['export_artifact']}")
    hard = run.train_losses["hard"]
    cycle = run.args.hard_pool
    first, last = np.mean(hard[:cycle]), np.mean(hard[-cycle:])
    check(last < first, f"hard training loss falls: first pool cycle "
          f"{first}, last {last}")
    ladder = {tag: res[tag] for tag, *_ in sc.HARD_LADDER}
    emit({"phase": "selfcheck_main_path", "args": SC_ARGS,
          "depth": SC_DEPTH, "results": res,
          "ladder": ladder,
          "train_losses_easy": run.train_losses["easy"][::10],
          "train_losses_hard": hard[::10],
          "hard_loss_first_cycle": first, "hard_loss_last_cycle": last,
          "train_s_per_step": {k: v / (run.args.steps if k == "easy"
                                       else run.args.hard_steps)
                               for k, v in run.train_seconds.items()},
          "section_seconds": seconds, "launches": launches})
    return f"{SC_OUT}/cpm_weights_hard.npz", launches


def phase_track_bench_main_path(weights: str) -> dict:
    """track_bench on the selfcheck's hard weights at full width: the
    crossing mode in one call, the enterleave mode through
    MultiPersonVideoSession windows (--stream), one seed of TRACK_FRAMES
    frames each; counts zeroed before each mode (B1: 2 per call or
    window). Checks the result dict's keys; reports identity accuracy and
    frames per second (the generator's host time included)."""
    out, launches = {}, {}
    modes = {"crossing": ([], 1),
             "enterleave": (["--stream"],
                            -(-TRACK_FRAMES // track_bench.STREAM_CHUNK))}
    keys = {"crossing": {"id_acc", "center_err_px", "pa_mpjpe_mm",
                         "cover40"},
            "enterleave": {"count_acc", "count_over", "count_under",
                           "count_err_transition", "count_err_steady",
                           "id_acc", "seg_consistency_min",
                           "ab_c_distinct_tracks", "c_track_reuses_b_slot"}}
    for mode, (extra, calls) in modes.items():
        res, counts, sec = _counted(lambda: track_bench.main(
            ["--weights", weights, "--mode", mode, "--seeds", "1",
             "--frames", str(TRACK_FRAMES), "--device", DEVICE] + extra))
        want = {**B2_NONE, "soft_argmax": calls * video_multi_b1_launches()}
        check(counts == want, f"track_bench {mode}: launched {counts}, "
              f"expected {want}")
        check(set(res) == {"config", mode}
              and set(res[mode]) == {"per_seed", "aggregate"}
              and set(res[mode]["per_seed"][0]) == keys[mode]
              and set(res[mode]["aggregate"]) == keys[mode],
              f"track_bench {mode} result keys")
        out[mode] = {"metrics": res[mode]["per_seed"][0], "seconds": sec,
                     "frames_per_s": TRACK_FRAMES / sec,
                     "launches": counts}
        launches[mode] = counts
    emit({"phase": "track_bench_main_path", "frames": TRACK_FRAMES,
          **out})
    return launches


def phase_hard_sweep_main_path() -> dict:
    """hard_sweep at full width: SWEEP_GRID (a plain row, and a row with
    distractors, union stage-1 targets and max_d 2), 20 steps each at
    batch 16 on pools of 2 batches, 16 eval frames; counts zeroed before
    (B1 per row: the plain and the refine_center + flip evaluations).
    Checks both rows' scores and that each row's weights npz loads back
    as the CPM it trained."""
    shutil.rmtree(SWEEP_OUT, ignore_errors=True)
    rows, counts, sec = _counted(lambda: hard_sweep.main(
        ["--grid", SWEEP_GRID, "--train_batch", "16", "--eval_frames", "16",
         "--out", SWEEP_OUT, "--device", DEVICE]))
    per_row = front_end_b1_launches() + front_end_b1_launches(
        refine_center=True, flip_tta=True)
    want = {**B2_NONE, "soft_argmax": per_row * len(rows)}
    check(counts == want, f"hard_sweep launched {counts}, expected {want}")
    grid = hard_sweep.parse_grid(SWEEP_GRID)
    check(list(rows) == [c["name"] for c in grid], f"sweep rows {list(rows)}")
    n_params = sum(p.numel() for p in cpm_lib.init_cpm_params(
        0, MAIN_CPM, device="cpu").parameters())
    for name, row in rows.items():
        cpm = cpm_lib.cpm_params_from_numpy(
            tf_converter.load_params_npz(row["weights"]), MAIN_CPM, DEVICE)
        check(sum(p.numel() for p in cpm.parameters()) == n_params
              and all(np.isfinite([row["plain"]["px"], row["rc_flip"]["px"],
                                   row["final_loss"]])),
              f"sweep row {name} loads back")
    emit({"phase": "hard_sweep_main_path", "grid": SWEEP_GRID,
          "rows": {k: {kk: v[kk] for kk in ("final_loss", "plain",
                                            "rc_flip")}
                   for k, v in rows.items()},
          "seconds": sec, "launches": counts})
    shutil.rmtree(SWEEP_OUT, ignore_errors=True)
    return counts


def _demo_files(out_dir: str, names: list) -> list:
    """The names missing from ``out_dir``; an image may have gone to its
    ``.npy`` fallback (no PIL)."""
    have = set(os.listdir(out_dir))
    return [n for n in names if n not in have and f"{n}.npy" not in have]


def phase_tools_main_path() -> dict:
    """demo --synthetic (DEMO_FRAMES; one estimate_and_fit call: fits.npz,
    a mesh OBJ, skeleton and mesh overlays per frame) and with --multi
    (DEMO_MULTI_FRAMES; an OBJ per kept person); profile_entry --fn
    estimate_and_fit --batch 8 --iters 1 and --fn fit_smpl, whose flops
    must equal FlopCounterMode's count of one call, and --quantize --fn
    estimate_2d --batch 16 (int8, dynamic scales: B2 per call as
    int8_launches computes); every run with the counts zeroed before (B1
    once per call of an image entry point)."""
    from torch.utils.flop_counter import FlopCounterMode
    shutil.rmtree(DEMO_OUT, ignore_errors=True)
    out, launches = {}, {}
    for name, n, extra in (("demo", DEMO_FRAMES, []),
                           ("demo_multi", DEMO_MULTI_FRAMES, ["--multi"])):
        d = f"{DEMO_OUT}/{name}"
        _, counts, sec = _counted(lambda: demo.main(
            ["--synthetic", str(n), "--out_dir", d, "--device", DEVICE]
            + extra))
        want = {**B2_NONE, "soft_argmax": 1}
        check(counts == want, f"{name}: launched {counts}, expected {want}")
        fits = checkpoint.load_fit_results(f"{d}/fits.npz")
        if extra:
            mask = fits["person_mask"] > 0
            names = [f"mesh_{i:03d}_p{k}.obj" for i, k in zip(*np.nonzero(
                mask))]
        else:
            names = [f"{p}_{i:03d}.{e}" for i in range(n)
                     for p, e in (("mesh", "obj"), ("mesh2d", "png"))]
        names += [f"pose2d_{i:03d}.png" for i in range(n)] + ["fits.npz"]
        missing = _demo_files(d, names)
        check(not missing, f"{name} did not write {missing}")
        out[name] = {"seconds": sec, "files": len(os.listdir(d)),
                     "launches": counts}
        launches[name] = counts
    shutil.rmtree(DEMO_OUT, ignore_errors=True)
    est = PoseEstimator.create_synthetic(seed=0, device=DEVICE)
    est8 = PoseEstimator.create_synthetic(seed=0, quantize=True,
                                          device=DEVICE)
    per_call8 = int8_launches(est8.cpm, MAIN_CPM, 16, True)
    runs = {"estimate_and_fit": (["--batch", "8"], est, 1, {}),
            "fit_smpl": (["--batch", "8"], est, 0, {}),
            "estimate_2d_int8": (["--batch", "16", "--quantize"], est8, 1,
                                 per_call8)}
    for name, (extra, ref, b1, b2) in runs.items():
        fn = name.replace("_int8", "")
        rec, counts, sec = _counted(lambda: profile_entry.main(
            ["--fn", fn, "--iters", "1", "--device", DEVICE] + extra))
        want = {**B2_NONE, "soft_argmax": b1 * PROFILE_CALLS,
                **{k: v * PROFILE_CALLS for k, v in b2.items()}}
        check(counts == want, f"profile_entry {name}: launched {counts}, "
              f"expected {want}")
        inputs = profile_entry.make_inputs(ref, fn, rec["batch"])
        ref.smpl_model.joint_basis  # built at first use, as in the tool
        with FlopCounterMode(display=False) as flops:
            getattr(ref, fn)(*inputs)
        check(rec["flops"] == flops.get_total_flops(),
              f"profile_entry {name}: flops {rec['flops']} vs "
              f"FlopCounterMode {flops.get_total_flops()}")
        check(set(rec) == {"fn", "batch", "ms_per_call", "items_per_s",
                           "flops", "flops_per_s", "mfu", "hbm_frac",
                           "trace_dir"}, f"profile_entry keys {set(rec)}")
        out[f"profile_{name}"] = {"record": rec, "seconds": sec,
                                  "launches": counts}
        launches[f"profile_{name}"] = counts
    emit({"phase": "tools_main_path", **out})
    return launches


def phase_hard_small_reference() -> None:
    """The GPU against the CPU on a small float32 model (the tests' small
    CPM and fit, the full synthetic SMPL and GMM-8, the same random
    weights; the int8 rung's QuantizedCPM calibrated on the CPU and
    copied), TF32 off: every selfcheck ladder rung on the same 4 hard
    frames of 64², within 0.05 px and 1 mm PA-MPJPE (BASELINE.json's
    budget); and track_bench's _match_metrics of an 8-frame crossing
    video tracked on each device (NMS radius 32 px: the default covers a
    64 px frame): equal identity accuracy and cover40, center error
    within 0.05 px, PA-MPJPE within 1 mm."""
    cpm_cfg, fit_cfg = _small_cfgs()
    model = smpl_data_lib.synthetic_smpl(seed=0, device="cpu")
    cpm = cpm_lib.init_cpm_params(0, cpm_cfg, device="cpu")
    runs, gaps = {}, {}
    tb_args = track_bench.parse_args(["--nms_radius", "32"])
    vid = synthetic_hard.make_hard_multi_video(model, 8, cpm_cfg, seed=0)
    # The int8 rung's CPM, quantized and calibrated once on the CPU (as in
    # int8_small_reference): calibrated on each device, the float
    # calibration forward's summation order moves a static scale by an
    # ulp, and the fit turns that into ≈ 1.6 mm (measured on the card).
    cal = synthetic_hard.make_hard_examples(
        model, selfcheck_e2e.CAL_FRAMES, cpm_cfg, seed=777,
        scale_range=(0.45, 0.95))["images"]
    int8 = PoseEstimator(cpm, model, None, cpm_cfg, fit_cfg, device="cpu",
                         quantize=True, calibration_images=cal,
                         int8_min_batch=0).cpm
    with NoTF32():
        for dev in ("cpu", DEVICE):
            run = selfcheck_e2e.Run(selfcheck_e2e.parse_args(
                ["--hard_eval_frames", "4", "--restarts", "2", "--out",
                 f"{SC_OUT}/small_{dev}", "--device", dev]),
                setup=(cpm_cfg, fit_cfg, model))
            prior = priors_lib.synthetic_gmm_prior(0, device=dev)
            weights = copy.deepcopy(cpm).to(dev)
            for tag, scale_range, truncation, kw in \
                    selfcheck_e2e.HARD_LADDER:
                if kw.get("calibrate"):
                    kw = {k: v for k, v in kw.items() if k != "calibrate"}
                    net = copy.deepcopy(int8).to(dev)
                else:
                    net = weights
                selfcheck_e2e.hard_eval(run, tag, net, prior, scale_range,
                                        truncation, **kw)
            est = run.estimator(weights, prior=prior, fit_restarts=2)
            res = track_bench._on_host(track_bench._tracked(
                est, tb_args, vid["images"], 2))
            run.results["match"] = track_bench._match_metrics(
                res, vid["centers"], vid["gt_joints3d"], metrics_lib)
            runs[dev] = run.results
    ok = True
    for tag, *_ in selfcheck_e2e.HARD_LADDER:
        g, w = runs[DEVICE][tag], runs["cpu"][tag]
        gaps[tag] = {"px": abs(g["px_err"] - w["px_err"]),
                     "pa_mm": abs(g["pa_mpjpe_mm"] - w["pa_mpjpe_mm"])}
        ok &= gaps[tag]["px"] <= 0.05 and gaps[tag]["pa_mm"] <= 1.0
    g, w = runs[DEVICE]["match"], runs["cpu"]["match"]
    gaps["match_metrics"] = {k: abs(g[k] - w[k]) for k in w}
    ok &= (g["id_acc"] == w["id_acc"] and g["cover40"] == w["cover40"]
           and gaps["match_metrics"]["center_err_px"] <= 0.05
           and gaps["match_metrics"]["pa_mpjpe_mm"] <= 1.0)
    emit({"phase": "hard_small_reference", "gaps": gaps,
          "match_metrics": runs[DEVICE]["match"], "ok": bool(ok)})
    check(ok, "GPU vs CPU selfcheck ladder and track_bench metrics")


# -- deployment artifacts (ROADMAP A.17) --------------------------------------

EXPORT_OUT = "build/chip_smoke_export"    # gitignored; removed at the end
EXPORT_STREAMS_OUT = "build/chip_smoke_export_streams"   # its own process
EXPORT_STREAM_CHUNK, EXPORT_STREAM_T = 16, 24   # one full window + 8
# Section 8's rule (the JAX tool's): the artifact against the live call.
ARTIFACT_J2D_PX, ARTIFACT_THETA, ARTIFACT_MPJPE_MM = 0.5, 0.05, 1.0
EXPORT_LOAD_LIMIT_S = 60.0   # the main artifact's export + save + load
# The fit of the export phases beside the main path and the int8 one: the
# default schedule's last stage alone (depth cut: an export traces each
# stage's gradient, seconds apiece, and the main path exports all three).
EXPORT_FIT = temporal.warmstart_schedule(FitConfig(), FitConfig().stages[-1]
                                         .iters)


def export_estimator_of(est: PoseEstimator) -> PoseEstimator:
    """``est``'s CPM (the int8 one, for a quantized estimator), SMPL model,
    prior and front end with :data:`EXPORT_FIT`."""
    return PoseEstimator(est.cpm, est.smpl_model, est.prior, est.cpm_cfg,
                         EXPORT_FIT, front_end=est.front_end,
                         device=est.device)


def _export_timed(export, path: str) -> tuple:
    """``export(path)`` with its save timed apart: (meta, seconds of the
    export without the save, seconds of the save, MB on disk)."""
    saves = []
    real_save = export_lib._save

    def timed_save(*a):
        t0 = time.perf_counter()
        out = real_save(*a)
        saves.append(time.perf_counter() - t0)
        return out

    t0 = time.perf_counter()
    with mock.patch.object(export_lib, "_save", timed_save):
        meta = export(path)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    mb = sum(os.path.getsize(os.path.join(path, f))
             for f in os.listdir(path)) / 1e6
    return meta, total - sum(saves), sum(saves), mb


def _artifact_gap(out: dict, live) -> dict:
    """Max |Δ| of joints2d and θ and the joints3d MPJPE (mm) of an
    artifact's numpy outputs against a live result on the same input, and
    whether they meet section 8's rule and the 1 mm bound."""
    got = {k: torch.as_tensor(out[k]) for k in ("joints2d", "theta",
                                                 "joints3d")}
    want = {k: getattr(live, k).cpu() for k in got}
    gap = {"max_d_joints2d_px": float((got["joints2d"]
                                       - want["joints2d"]).abs().max()),
           "max_d_theta": float((got["theta"] - want["theta"]).abs().max()),
           "joints3d_mpjpe_mm": 1000.0 * float(
               (got["joints3d"] - want["joints3d"]).norm(dim=-1).mean())}
    gap["ok"] = (gap["max_d_joints2d_px"] < ARTIFACT_J2D_PX
                 and gap["max_d_theta"] < ARTIFACT_THETA
                 and gap["joints3d_mpjpe_mm"] <= ARTIFACT_MPJPE_MM)
    return gap


def phase_custom_op_overhead() -> dict:
    """Eager host µs per call of each kernel's wrapper, which goes through
    its ``torch.library`` op (the dispatcher and the op's CUDA kernel),
    against the launch function the op calls, called directly: 500 calls
    of each, four rounds in turns (direct, wrapper, wrapper, direct), each
    round ending in a synchronize, on inputs small enough that the host
    and not the kernel sets the pace. The difference is the op's dispatch
    overhead per call (the int8 path makes 84 gathers, 12 quantize passes
    and, with dynamic scales, 40 abs-max passes per chunk of 16)."""
    ck = cuda_kernels
    hm = torch.randn(1, 46, 46, 15, device=DEVICE)
    x = torch.randn(1, 8, 8, 128, device=DEVICE, dtype=torch.bfloat16)
    scale = ck.act_scale_cuda(x)
    out = torch.empty(64, 3 * 3 * 128, dtype=torch.int8, device=DEVICE)
    cases = {
        "soft_argmax": (lambda: ck.soft_argmax_cuda(hm),
                        lambda: ck._soft_argmax_launch(hm, 100.0, 8.0)),
        "act_scale": (lambda: ck.act_scale_cuda(x),
                      lambda: ck._act_scale_launch(x)),
        "quantize_act": (lambda: ck.quantize_act_cuda(x, scale),
                         lambda: ck._quantize_launch(x, scale)),
        "quantize_im2col": (
            lambda: ck.quantize_im2col_cuda(x, scale, 3, (0, 1, 0, 8), out),
            lambda: ck._im2col_launch(x, scale, 3, (0, 1, 0, 8), out)),
    }
    calls, res = 500, {}
    for name, (wrapper, direct) in cases.items():
        us = {"wrapper": [], "direct": []}
        for kind in ("direct", "wrapper", "wrapper", "direct"):
            fn = wrapper if kind == "wrapper" else direct
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            us[kind].append((time.perf_counter() - t0) / calls * 1e6)
        res[name] = {"wrapper_us": us["wrapper"], "direct_us": us["direct"],
                     "overhead_us": statistics.median(us["wrapper"])
                     - statistics.median(us["direct"])}
    emit({"phase": "custom_op_overhead", "calls": calls, **res})
    return res


def phase_export_main_path(est: PoseEstimator, images: np.ndarray) -> tuple:
    """The slice's path: the full-width bf16 ``estimate_and_fit`` exported
    with a symbolic batch (``export.export_estimator``, the default
    FitConfig's three Adam stages as scans), saved, loaded
    (``export.load``) and run at batch 8 against the live call on the
    same frames, live and artifact in turns (live, artifact, artifact,
    live). Checks section 8's rule (Δjoints2d < 0.5 px, Δθ < 0.05) and
    joints3d within 1 mm MPJPE; B1's launches per artifact call equal to
    the live call's; export + load under 60 s. Returns (the loaded
    program, its launches in one call)."""
    path = f"{EXPORT_OUT}/main"
    meta, export_s, save_s, mb = _export_timed(
        lambda p: export_lib.export_estimator(est, p, fn="estimate_and_fit"),
        path)
    t0 = time.perf_counter()
    prog = export_lib.load(path)
    load_s = time.perf_counter() - t0
    calls = {"live": [], "artifact": []}
    launches, outs = {}, {}
    for kind in ("live", "artifact", "artifact", "live"):
        call = ((lambda: est.estimate_and_fit(images)) if kind == "live"
                else (lambda: prog(images)))
        outs[kind], launches[kind], sec = _counted(call)
        calls[kind].append(sec)
    gap = _artifact_gap(outs["artifact"], outs["live"])
    for k, v in outs["artifact"].items():
        check(np.isfinite(v).all(), f"artifact {k} finite")
    check(meta["input"]["shape"][0] == "b", "symbolic batch")
    emit({"phase": "export_main_path", "batch": images.shape[0],
          "symbolic_batch": True, "export_s": export_s, "save_s": save_s,
          "load_s": load_s, "export_plus_load_s": export_s + save_s + load_s,
          "program_mb": mb, "precision": meta["precision"],
          "decode_impl": meta["decode_impl"],
          "seconds_per_call": calls,
          "artifact_over_live": statistics.median(calls["artifact"])
          / statistics.median(calls["live"]),
          "launches_live": launches["live"],
          "launches_artifact": launches["artifact"], **gap})
    check(gap["ok"], f"artifact vs live: {gap}")
    check(launches["artifact"] == launches["live"]
          and launches["artifact"]["soft_argmax"] == 1,
          f"artifact launched {launches['artifact']}, live "
          f"{launches['live']}")
    check(export_s + save_s + load_s < EXPORT_LOAD_LIMIT_S,
          f"export + save + load took {export_s + save_s + load_s} s")
    return prog, launches["artifact"]


def phase_export_int8(est8: PoseEstimator, images: np.ndarray,
                      per_chunk: dict) -> dict:
    """The int8 path (``est8`` an :func:`export_estimator_of`) exported at
    a static batch of 32 with ``cpm_microbatch`` 16 (two chunks): the
    loaded artifact's B2 launches
    are ``int8_launches``' two chunks, B1's the live call's; its outputs
    against the live int8 call within section 8's rule and 1 mm."""
    path = f"{EXPORT_OUT}/int8"
    meta, export_s, save_s, mb = _export_timed(
        lambda p: export_lib.export_estimator(est8, p, fn="estimate_and_fit",
                                              batch=images.shape[0]), path)
    prog = export_lib.load(path)
    live, live_launches, live_s = _counted(
        lambda: est8.estimate_and_fit(images))
    out, launches, art_s = _counted(lambda: prog(images))
    chunks = images.shape[0] // INT8_CHUNK
    want = {**{k: n * chunks for k, n in per_chunk.items()},
            "soft_argmax": chunks}
    gap = _artifact_gap(out, live)
    emit({"phase": "export_int8", "batch": images.shape[0],
          "cpm_microbatch": INT8_CHUNK, "export_s": export_s,
          "save_s": save_s, "program_mb": mb,
          "quantized_params": meta["estimator"]["quantized_params"],
          "live_s": live_s, "artifact_s": art_s,
          "launches_live": live_launches, "launches_artifact": launches,
          "launches_expected": want, **gap})
    check(meta["estimator"]["quantized_params"], "int8 params baked")
    check(launches == want and live_launches == want,
          f"int8 artifact launched {launches}, live {live_launches}, "
          f"expected {want}")
    check(gap["ok"], f"int8 artifact vs live: {gap}")
    return launches


def phase_export_fit_smpl(est: PoseEstimator) -> dict:
    """The joints-only ``fit_smpl`` artifact (static batch 8, ``est`` an
    :func:`export_estimator_of`) on the joints of 8 known bodies against
    the live ``fit_smpl`` + mesh: θ within section 8's 0.05, joints3d
    within 1 mm; no kernel launches (there is no CPM)."""
    path = f"{EXPORT_OUT}/fit_smpl"
    _, export_s, save_s, mb = _export_timed(
        lambda p: export_lib.export_estimator(est, p, fn="fit_smpl",
                                              batch=8), path)
    prog = export_lib.load(path)
    px, conf = _clean_fit_observations(est.smpl_model, range(8),
                                       est.fit_cfg.img_size)
    live = est.fit_smpl(px, conf)
    _, joints3d = est._mesh(live)
    out, launches, _ = _counted(lambda: prog(px, conf))
    d_theta = float((torch.as_tensor(out["theta"]) - live.theta.cpu())
                    .abs().max())
    mpjpe = 1000.0 * float((torch.as_tensor(out["joints3d"])
                            - joints3d.cpu()).norm(dim=-1).mean())
    ok = d_theta < ARTIFACT_THETA and mpjpe <= ARTIFACT_MPJPE_MM
    emit({"phase": "export_fit_smpl", "batch": 8, "export_s": export_s,
          "save_s": save_s, "program_mb": mb, "max_d_theta": d_theta,
          "joints3d_mpjpe_mm": mpjpe, "launches": launches, "ok": ok})
    check(launches == dict.fromkeys(COUNTED, 0),
          f"fit_smpl artifact launched {launches}")
    check(ok, "fit_smpl artifact vs live")
    return launches


def phase_export_multi(est: PoseEstimator, images: np.ndarray) -> dict:
    """``estimate_and_fit_multi`` (2 slots; ``est`` an
    :func:`export_estimator_of`) exported at a static batch of 8 on
    two-person frames: the same person masks as the live call, the
    fields within section 8's rule and 1 mm, B1's launches the live
    call's (``multi_b1_launches``)."""
    path = f"{EXPORT_OUT}/multi"
    _, export_s, save_s, mb = _export_timed(
        lambda p: export_lib.export_estimator(
            est, p, fn="estimate_and_fit_multi", batch=images.shape[0],
            max_people=MULTI_PEOPLE), path)
    prog = export_lib.load(path)
    live, live_launches, _ = _counted(
        lambda: est.estimate_and_fit_multi(images, max_people=MULTI_PEOPLE))
    out, launches, _ = _counted(lambda: prog(images))
    gap = _artifact_gap(out, live)
    same_mask = bool(np.array_equal(out["person_mask"],
                                    live.person_mask.cpu().numpy()))
    emit({"phase": "export_multi", "batch": images.shape[0],
          "max_people": MULTI_PEOPLE, "export_s": export_s,
          "save_s": save_s, "program_mb": mb,
          "same_person_mask": same_mask, "launches_live": live_launches,
          "launches_artifact": launches, **gap})
    check(launches == live_launches == {
        **B2_NONE, "soft_argmax": multi_b1_launches(False, False)},
        f"multi artifact launched {launches}, live {live_launches}")
    check(same_mask and gap["ok"], f"multi artifact vs live: {gap}")
    return launches


def _session_outputs(session, frames: np.ndarray, to_numpy) -> list:
    outs = []
    for i in range(0, frames.shape[0], STREAM_PUSH):
        r = session.push(frames[i:i + STREAM_PUSH])
        if r is not None:
            outs.append(to_numpy(r))
    outs.append(to_numpy(session.flush()))
    return outs


def phase_export_streams(est: PoseEstimator = None) -> dict:
    """Both streaming artifacts of ``est`` (an :func:`export_estimator_of`;
    by default of the main estimator, when the phase runs in a process of
    its own) at chunk EXPORT_STREAM_CHUNK over EXPORT_STREAM_T frames (one
    full window and a padded one), pushed STREAM_PUSH frames at a time:
    ``ArtifactVideoSession`` of ``export_video_stream`` against
    ``VideoSession``, and of ``export_video_multi_stream`` against
    ``MultiPersonVideoSession`` on two-person frames. Same windows and
    carries: the same perms and frame masks, joints3d within 1 mm; B1
    once a window (the multi pipeline: ``video_multi_b1_launches``)."""
    if est is None:
        est = export_estimator_of(PoseEstimator.create_synthetic(
            seed=0, cpm_cfg=MAIN_CPM, device=DEVICE))
    size = est.cpm_cfg.input_size
    chunk, t = EXPORT_STREAM_CHUNK, EXPORT_STREAM_T
    windows = -(-t // chunk)
    res, launches = {}, {}
    for kind, frames in (
            ("video_stream", _frames(t, size, size, seed=61)),
            ("video_multi_stream", two_people_frames(t, size, size,
                                                     seed=62))):
        path = f"{EXPORT_STREAMS_OUT}/{kind}"
        if kind == "video_stream":
            export = lambda p: export_lib.export_video_stream(  # noqa: E731
                est, p, chunk=chunk)
            live_session = VideoSession(est, chunk=chunk)
            per_window = 1
        else:
            export = lambda p: export_lib.export_video_multi_stream(  # noqa
                est, p, chunk=chunk, max_people=MULTI_PEOPLE)
            live_session = MultiPersonVideoSession(
                est, max_people=MULTI_PEOPLE, chunk=chunk)
            per_window = video_multi_b1_launches()
        _, export_s, save_s, mb = _export_timed(export, path)
        t0 = time.perf_counter()
        art_session = export_lib.ArtifactVideoSession(path)
        load_s = time.perf_counter() - t0
        to_np = (lambda r: {k: v.cpu().numpy()  # noqa: E731
                            for k, v in r._asdict().items()})
        live, live_l, live_s = _counted(
            lambda: _session_outputs(live_session, frames, to_np))
        art, art_l, art_s = _counted(
            lambda: _session_outputs(art_session, frames, lambda r: r))
        axis1 = {"theta", "beta", "cam", "vertices", "joints3d", "energy"} \
            if kind == "video_multi_stream" else set()

        def cat(outs, k):
            return np.concatenate([o[k] for o in outs],
                                  axis=1 if k in axis1 else 0)
        mpjpe = 1000.0 * float(np.linalg.norm(
            cat(art, "joints3d") - cat(live, "joints3d"), axis=-1).mean())
        same = {k: bool(np.array_equal(cat(art, k), cat(live, k)))
                for k in ("perm", "frame_mask") if k in art[0]}
        ok = all(same.values()) and mpjpe <= ARTIFACT_MPJPE_MM
        res[kind] = {"export_s": export_s, "save_s": save_s,
                     "load_s": load_s, "program_mb": mb,
                     "live_s": live_s, "artifact_s": art_s,
                     "same": same, "joints3d_mpjpe_mm": mpjpe,
                     "launches_live": live_l, "launches_artifact": art_l,
                     "ok": ok}
        check(ok, f"{kind} artifact session vs live session: "
              f"{res[kind]}")
        want = {**B2_NONE, "soft_argmax": per_window * windows}
        check(art_l == live_l == want,
              f"{kind}: artifact launched {art_l}, live {live_l}, "
              f"expected {want}")
        launches[kind] = art_l
    shutil.rmtree(EXPORT_STREAMS_OUT, ignore_errors=True)
    emit({"phase": "export_streams", "frames": t, "chunk": chunk,
          "push": STREAM_PUSH, **res, "launches": launches})
    return launches


EXPORT_NEW_OUT = "build/chip_smoke_export_new"   # its own process
EXPORT_LBFGS_BATCH = 8
INT8_SYMBOLIC_HINT = 16                 # params_batch_hint of its export
INT8_SYMBOLIC_BATCHES = (1, 8, 16)
VIDEO_SYMBOLIC_T = (8, 16)
VIDEO_SYMBOLIC_TEMPORAL_T = 8


def _cond_calls(prog) -> list:
    """A counter of the calls of every ``while_loop`` condition of a loaded
    program (the L-BFGS linesearches): ``[n]``, read after a call. Each
    linesearch calls its condition once per iteration and once more when
    it stops."""
    calls = [0]
    for name, sub in prog._module.named_modules():
        if name.rsplit(".", 1)[-1].startswith("while_loop_cond"):
            sub.register_forward_hook(
                lambda *_: calls.__setitem__(0, calls[0] + 1))
    return calls


def phase_export_lbfgs(est: PoseEstimator, head: dict,
                       images: np.ndarray) -> dict:
    """The fit-extras estimator (``extras_fit_cfg``: the default schedule
    as L-BFGS stages, the capsule term on the pose stages; the learned
    init ``head``) exported as ``estimate_and_fit`` at a static batch of
    8: each stage a ``scan`` over its steps with a ``while_loop``
    linesearch. Artifact against the live call on the same frames, both
    under :class:`Deterministic`: joints3d within 1 mm, θ's gap stated;
    the linesearch iterations per step in the artifact (its loops'
    condition calls) against the live fit's host reads; B1 once per
    call, no B2."""
    cfg = extras_fit_cfg()
    ext = PoseEstimator(est.cpm, est.smpl_model, est.prior, est.cpm_cfg,
                        cfg, init_head=head, device=DEVICE)
    path = f"{EXPORT_NEW_OUT}/lbfgs"
    _, export_s, save_s, mb = _export_timed(
        lambda p: export_lib.export_estimator(ext, p, fn="estimate_and_fit",
                                              batch=images.shape[0]), path)
    prog = export_lib.load(path)
    conds = _cond_calls(prog)
    steps = sum(st.iters for st in cfg.stages)
    per_search = []
    zoom = lbfgs_lib.zoom_linesearch

    def counted_zoom(*args):
        before = lbfgs_lib.COUNTS["host_reads"]
        out = zoom(*args)
        per_search.append(lbfgs_lib.COUNTS["host_reads"] - before)
        return out

    with Deterministic(), mock.patch.object(lbfgs_lib, "zoom_linesearch",
                                            counted_zoom):
        lbfgs_lib.reset_counts()
        live, live_l, live_s = _counted(lambda: ext.estimate_and_fit(images))
        live_iters = lbfgs_lib.COUNTS["host_reads"]
        out, art_l, art_s = _counted(lambda: prog(images))
    # Each linesearch calls its condition once more than it iterates; a
    # torch whose scan runs the first step twice runs each stage's first
    # linesearch twice.
    repeats = scan_first_step_repeats()
    firsts = np.cumsum([0] + [st.iters for st in cfg.stages])[:-1]
    art_iters = conds[0] - (steps + repeats * len(cfg.stages))
    want_iters = live_iters + repeats * sum(per_search[i] for i in firsts)
    gap = _artifact_gap(out, live)
    exact = {k: bool(np.array_equal(out[k], getattr(live, k).cpu().numpy()))
             for k in ("joints2d", "theta", "joints3d")}
    emit({"phase": "export_lbfgs", "batch": images.shape[0],
          "lbfgs_steps": steps, "export_s": export_s, "save_s": save_s,
          "program_mb": mb, "live_s": live_s, "artifact_s": art_s,
          "linesearch_iterations_per_step_live": live_iters / steps,
          "linesearch_iterations_per_step_artifact": art_iters / steps,
          "scan_first_step_repeats": repeats,
          "artifact_iterations_expected": want_iters,
          "launches_live": live_l, "launches_artifact": art_l,
          "bit_equal": exact, **gap})
    check(gap["joints3d_mpjpe_mm"] <= ARTIFACT_MPJPE_MM,
          f"L-BFGS artifact vs live: {gap}")
    # The same arithmetic on the same values takes the same linesearch
    # decisions: where the outputs are bit-equal, so are the iterations.
    check(art_iters == want_iters or not all(exact.values()),
          f"L-BFGS artifact ran {art_iters} linesearch iterations, "
          f"expected {want_iters} (live fit {live_iters})")
    check(0 < art_iters <= steps * lbfgs_lib.MAX_LINESEARCH_STEPS,
          f"L-BFGS artifact ran {art_iters} linesearch iterations")
    check(art_l == live_l == {**B2_NONE, "soft_argmax": 1},
          f"L-BFGS artifact launched {art_l}, live {live_l}")
    return art_l


def phase_export_int8_symbolic(images: np.ndarray) -> dict:
    """An int8 estimator (``int8_min_batch=4``, 8 calibration frames, no
    ``cpm_microbatch``) exported as ``estimate_2d`` with a symbolic batch
    (``params_batch_hint`` 16): its convs tile by groups of images
    (``ops/quantize._int8_conv_grouped``). Run at batch 1, 8 and 16
    against the live call on the same int8 weights (at batch 1, below
    ``int8_min_batch``, the artifact still serves its baked int8 CPM):
    joints2d and conf bit-equal (the integer GEMM is exact whatever the
    tiles, and B2 is bit-exact); B2's launches those of
    ``int8_launches(grouped=True)``, the live call's those of the static
    tiles, B1 once. First, B2's functional gather (the form the
    program's scan bodies call) against the in-place one, bit for bit, on
    every tile of ``phase_quantize_im2col_check``'s cases."""
    tiles = 0
    for name, x, a_scale, k, case_tiles in _im2col_cases():
        scale = (None if x.dtype == torch.int8
                 else cuda_kernels.act_scale_cuda(x, a_scale))
        for tile in case_tiles:
            want = cuda_kernels.quantize_im2col_cuda(
                x, scale, k, tile, _rows_buffer(x, k, tile))
            got = cuda_kernels.quantize_im2col_tile_cuda(
                x, scale, k, tile, _pad8(k * k * x.shape[3]))
            check(torch.equal(got, want),
                  f"functional quantize_im2col vs in-place, {name} {tile}")
            tiles += 1
    size = MAIN_CPM.input_size
    est8 = PoseEstimator.create_synthetic(
        seed=0, cpm_cfg=MAIN_CPM, quantize=True, int8_min_batch=4,
        calibration_images=_frames(8, size, size, seed=1), device=DEVICE)
    path = f"{EXPORT_NEW_OUT}/int8_symbolic"
    meta, export_s, save_s, mb = _export_timed(
        lambda p: export_lib.export_estimator(
            est8, p, fn="estimate_2d", params_batch_hint=INT8_SYMBOLIC_HINT),
        path)
    check(meta["input"]["shape"][0] == "b"
          and meta["estimator"]["quantized_params"],
          "symbolic-batch int8 artifact")
    prog = export_lib.load(path)
    live8 = copy.copy(est8)
    live8.int8_min_batch = 1
    repeats = scan_first_step_repeats()
    res = {"scan_first_step_repeats": repeats}
    launches = {}
    for b in INT8_SYMBOLIC_BATCHES:
        frames = images[:b]
        live, live_l, live_s = _counted(lambda: live8.estimate_2d(frames))
        out, art_l, art_s = _counted(lambda: prog(frames))
        same = {k: bool(np.array_equal(out[k], getattr(live, k).cpu()
                                       .numpy()))
                for k in ("joints2d", "conf")}
        want_art = {**int8_launches(est8.cpm, MAIN_CPM, b, False,
                                    grouped=True, scan_repeats=repeats),
                    "soft_argmax": 1}
        want_live = {**int8_launches(est8.cpm, MAIN_CPM, b, False),
                     "soft_argmax": 1}
        res[str(b)] = {"bit_equal": same, "live_s": live_s,
                       "artifact_s": art_s, "launches_live": live_l,
                       "launches_artifact": art_l,
                       "launches_artifact_expected": want_art}
        check(all(same.values()), f"int8 symbolic artifact at batch {b} "
              f"vs live: {same}")
        check(art_l == want_art and live_l == want_live,
              f"int8 symbolic artifact at batch {b} launched {art_l} "
              f"(expected {want_art}), live {live_l} ({want_live})")
        launches[b] = art_l
    emit({"phase": "export_int8_symbolic", "group_images":
          quantize_lib.GROUP_IMAGES, "params_batch_hint": INT8_SYMBOLIC_HINT,
          "functional_gather_tiles_checked": tiles, "export_s": export_s,
          "save_s": save_s, "program_mb": mb, **res})
    return launches[INT8_SYMBOLIC_BATCHES[-1]]


def phase_export_video_symbolic(est: PoseEstimator) -> dict:
    """``estimate_and_fit_video`` exported with a symbolic T (``est`` an
    :func:`export_estimator_of` with 4 yaw hypotheses): the smooth mode
    run at T = 8 and T = 16 against the live call (joints3d within 1 mm,
    one shared β), the temporal mode (its warm starts a scan over frames)
    at T = 8; B1 once per call."""
    size = est.cpm_cfg.input_size
    res, launches = {}, None
    for mode, ts in (("smooth", VIDEO_SYMBOLIC_T),
                     ("temporal", (VIDEO_SYMBOLIC_TEMPORAL_T,))):
        path = f"{EXPORT_NEW_OUT}/video_{mode}"
        meta, export_s, save_s, mb = _export_timed(
            lambda p: export_lib.export_estimator(
                est, p, fn="estimate_and_fit_video", mode=mode), path)
        check(meta["input"]["shape"][0] == "b", "symbolic T")
        prog = export_lib.load(path)
        res[mode] = {"export_s": export_s, "save_s": save_s,
                     "program_mb": mb}
        for t in ts:
            frames = _frames(t, size, size, seed=65 + t)
            live, live_l, live_s = _counted(
                lambda: est.estimate_and_fit_video(frames, mode))
            out, art_l, art_s = _counted(lambda: prog(frames))
            gap = _artifact_gap(out, live)
            shared = float(np.ptp(out["beta"], axis=0).max())
            res[mode][str(t)] = {"live_s": live_s, "artifact_s": art_s,
                                 "beta_ptp": shared,
                                 "launches_live": live_l,
                                 "launches_artifact": art_l, **gap}
            check(gap["joints3d_mpjpe_mm"] <= ARTIFACT_MPJPE_MM,
                  f"video {mode} artifact at T = {t} vs live: {gap}")
            check(mode != "smooth" or shared < 1e-5,
                  f"video artifact at T = {t}: β not shared ({shared})")
            check(art_l == live_l == {**B2_NONE, "soft_argmax": 1},
                  f"video {mode} artifact at T = {t} launched {art_l}, "
                  f"live {live_l}")
            launches = art_l
    emit({"phase": "export_video_symbolic", "restarts": est.fit_restarts,
          **res})
    return launches


def phase_export_new_paths() -> dict:
    """The three exports this slice opened (L-BFGS fits, the int8 CPM with
    a symbolic batch, the video fits with a symbolic T), in a process of
    their own beside the hard set: tracing and saving are host work. The
    init head is trained here as ``phase_fit_extras_main_path`` trains
    it."""
    size = MAIN_CPM.input_size
    est = PoseEstimator.create_synthetic(seed=0, cpm_cfg=MAIN_CPM,
                                         device=DEVICE)
    head, _ = init_head_lib.train_init_head(
        est.smpl_model, steps=HEAD_STEPS, batch=HEAD_BATCH, seed=0)
    images = _frames(INT8_SYMBOLIC_BATCHES[-1], size, size, seed=66)
    launches = {
        "lbfgs": phase_export_lbfgs(est, head,
                                    images[:EXPORT_LBFGS_BATCH]),
        "int8_symbolic": phase_export_int8_symbolic(images),
        "video_symbolic": phase_export_video_symbolic(PoseEstimator(
            est.cpm, est.smpl_model, est.prior, est.cpm_cfg, EXPORT_FIT,
            fit_restarts=VIDEO_RESTARTS, device=DEVICE))}
    shutil.rmtree(EXPORT_NEW_OUT, ignore_errors=True)
    emit({"phase": "export_new_paths", "launches": launches})
    return launches


def phase_serving_artifact(prog) -> dict:
    """A few requests through ``BatchingServer(ServableProgram(prog))``,
    the main path's loaded artifact behind the server with no estimator:
    8 frames of three resolutions, letterboxed at submit time into one
    batch of 8, each response within section 8's rule of the artifact's
    direct call on the same letterboxed batch (the same batch: bf16
    convs round differently at another batch size, and random weights'
    flat heatmaps turn that into pixels); one B1 launch per batch."""
    servable = export_lib.ServableProgram(prog)
    frames = _load_frames(300)[:SERVE_BATCH]
    size = servable.cpm_cfg.input_size
    with serving.BatchingServer(servable, max_batch=SERVE_BATCH,
                                buckets=(SERVE_BATCH,), max_wait_ms=5000.0,
                                fields=SERVE_FIELDS) as srv:
        zero_counts()
        outs = [f.result(600) for f in srv.submit_many(frames)]
        launches = read_counts()
        snap = srv.stats.snapshot()
    boxed = [pre.letterbox_image_np(img, size)
             if img.shape[:2] != (size, size) else (img, None)
             for img in frames]
    direct = prog(np.stack([b for b, _ in boxed]))
    gaps = []
    for i, (out, (_, a)) in enumerate(zip(outs, boxed)):
        j = direct["joints2d"][i]
        if a is not None:
            j = (j - a[2:4]) / a[0:2]
        gaps.append({"joints2d": float(np.abs(out["joints2d"] - j).max()),
                     "theta": float(np.abs(out["theta"]
                                           - direct["theta"][i]).max())})
    ok = all(g["joints2d"] < ARTIFACT_J2D_PX and g["theta"] < ARTIFACT_THETA
             for g in gaps)
    emit({"phase": "serving_artifact", "requests": len(frames),
          "batches": snap["batches"], "mean_batch": snap["mean_batch"],
          "max_d_joints2d_px": max(g["joints2d"] for g in gaps),
          "max_d_theta": max(g["theta"] for g in gaps),
          "launches": launches, "ok": ok})
    check(len(outs) == len(frames) and all(
        o["theta"].shape == (72,) for o in outs), "every request answered")
    check(snap["batches"] == 1, f"{len(frames)} requests formed "
          f"{snap['batches']} batches")
    check(launches == {**B2_NONE, "soft_argmax": 1},
          f"served artifact launched {launches}")
    check(ok, "served artifact vs its direct call")
    return launches


def phase_export_small_reference() -> None:
    """The GPU artifact against the CPU artifact of the same small float32
    estimator (``_small_cfgs``' CPM and the last stage of its fit, the
    same weights on both devices; TF32 off while exporting, which the
    artifact records and applies; the process's first exports, so the CPU
    one's seconds include torch.export's one-time set-up):
    ``estimate_and_fit`` at a static batch of 2 on the same frames,
    joints2d within 1e-2 px, θ within 1e-3, joints3d within 1 mm."""
    cpm_cfg, fit_cfg = _small_cfgs()
    fit_cfg = temporal.warmstart_schedule(fit_cfg, fit_cfg.stages[-1].iters)
    frames = _frames(2, cpm_cfg.input_size, cpm_cfg.input_size, seed=63)
    outs, seconds = {}, {}
    with NoTF32():
        for dev in ("cpu", DEVICE):
            est = PoseEstimator.create_synthetic(
                seed=0, cpm_cfg=cpm_cfg, fit_cfg=fit_cfg, device=dev)
            path = f"{EXPORT_OUT}/small_{dev}"
            t0 = time.perf_counter()
            meta = export_lib.export_estimator(est, path,
                                               fn="estimate_and_fit",
                                               batch=2)
            seconds[dev] = time.perf_counter() - t0
            check(meta["platforms"] == [dev], f"platforms {meta}")
            outs[dev] = export_lib.load(path)(frames)
    gap = {k: float(np.abs(outs[DEVICE][k] - outs["cpu"][k]).max())
           for k in ("joints2d", "theta", "cam")}
    gap["joints3d_mpjpe_mm"] = 1000.0 * float(np.linalg.norm(
        outs[DEVICE]["joints3d"] - outs["cpu"]["joints3d"], axis=-1).mean())
    ok = (gap["joints2d"] <= 1e-2 and gap["theta"] <= 1e-3
          and gap["joints3d_mpjpe_mm"] <= 1.0)
    emit({"phase": "export_small_reference", "export_s": seconds,
          "gap": gap, "ok": ok})
    check(ok, f"GPU artifact vs CPU artifact: {gap}")

# -- the parity harness, the TF converter and their CLIs (ROADMAP A.20) -------

# The day-one CLI's certification probe frames and smoke-eval frames: two
# batches of run_day_one's default eval batch, on the full-size SMPL.
DAY_ONE_ARGS = ["--frames", "2", "--eval_frames", "8"]
DAY_ONE_EVAL_BATCH = 4
DAY_ONE_VERTS = smpl_data_lib.NUM_VERTS
DAY_ONE_TIMEOUT_S = 900.0
# tests/test_parity.py's sweep case: the oracle's gmof_sigma mismatched.
PARITY_SWEEP_ARGS = ["--sweep", "--frames", "2", "--passes", "1",
                     "--oracle_sigma", "40"]
# tests/test_parity.py's stage-parity bounds (m, px, relative).
STAGE_PARITY_BOUNDS = {"smpl_verts_max_m": 1e-5, "smpl_joints_max_m": 1e-5,
                       "decode_max_px": 0.0, "decode_conf_max": 1e-6,
                       "projection_max_px": 1e-3, "energy_rel_err": 1e-5}
TF_STYLES = {"slim": ("{}/weights", "{}/biases"),
             "layers": ("{}/kernel", "{}/bias"),
             "plain": ("{}_W", "{}_b")}


class ChumpyLike:
    """The real SMPL pickle wraps several tensors in chumpy arrays, whose
    dense payload is the ``.r`` attribute (what ``load_smpl_pickle``
    unwraps)."""

    def __init__(self, value):
        self.r = np.asarray(value)


def write_smpl_pickle(path: str, model) -> None:
    """``model``'s tensors in the real SMPL pickle schema: chumpy
    wrappers, a scipy-sparse J_regressor, a (2, 24) uint32 kintree_table
    with the 4294967295 root sentinel, uint32 faces, protocol 2."""
    import pickle

    import scipy.sparse
    arrays = model.to_numpy()
    parents = np.asarray(arrays["parents"], np.int64)
    kintree = np.stack([parents.astype(np.uint32),
                        np.arange(len(parents), dtype=np.uint32)])
    kintree[0, 0] = np.uint32(4294967295)
    dd = {"v_template": ChumpyLike(arrays["v_template"].astype(np.float64)),
          "shapedirs": ChumpyLike(arrays["shapedirs"].astype(np.float64)),
          "posedirs": ChumpyLike(arrays["posedirs"].astype(np.float64)),
          "J_regressor": scipy.sparse.csc_matrix(
              arrays["J_regressor"].astype(np.float64)),
          "weights": ChumpyLike(arrays["weights"].astype(np.float64)),
          "kintree_table": kintree,
          "f": np.asarray(arrays["faces"], np.uint32),
          "bs_style": "lbs", "bs_type": "lrotmin",
          "J": np.zeros((len(parents), 3))}
    with open(path, "wb") as f:
        pickle.dump(dd, f, protocol=2)


def write_gmm_pickle(path: str, seed: int = 3, k: int = 8) -> None:
    """A SMPLify ``gmm_08.pkl``-layout prior: means, covars, weights."""
    import pickle
    rng = np.random.RandomState(seed)
    means = 0.1 * rng.randn(k, priors_lib.BODY_POSE_DIM)
    covs = np.stack([np.eye(priors_lib.BODY_POSE_DIM) * (1.0 + 0.1 * i)
                     for i in range(k)])
    with open(path, "wb") as f:
        pickle.dump({"means": means, "covars": covs,
                     "weights": np.full(k, 1 / k)}, f, protocol=2)


def fabricate_reference(ref_dir: str, model, cpm_params: dict) -> None:
    """A reference-like directory, nested as a checkout would be: the CPM
    weights as ``tf_converter.save_params_npz``'s flat npz, the SMPL model
    in the real pickle schema and a SMPLify GMM pickle."""
    os.makedirs(f"{ref_dir}/models", exist_ok=True)
    tf_converter.save_params_npz(f"{ref_dir}/models/cpm_weights.npz",
                                 cpm_params)
    write_smpl_pickle(f"{ref_dir}/models/basicModel_neutral.pkl", model)
    write_gmm_pickle(f"{ref_dir}/models/gmm_08.pkl")


def write_tf1_checkpoint(path: str, params: dict, style: str) -> None:
    """``params`` ({layer: {"w" HWIO, "b"}}) as a TF1 checkpoint written by
    ``tf.compat.v1.train.Saver``, variables named in ``style``."""
    import tensorflow as tf
    tf1 = tf.compat.v1
    w_name, b_name = TF_STYLES[style]
    graph = tf1.Graph()
    with graph.as_default():
        for layer, wb in params.items():
            tf1.Variable(wb["w"], name=w_name.format(layer))
            tf1.Variable(wb["b"], name=b_name.format(layer))
        saver = tf1.train.Saver()
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, path)


def main_cpm_params() -> dict:
    """The full-width CPM's random weights from seed 0, as numpy HWIO."""
    return cpm_lib.cpm_params_to_numpy(
        cpm_lib.init_cpm_params(0, MAIN_CPM, device="cpu"))


def stage_parity_ok(report: dict) -> bool:
    return all(report[k] <= bound
               for k, bound in STAGE_PARITY_BOUNDS.items())


def phase_in_process(call: str) -> subprocess.Popen:
    """Start ``chip_smoke.<call>`` in a Python process of its own, from
    this file's directory, its standard output to a temporary file."""
    out = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.{call}"],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=out,
        text=True)
    proc.out = out
    return proc


def stop_process(proc: subprocess.Popen) -> None:
    """Kill ``proc`` if it is still running."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def wait_for_file(path: str, timeout: float,
                  proc: subprocess.Popen | None = None) -> None:
    """Wait until ``path`` exists or ``proc``, when given, has exited (its
    phase line then says why, when it is finished)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path) and (proc is None
                                        or proc.poll() is None):
        check(time.monotonic() < deadline, f"{path} did not appear")
        time.sleep(0.2)


def finish_process(proc: subprocess.Popen, phase: str,
                   timeout: float) -> dict:
    """Wait for a :func:`phase_in_process` process, echo what it printed
    and return its ``phase`` line; fails unless it exits 0 with that
    line. The process is killed if it is still running."""
    try:
        proc.wait(timeout=timeout)
    finally:
        stop_process(proc)
    proc.out.seek(0)
    lines = {}
    for line in proc.out.read().splitlines():
        print(line, flush=True)
        if line.startswith("{"):
            obj = json.loads(line)
            lines[obj.get("phase")] = obj
    proc.out.close()
    check(proc.returncode == 0 and phase in lines,
          f"{phase} process exited {proc.returncode}")
    return lines[phase]


def phase_day_one_main_path() -> dict:
    """The day-one CLI (``tools/reference_day_one.main``) on a reference
    directory fabricated in a temporary directory: the full-width CPM's
    weights (seed 0) as an npz, the full-size synthetic SMPL in the real
    pickle schema, a SMPLify GMM pickle. DAY_ONE_ARGS: certification on
    2 probe frames (the port's L-BFGS fit on the card, the float64 oracle
    on the host), the smoke eval on 2 batches of DAY_ONE_EVAL_BATCH
    (run_day_one's default; B1 once per batch).
    The CLI's exit code must be 0; the verdict must be certified, within
    1 mm and the stage-parity bounds."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_day_one_") as tmp:
        t0 = time.perf_counter()
        fabricate_reference(f"{tmp}/reference",
                            smpl_data_lib.synthetic_smpl(
                                seed=0, num_verts=DAY_ONE_VERTS,
                                device="cpu"),
                            main_cpm_params())
        fabricate_s = time.perf_counter() - t0
        lbfgs_lib.reset_counts()
        code = None

        def run():
            nonlocal code
            try:
                reference_day_one.main(
                    ["--reference", f"{tmp}/reference", "--out",
                     f"{tmp}/out", "--device", DEVICE] + DAY_ONE_ARGS)
            except SystemExit as e:
                code = e.code

        _, counts, sec = _counted(run)
        with open(f"{tmp}/out/day_one_verdict.json") as f:
            verdict = json.load(f)
    n_eval = max(1, reference_day_one.parse_args(
        ["--reference", ""] + DAY_ONE_ARGS).eval_frames // DAY_ONE_EVAL_BATCH)
    cert = verdict.get("certification", {})
    secs = {**verdict["seconds"], **{f"certify_{k}": v for k, v in
                                     cert.get("seconds", {}).items()}}
    out = {"exit_code": code, "ok": verdict["ok"],
           "missing": verdict["missing"],
           "stage_parity": cert.get("stage_parity"),
           "fit_gap_mm_mean": cert.get("fit_gap", {}).get(
               "mpjpe_gap_mm_mean"),
           "fit_gap_mm_max": cert.get("fit_gap", {}).get(
               "mpjpe_gap_mm_max"),
           "certified": cert.get("certified"),
           "independent_fit_gap_mm": cert.get("independent_fit_gap_mm"),
           "gt_mpjpe_mm_ours": cert.get("gt_mpjpe_mm_ours"),
           "gt_mpjpe_mm_oracle": cert.get("gt_mpjpe_mm_oracle"),
           "smoke_eval": {k: verdict.get("smoke_eval", {}).get(k) for k in
                          ("num_frames", "mpjpe_p1", "pa_mpjpe")},
           "fabricate_s": fabricate_s, "seconds": sec, "sections_s": secs,
           "oracle_evaluations": cert.get("oracle_evaluations"),
           "lbfgs": dict(lbfgs_lib.COUNTS), "launches": counts,
           "b1_per_smoke_eval_batch": counts["soft_argmax"] / n_eval}
    emit({"phase": "day_one_main_path", **out})
    check(code == 0, f"day-one CLI exited {code}")
    check(verdict["ok"] and cert["certified"]
          and cert["fit_gap"]["mpjpe_gap_mm_mean"] <= 1.0,
          f"day-one verdict {out}")
    check(stage_parity_ok(cert["stage_parity"]),
          f"stage parity {cert['stage_parity']}")
    want = {**B2_NONE, "soft_argmax": n_eval}
    check(counts == want, f"day-one launched {counts}, expected {want}")
    return counts


def phase_parity_sweep_main_path() -> dict:
    """The parity-sweep CLI (``tools/parity_sweep.main``) with
    PARITY_SWEEP_ARGS on the full-size synthetic SMPL and GMM-8: the
    oracle fits 2 probe frames with gmof_sigma 40 on the host, then one
    greedy pass over the default axes, each candidate a fit on the card
    (no CPM: B1 never runs). The best gap must be no worse than the
    first."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as tmp:
        report, counts, sec = _counted(lambda: parity_sweep.main(
            PARITY_SWEEP_ARGS + ["--out", f"{tmp}/parity.json", "--device",
                                 DEVICE]))
    s = report["sweep"]
    fits = [h["seconds"] for h in s["history"]]
    emit({"phase": "parity_sweep_main_path",
          "best_gap_mm": s["best_gap_mm"],
          "trajectory_mm": s["trajectory_mm"], "evals": s["evals"],
          "best_setting": s["best_setting"],
          "seconds_per_eval": statistics.mean(fits),
          "seconds_per_eval_max": max(fits), "seconds": sec,
          "launches": counts})
    check(s["best_gap_mm"] <= s["trajectory_mm"][0] + 1e-9
          and np.isfinite(s["best_gap_mm"]),
          f"sweep best {s['best_gap_mm']} vs first {s['trajectory_mm'][0]}")
    check(counts == {**B2_NONE, "soft_argmax": 0},
          f"parity sweep launched {counts}")
    return counts


def phase_tf_converter_check() -> dict:
    """Where tensorflow imports: the full-width CPM's weights (seed 0)
    written as a TF1 checkpoint in each naming style TF_STYLES, converted
    (``utils/tf_converter.convert_tf_checkpoint``) bit for bit back to
    the source, and ``estimate_2d`` on the converted weights equal to the
    source weights' (0 px) on frames of two people. Where it does not,
    one line says so."""
    if importlib.util.find_spec("tensorflow") is None:
        out = {"phase": "tf_converter_check",
               "skipped": "tensorflow is not installed"}
        emit(out)
        return out
    params = main_cpm_params()
    names = [d[0] for d in cpm_lib._layer_defs(MAIN_CPM)]
    model = smpl_data_lib.synthetic_smpl(seed=0, device=DEVICE)
    size = MAIN_CPM.input_size
    frames = two_people_frames(2, size, size, seed=12)

    def joints2d(p):
        est = PoseEstimator(cpm_lib.cpm_params_from_numpy(p, MAIN_CPM,
                                                          DEVICE),
                            model, None, MAIN_CPM, device=DEVICE)
        return est.estimate_2d(frames).joints2d

    want = joints2d(params)
    out = {"phase": "tf_converter_check", "styles": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tf_") as tmp:
        for style in TF_STYLES:
            t0 = time.perf_counter()
            write_tf1_checkpoint(f"{tmp}/{style}.ckpt", params, style)
            t1 = time.perf_counter()
            got = tf_converter.convert_tf_checkpoint(f"{tmp}/{style}.ckpt",
                                                     names)
            t2 = time.perf_counter()
            equal = set(got) == set(params) and all(
                np.array_equal(got[k][kind], params[k][kind])
                and got[k][kind].dtype == np.float32
                for k in params for kind in ("w", "b"))
            px = float((joints2d(got) - want).abs().max())
            out["styles"][style] = {"bit_equal": equal, "max_px": px,
                                    "write_s": t1 - t0, "convert_s": t2 - t1}
    emit(out)
    for style, r in out["styles"].items():
        check(r["bit_equal"] and r["max_px"] == 0.0,
              f"tf_converter {style}: {r}")
    return out


# -- data parallelism over torch.distributed (ROADMAP A.21) ------------------

PARALLEL_OUT = "build/chip_smoke_parallel"   # gitignored; removed at the end
PARALLEL_EVAL_BATCHES = 2
DP_BATCH = 32                 # tools/train_cpm.py's default --batch
DP_STEPS = 3
DP_PARAM_ATOL = 5e-4          # tests/test_parallel.py's DP-step bound
PARALLEL_CLI_ARGS = ["--synthetic", "--steps", "3"]
PARALLEL_TIMEOUT_S = 600.0
ARTIFACT_JOINTS_ATOL = 1e-2   # tests/test_export.py's sharded artifact
SHARDED_VIDEO_MODES_T = 8     # the temporal and independent modes' frames


def sharded_b1_launches(batch: int, world: int, chunk: int) -> int:
    """B1 launches on each rank per sharded call (``sharded_fused_fn``,
    ``sharded_2d_fn``, a sharded artifact) on the float CPM: one per
    ``chunk``-frame micro-chunk of the rank's batch / world rows, one
    without micro-chunks."""
    rows = batch // world
    return -(-rows // chunk) if chunk else 1


def video_collectives(mode: str, iters: int = 100, restarts: int = 4,
                      shared_beta: bool = True, masked: bool = False,
                      anchored: bool = False, outputs: int = 8) -> dict:
    """Collectives by kind (``parallel/mesh.COLLECTIVES``) on each rank
    per frame-sharded video call: ``outputs`` gathers of the results (8
    from ``estimate_and_fit_video(mesh=)``, 5 from a
    ``fitting/temporal.py`` fit with ``mesh=``);
    the temporal mode one more, of the 2D joints; the smooth mode one of
    its hypotheses' lattice (with more than one hypothesis) or of its β
    (with one, a shared β and no anchor) and one of the mask, a halo
    exchange per refine step and one of the mask, and a β ``psum`` per
    step when β is shared."""
    if mode == "independent":
        return {"gather": outputs, "halo": 0, "psum": 0}
    if mode == "temporal":
        return {"gather": outputs + 1, "halo": 0, "psum": 0}
    first = restarts > 1 or (shared_beta and not anchored)
    return {"gather": outputs + int(first) + int(masked),
            "halo": iters + int(masked), "psum": iters * int(shared_beta)}


def _collectives_of(fn):
    """(result, launches, seconds, collectives by kind) of ``fn()``, the
    kernel and collective counts zeroed before."""
    from tpu_pose_torch.parallel import mesh as mesh_lib
    mesh_lib.COLLECTIVES.clear()
    out, launches, seconds = _counted(fn)
    return out, launches, seconds, dict(mesh_lib.COLLECTIVES)


def _check_collectives(got: dict, want: dict, what: str) -> None:
    check(collections.Counter(got) == collections.Counter(want),
          f"{what}: collectives {got}, expected {want}")


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Deterministic:
    """``torch.use_deterministic_algorithms(True)`` for the duration, with
    the ``CUBLAS_WORKSPACE_CONFIG`` that the mode requires of an op on
    cuBLAS. The variable is set only here: set when the process starts, it
    made every eager call of the process slower, the timed ones too. The
    eager fit is not bit-reproducible on the card by default (ROADMAP §C);
    under this mode two calls are, so a sharded path at world 1 must equal
    the live one exactly."""

    def __enter__(self):
        self.prev = torch.are_deterministic_algorithms_enabled()
        self.prev_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.prev)
        if self.prev_env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = self.prev_env


def _max_gap(a, b) -> dict:
    return {k: float((getattr(a, k).float() - getattr(b, k).float()).abs()
                     .max()) for k in a._fields}


def phase_sharded_main_path(est: PoseEstimator, mesh,
                            images: np.ndarray) -> dict:
    """``parallel/eval.sharded_fused_fn`` over the mesh against the live
    ``estimate_and_fit`` on the same frames: seconds per call of each
    (default mode, two calls each in turns after a warm-up of each), B1
    launches per sharded call (as
    ``sharded_b1_launches``), the ``all_gather`` of the outputs timed alone
    with its bytes, and Δθ against the live call and between two live
    calls (the card's eager non-determinism). Under ``Deterministic`` the
    sharded call equals the live one in every output field when the world
    is one rank."""
    from tpu_pose_torch.parallel import mesh as mesh_lib
    run = eval_lib.sharded_fused_fn(est, mesh)
    first = est.estimate_and_fit(images)   # warm-ups: cuDNN, the NCCL
    run(images)                            # communicator
    live_s, sharded_s = [], []
    for _ in range(2):
        live, live_counts, s = _counted(lambda: est.estimate_and_fit(images))
        live_s.append(s)
        res, counts, s = _counted(lambda: run(images))
        sharded_s.append(s)
    check_result(res, len(images))
    b1 = sharded_b1_launches(len(images), mesh.size(), est.cpm_microbatch)
    check(counts == {**B2_NONE, "soft_argmax": b1},
          f"sharded_main_path: launched {counts}, expected {b1} B1")
    with Deterministic():
        exact = _max_gap(run(images), est.estimate_and_fit(images))
    if mesh.size() == 1:
        check(max(exact.values()) == 0.0,
              f"sharded_main_path: deterministic gaps {exact}")
    gather_ms = eager_ms(lambda: mesh_lib.gather_batch(live, mesh), reps=20)
    emit({"phase": "sharded_main_path", "world_size": mesh.size(),
          "batch": len(images), "s_per_call": sharded_s,
          "live_s_per_call": live_s, "b1_per_call": counts["soft_argmax"],
          "live_launches": live_counts, "all_gather_ms": gather_ms,
          "all_gather_bytes": _bytes(live),
          "max_d_theta": _max_gap(res, live)["theta"],
          "live_vs_live_max_d_theta": _max_gap(first, live)["theta"],
          "deterministic_max_gap": exact})
    return counts


def phase_sharded_eval(est: PoseEstimator, mesh) -> dict:
    """``evaluate_h36m_style`` and ``evaluate_pckh`` with the mesh against
    the same evaluators without one, on PARALLEL_EVAL_BATCHES synthetic
    batches of MAIN_BATCH, under ``Deterministic``: B1 per batch as
    ``sharded_b1_launches``; at world 1 the metrics equal."""
    model = smpl_data_lib.synthetic_smpl(seed=0, device="cpu")
    batches = list(synthetic.eval_batches(model, MAIN_BATCH,
                                          PARALLEL_EVAL_BATCHES, MAIN_CPM))
    b1 = sharded_b1_launches(MAIN_BATCH, mesh.size(), est.cpm_microbatch)
    out, launches = {}, {}
    for name, evaluate in (("h36m", eval_lib.evaluate_h36m_style),
                           ("pckh", eval_lib.evaluate_pckh)):
        with Deterministic():
            single, _, single_s = _counted(
                lambda: evaluate(est, iter(batches)))
            res, counts, seconds = _counted(
                lambda: evaluate(est, iter(batches), mesh=mesh))
        want = {**B2_NONE, "soft_argmax": b1 * PARALLEL_EVAL_BATCHES}
        check(counts == want, f"sharded_eval {name}: launched {counts}, "
              f"expected {want}")
        check(mesh.size() > 1 or res == single,
              f"sharded_eval {name}: {res} vs {single}")
        out[name] = {"result": {k: v for k, v in res.items()
                                if not isinstance(v, dict)},
                     "equal": res == single, "seconds": seconds,
                     "single_seconds": single_s,
                     "b1_per_batch": counts["soft_argmax"]
                     / PARALLEL_EVAL_BATCHES}
        launches[name] = counts
    emit({"phase": "sharded_eval", "world_size": mesh.size(),
          "batch": MAIN_BATCH, "batches": PARALLEL_EVAL_BATCHES,
          "deterministic": True, **out})
    return launches


def phase_dp_train_step(mesh) -> dict:
    """``make_train_step(mesh=)`` against the single-device step at full
    width on one synthetic batch of DP_BATCH, DP_STEPS steps each from the
    same initial state (the CLI's schedule): the first step's loss within
    1e-5, the largest parameter difference after the steps within
    DP_PARAM_ATOL, seconds per step with and without the mesh, no kernel
    of the port launched; and the gradients' ``all_reduce``
    (``mesh.pmean``) timed alone with its bytes."""
    from tpu_pose_torch.parallel import mesh as mesh_lib
    model = smpl_data_lib.synthetic_smpl(seed=0, device="cpu")
    batch = next(synthetic.cpm_train_batches(model, DP_BATCH, 1, MAIN_CPM,
                                             seed=0))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(DEVICE)
             for k, v in batch.items()}
    runs = {}
    for label, m in (("single", None), ("mesh", mesh)):
        cpm, opt_state, opt = cpm_train.init_train_state(
            0, MAIN_CPM, lr=TRAIN_LR, total_steps=TRAIN_STEPS, device=DEVICE)
        if m is not None:
            mesh_lib.replicate(cpm, m)
        step = cpm_train.make_train_step(MAIN_CPM, opt, mesh=m)
        losses, seconds = [], []
        zero_counts()
        for _ in range(DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cpm, opt_state, loss = step(cpm, opt_state, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            losses.append(float(loss))
        check(read_counts() == dict.fromkeys(COUNTED, 0),
              f"dp_train_step {label}: launched {read_counts()}")
        check(all(np.isfinite(losses)), f"dp_train_step losses {losses}")
        runs[label] = (cpm, losses, seconds)
    (cpm_1, loss_1, s_1), (cpm_n, loss_n, s_n) = runs["single"], runs["mesh"]
    check(abs(loss_n[0] - loss_1[0]) <= LOSS_RTOL * abs(loss_1[0]),
          f"dp_train_step: first loss {loss_n[0]} vs {loss_1[0]}")
    with torch.no_grad():
        d_param = max(float((a - b).abs().max()) for a, b in
                      zip(cpm_1.parameters(), cpm_n.parameters()))
    check(d_param <= DP_PARAM_ATOL, f"dp_train_step: params {d_param} apart")
    grads = [torch.randn_like(p) for p in cpm_n.parameters()]
    allreduce_ms = eager_ms(lambda: mesh_lib.pmean(grads, mesh), reps=20)
    emit({"phase": "dp_train_step", "world_size": mesh.size(),
          "batch": DP_BATCH, "steps": DP_STEPS, "loss_mesh": loss_n,
          "loss_single": loss_1, "max_param_diff": d_param,
          "s_per_step_mesh": statistics.median(s_n[1:]),
          "s_per_step_single": statistics.median(s_1[1:]),
          "grad_all_reduce_ms": allreduce_ms,
          "grad_all_reduce_bytes": _bytes(grads) + 4})
    return dict.fromkeys(COUNTED, 0)


def phase_sharded_export(est: PoseEstimator, mesh,
                         images: np.ndarray) -> dict:
    """``export_estimator(fn="estimate_2d", batch=MAIN_BATCH,
    n_devices=world)``, loaded and run against the live
    ``sharded_2d_fn`` on the same frames: export and load seconds, the
    recorded sharding, B1 per artifact call as ``sharded_b1_launches``,
    joints within tests/test_export.py's sharded bound."""
    from tpu_pose_torch.parallel import eval as peval
    path = os.path.join(PARALLEL_OUT, "estimate_2d_dp")
    t0 = time.perf_counter()
    meta = export_lib.export_estimator(est, path, fn="estimate_2d",
                                       batch=len(images),
                                       n_devices=mesh.size())
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prog = export_lib.load(path)
    load_s = time.perf_counter() - t0
    check(meta["sharding"] == {"n_devices": mesh.size(), "axis": "data"},
          f"sharded_export: sharding {meta['sharding']}")
    live = peval.sharded_2d_fn(est, mesh)(images)
    prog(images)
    out, counts, seconds = _counted(lambda: prog(images))
    b1 = sharded_b1_launches(len(images), mesh.size(), 0)
    check(counts == {**B2_NONE, "soft_argmax": b1},
          f"sharded_export: launched {counts}, expected {b1} B1")
    d_joints = float(np.abs(out["joints2d"]
                            - live.joints2d.cpu().numpy()).max())
    check(d_joints <= ARTIFACT_JOINTS_ATOL,
          f"sharded_export: joints2d {d_joints} px from the live call")
    emit({"phase": "sharded_export", "world_size": mesh.size(),
          "batch": len(images), "export_s": export_s, "load_s": load_s,
          "s_per_call": seconds, "b1_per_call": counts["soft_argmax"],
          "max_d_joints2d_px": d_joints, "sharding": meta["sharding"]})
    return counts


def phase_sharded_video(est: PoseEstimator, mesh,
                        frames: np.ndarray) -> dict:
    """The frame-sharded ``estimate_and_fit_video(mode="smooth",
    mesh=)`` (``est`` with VIDEO_RESTARTS hypotheses, 100 refine steps)
    against the live unsharded call on the same VIDEO_T frames: seconds
    per call of each (a warm-up of each, then two calls each in turns),
    B1 launches per call on this rank (one: the rank's frames in one
    decode), the collectives per call by kind against
    ``video_collectives``; under ``Deterministic`` the sharded call equals
    the live one in every output field when the world is one rank. Then
    the temporal and independent modes once each on the first
    SHARDED_VIDEO_MODES_T frames, under ``Deterministic``, against their
    live calls in the same way."""
    def call(clip, mode, sharded):
        return lambda: est.estimate_and_fit_video(
            clip, mode, mesh=mesh if sharded else None)

    live_call, sharded_call = (call(frames, "smooth", s) for s in (0, 1))
    first = live_call()
    sharded_call()
    live_s, sharded_s = [], []
    for _ in range(2):
        live, live_counts, s = _counted(live_call)
        live_s.append(s)
        res, counts, s, collectives = _collectives_of(sharded_call)
        sharded_s.append(s)
    check_result(res, len(frames))
    one_b1 = {**B2_NONE, "soft_argmax": 1}
    check(counts == live_counts == one_b1,
          f"sharded_video: launched {counts}, live {live_counts}")
    want = video_collectives("smooth", restarts=est.fit_restarts)
    _check_collectives(collectives, want, "sharded_video")
    with Deterministic():
        exact = _max_gap(sharded_call(), live_call())
    if mesh.size() == 1:
        check(max(exact.values()) == 0.0,
              f"sharded_video: deterministic gaps {exact}")
    modes = {}
    for mode in ("temporal", "independent"):
        clip = frames[:SHARDED_VIDEO_MODES_T]
        with Deterministic():
            want_res, _, mode_live_s = _counted(call(clip, mode, False))
            got, mode_counts, mode_s, mode_coll = _collectives_of(
                call(clip, mode, True))
        check_result(got, len(clip))
        gap = _max_gap(got, want_res)
        check(mesh.size() > 1 or max(gap.values()) == 0.0,
              f"sharded_video {mode}: deterministic gaps {gap}")
        check(mode_counts == one_b1,
              f"sharded_video {mode}: launched {mode_counts}")
        _check_collectives(mode_coll, video_collectives(mode),
                           f"sharded_video {mode}")
        modes[mode] = {"frames": len(clip), "s": mode_s,
                       "live_s": mode_live_s, "collectives": mode_coll,
                       "deterministic_max_gap": gap}
    emit({"phase": "sharded_video", "world_size": mesh.size(),
          "frames": len(frames), "restarts": est.fit_restarts,
          "refine_steps": 100, "s_per_call": sharded_s,
          "live_s_per_call": live_s, "b1_per_call": counts["soft_argmax"],
          "collectives_per_call": collectives,
          "collectives_expected": want,
          "max_d_theta": _max_gap(res, live)["theta"],
          "live_vs_live_max_d_theta": _max_gap(first, live)["theta"],
          "deterministic_max_gap": exact, "modes": modes})
    return counts


def phase_sharded_video_export(est: PoseEstimator, mesh,
                               frames: np.ndarray) -> dict:
    """``export_estimator(fn="estimate_and_fit_video", mode="smooth",
    batch=T, n_devices=world)``: the per-rank program, its halo exchanges
    and β sums inside its replayed Adam scan; loaded and run against the
    live frame-sharded call on the same frames (``est`` an
    :func:`export_estimator_of` with VIDEO_RESTARTS hypotheses, as
    ``phase_export_video_symbolic``'s): export, save, load and call
    seconds, the recorded sharding, B1 once per call on each side, θ and
    joints3d within that phase's bounds (section 8's rule)."""
    path = os.path.join(PARALLEL_OUT, "video_smooth_dp")
    meta, export_s, save_s, mb = _export_timed(
        lambda p: export_lib.export_estimator(
            est, p, fn="estimate_and_fit_video", batch=len(frames),
            n_devices=mesh.size(), mode="smooth"), path)
    t0 = time.perf_counter()
    prog = export_lib.load(path)
    load_s = time.perf_counter() - t0
    check(meta["sharding"] == {"n_devices": mesh.size(), "axis": "data"},
          f"sharded_video_export: sharding {meta['sharding']}")
    live, live_l, live_s = _counted(
        lambda: est.estimate_and_fit_video(frames, "smooth", mesh=mesh))
    out, art_l, art_s = _counted(lambda: prog(frames))
    gap = _artifact_gap(out, live)
    check(gap["max_d_theta"] < ARTIFACT_THETA
          and gap["joints3d_mpjpe_mm"] <= ARTIFACT_MPJPE_MM,
          f"sharded_video_export: artifact vs live {gap}")
    check(art_l == live_l == {**B2_NONE, "soft_argmax": 1},
          f"sharded_video_export: launched {art_l}, live {live_l}")
    emit({"phase": "sharded_video_export", "world_size": mesh.size(),
          "frames": len(frames), "restarts": est.fit_restarts,
          "export_s": export_s, "save_s": save_s, "load_s": load_s,
          "program_mb": mb, "s_per_call": art_s, "live_s_per_call": live_s,
          "b1_per_call": art_l["soft_argmax"],
          "sharding": meta["sharding"], **gap})
    return art_l


def phase_parallel_cli() -> dict:
    """The train CLI under the launcher, as a user runs it (``torchrun
    --standalone --nproc_per_node 1 -m tpu_pose_torch.tools.train_cpm``
    with PARALLEL_CLI_ARGS, through ``python -m torch.distributed.run``),
    then ``tools/multiprocess_smoke`` with one rank on the card: both
    exit 0, the CLI with a finite final loss, the smoke with its OK."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "tpu_pose_torch.tools.train_cpm",
         *PARALLEL_CLI_ARGS, "--device", DEVICE], cwd=root,
        capture_output=True, text=True, timeout=PARALLEL_TIMEOUT_S)
    cli_s = time.perf_counter() - t0
    done = [ln for ln in cli.stdout.splitlines() if ln.startswith("done:")]
    check(cli.returncode == 0 and len(done) == 1,
          f"train_cpm under torchrun exited {cli.returncode}: "
          f"{cli.stderr[-2000:]}")
    final = float(done[0].rsplit(" ", 1)[1])
    check(np.isfinite(final), f"train_cpm final loss {final}")
    t0 = time.perf_counter()
    smoke = subprocess.run(
        [sys.executable, "-m", "tpu_pose_torch.tools.multiprocess_smoke",
         "--nproc", "1", "--device", torch.device(DEVICE).type], cwd=root,
        capture_output=True, text=True, timeout=PARALLEL_TIMEOUT_S)
    smoke_s = time.perf_counter() - t0
    check(smoke.returncode == 0
          and "multiprocess_smoke: OK" in smoke.stdout,
          f"multiprocess_smoke exited {smoke.returncode}: "
          f"{smoke.stdout[-1000:]} {smoke.stderr[-1000:]}")
    report = json.loads(smoke.stdout.strip().splitlines()[-2])
    emit({"phase": "parallel_cli", "train_cli_s": cli_s,
          "train_cli_final_loss": final, "train_cli_args": PARALLEL_CLI_ARGS,
          "multiprocess_smoke_s": smoke_s,
          "multiprocess_smoke": {k: report[k] for k in
                                 ("reference_loss", "ok")},
          "backend": report["ranks"][0]["backend"]})
    return dict.fromkeys(COUNTED, 0)


def phase_parallel_main_path(timed_flag: str | None = None,
                             go_flag: str | None = None) -> dict:
    """The data-parallel phases in this process's own world (a mesh over
    every rank: one card over NCCL when the script runs alone): the
    sharded main path and the DP train step, whose seconds are compared
    with the live call's and the single step's; then ``timed_flag`` is
    created (when given), so that the caller starts other work on the
    card only after those times were taken, and the process waits for
    ``go_flag`` (when given), so that the rest runs when the caller has
    room for it: the sharded evaluators, the sharded artifact at full
    width, the train CLI under the launcher and the multi-process smoke.
    Runs in a process of its own
    (``phase_in_process``), so the process group ends with it; prints a
    ``parallel_phases`` line with each phase's launches."""
    from tpu_pose_torch.parallel import mesh as mesh_lib
    t0 = time.perf_counter()
    mesh = mesh_lib.make_mesh(device=torch.device(DEVICE).type)
    try:
        est = PoseEstimator.create_synthetic(seed=0, cpm_cfg=MAIN_CPM,
                                             device=DEVICE)
        size = MAIN_CPM.input_size
        images = _frames(MAIN_BATCH, size, size, seed=0)
        launches = {
            "sharded_main_path": phase_sharded_main_path(est, mesh, images),
            "dp_train_step": phase_dp_train_step(mesh)}
        if timed_flag:
            open(timed_flag, "w").close()
        if go_flag:
            wait_for_file(go_flag, DAY_ONE_TIMEOUT_S)
        launches["sharded_eval"] = phase_sharded_eval(est, mesh)
        launches["sharded_export"] = phase_sharded_export(est, mesh, images)
        est_v = PoseEstimator(est.cpm, est.smpl_model, est.prior, MAIN_CPM,
                              est.fit_cfg, fit_restarts=VIDEO_RESTARTS,
                              device=DEVICE)
        launches["sharded_video"] = phase_sharded_video(
            est_v, mesh, _frames(VIDEO_T, size, size, seed=5))
        launches["sharded_video_export"] = phase_sharded_video_export(
            PoseEstimator(est.cpm, est.smpl_model, est.prior, MAIN_CPM,
                          EXPORT_FIT, fit_restarts=VIDEO_RESTARTS,
                          device=DEVICE), mesh,
            _frames(VIDEO_SYMBOLIC_T[0], size, size, seed=67))
        launches["parallel_cli"] = phase_parallel_cli()
        backend = torch.distributed.get_backend()
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(PARALLEL_OUT, ignore_errors=True)
    line = {"phase": "parallel_phases", "world_size": mesh.size(),
            "backend": backend, "launches": launches,
            "seconds": time.perf_counter() - t0}
    emit(line)
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    replay = phase_graph_replay()
    err = phase_soft_argmax_check()
    timing = phase_soft_argmax_timing(replay)
    q_err = phase_quantize_act_check()
    q_timing = phase_quantize_act_timing(replay)
    g_err = phase_quantize_im2col_check()
    g_timing = phase_quantize_im2col_timing(replay)
    phase_native_letterbox_check()

    t0 = time.perf_counter()
    est = PoseEstimator.create_synthetic(seed=0, cpm_cfg=MAIN_CPM,
                                         device=DEVICE)
    emit({"phase": "create", "seconds": time.perf_counter() - t0,
          "cpm_params": sum(p.numel() for p in est.cpm.parameters())})
    size = MAIN_CPM.input_size
    images = _frames(MAIN_BATCH, size, size, seed=0)
    res, launches = phase_main_path(est, images)
    phase_custom_op_overhead()
    # First, as the process's first exports: torch.export's first use
    # imports and sets up its machinery once.
    phase_export_small_reference()
    art_main, xp_launches = phase_export_main_path(est, images)
    sa_launches = phase_serving_artifact(art_main)
    del art_main
    est_x = export_estimator_of(est)
    xf_launches = phase_export_fit_smpl(est_x)
    xm_launches = phase_export_multi(
        est_x, two_people_frames(MAIN_BATCH, size, size, seed=64))
    del est_x
    phase_breakdown(est, images)
    phase_profile(est, images)
    phase_plain_decode(est, images, res)
    phase_small_reference()
    phase_fit_recovery(est)
    x_launches = phase_fit_extras_main_path(est, images)
    m_launches = phase_multi_main_path(
        est, two_people_frames(MAIN_BATCH, size, size, seed=7))
    s_launches = phase_serving_main_path(est)
    sf_launches = phase_serving_fit(est)
    sm_launches = phase_serving_multi(est)

    t0 = time.perf_counter()
    est8 = PoseEstimator.create_synthetic(
        seed=0, cpm_cfg=MAIN_CPM, quantize=True,
        calibration_images=_frames(8, size, size, seed=1),
        cpm_microbatch=INT8_CHUNK, device=DEVICE)
    per_chunk = int8_launches(est8.cpm, MAIN_CPM, INT8_CHUNK, False)
    emit({"phase": "create_int8", "seconds": time.perf_counter() - t0,
          "conv_layers": len(list(est8.cpm.children())),
          "b2_launches_per_chunk": per_chunk,
          "int8_min_batch": est8.int8_min_batch,
          "cpm_microbatch": est8.cpm_microbatch})
    images8 = _frames(INT8_BATCH, size, size, seed=2)
    runs = INT8_BATCH // INT8_CHUNK * 4            # chunks × calls
    _, launches8 = phase_main_path(
        est8, images8, "int8_main_path",
        {k: n * runs for k, n in per_chunk.items()})
    x8_launches = phase_export_int8(export_estimator_of(est8), images8,
                                    per_chunk)
    phase_int8_dynamic(images8[:INT8_CHUNK])
    phase_int8_small_batch(est8, images8[:MAIN_BATCH])
    phase_int8_breakdown(est8, images8[:INT8_CHUNK])
    phase_int8_small_reference()
    mi_launches = phase_multi_int8(
        est8, two_people_frames(INT8_CHUNK, size, size, seed=11))
    si_launches = phase_serving_int8(est8, per_chunk)

    t0 = time.perf_counter()
    est_fe = PoseEstimator.create_synthetic(seed=0, cpm_cfg=MAIN_CPM,
                                            device=DEVICE, **FRONT_END)
    emit({"phase": "create_front_end", "seconds": time.perf_counter() - t0})
    frames_fe = _frames(MAIN_BATCH, *FRONT_END_HW, seed=4)
    fe_launches = phase_front_end_main_path(est_fe, frames_fe)
    phase_front_end_breakdown(est_fe, frames_fe)
    est_mfe = PoseEstimator(est_fe.cpm, est_fe.smpl_model, est_fe.prior,
                            MAIN_CPM, est_fe.fit_cfg, device=DEVICE,
                            **MULTI_FRONT_END)
    mfe_launches = phase_multi_main_path(
        est_mfe, two_people_frames(MAIN_BATCH, *FRONT_END_HW, seed=8),
        "multi_front_end", MULTI_FRONT_END_PEOPLE, crop=True,
        flip_tta=True)
    del est_fe, est_mfe

    est_v = PoseEstimator.create_synthetic(seed=0, cpm_cfg=MAIN_CPM,
                                           device=DEVICE,
                                           fit_restarts=VIDEO_RESTARTS)
    video = _frames(VIDEO_T, size, size, seed=5)
    v_launches = phase_video_main_path(est_v, video)
    phase_video_modes(est_v, video)
    phase_video_stream(est_v, _frames(STREAM_T, size, size, seed=6))
    video_m = two_people_frames(VIDEO_MULTI_T, size, size, seed=9)
    vm_launches = phase_video_multi_main_path(est_v, video_m)
    vk_launches = phase_video_multi_knobs(est_v,
                                          video_m[:VIDEO_MULTI_KNOBS_T])
    vs_launches = phase_video_multi_stream(
        est_v, two_people_frames(STREAM_T, size, size, seed=10))
    del est_v

    est8v = PoseEstimator.create_synthetic(
        seed=0, cpm_cfg=MAIN_CPM, quantize=True,
        calibration_images=_frames(8, size, size, seed=1),
        cpm_microbatch=INT8_CHUNK, refine_scale=True,
        fit_restarts=VIDEO_RESTARTS, device=DEVICE)
    v8_launches = phase_video_int8(est8v, video)
    del est8v
    phase_front_end_small_reference()
    phase_video_small_reference()
    phase_multi_small_reference()
    phase_fit_extras_small_reference()

    cpm_t, opt_state, opt, batch, t_launches = phase_train_main_path()
    est_qat8 = phase_train_qat_and_resume(cpm_t, opt_state, opt, batch)
    del cpm_t, opt_state, opt, batch
    e_launches = phase_eval_main_path(est, est_qat8, per_chunk)
    del est_qat8
    phase_train_eval_small_reference()

    # From here three host-bound pieces run in processes of their own: the
    # data-parallel phases (their process group, NCCL over the one card,
    # ends with their process), and, beside the hard-set phases and the
    # sweep, the day-one CLI (eager L-BFGS fits with host reads, the
    # oracle's scipy loop) as a user runs it and the streaming exports
    # (tracing, 300 MB saves and loads). The data-parallel phases that
    # compare seconds per call run first, with nothing else on the card
    # or the host; the rest of them beside the sweep.
    t0 = time.perf_counter()
    flag_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    timed_flag, go_flag = (os.path.join(flag_dir, n) for n in ("timed",
                                                               "go"))
    parallel = phase_in_process(
        f"phase_parallel_main_path({timed_flag!r}, {go_flag!r})")
    day_one = streams = export_new = None
    try:
        wait_for_file(timed_flag, PARALLEL_TIMEOUT_S, parallel)
        emit({"phase": "parallel_timed_phases",
              "seconds": time.perf_counter() - t0})
        day_one = phase_in_process("phase_day_one_main_path()")
        streams = phase_in_process("phase_export_streams()")
        export_new = phase_in_process("phase_export_new_paths()")
        phase_hard_data_check()
        hard_npz, sc_launches = phase_selfcheck_main_path()
        tb_launches = phase_track_bench_main_path(hard_npz)
        hs_launches = phase_hard_sweep_main_path()
        tl_launches = phase_tools_main_path()
        phase_hard_small_reference()
        shutil.rmtree(SC_OUT, ignore_errors=True)
        shutil.rmtree(EXPORT_OUT, ignore_errors=True)
        emit({"phase": "hard_set_phases",
              "seconds": time.perf_counter() - t0})
        phase_tf_converter_check()
        open(go_flag, "w").close()
        ps_launches = phase_parity_sweep_main_path()
        par = finish_process(parallel, "parallel_phases",
                             PARALLEL_TIMEOUT_S)["launches"]
        xs_launches = finish_process(streams, "export_streams",
                                     PARALLEL_TIMEOUT_S)["launches"]
        xn_launches = finish_process(export_new, "export_new_paths",
                                     PARALLEL_TIMEOUT_S)["launches"]
        d1_launches = finish_process(day_one, "day_one_main_path",
                                     DAY_ONE_TIMEOUT_S)["launches"]
    finally:
        for proc in (parallel, day_one, streams, export_new):
            if proc is not None:
                stop_process(proc)
        shutil.rmtree(flag_dir, ignore_errors=True)
    emit({"phase": "hard_set_and_parity_phases",
          "seconds": time.perf_counter() - t0})
    sc_total = _sum_counts(sc_launches.values())
    sc8 = sc_launches["hard_rc_int8_calibrated"]
    pe8 = tl_launches["profile_estimate_2d_int8"]

    q_row = q_timing[QUANT_KERNEL_ROW]
    g_row = g_timing[IM2COL_KERNEL_ROW]
    sa_row = timing["nhwc", MAIN_BATCH]
    sa_nchw = timing["nchw_view", MAIN_BATCH]
    emit({"kernels": [{
        "name": "soft_argmax", "route": "cuda",
        "source": "tpu_pose_torch/csrc/soft_argmax.cu",
        "replaces": "tpu_pose/ops/pallas_kernels.py:57",
        "launches": launches["soft_argmax"],
        "launches_int8_path": launches8["soft_argmax"],
        "launches_front_end_path": fe_launches["soft_argmax"],
        "launches_video_path": v_launches["soft_argmax"],
        "launches_video_int8_path": v8_launches["soft_argmax"],
        "launches_multi_path": m_launches["soft_argmax"],
        "launches_multi_front_end_path": mfe_launches["soft_argmax"],
        "launches_multi_int8_path": mi_launches["soft_argmax"],
        "launches_video_multi_path": vm_launches["soft_argmax"],
        "launches_video_multi_knobs_path": vk_launches["soft_argmax"],
        "launches_video_multi_stream_path": vs_launches["soft_argmax"],
        "launches_fit_extras_path": x_launches["soft_argmax"],
        "launches_serving_path": s_launches["soft_argmax"],
        "launches_serving_int8_path": si_launches["soft_argmax"],
        "launches_serving_multi_path": sm_launches["soft_argmax"],
        "launches_serving_fit_path": sf_launches["soft_argmax"],
        "launches_train_path": t_launches["soft_argmax"],
        "launches_eval_h36m_path": e_launches["h36m"]["soft_argmax"],
        "launches_eval_pckh_path": e_launches["pckh"]["soft_argmax"],
        "launches_eval_oks_path": e_launches["oks"]["soft_argmax"],
        "launches_eval_int8_path": e_launches["pckh_int8"]["soft_argmax"],
        "launches_selfcheck_path": sc_total["soft_argmax"],
        "launches_selfcheck_int8_rung": sc8["soft_argmax"],
        "launches_track_bench_path": _sum_counts(
            tb_launches.values())["soft_argmax"],
        "launches_hard_sweep_path": hs_launches["soft_argmax"],
        "launches_demo_path": tl_launches["demo"]["soft_argmax"],
        "launches_demo_multi_path": tl_launches["demo_multi"]["soft_argmax"],
        "launches_profile_entry_path": tl_launches[
            "profile_estimate_and_fit"]["soft_argmax"],
        "launches_profile_entry_int8_path": pe8["soft_argmax"],
        "launches_export_main_path": xp_launches["soft_argmax"],
        "launches_export_int8_path": x8_launches["soft_argmax"],
        "launches_export_multi_path": xm_launches["soft_argmax"],
        "launches_export_video_stream_path": xs_launches["video_stream"][
            "soft_argmax"],
        "launches_export_video_multi_stream_path": xs_launches[
            "video_multi_stream"]["soft_argmax"],
        "launches_export_fit_smpl_path": xf_launches["soft_argmax"],
        "launches_export_lbfgs_path": xn_launches["lbfgs"]["soft_argmax"],
        "launches_export_int8_symbolic_path": xn_launches["int8_symbolic"][
            "soft_argmax"],
        "launches_export_video_symbolic_path": xn_launches[
            "video_symbolic"]["soft_argmax"],
        "launches_serving_artifact_path": sa_launches["soft_argmax"],
        "launches_selfcheck_export_section": sc_launches["export_section"][
            "soft_argmax"],
        "launches_day_one_path": d1_launches["soft_argmax"],
        "launches_parity_sweep_path": ps_launches["soft_argmax"],
        "launches_sharded_main_path": par["sharded_main_path"][
            "soft_argmax"],
        "launches_sharded_eval_h36m_path": par["sharded_eval"]["h36m"][
            "soft_argmax"],
        "launches_sharded_eval_pckh_path": par["sharded_eval"]["pckh"][
            "soft_argmax"],
        "launches_sharded_export_path": par["sharded_export"][
            "soft_argmax"],
        "launches_sharded_video_path": par["sharded_video"]["soft_argmax"],
        "launches_sharded_video_export_path": par["sharded_video_export"][
            "soft_argmax"],
        "launches_dp_train_path": par["dp_train_step"]["soft_argmax"],
        "max_abs_err": err["max_abs_err"],
        "ms": sa_row["ms"], "plain_ms": sa_row["plain_ms"],
        "bound_ms": sa_row["bound_ms"], "bound_by": sa_row["bound_by"],
        "library_ms": None, "replay_ms": replay["cold_ms"],
        "batch": MAIN_BATCH, "layout": "nhwc",
        "nchw_view_ms": sa_nchw["ms"],
        "card": card}, {
        "name": "quantize_act", "route": "cuda",
        "source": "tpu_pose_torch/csrc/quantize_act.cu",
        "replaces": "tpu_pose/ops/pallas_kernels.py:119",
        "launches": launches8["quantize_act"],
        "launches_video_int8_path": v8_launches["quantize_act"],
        "launches_multi_int8_path": mi_launches["quantize_act"],
        "launches_serving_int8_path": si_launches["quantize_act"],
        "launches_eval_int8_path": e_launches["pckh_int8"]["quantize_act"],
        "launches_train_path": t_launches["quantize_act"],
        "launches_selfcheck_int8_rung": sc8["quantize_act"],
        "launches_profile_entry_int8_path": pe8["quantize_act"],
        "absmax_launches_profile_entry_int8_path": pe8[
            "quantize_act_absmax"],
        "launches_export_int8_path": x8_launches["quantize_act"],
        "launches_export_int8_symbolic_path": xn_launches["int8_symbolic"][
            "quantize_act"],
        "launches_selfcheck_path_other_sections": sc_total["quantize_act"]
        - sc8["quantize_act"],
        "launches_sharded_paths": _sum_counts(
            [par["sharded_main_path"], par["sharded_export"],
             par["sharded_video"], par["sharded_video_export"],
             *par["sharded_eval"].values()])["quantize_act"],
        "launches_dp_train_path": par["dp_train_step"]["quantize_act"],
        "max_abs_err": q_err["max_abs_err"],
        "ms": q_row["ms"], "plain_ms": q_row["plain_ms"],
        "bound_ms": q_row["bound_ms"], "bound_by": q_row["bound_by"],
        "library_ms": q_row["library_ms"], "replay_ms": replay["cold_ms"],
        "dynamic_ms": q_row["dynamic_ms"],
        "shape": list(QUANT_SHAPES[QUANT_KERNEL_ROW][0]),
        "batch": INT8_CHUNK, "card": card}, {
        "name": "quantize_im2col", "route": "cuda",
        "source": "tpu_pose_torch/csrc/quantize_act.cu",
        "replaces": "tpu_pose/ops/pallas_kernels.py:119",
        "launches": launches8["quantize_im2col"],
        "launches_video_int8_path": v8_launches["quantize_im2col"],
        "launches_multi_int8_path": mi_launches["quantize_im2col"],
        "launches_serving_int8_path": si_launches["quantize_im2col"],
        "launches_eval_int8_path": e_launches["pckh_int8"][
            "quantize_im2col"],
        "launches_train_path": t_launches["quantize_im2col"],
        "launches_selfcheck_int8_rung": sc8["quantize_im2col"],
        "launches_profile_entry_int8_path": pe8["quantize_im2col"],
        "launches_export_int8_path": x8_launches["quantize_im2col"],
        "launches_export_int8_symbolic_path": xn_launches["int8_symbolic"][
            "quantize_im2col"],
        "launches_sharded_paths": _sum_counts(
            [par["sharded_main_path"], par["sharded_export"],
             par["sharded_video"], par["sharded_video_export"],
             *par["sharded_eval"].values()])["quantize_im2col"],
        "launches_dp_train_path": par["dp_train_step"]["quantize_im2col"],
        "max_abs_err": g_err["max_abs_err"],
        "ms": g_row["ms"], "plain_ms": g_row["plain_ms"],
        "bound_ms": g_row["bound_ms"], "bound_by": g_row["bound_by"],
        "library_ms": None, "replay_ms": replay["cold_ms"],
        "unfused_route_ms": g_row["unfused_route_ms"],
        "shape": list(IM2COL_SHAPES[IM2COL_KERNEL_ROW][0]),
        "tile": g_row["tile"], "card": card}]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
