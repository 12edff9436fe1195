"""Deployment artifacts for the fused pipeline (port of
``tpu_pose/export.py``).

An artifact is a directory that runs one of the estimator's entry points
with no estimator, no model code and no checkpoint on the serving host:
``torch.export`` traces the entry point once into an ``ExportedProgram``
whose parameters and constants are the CPM weights, the SMPL model and
the prior, and ``torch.export.save`` writes it.

Artifact layout (a directory):

- ``meta.json``   — format version, exported function, platforms, input
  spec, output spec, decode impl, precision flags, estimator settings
  echo, the program's sha256. Human-readable contract of what the program
  computes.
- ``program.pt2`` — the saved ``torch.export.ExportedProgram``.

Five exportable functions (the serving entry points), as in the JAX
package: ``estimate_2d``, ``estimate_and_fit``,
``estimate_and_fit_multi``, ``estimate_and_fit_video`` (leading dim = T;
``mode`` smooth | temporal | independent) and ``fit_smpl`` ((joints2d,
conf) → SMPL fit + posed mesh). :func:`export_video_stream` and
:func:`export_video_multi_stream` write the two window programs of the
streaming sessions (``program_first.pt2``, ``program_anchored.pt2``),
run by :class:`ArtifactVideoSession`.

Batch dimension: ``batch=None`` (default) exports with a symbolic batch
(``torch.export.Dim("b")``): one artifact serves any batch, including the
serving layer's bucket ladder, and a video artifact any T ≥ 2. A static
int pins it (required with ``cpm_microbatch`` chunking, whose chunk loop
runs over the concrete batch). With a symbolic batch the int8 CPM tiles
its convs by fixed groups of images (``ops/quantize._int8_conv_grouped``).

How the fit exports: its loops become loops of the program, not
unrolled steps (``fitting/fit.FitExport``): an Adam stage is a ``scan``
over its steps, an L-BFGS stage a ``scan`` whose linesearch is a
``while_loop`` with the eager loop's exit, and the video fits' loops over
frames (the warm starts, the Viterbi selection) are scans. The traced
function runs twice: once eagerly on example inputs, recording each
stage's gradient graph, then inside ``torch.export``, where each stage
replays its graph in the body of its loop. The hand-written kernels are
``torch.library`` custom ops (``ops/cuda_kernels.py``), so the program
calls them as the live path does.

Device: a program is traced on one device (``platforms`` is the
estimator's device type, ``"cuda"`` or ``"cpu"``) and runs there; the JAX
package's cross-lowering has no counterpart. Process-global precision
flags (TF32) are not part of a traced graph, so ``meta.json`` records the
flags the program must run under and :class:`LoadedProgram` sets them
around each call.

Loading needs only this module's :func:`load`, which imports torch, json,
hashlib and the custom ops' registrations: ``prog = load(path); out =
prog(frames)`` returns numpy arrays.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import hashlib
import io
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

# The custom ops' registrations (and their plain versions): a loaded
# program calls them.
from tpu_pose_torch.ops import cuda_kernels  # noqa: F401
from tpu_pose_torch.utils import world

FORMAT_VERSION = 1
FUNCTIONS = ("estimate_2d", "estimate_and_fit", "estimate_and_fit_multi",
             "estimate_and_fit_video", "fit_smpl")
_META_NAME = "meta.json"
_PROGRAM_NAME = "program.pt2"
_PROGRAM_FIRST = "program_first.pt2"
_PROGRAM_ANCHORED = "program_anchored.pt2"
_PLATFORMS = ("cuda", "cpu")


def _resolve_decode_impl(cpm_cfg) -> str:
    """Pin ``decode_impl="auto"`` to the route the live path takes for it:
    B1's custom op (``"cuda"``), which launches the kernel on the GPU and
    runs the plain version on the CPU, so an artifact decodes as the live
    call does on either device. ``"torch"`` (the plain decode, traced
    inline) stays as it is."""
    return "cuda" if cpm_cfg.decode_impl == "auto" else cpm_cfg.decode_impl


def _platforms(est, platforms) -> tuple:
    """The artifact's platform: the estimator's device type. A program is
    traced on one device and runs on it, so anything else raises."""
    own = (est.device.type,)
    platforms = tuple(platforms) if platforms else own
    if platforms != own:
        raise ValueError(
            f"platforms={platforms!r}: a torch.export program is traced on "
            f"one device and runs there, and this estimator is on "
            f"{est.device.type!r}; build the estimator on the target device "
            f"(cross-lowering, as the JAX package does, is not supported: "
            f"ROADMAP.md §C)")
    if platforms[0] not in _PLATFORMS:
        raise ValueError(f"unsupported platform {platforms[0]!r}; expected "
                         f"one of {_PLATFORMS}")
    return platforms


def _estimator_for(est, decode_impl: str, params):
    """Shallow clone with the decode pinned and the precision policy fixed
    to ``params`` (the policy reads the batch, which may be symbolic)."""
    est2 = copy.copy(est)
    est2.cpm_cfg = dataclasses.replace(est.cpm_cfg, decode_impl=decode_impl)
    est2.cpm, est2.cpm_bf16 = params, None
    return est2


def _build_fn(est, fn_name: str, shards: Optional[tuple] = None,
              **fn_kwargs):
    """Dict-returning wrapper over the estimator's entry point (dicts, so a
    loaded program's outputs need no result types). ``shards``: (the
    replica group's registered name, its size) of a frame-sharded video
    program, which takes this rank's frames and its index in the group."""
    if fn_name == "estimate_2d":
        return lambda frames: est.estimate_2d(frames)._asdict()
    if fn_name == "estimate_and_fit":
        return lambda frames: est.estimate_and_fit(frames)._asdict()
    if fn_name == "estimate_and_fit_video":
        mode = fn_kwargs.get("mode", "smooth")
        if mode not in ("smooth", "temporal", "independent"):
            raise ValueError(f"unknown video mode: {mode!r}")
        if shards is not None:
            from tpu_pose_torch.parallel import mesh as mesh_lib
            return lambda frames, index: est._video(
                frames, mode, mesh_lib.FrameShard(*shards, index))._asdict()
        return lambda frames: est.estimate_and_fit_video(
            frames, mode=mode)._asdict()
    if fn_name == "estimate_and_fit_multi":
        kw = dict(max_people=2, min_person_score=0.05,
                  person_score_frac=0.4, dup_px=30.0)
        kw.update(fn_kwargs)
        return lambda frames: est.estimate_and_fit_multi(
            frames, **kw)._asdict()
    if fn_name == "fit_smpl":
        # Joints-only deployment (an external 2D detector feeds the fit):
        # joints2d in NETWORK-frame pixels (FitConfig.img_size), conf in
        # [0, 1]. The fused path's fit + mesh tail.
        def fn(joints2d, conf):
            res = est.fit_smpl(joints2d, conf,
                               restarts=max(est.fit_restarts, 1))
            vertices, joints3d = est._mesh(res)
            return {"theta": res.theta, "beta": res.beta, "cam": res.cam,
                    "vertices": vertices, "joints3d": joints3d,
                    "energy": res.energy}
        return fn
    raise ValueError(f"unknown fn {fn_name!r}; expected one of {FUNCTIONS}")


class _Program(torch.nn.Module):
    """The module ``torch.export`` traces: ``fn`` with the CPM registered
    as a submodule, so its weights are the program's parameters."""

    def __init__(self, fn, cpm, loops):
        super().__init__()
        self.cpm = cpm
        self._fn = fn
        self._loops = loops

    def forward(self, *args):
        from tpu_pose_torch.fitting import fit as fit_lib
        self._loops.restart()
        # The loops' bodies turn the cache back on (FitExport).
        with fit_lib.fake_tensor_cache(args, False):
            return self._fn(*args)


def _trace(fn, cpm, args: tuple, dynamic_shapes=None,
           size_oblivious: bool = False):
    """Export ``fn(*args)``: an eager run that records the fit loops'
    gradient graphs, then the export trace that replays them as loops
    (``fitting/fit.FitExport``). Returns (the ExportedProgram, the eager
    run's outputs, the precision flags the program must run under).
    ``size_oblivious``: trace under :func:`_size_oblivious`."""
    from tpu_pose_torch.fitting import fit as fit_lib
    from tpu_pose_torch.utils import device as device_lib
    # A static export's gradient graphs are traced on concrete shapes:
    # several times faster than with a symbolic batch.
    loops = fit_lib.FitExport(symbolic=dynamic_shapes is not None)
    module = _Program(fn, cpm, loops)
    exact = (device_lib.full_f32_matmul.entries,
             device_lib.full_f32_conv.entries)
    with loops.recording(), _gc_paused():
        eager = module(*args)
    with (loops.replaying_calls(), torch.no_grad(), _no_stack_traces(),
          _gc_paused(),
          _size_oblivious() if size_oblivious else contextlib.nullcontext()):
        program = torch.export.export(module, args,
                                      dynamic_shapes=dynamic_shapes,
                                      strict=False)
    loops.finish()
    # A flag that a precision scope turned off anywhere stays off for the
    # whole program: the graph cannot switch it mid-call.
    precision = {
        "matmul_allow_tf32": bool(
            torch.backends.cuda.matmul.allow_tf32
            and device_lib.full_f32_matmul.entries == exact[0]),
        "cudnn_allow_tf32": bool(
            torch.backends.cudnn.allow_tf32
            and device_lib.full_f32_conv.entries == exact[1])}
    return program, eager, precision


@contextlib.contextmanager
def _gc_paused():
    """Pause the cyclic garbage collector. Tracing, saving or loading a
    program makes millions of small objects, and each of the collector's
    full passes walks the whole heap of the process, so its cost grows
    with everything else the process holds. What became garbage
    meanwhile sits in the youngest generation, collected once at the
    end."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()
            gc.collect(0)


@contextlib.contextmanager
def _no_stack_traces():
    """Trace without a stack trace per node. The trace otherwise walks
    the Python stack at every node it adds, for metadata that only a
    reader of the graph uses: seconds of the main artifact's export. The
    tracers read a class attribute, which is pinned to False for the
    duration."""
    from torch.fx import proxy
    base = proxy.TracerBase
    prev = base.__dict__.get("record_stack_traces", False)
    base.record_stack_traces = property(lambda self: False,
                                        lambda self, value: None)
    try:
        yield
    finally:
        base.record_stack_traces = prev


def _size_oblivious():
    """Symbolic sizes taken as ≥ 2 without a guard where an op asks
    whether a size is 0 or 1 (``backed_size_oblivious``): a video's
    T − 1 frame pairs, or the int8 CPM's number of image groups, would
    otherwise be guarded ≠ 1 (ruling out T = 2, or batches past one
    group) or specialized to the example's 1. A program's ops still run
    on the real sizes."""
    from torch.fx.experimental import _config
    return _config.patch(backed_size_oblivious=True)


def _example_frames(est, b: int, h: int, w: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, 256, (b, h, w, 3)).astype(
        np.uint8)).to(est.device)


def _unfold_sym_sums(gm) -> None:
    """Rewrite each ``torch.sym_sum`` node of ``gm`` and of its subgraphs
    (a symbolic size's sum, which a replayed gradient graph can produce)
    as a chain of ``+``: the program serializer knows no ``sym_sum``."""
    import operator
    changed = False
    for node in list(gm.graph.nodes):
        if node.op == "get_attr" and isinstance(
                getattr(gm, node.target, None), torch.fx.GraphModule):
            _unfold_sym_sums(getattr(gm, node.target))
        if node.op != "call_function" or node.target is not torch.sym_sum:
            continue
        terms = list(node.args[0])
        acc, acc_val = terms[0], _meta_val(terms[0])
        with gm.graph.inserting_before(node):
            for term in terms[1:]:
                acc_val = acc_val + _meta_val(term)
                acc = gm.graph.call_function(operator.add, (acc, term))
                acc.meta["val"] = acc_val
        node.replace_all_uses_with(acc)
        gm.graph.erase_node(node)
        changed = True
    if changed:
        gm.recompile()


def _meta_val(arg):
    return arg.meta["val"] if isinstance(arg, torch.fx.Node) else arg


def _save(program, path: str, name: str) -> str:
    """Save ``program`` as ``path/name``; return its sha256."""
    _unfold_sym_sums(program.graph_module)
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, name)
    with _gc_paused():
        torch.export.save(program, target)
    with open(target, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _write_meta(path: str, meta: dict) -> None:
    with open(os.path.join(path, _META_NAME), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)


def export_estimator(est, path: str, fn: str = "estimate_and_fit",
                     batch: Optional[int] = None,
                     input_shape: Optional[tuple] = None,
                     platforms: Optional[Sequence[str]] = None,
                     params_batch_hint: int = 1,
                     n_devices: Optional[int] = None,
                     **fn_kwargs) -> dict:
    """Export one of the estimator's fused entry points as a standalone
    artifact directory at ``path``.

    Args:
      est: a ``PoseEstimator``; its refine/flip/letterbox settings are
        honored and recorded in the artifact metadata.
      fn: one of :data:`FUNCTIONS`.
      batch: static batch size, or None for a symbolic batch dimension
        (one artifact, any batch; for ``estimate_and_fit_video``, any
        T ≥ 2). Incompatible with ``cpm_microbatch``.
      input_shape: (H, W) of the input frames; defaults to the network
        input size. Frames are uint8 (B, H, W, 3).
      platforms: the estimator's device type (the default); any other
        raises, since a program runs on the device it was traced on.
      params_batch_hint: which side of the int8/float precision policy to
        bake when ``batch=None`` (a static ``batch`` overrides the hint).
      n_devices: None (default) exports a single-device program. An int
        exports a data-parallel artifact: the program is the per-rank one
        at ``batch / n_devices`` frames, and a loader in a world of at
        least ``n_devices`` ranks (``torch.distributed``) runs each rank's
        rows and gathers the outputs (``LoadedProgram``). Needs a static
        ``batch`` divisible by ``n_devices`` and a world of at least
        ``n_devices`` ranks. Every rank calls this; rank 0 writes, the
        others read its ``meta.json``. The per-frame functions' programs
        hold no collective, and rank 0 alone traces them. The video fits
        couple the frames, so a video program (``api._video``)
        holds its collectives (the gathered hypotheses, the refine's
        per-step halo exchange and β sum, over the replica group that
        ``utils/world.replica_group`` names, and takes the rank's index
        in it as a second input): ranks ``0 … n_devices − 1`` trace it
        together, their eager recording runs talking to each other.
      **fn_kwargs: static knobs of the multi-person path (``max_people``,
        ``min_person_score``, ...) and the video path's ``mode``.

    Returns the metadata dict that was written to ``meta.json``.
    """
    video = fn == "estimate_and_fit_video" and n_devices is not None
    if n_devices is None or (world.world_size() == 1 and not video):
        return _export_estimator(est, path, fn, batch, input_shape,
                                 platforms, params_batch_hint, n_devices,
                                 **fn_kwargs)
    _check_sharding(batch, n_devices)   # on every rank, before any talk
    shards = (world.replica_group(n_devices), n_devices) if video else None
    rank = torch.distributed.get_rank()
    error = None
    if rank < n_devices if video else rank == 0:
        try:
            meta = _export_estimator(est, path, fn, batch, input_shape,
                                     platforms, params_batch_hint,
                                     n_devices, shards=shards,
                                     save=rank == 0, **fn_kwargs)
        except Exception as e:
            error, failed = f"{type(e).__name__}: {e}", e
    errors = [None] * world.world_size()
    torch.distributed.all_gather_object(errors, error)
    if error is not None:
        raise failed
    for r, e in enumerate(errors):
        if e is not None:
            raise ValueError(f"rank {r}'s export failed: {e}")
    if rank != 0:
        with open(os.path.join(path, _META_NAME)) as f:
            meta = json.load(f)
    return meta


def _check_sharding(batch: Optional[int], n_devices: int) -> None:
    """The refusals of a sharded export."""
    if batch is None:
        raise ValueError("sharded export needs a static batch")
    if batch % n_devices:
        raise ValueError(
            f"batch {batch} not divisible by n_devices {n_devices}")
    if world.world_size() < n_devices:
        raise ValueError(
            f"need {n_devices} ranks to export the sharded program, "
            f"the world has {world.world_size()}")


def _export_estimator(est, path: str, fn: str = "estimate_and_fit",
                      batch: Optional[int] = None,
                      input_shape: Optional[tuple] = None,
                      platforms: Optional[Sequence[str]] = None,
                      params_batch_hint: int = 1,
                      n_devices: Optional[int] = None,
                      shards: Optional[tuple] = None, save: bool = True,
                      **fn_kwargs) -> dict:
    """The export itself, on this rank (see :func:`export_estimator`);
    ``shards``: a video program's (replica group name, size); ``save``:
    write the artifact (else trace only, for a video program's other
    ranks)."""
    if fn not in FUNCTIONS:
        raise ValueError(f"unknown fn {fn!r}; expected one of {FUNCTIONS}")
    if fn_kwargs and fn not in ("estimate_and_fit_multi",
                                "estimate_and_fit_video"):
        raise ValueError(
            f"{fn} takes no extra kwargs, got {sorted(fn_kwargs)}")
    if n_devices is not None:
        _check_sharding(batch, n_devices)
    if batch is None and est.cpm_microbatch:
        raise ValueError(
            "symbolic batch (batch=None) is incompatible with "
            "cpm_microbatch chunking — pass a static batch")
    platforms = _platforms(est, platforms)
    decode_impl = _resolve_decode_impl(est.cpm_cfg)
    params = est._params_for_batch(
        batch if batch is not None else params_batch_hint)
    quantized = _params_quantized(params)
    est2 = _estimator_for(est, decode_impl, params)

    h, w = input_shape or (est.cpm_cfg.input_size, est.cpm_cfg.input_size)
    b_meta = "b" if batch is None else int(batch)
    # The example a symbolic batch is traced on. A video's T − 1 frame
    # pairs must not be 1: a size-1 dimension specializes.
    b_ex = ((3 if fn == "estimate_and_fit_video" else 2) if batch is None
            else int(batch) // (n_devices or 1))
    if fn == "fit_smpl":
        p = est.cpm_cfg.num_joints
        rng = np.random.RandomState(0)
        size = est.fit_cfg.img_size
        args = (torch.from_numpy(rng.uniform(
                    0.25 * size, 0.75 * size, (b_ex, p, 2)).astype(
                    np.float32)).to(est.device),
                torch.from_numpy(rng.uniform(0.5, 1.0, (b_ex, p)).astype(
                    np.float32)).to(est.device))
        inputs_meta = [
            {"name": "joints2d", "shape": [b_meta, p, 2],
             "dtype": "float32"},
            {"name": "conf", "shape": [b_meta, p], "dtype": "float32"}]
    else:
        args = (_example_frames(est, b_ex, int(h), int(w)),)
        inputs_meta = [{"name": "frames",
                        "shape": [b_meta, int(h), int(w), 3],
                        "dtype": "uint8"}]
    if shards is not None:   # this rank's index, an input of the program
        args += (torch.tensor([torch.distributed.get_rank() % n_devices],
                              device=est.device),)
    dynamic = None
    oblivious = batch is None and (fn == "estimate_and_fit_video"
                                   or quantized)
    if batch is None:
        # Size-oblivious tracing does not take a batch of 0 as excluded.
        dim = torch.export.Dim("b", min=1 if oblivious else 0)
        dynamic = (tuple({0: dim} for _ in args),)   # forward(*args)
    program, _, precision = _trace(
        _build_fn(est2, fn, shards, **fn_kwargs), params, args, dynamic,
        size_oblivious=oblivious)
    if not save:
        return None

    meta = {
        "format_version": FORMAT_VERSION,
        "fn": fn,
        "fn_kwargs": fn_kwargs,
        "platforms": list(platforms),
        "decode_impl": decode_impl,
        # "input" mirrors inputs[0] (ServableProgram reads it); "inputs"
        # is authoritative.
        "input": {"shape": inputs_meta[0]["shape"],
                  "dtype": inputs_meta[0]["dtype"]},
        "inputs": inputs_meta,
        "sharding": (None if n_devices is None else
                     {"n_devices": int(n_devices), "axis": "data"}),
        "precision": precision,
        "outputs": _out_spec(program, b_meta if n_devices else None),
        "estimator": {
            "refine_center": bool(est.refine_center),
            "refine_scale": bool(est.refine_scale),
            "flip_tta": bool(est.flip_tta),
            # What the PROGRAM does: scale TTA runs only on the
            # single-person image front ends.
            "scale_tta": ([float(s) for s in est.scale_tta]
                          if fn in ("estimate_2d", "estimate_and_fit",
                                    "estimate_and_fit_video") else []),
            "letterbox": bool(est.letterbox),
            "fit_restarts": int(est.fit_restarts),
            "quantized_params": quantized,
        },
        "tpu_pose_version": _version(),
    }
    meta["program_sha256"] = _save(program, path, _PROGRAM_NAME)
    _write_meta(path, meta)
    return meta


def _out_spec(program, batch=None) -> dict:
    """Output name → {shape, dtype} from the program's output node; the
    symbolic batch prints as "b". ``batch``: the global batch a sharded
    program's per-rank leading dimension stands for."""
    from torch.utils import _pytree
    out_node = next(n for n in program.graph.nodes if n.op == "output")
    vals = [n.meta["val"] for n in out_node.args[0]]
    tree = _pytree.tree_unflatten(vals, program.call_spec.out_spec)
    names = {}
    for n in program.graph.nodes:
        if n.op == "placeholder" and n.name in (
                program.graph_signature.user_inputs):
            d0 = n.meta["val"].shape[0]
            if isinstance(d0, torch.SymInt):
                names[str(d0)] = "b"
    out = {name: {"shape": [names.get(str(d), str(d)) for d in v.shape],
                  "dtype": str(v.dtype).removeprefix("torch.")}
           for name, v in tree.items()}
    if batch is not None:
        for spec in out.values():
            spec["shape"][0] = str(batch)
    return out


def _params_quantized(params) -> bool:
    from tpu_pose_torch.models import cpm as cpm_lib
    return isinstance(params, cpm_lib.QuantizedCPM)


def _version() -> str:
    try:
        from importlib.metadata import version
        return version("tpu-pose")
    except Exception:  # not installed: a source checkout
        return "unknown"


@contextlib.contextmanager
def _precision(flags: Optional[dict]):
    """The TF32 flags a program was exported under, for the duration."""
    if not flags:
        yield
        return
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = flags["matmul_allow_tf32"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn_allow_tf32"]
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _device_of(meta: dict) -> torch.device:
    return torch.device(meta["platforms"][0])


class LoadedProgram:
    """A loaded deployment artifact: ``prog(frames)`` → dict of numpy
    arrays. Validates the input against the artifact's recorded spec and
    runs the program on its device, under its precision flags, without
    autograd.

    A sharded artifact (``meta["sharding"]``) needs a world of at least
    ``n_devices`` ranks; every rank calls it with the global batch, runs
    the rows of shard ``rank % n_devices`` and gathers the shards, so
    each rank returns the whole batch's outputs. A sharded video program
    also takes the shard's index, and its collectives run over the rank's
    replica group (``utils/world.replica_group``): the world must be a
    multiple of ``n_devices``, and every rank loads it together."""

    def __init__(self, program, meta: dict):
        self._module = program.module()
        self.meta = meta
        self.device = _device_of(meta)
        shard = meta.get("sharding")
        self._n_shards = int(shard["n_devices"]) if shard else 1
        if world.world_size() < self._n_shards:
            raise ValueError(
                f"artifact needs {self._n_shards} ranks "
                f"({shard['axis']}-sharded), the world has "
                f"{world.world_size()}")
        self._takes_index = bool(shard) and meta["fn"] == (
            "estimate_and_fit_video")
        if self._takes_index:
            world.replica_group(self._n_shards)

    @property
    def fn(self) -> str:
        return self.meta["fn"]

    @property
    def platforms(self) -> tuple:
        return tuple(self.meta["platforms"])

    def _input_specs(self) -> list:
        return self.meta.get(
            "inputs", [dict(self.meta["input"], name="frames")])

    def _validate(self, args) -> tuple:
        specs = self._input_specs()
        if len(args) != len(specs):
            raise ValueError(
                f"{self.fn} artifact takes {len(specs)} input(s) "
                f"({[s['name'] for s in specs]}), got {len(args)}")
        out = []
        for a, spec in zip(args, specs):
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.ascontiguousarray(a))
            want = spec["shape"]
            if a.dim() == len(want) - 1:   # single sample → batch of 1
                a = a[None]
            if a.dim() != len(want) or list(a.shape[1:]) != want[1:]:
                raise ValueError(
                    f"expected {spec['name']} (b, "
                    f"{', '.join(map(str, want[1:]))}), got "
                    f"{tuple(a.shape)}")
            if want[0] != "b" and a.shape[0] != want[0]:
                raise ValueError(
                    f"artifact was exported for static batch {want[0]}, "
                    f"got {a.shape[0]}")
            dtype = getattr(torch, spec["dtype"])
            if a.dtype != dtype:
                if dtype == torch.uint8:
                    a = torch.clamp(a, 0, 255)
                a = a.to(dtype)
            out.append(a.to(self.device))
        if len({a.shape[0] for a in out}) > 1:
            raise ValueError(
                f"inconsistent batch sizes: {[a.shape[0] for a in out]}")
        if self.fn == "estimate_and_fit_video" and out[0].shape[0] < 2:
            raise ValueError(
                f"a video artifact fits T >= 2 frames, got "
                f"{out[0].shape[0]}: fit a single frame with an "
                f"estimate_and_fit artifact")
        return tuple(out)

    def call_device(self, *args) -> dict:
        """Run WITHOUT the device→host sync: returns tensors on the
        program's device, so a caller pipelining transfers (the serving
        dispatcher) keeps the launches asynchronous."""
        args = self._validate(args)
        n = self._n_shards
        if n > 1 or self._takes_index:
            per = args[0].shape[0] // n
            s = torch.distributed.get_rank() % n
            args = tuple(a[s * per:(s + 1) * per] for a in args)
            if self._takes_index:
                args += (torch.tensor([s], device=self.device),)
        with _precision(self.meta.get("precision")), torch.no_grad():
            out = self._module(*args)
        if n > 1:
            out = {k: world.gather_rows(v, keep=n) for k, v in out.items()}
        return out

    def __call__(self, *args) -> dict:
        out = self.call_device(*args)
        return {k: v.cpu().numpy() for k, v in out.items()}


# Result-field axis split for window slicing — MUST mirror
# api._VIDEO_MULTI_T_FIRST / _VIDEO_MULTI_K_FIRST (tested for drift in
# tests/test_torch_export.py); duplicated so a deployment host importing
# only this module never pulls the model stack.
_VIDEO_T_FIRST = ("joints2d", "conf", "person_scores", "frame_mask",
                  "perm")
_VIDEO_K_FIRST = ("theta", "beta", "cam", "vertices", "joints3d",
                  "energy")


def _stream_meta(est, fn: str, fn_kwargs: dict, platforms, decode_impl,
                 chunk: int, carry_keys, carry: dict, program,
                 params, scale_tta) -> dict:
    size = est.cpm_cfg.input_size
    estimator = {
        "refine_scale": bool(est.refine_scale),
        "flip_tta": bool(est.flip_tta),
        "scale_tta": scale_tta,
        "letterbox": bool(est.letterbox),
        "fit_restarts": int(est.fit_restarts),
        "quantized_params": _params_quantized(params),
    }
    if fn == "video_stream":
        estimator["refine_center"] = bool(est.refine_center)
    return {
        "format_version": FORMAT_VERSION,
        "fn": fn,
        "fn_kwargs": fn_kwargs,
        "platforms": list(platforms),
        "decode_impl": decode_impl,
        "chunk": int(chunk),
        "carry_keys": list(carry_keys),
        "input": {"shape": [int(chunk), size, size, 3], "dtype": "uint8"},
        "carry": {k: {"shape": list(map(int, carry[k].shape)),
                      "dtype": str(carry[k].dtype).removeprefix("torch.")}
                  for k in carry_keys},
        "outputs": _out_spec(program),
        "estimator": estimator,
        "tpu_pose_version": _version(),
    }


def _export_stream(est, path: str, chunk: int, platforms, fn_name: str,
                   window, fn_kwargs: dict, scale_tta) -> dict:
    """The two window programs of a streaming session: ``window(frames,
    pad_mask, carry)`` returns the window's result dict plus its carry
    keys, with ``carry`` None for the first window."""
    platforms = _platforms(est, platforms)
    decode_impl = _resolve_decode_impl(est.cpm_cfg)
    params = est._params_for_batch(chunk)
    est2 = _estimator_for(est, decode_impl, params)
    size = est.cpm_cfg.input_size
    frames = _example_frames(est, chunk, size, size)
    pad_mask = torch.ones(chunk, device=est.device)

    def fn_first(frames, pad_mask):
        return window(est2, frames, pad_mask, None)

    first, out, precision = _trace(fn_first, params, (frames, pad_mask))
    carry_keys = tuple(k for k in out if k.startswith("carry_"))
    carry = tuple(out[k] for k in carry_keys)

    def fn_anchored(frames, pad_mask, *carry):
        return window(est2, frames, pad_mask, carry)

    anchored, _, precision2 = _trace(fn_anchored, params,
                                     (frames, pad_mask) + carry)
    meta = _stream_meta(est, fn_name, fn_kwargs, platforms, decode_impl,
                        chunk, carry_keys, out, first, params, scale_tta)
    meta["precision"] = {k: precision[k] and precision2[k]
                         for k in precision}
    meta["program_sha256"] = {
        _PROGRAM_FIRST: _save(first, path, _PROGRAM_FIRST),
        _PROGRAM_ANCHORED: _save(anchored, path, _PROGRAM_ANCHORED)}
    _write_meta(path, meta)
    return meta


def export_video_multi_stream(est, path: str, chunk: int = 64,
                              platforms: Optional[Sequence[str]] = None,
                              max_people: int = 2,
                              min_person_score: float = 0.05,
                              person_score_frac: float = 0.4,
                              dup_px: float = 30.0,
                              temporal_hints: bool = True,
                              hint_passes: int = 1,
                              hint_crop: bool = False,
                              track_reassociate: bool = False,
                              allow_empty: bool = False,
                              track_birth_cost: float = 0.05,
                              track_death_frames: int = 0,
                              track_anchor_refresh: float = 0.0,
                              presence_keep_frac: float = 1.0) -> dict:
    """Export the TRACKED STREAMING video pipeline: the two window programs
    :class:`api.MultiPersonVideoSession` runs (first window; anchored
    continuation carrying the tracker state and each track's last
    solution), so a deployment host runs identity-consistent multi-person
    video of any length from the artifact alone — see
    :class:`ArtifactVideoSession`.

    Artifact layout: ``meta.json`` + ``program_first.pt2`` +
    ``program_anchored.pt2``. Both programs take a ``chunk``-frame window
    (static — the session zero-pads the final partial window) and return
    the window result plus the flattened carry."""
    from torch.utils import _pytree
    fn_kwargs = {"max_people": max_people,
                 "min_person_score": min_person_score,
                 "person_score_frac": person_score_frac,
                 "dup_px": dup_px,
                 "temporal_hints": temporal_hints,
                 "hint_passes": hint_passes,
                 "hint_crop": hint_crop,
                 "track_reassociate": track_reassociate,
                 "allow_empty": allow_empty,
                 "track_birth_cost": track_birth_cost,
                 "track_death_frames": track_death_frames,
                 "track_anchor_refresh": track_anchor_refresh,
                 "presence_keep_frac": presence_keep_frac}
    # The association state is an opaque tuple of tensors (the Viterbi
    # carry); it is flattened into enumerated carry keys so the artifact
    # format does not depend on its structure.
    spec = {}

    def window(est2, frames, pad_mask, carry):
        state = anchors = None
        if carry is not None:
            n = spec["n_assoc"]
            state = _pytree.tree_unflatten(list(carry[:n]), spec["tree"])
            anchors = dict(zip(("theta", "beta", "cam"), carry[n:n + 3]))
            if presence_keep_frac < 1.0:
                anchors["presence"] = carry[n + 3]
        r, s, a = est2._video_multi(
            est2.cpm, frames, pad_mask=pad_mask, track_state=state,
            anchors=anchors, return_carry=True, **fn_kwargs)
        d = r._asdict()
        d.pop("track_mask")   # per-window; the session recomputes it
        leaves, spec["tree"] = _pytree.tree_flatten(s)
        spec["n_assoc"] = len(leaves)
        for i, leaf in enumerate(leaves):
            d[f"carry_assoc_{i}"] = leaf
        for k in ("theta", "beta", "cam", "presence"):
            if k in a:
                d[f"carry_{k}"] = a[k]
        return d

    return _export_stream(est, path, chunk, platforms, "video_multi_stream",
                          window, fn_kwargs, [])


def export_video_stream(est, path: str, chunk: int = 64,
                        platforms: Optional[Sequence[str]] = None
                        ) -> dict:
    """Export the SINGLE-PERSON streaming video pipeline — the two window
    programs :class:`api.VideoSession` runs (the 2D front end + the
    anchored joint smooth fit; the last solution carries as the next
    window's anchor). Same artifact layout as
    :func:`export_video_multi_stream`; run with
    :class:`ArtifactVideoSession`."""
    def window(est2, frames, pad_mask, carry):
        anchor = (None if carry is None
                  else dict(zip(("theta", "beta", "cam"), carry)))
        r, a = est2._video_window(est2.cpm, frames, pad_mask, anchor=anchor)
        d = r._asdict()
        for k in ("theta", "beta", "cam"):
            d[f"carry_{k}"] = a[k]
        return d

    return _export_stream(est, path, chunk, platforms, "video_stream",
                          window, {}, [float(s) for s in est.scale_tta])


class ArtifactVideoSession:
    """Online streaming video driven ENTIRELY from an artifact — the
    deployment twin of :class:`api.MultiPersonVideoSession` (for
    :func:`export_video_multi_stream` artifacts: tracked multi-person)
    or :class:`api.VideoSession` (for :func:`export_video_stream`
    artifacts: single-person anchored smooth fits). Same push/flush
    contract and window programs as the live sessions, with no model
    code and no weights on the host.

    ``push(frames)`` buffers host-side and runs one window program per
    full ``chunk``; returns a dict of numpy arrays covering the completed
    windows (time-first fields on axis 0, track-first on axis 1, plus
    ``track_mask`` over the emitted span) or None. ``flush()`` runs the
    final zero-padded partial window and closes the session. The carry
    stays on the device between windows.
    """

    def __init__(self, path: str):
        meta_path = os.path.join(path, _META_NAME)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(f"{path} is not an export artifact")
        with open(meta_path) as f:
            self.meta = json.load(f)
        if self.meta.get("fn") not in ("video_multi_stream",
                                       "video_stream"):
            raise ValueError(
                f"need a video_multi_stream or video_stream artifact, "
                f"got fn={self.meta.get('fn')!r}")
        if self.meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"artifact format {self.meta.get('format_version')} "
                f"!= supported {FORMAT_VERSION}")
        shas = self.meta.get("program_sha256") or {}
        files = [os.path.join(path, name)
                 for name in (_PROGRAM_FIRST, _PROGRAM_ANCHORED)]
        blobs = [_read_verified(f, shas.get(name)) for f, name in
                 zip(files, (_PROGRAM_FIRST, _PROGRAM_ANCHORED))]
        self._first, self._anchored = (_load_program(b).module()
                                       for b in blobs)
        self.device = _device_of(self.meta)
        self.chunk = int(self.meta["chunk"])
        self._hw = tuple(self.meta["input"]["shape"][1:3])
        self._carry_keys = tuple(self.meta["carry_keys"])
        if self.meta["fn"] == "video_stream":
            # Single-person results: every field is time-first.
            self._t_first = tuple(k for k in self.meta["outputs"]
                                  if k not in self._carry_keys)
            self._k_first = ()
        else:
            self._t_first = _VIDEO_T_FIRST
            self._k_first = _VIDEO_K_FIRST
        self._buf: list = []
        self._buffered = 0
        self._carry = None
        self._closed = False

    @property
    def frames_buffered(self) -> int:
        return self._buffered

    def _run_window(self, win: np.ndarray, n_real: int) -> dict:
        pad_mask = np.ones(self.chunk, np.float32)
        if n_real < self.chunk:
            pad = np.zeros((self.chunk - n_real,) + win.shape[1:],
                           win.dtype)
            win = np.concatenate([win, pad])
            pad_mask[n_real:] = 0.0
        # Contiguous, as the live session's frames are: the convs follow
        # the input's memory layout, and another layout rounds otherwise.
        args = (torch.from_numpy(np.ascontiguousarray(win)).to(self.device),
                torch.from_numpy(pad_mask).to(self.device))
        with _precision(self.meta.get("precision")), torch.no_grad():
            if self._carry is None:
                out = self._first(*args)
            else:
                out = self._anchored(*args, *self._carry)
        self._carry = tuple(out[k] for k in self._carry_keys)
        res = {k: v.cpu().numpy() for k, v in out.items()
               if k not in self._carry_keys}
        for k in self._t_first:
            res[k] = res[k][:n_real]
        for k in self._k_first:
            res[k] = res[k][:, :n_real]
        return res

    def _concat(self, outs: list) -> dict:
        res = outs[0] if len(outs) == 1 else {
            k: np.concatenate([o[k] for o in outs],
                              axis=0 if k in self._t_first else 1)
            for k in self._t_first + self._k_first}
        if "frame_mask" in res:
            res["track_mask"] = (
                res["frame_mask"].astype(np.float32).mean(axis=0) >= 0.5)
        return res

    def push(self, frames) -> Optional[dict]:
        if self._closed:
            raise RuntimeError("session already flushed")
        frames = np.asarray(frames)
        if frames.ndim == 3:
            frames = frames[None]
        if frames.shape[1:3] != self._hw or frames.shape[-1] != 3:
            raise ValueError(
                f"expected frames (n, {self._hw[0]}, {self._hw[1]}, 3), "
                f"got {frames.shape}")
        if frames.dtype != np.uint8:
            frames = np.clip(frames, 0, 255).astype(np.uint8)
        self._buf.append(frames)
        self._buffered += frames.shape[0]
        outs = []
        while self._buffered >= self.chunk:
            buf = (np.concatenate(self._buf)
                   if len(self._buf) > 1 else self._buf[0])
            win, rest = buf[:self.chunk], buf[self.chunk:]
            self._buf = [rest] if rest.shape[0] else []
            self._buffered -= self.chunk
            outs.append(self._run_window(win, self.chunk))
        return self._concat(outs) if outs else None

    def flush(self) -> Optional[dict]:
        if self._closed:
            raise RuntimeError("session already flushed")
        self._closed = True
        if self._buffered == 0:
            return None
        buf = (np.concatenate(self._buf)
               if len(self._buf) > 1 else self._buf[0])
        self._buf, self._buffered = [], 0
        return self._concat([self._run_window(buf, buf.shape[0])])


class ServableProgram:
    """Adapter: a fused-path artifact presented through the estimator
    interface :class:`serving.BatchingServer` consumes — so a serving
    host deploys from the artifact alone (no checkpoints, no model code).

    ``BatchingServer(ServableProgram("/srv/pose_artifact"))`` serves
    mixed-resolution traffic: the adapter exposes the artifact's network
    frame size for the server's submit-time letterbox and its device for
    the dispatcher, and the server's ``fields=`` selection validates
    against the artifact's recorded output spec. Use a SYMBOLIC-batch
    artifact (``batch=None`` at export) so every server bucket runs; a
    static-batch artifact requires ``buckets=(batch,)`` and
    ``max_batch=batch``.
    """

    def __init__(self, program):
        prog = load(program) if isinstance(program, str) else program
        if prog.fn not in ("estimate_and_fit",
                           "estimate_and_fit_multi", "fit_smpl"):
            raise ValueError(
                f"serving needs an estimate_and_fit, "
                f"estimate_and_fit_multi, or fit_smpl artifact, "
                f"got fn={prog.fn!r}")
        self.program = prog
        self.fn = prog.fn     # BatchingServer(fn=...) must match this
        self.device = prog.device
        self.result_fields = tuple(prog.meta["outputs"])
        shape = prog.meta["input"]["shape"]
        if prog.fn == "fit_smpl":
            # joints2d spec (b, P, 2): the server validates submit_fit
            # requests against this before co-batching them.
            self.num_joints = int(shape[1])
        self.symbolic_batch = shape[0] == "b"
        self.static_batch = None if self.symbolic_batch else shape[0]
        if shape[1] == shape[2]:
            import types
            self.cpm_cfg = types.SimpleNamespace(input_size=shape[1])

    def _call(self, *args) -> dict:
        # Tensors out (no host sync): the dispatcher copies them itself.
        return self.program.call_device(*args)

    # Every servable fn name resolves to the artifact's single program
    # (fit_smpl takes (joints2d, conf) per its two-input spec); the
    # server verifies its fn matches self.fn before dispatching.
    estimate_and_fit = _call
    estimate_and_fit_multi = _call
    fit_smpl = _call


def load(path: str) -> LoadedProgram:
    """Load an artifact directory written by :func:`export_estimator`.
    Needs no model code — just torch, the custom ops' registrations and
    the artifact. Verifies the program's sha256 against ``meta.json``
    (artifacts ship over networks; a truncated or bit-rotted program
    should fail loudly here, not as an opaque load error or wrong
    numerics)."""
    meta_path = os.path.join(path, _META_NAME)
    prog_path = os.path.join(path, _PROGRAM_NAME)
    if not (os.path.exists(meta_path) and os.path.exists(prog_path)):
        raise FileNotFoundError(
            f"{path} is not an export artifact "
            f"(need {_META_NAME} + {_PROGRAM_NAME})")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"artifact format {meta.get('format_version')} "
            f"!= supported {FORMAT_VERSION}")
    blob = _read_verified(prog_path, meta.get("program_sha256"))
    return LoadedProgram(_load_program(blob), meta)


def inspect_artifact(path: str) -> dict:
    """Summarize an artifact directory WITHOUT loading or running it:
    manifest essentials, per-program file sizes, and sha256 verification
    status — cheap enough for a registry scan or a deploy-time preflight
    (``tpu-pose-torch-export --inspect <dir>``)."""
    meta_path = os.path.join(path, _META_NAME)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"{path} is not an export artifact "
                                f"(no {_META_NAME})")
    with open(meta_path) as f:
        meta = json.load(f)
    recorded = meta.get("program_sha256")
    # Single artifacts: program.pt2 + one sha string; streaming-session
    # artifacts: {file name: sha} over their two window programs.
    names = (sorted(recorded) if isinstance(recorded, dict)
             else [_PROGRAM_NAME])
    programs, ok = {}, True
    for name in names:
        p = os.path.join(path, name)
        if not os.path.exists(p):
            programs[name] = {"bytes": None, "sha256_ok": False}
            ok = False
            continue
        with open(p, "rb") as f:
            blob = f.read()
        want = recorded[name] if isinstance(recorded, dict) else recorded
        good = (want is None
                or hashlib.sha256(blob).hexdigest() == want)
        programs[name] = {"bytes": len(blob), "sha256_ok": bool(good)}
        ok = ok and good
    return {
        "path": path,
        "ok": bool(ok and meta.get("format_version") == FORMAT_VERSION),
        "format_version": meta.get("format_version"),
        "fn": meta.get("fn"),
        "platforms": meta.get("platforms"),
        "sharding": meta.get("sharding"),
        "inputs": meta.get("inputs", [meta.get("input")]),
        "outputs": sorted(meta.get("outputs", {})),
        "estimator": meta.get("estimator"),
        "precision": meta.get("precision"),
        "chunk": meta.get("chunk"),
        "tpu_pose_version": meta.get("tpu_pose_version"),
        "programs": programs,
    }


@contextlib.contextmanager
def _cached_schema_type_hints():
    """``torch.export.load`` resolves the type hints of its schema
    dataclasses again for every field of every node it reads (tens of
    thousands of ``typing.get_type_hints`` calls for one fit program, half
    the load). The schema's types do not change, so the calls are cached
    for the duration. Where torch's deserializer is laid out otherwise, it
    runs as it is."""
    try:
        from torch._export.serde import serialize
    except ImportError:
        yield
        return
    real = getattr(serialize, "typing", None)
    if real is None or not hasattr(real, "get_type_hints"):
        yield
        return
    cache = {}

    def get_type_hints(cls, globalns=None, *args, **kw):
        key = (cls, id(globalns), args, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = real.get_type_hints(cls, globalns, *args, **kw)
        return cache[key]

    proxy = type("typing", (), {"__getattr__": lambda _, n: getattr(real, n),
                                "get_type_hints": staticmethod(
                                    get_type_hints)})()
    serialize.typing = proxy
    try:
        yield
    finally:
        serialize.typing = real


def _load_program(blob: bytes):
    with _cached_schema_type_hints(), _gc_paused():
        return torch.export.load(io.BytesIO(blob))


def _read_verified(prog_path: str, expect_sha: Optional[str]) -> bytes:
    with open(prog_path, "rb") as f:
        blob = f.read()
    if expect_sha is not None:
        got = hashlib.sha256(blob).hexdigest()
        if got != expect_sha:
            raise ValueError(
                f"artifact integrity check failed for {prog_path}: "
                f"sha256 {got} != recorded {expect_sha} "
                f"(corrupt or tampered program file)")
    return blob
