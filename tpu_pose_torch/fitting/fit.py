"""SMPLify-style fit as an eager batched loop (port of
``tpu_pose/fitting/fit.py``).

The staged schedule (camera first, then annealed joint optimization) is a
Python loop over ``FitConfig.stages``; each stage runs ``iters`` Adam
steps (or L-BFGS steps, ``fitting/lbfgs.py``) with fresh optimizer state
and a per-parameter-group mask. A batch of samples is fitted together:
one backward of ``energy.sum()`` gives each sample's own gradient,
because the samples are independent — the same per-sample updates as the
JAX package's ``vmap``.

Nothing inside the Adam loop reads a device value on the host, so on the
GPU it only queues kernels; the L-BFGS linesearch reads one flag per
iteration. Capturing the loops in CUDA graphs is later work (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from tpu_pose_torch.fitting import interpenetration as interp_lib
from tpu_pose_torch.fitting import lbfgs as lbfgs_lib
from tpu_pose_torch.fitting.energy import fit_energy, perspective_kwargs
from tpu_pose_torch.models import camera as camera_lib
from tpu_pose_torch.models import joints as joints_lib
from tpu_pose_torch.models import smpl as smpl_lib
from tpu_pose_torch.models.smpl_data import SMPLData
from tpu_pose_torch.utils.config import FitConfig, StageConfig
from tpu_pose_torch.utils.device import no_grad

# optax.adam's constants (b1, b2, eps, eps_root).
_B1, _B2, _EPS, _EPS_ROOT = 0.9, 0.999, 1e-8, 0.0


class FitResult(NamedTuple):
    theta: torch.Tensor           # (B, 72) fitted pose
    beta: torch.Tensor            # (B, 10) fitted shape
    cam: torch.Tensor             # (B, 3) fitted camera
    energy: torch.Tensor          # (B,) final energy value
    energy_history: torch.Tensor  # (B, total_iters) or (B, 0) if not kept


def _split(x: torch.Tensor, cfg: FitConfig) -> dict:
    """Flat (B, 72 + 10 + 3) parameters → {'theta', 'beta', 'cam'} views."""
    n_theta = cfg.num_joints_smpl * 3
    return {"theta": x[:, :n_theta],
            "beta": x[:, n_theta:n_theta + cfg.num_betas],
            "cam": x[:, n_theta + cfg.num_betas:]}


def _stage_mask(stage: StageConfig, cfg: FitConfig, device) -> torch.Tensor:
    """0/1 gradient mask over the flat parameters implementing the
    stage's parameter groups (global orientation, body pose, shape,
    camera)."""
    groups = ((3, stage.opt_global),
              (cfg.num_joints_smpl * 3 - 3, stage.opt_pose),
              (cfg.num_betas, stage.opt_shape),
              (3, stage.opt_cam))
    return torch.cat([torch.full((n,), 1.0 if on else 0.0, device=device)
                      for n, on in groups])


def _normalize_obs(joints2d, cfg: FitConfig):
    """Map pixel observations to [-1, 1] (see FitConfig.normalize_obs)."""
    if not cfg.normalize_obs:
        return joints2d
    half = cfg.img_size / 2.0
    return (joints2d - half) / half


def yaw_from_limb_order(model: SMPLData, joints2d_norm: torch.Tensor,
                        conf: torch.Tensor, cfg: FitConfig):
    """Closed-form global-yaw estimate from the 2D left/right limb ordering,
    batched: under a yaw ψ the rest-pose joint x projects as
    x·cosψ + z·sinψ, so the confidence-weighted correlation with the
    centered observed x is A·cosψ + B·sinψ, maximized at ψ* = atan2(B, A).

    Returns yaw (B,) radians and strength (B,) in [0, 1], the normalized
    correlation magnitude."""
    j14 = joints_lib.select_smpl_joints(model.joint_basis[0])  # (14, 3)
    w = conf / (conf.sum(-1, keepdim=True) + 1e-8)
    ox = joints2d_norm[..., 0]
    ox = ox - (w * ox).sum(-1, keepdim=True)
    x = j14[:, 0] - (w * j14[:, 0]).sum(-1, keepdim=True)
    z = j14[:, 2] - (w * j14[:, 2]).sum(-1, keepdim=True)
    a = (w * ox * x).sum(-1)
    b = (w * ox * z).sum(-1)
    mag = torch.sqrt(a * a + b * b)
    norm = (torch.sqrt((w * ox * ox).sum(-1))
            * torch.sqrt((w * (x * x + z * z)).sum(-1)) + 1e-8)
    return torch.atan2(b, a), mag / norm


def default_init(model: SMPLData, joints2d_norm: torch.Tensor,
                 conf: torch.Tensor, cfg: FitConfig) -> dict:
    """Initial parameters, batched: mean pose (plus the limb-order yaw
    unless ``cfg.yaw_init == "zero"``), zero shape, and the camera from
    the rest-pose extents heuristic."""
    n, device = joints2d_norm.shape[0], joints2d_norm.device
    theta0 = torch.zeros(n, cfg.num_joints_smpl * 3, device=device)
    j_rest14 = joints_lib.select_smpl_joints(model.joint_basis[0])
    j_rest14 = j_rest14.expand(n, *j_rest14.shape)
    if cfg.yaw_init == "limb_order":
        yaw, _ = yaw_from_limb_order(model, joints2d_norm, conf, cfg)
        theta0[:, 1] = yaw
        # The camera init must see the YAWED rest pose: the x-extent the
        # scale/depth heuristics match against changes with facing.
        c, s = torch.cos(yaw), torch.sin(yaw)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        rot = torch.stack([torch.stack([c, zero, s], -1),
                           torch.stack([zero, one, zero], -1),
                           torch.stack([-s, zero, c], -1)], -2)
        j_rest14 = j_rest14 @ rot.transpose(-1, -2)
    beta0 = torch.zeros(n, cfg.num_betas, device=device)
    if cfg.camera_model == camera_lib.WEAK_PERSPECTIVE:
        cam0 = camera_lib.init_weak_perspective(joints2d_norm, j_rest14, conf)
    else:
        cam0 = camera_lib.init_perspective(
            joints2d_norm, j_rest14,
            focal=perspective_kwargs(cfg)["focal"], conf=conf)
    return {"theta": theta0, "beta": beta0, "cam": cam0}


def _bias_corrections(iters: int) -> np.ndarray:
    """(iters, 2) float32 ``1 − b1^t``, ``1 − b2^t`` for t = 1..iters,
    optax's bias corrections, rounded to float32 as the loop uses them."""
    return np.array(
        [[np.float32(1) - np.power(np.float32(b), np.float32(t))
          for b in (_B1, _B2)] for t in range(1, iters + 1)],
        np.float32).reshape(iters, 2)


def _adam_grad_fn(energy_fn, n_x: int = 1):
    """``(*xs, *args) -> (*gradients of energy_fn(*xs, *args).sum(), the
    energies)`` over the first ``n_x`` inputs: what one Adam step
    evaluates."""
    def grad_fn(*inputs):
        xs = [t.detach().requires_grad_(True) for t in inputs[:n_x]]
        with torch.enable_grad():
            e = energy_fn(*xs, *inputs[n_x:])
            gs = torch.autograd.grad(e.sum(), xs)
        return (*gs, e.detach())
    return grad_fn


def _run_adam(energy_fn, x, iters: int, lr: float,
              mask: Optional[torch.Tensor] = None,
              keep_history: bool = False, args: tuple = (),
              exchange: Any = None):
    """``iters`` Adam steps on ``x`` from fresh state, with optax.adam's
    update in its order of operations: moments ``(1−b)·g + b·m``, bias
    correction ``1 − b^t`` in float32, update ``m̂ / (√(v̂ + eps_root) +
    eps) · (−lr)``. ``x`` is a tensor, or a tuple of tensors that Adam
    updates as it would their concatenation (it is elementwise); the
    gradient is of ``energy_fn(*x, *args).sum()``, masked (when ``mask``
    is given, for a single tensor) before the update. ``args`` holds
    every tensor the energy reads that is not a constant of the program
    (tensors, dicts, tuples and dataclasses of them): an export replays
    the energy's gradient graph on them (:class:`FitExport`). Returns
    (the new ``x``, the energies of each step when ``keep_history``).

    ``exchange`` (a frame-sharded fit, ``temporal.py``; a dataclass whose
    tensors an export passes into its loop body) talks to the other
    ranks at every step: ``exchange.halo(x)`` before the gradient, a
    tuple of tensors that the energy reads after ``x``
    (``energy_fn(*x, halo, *args)``), and ``exchange.reduce(gradients)``
    after it. Without it the steps are the ops above alone."""
    single = isinstance(x, torch.Tensor)
    xs = (x,) if single else tuple(x)
    grad_fn = _adam_grad_fn(energy_fn, len(xs))
    kind = ("adam", iters, float(lr), mask is not None, keep_history,
            exchange is not None)
    trace = _FIT_EXPORT.get()
    if trace is not None and trace.replaying:
        if exchange is not None:   # the body exchanges its own halo
            args = (exchange.halo_like(xs),) + tuple(args)
        xs, hist = trace.replay_adam(kind, xs, iters, lr, mask,
                                     keep_history, args, exchange)
        return (xs[0] if single else xs), hist
    xs0 = xs
    mus = [torch.zeros_like(t) for t in xs]
    nus = [torch.zeros_like(t) for t in xs]
    hist = []
    bcs = _bias_corrections(iters)
    halo0 = ()
    for t in range(iters):
        if exchange is None:
            *gs, e = grad_fn(*xs, *args)
        else:
            halo = exchange.halo(xs)
            halo0 = halo0 or (halo,)
            *gs, e = grad_fn(*xs, halo, *args)
            gs = exchange.reduce(gs)
        if keep_history:
            hist.append(e)
        with torch.no_grad():
            bc1, bc2 = float(bcs[t, 0]), float(bcs[t, 1])
            new = []
            for i, g in enumerate(gs):
                if mask is not None:
                    g = g * mask
                mus[i] = (1 - _B1) * g + _B1 * mus[i]
                nus[i] = (1 - _B2) * (g * g) + _B2 * nus[i]
                update = (mus[i] / bc1) / (torch.sqrt(nus[i] / bc2
                                                      + _EPS_ROOT) + _EPS)
                new.append(xs[i] + update * (-lr))
            xs = tuple(new)
    if trace is not None:
        if exchange is not None:
            args = (halo0 or (exchange.halo(xs0),)) + tuple(args)
        trace.record(kind, grad_fn, xs0, args,
                     _bias_table(iters, xs0[0].device))
    xs = tuple(t.detach() for t in xs)
    return (xs[0] if single else xs), hist


def _run_lbfgs(energy_fn, x: torch.Tensor, iters: int,
               mask: Optional[torch.Tensor] = None,
               keep_history: bool = False, args: tuple = ()):
    """``fitting/lbfgs.run_lbfgs`` on ``energy_fn(x, *args)``, or, inside
    an export, its recorded form (:class:`FitExport`)."""
    trace = _FIT_EXPORT.get()
    if trace is not None and trace.replaying:
        return trace.replay_lbfgs(("lbfgs", iters, mask is not None,
                                   keep_history), x, iters, keep_history,
                                  args)
    out = lbfgs_lib.run_lbfgs(energy_fn, x, iters, mask, keep_history, args)
    if trace is not None:
        vg = lbfgs_lib.value_and_grad_fn(energy_fn, mask)

        def grad_fn(x, *args):
            e, g = vg(x, *args)
            return g, e
        trace.record(("lbfgs", iters, mask is not None, keep_history),
                     grad_fn, (x,), args)
    return out


# -- the export form of the fit loops ----------------------------------------

_FIT_EXPORT: contextvars.ContextVar = contextvars.ContextVar(
    "fit_export", default=None)


def exporting() -> bool:
    """Whether an export is tracing the fit (:class:`FitExport`): the
    loops over frames then take their ``scan`` forms."""
    trace = _FIT_EXPORT.get()
    return trace is not None and trace.replaying


@contextlib.contextmanager
def not_recording():
    """Within this scope an export's recording run records no gradient
    graph: for the iterations after the first of a loop whose export form
    replays one graph for all of them (``temporal.fit_video``'s warm
    starts)."""
    token = _FIT_EXPORT.set(None)
    try:
        yield
    finally:
        _FIT_EXPORT.reset(token)


@contextlib.contextmanager
def fake_tensor_cache(tensors, enabled: bool):
    """While an export traces (``tensors`` fake), turn its fake-tensor
    cache on or off; a no-op on real tensors. A cache hit rebuilds its
    output's symbolic sizes and strides, which at an export's top level
    costs more than the op's meta kernel, and inside a loop body less
    (torch 2.11 on an H100 host: the main artifact's trace is shortest
    with the cache off at the top level and on in the loop bodies). The
    program traced is the same either way."""
    from torch._guards import detect_fake_mode
    mode = detect_fake_mode(tuple(tensors))
    if mode is None:
        yield
        return
    prev = mode.cache_enabled
    mode.cache_enabled = enabled
    try:
        yield
    finally:
        mode.cache_enabled = prev


def dense(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` with the default strides: the initial
    value of a scan's carry, whose strides the body's results must
    match."""
    return t.clone(memory_format=torch.contiguous_format)


def scan_replaying(body, init: list, xs: list, additional: tuple):
    """``scan_op(body, init, xs, additional)`` inside an export, for a
    ``body`` that runs fit stages (which replay recorded graphs): each
    trace of the body starts at the same recorded graph, whether the
    operator traces it once or more, and the constants of the graphs it
    may replay (their lifted constants, the bias-correction tables) are
    passed in as inputs, since a loop body nested in another takes no
    tensor constant."""
    from torch._higher_order_ops.scan import scan_op
    trace = _FIT_EXPORT.get()
    start, ends = trace._next, []
    pool = [t for g in trace.graphs[start:] for t in g[3]]

    def traced(*inputs):
        inputs, pooled = inputs[:len(inputs) - len(pool)], inputs[
            len(inputs) - len(pool):]
        outer = trace._subst
        trace._subst = {id(t): v for t, v in zip(pool, pooled)}
        trace._next = start
        try:
            out = body(*inputs)
        finally:
            trace._subst = outer
        ends.append(trace._next)
        return out

    with fake_tensor_cache(init, True):
        out = scan_op(traced, init, xs,
                      tuple(additional) + tuple(t.view_as(t) for t in pool))
    trace._next = ends[-1]
    return out


def _flatten(tree) -> list:
    """The tensors of a nested tuple / list / dict / dataclass, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _flatten(v)]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flatten(tree[k])]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in _flatten(getattr(tree, f.name))]
    return []


def _unflatten(tree, leaves):
    """``tree`` with its tensors replaced, in :func:`_flatten`'s order, by
    those of the iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if dataclasses.is_dataclass(tree):
        # A copy with its fields set (frozen dataclasses allow it through
        # object.__setattr__): cached properties of static data carry over.
        out = copy.copy(tree)
        for f in dataclasses.fields(tree):
            object.__setattr__(out, f.name,
                               _unflatten(getattr(tree, f.name), leaves))
        return out
    return tree


def _batched(tree, inside: bool = False) -> list:
    """For each tensor of :func:`_flatten`'s list: whether it may carry
    the batch. A dataclass's tensors (the SMPL model, the prior, the
    capsules) never do."""
    if isinstance(tree, torch.Tensor):
        return [not inside]
    if isinstance(tree, (tuple, list)):
        return [f for v in tree for f in _batched(v, inside)]
    if isinstance(tree, dict):
        return [f for k in sorted(tree) for f in _batched(tree[k], inside)]
    if dataclasses.is_dataclass(tree):
        return [f for fl in dataclasses.fields(tree)
                for f in _batched(getattr(tree, fl.name), True)]
    return []


def _signature(kind: tuple, xs, leaves) -> tuple:
    return kind + (tuple((tuple(t.shape[1:]), t.dtype) for t in xs),
                   tuple((t.dim(), t.dtype) for t in leaves))


def _bias_table(iters: int, device) -> torch.Tensor:
    """The (iters, 2) bias corrections an Adam scan steps over: on CUDA
    their float32 reciprocals (see :class:`FitExport`)."""
    table = _bias_corrections(iters)
    if torch.device(device).type == "cuda":
        table = (np.float32(1) / table).astype(np.float32)
    return torch.tensor(table, device=device)


class FitExport:
    """The export form of the fit loops: each :func:`_run_adam` call
    becomes one ``torch._higher_order_ops.scan`` over the (iters, 2)
    table of bias corrections (a run of :func:`_stage_groups` one scan
    over all its stages' steps, :func:`_run_adam_stages`), and each
    :func:`_run_lbfgs` call one
    ``scan`` over its steps with a ``while_loop`` linesearch
    (``lbfgs.lbfgs_scan``); the body of either evaluates the stage's
    gradient graph.

    ``autograd.grad`` cannot run inside a scan body that an export
    traces, and a ``make_fx`` started inside the export would see its
    fake tensors. So the export runs the traced function twice:

    1. under :meth:`recording`, eagerly on example inputs: each stage
       runs its loop and then traces the gradient of its energy with
       ``make_fx`` on its example (``x`` and the tensors of ``args`` as
       explicit inputs; with ``symbolic``, dim 0 of ``x`` and of the
       inputs that share it symbolic, so any batch replays), and appends
       the graph;
    2. under :meth:`replaying_calls`, inside ``torch.export``: each stage
       takes the next recorded graph, checks that it was recorded for a
       stage of the same kind (optimizer, steps, lr, mask, history,
       shapes' ranks, dtypes), and emits the loop. A graph used by
       another stage raises.

    The Adam scan's update is the eager loop's, op for op; the bias
    corrections come from the table as tensors, so on CUDA the body
    multiplies by their float32 reciprocals, which is what the eager
    loop's division by a Python float does there (and on the CPU it
    divides, as the eager loop does). The L-BFGS scan runs the eager
    stage's arithmetic (``lbfgs.py``). Either way the steps match the
    eager loop's bit for bit."""

    def __init__(self, symbolic: bool = True):
        self.symbolic = symbolic
        self.graphs: list = []
        self.replaying = False
        self._next = 0
        # Recorded constants → their traced stand-ins in a loop body
        # (scan_replaying).
        self._subst: dict = {}

    @contextlib.contextmanager
    def recording(self):
        token = _FIT_EXPORT.set(self)
        try:
            yield self
        finally:
            _FIT_EXPORT.reset(token)

    @contextlib.contextmanager
    def replaying_calls(self):
        """Replay mode; the call counter restarts with :meth:`restart`
        (each trace of the exported function starts at the first
        graph)."""
        token = _FIT_EXPORT.set(self)
        self.replaying, self._next = True, 0
        try:
            yield self
        finally:
            self.replaying = False
            _FIT_EXPORT.reset(token)

    def restart(self) -> None:
        self._next = 0

    def finish(self) -> None:
        """Raise unless every recorded graph was replayed."""
        if self._next != len(self.graphs):
            raise RuntimeError(
                f"the export replayed {self._next} of the "
                f"{len(self.graphs)} fit loops recorded: the traced "
                f"function took another path than the recorded run")

    def record(self, kind: tuple, grad_fn, xs: tuple, args,
               table: Optional[torch.Tensor] = None) -> None:
        """Trace and keep the gradient graph of a loop; ``table``: the
        rows an Adam scan steps over."""
        gm, used, consts = self._trace_gradient(grad_fn, xs, args,
                                                self.symbolic)
        if table is not None:
            consts.append(table)
        self.graphs.append(
            (_signature(kind, xs, _flatten(args)), gm, used, consts))

    @staticmethod
    def _trace_gradient(grad_fn, xs: tuple, args, symbolic: bool) -> tuple:
        """(the graph of ``grad_fn(*xs, *args)`` → (*gradients, energies),
        the indices of the tensors of ``args`` it reads, its tensor
        constants), traced on ``xs``' and ``args``' shapes, the batch
        symbolic when ``symbolic``."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.fx.experimental.proxy_tensor import make_fx
        from torch.fx.experimental.symbolic_shapes import (
            DimDynamic, ShapeEnv, StatelessSymbolicContext)
        leaves = _flatten(args)
        n_x = len(xs)

        def traced(*inputs):
            return grad_fn(*inputs[:n_x],
                           *_unflatten(args, iter(inputs[n_x:])))

        # Symbolic only where the batch can vary: dim 0 of the first x
        # and of each other x or input whose dim 0 is its (the
        # observations of a batched fit); the model's, the prior's and the
        # capsules' sizes stay concrete, which keeps the trace cheap.
        env = ShapeEnv()
        mode = FakeTensorMode(shape_env=env, allow_non_fake_inputs=True)
        # Without the fake-tensor cache: rebuilding a cached symbolic
        # output costs more than the meta kernel (measured: the trace
        # takes half the time on the card's host).
        mode.cache_enabled = False
        n = xs[0].shape[0]

        def fake(t, batched=True):
            dyn = [DimDynamic.DYNAMIC
                   if symbolic and batched and i == 0 and d == n
                   else DimDynamic.STATIC for i, d in enumerate(t.shape)]
            return mode.from_tensor(t.detach(), symbolic_context=(
                StatelessSymbolicContext(dynamic_sizes=dyn)))

        gm = make_fx(traced, tracing_mode="symbolic",
                     _allow_non_fake_inputs=True)(
            *[fake(t) for t in xs],
            *[fake(t, b) for t, b in zip(leaves, _batched(args))])
        # Drop the inputs the gradient never reads (most of the SMPL
        # model's arrays): the scan would carry them for nothing.
        inputs = [n for n in gm.graph.nodes if n.op == "placeholder"]
        used = [i for i, n in enumerate(inputs[n_x:]) if n.users]
        for n in inputs[n_x:]:
            if not n.users:
                gm.graph.erase_node(n)
        # The graph's tensor constants become inputs too: a scan body may
        # read no tensor that the export has not traced.
        consts, lifted = [], {}
        last = [n for n in gm.graph.nodes if n.op == "placeholder"][-1]
        for n in list(gm.graph.nodes):
            if n.op == "get_attr" and isinstance(
                    getattr(gm, n.target), torch.Tensor):
                if n.target not in lifted:
                    consts.append(getattr(gm, n.target))
                    with gm.graph.inserting_after(last):
                        last = gm.graph.placeholder(f"const_{len(consts)}")
                    lifted[n.target] = last
                n.replace_all_uses_with(lifted[n.target])
                gm.graph.erase_node(n)
        for target in lifted:
            delattr(gm, target)
        gm.recompile()
        return gm, used, consts

    def _take(self, kind: tuple, xs: tuple, args):
        """The next recorded graph, checked against this stage, and the
        tensors it reads: views of the used ``args`` tensors and of its
        constants (a loop body takes the program's constants, the model's
        arrays, only as traced tensors)."""
        leaves = _flatten(args)
        sig = _signature(kind, xs, leaves)
        if self._next >= len(self.graphs):
            raise RuntimeError(
                f"fit loop {self._next} was not recorded (the recorded "
                f"run made {len(self.graphs)})")
        want, gm, used, consts = self.graphs[self._next]
        consts = [self._subst.get(id(t), t) for t in consts]
        if want != sig:
            raise RuntimeError(
                f"fit loop {self._next}: recorded for {want}, replayed "
                f"for {sig}")
        self._next += 1
        inputs = [t.view_as(t) for t in [leaves[i] for i in used] + consts]
        if want[0] == "adam":          # the table goes to the scan's xs
            return gm, inputs[:-1], inputs[-1]
        if want[0] == "adam_stages":   # and the weights are the last leaf
            w = len(leaves) - 1
            return (gm, inputs[:-1], inputs[-1],
                    used.index(w) if w in used else None)
        return gm, inputs

    def replay_adam(self, kind, xs, iters, lr, mask, keep_history, args,
                    exchange=None):
        """The scan of an Adam stage, or, for an ``"adam_stages"`` kind
        (:func:`_run_adam_stages`, ``iters`` and ``lr`` None), of several:
        each row of its table then also holds the step's −lr, the flag
        that restarts the moments and the weights. With an ``exchange``
        (:func:`_run_adam`) the body trades the halo of its ``xs`` and
        puts it in the place of the recorded one, ``args[0]``, and
        reduces the gradients."""
        from torch._higher_order_ops.scan import scan_op
        stages = kind[0] == "adam_stages"
        used = self.graphs[self._next][2] if self._next < len(
            self.graphs) else []
        gm, leaves, table, *w_at = self._take(kind, xs, args)
        n = len(xs)
        on_cuda = xs[0].device.type == "cuda"
        n_halo = 0 if exchange is None else len(_flatten(args[0]))
        halo_at = [(j, i) for j, i in enumerate(used) if i < n_halo]
        ex_leaves = _flatten(exchange)

        def body(*inputs):
            xs, mus, nus = inputs[:n], inputs[n:2 * n], inputs[2 * n:3 * n]
            bc, *inputs = inputs[3 * n:]
            if ex_leaves:
                ex = _unflatten(exchange,
                                iter(inputs[len(inputs) - len(ex_leaves):]))
                inputs = inputs[:len(inputs) - len(ex_leaves)]
            if mask is not None:
                *inputs, m = inputs
            if not stages:
                neg_lr = -lr
            else:
                neg_lr, restart = bc[2], bc[3] > 0
                mus = [torch.where(restart, 0.0, mu) for mu in mus]
                nus = [torch.where(restart, 0.0, nu) for nu in nus]
                if w_at[0] is not None:
                    inputs[w_at[0]] = bc[4:]
            if exchange is not None:
                halo = _flatten(ex.halo(xs))
                for j, i in halo_at:
                    inputs[j] = halo[i]
            *gs, e = gm(*xs, *inputs)
            if exchange is not None:
                gs = ex.reduce(gs)
            out = ([], [], [])
            for x, mu, nu, g in zip(xs, mus, nus, gs):
                if mask is not None:
                    g = g * m
                mu = (1 - _B1) * g + _B1 * mu
                nu = (1 - _B2) * (g * g) + _B2 * nu
                if on_cuda:
                    update = (mu * bc[0]) / (torch.sqrt(nu * bc[1]
                                                        + _EPS_ROOT) + _EPS)
                else:
                    update = (mu / bc[0]) / (torch.sqrt(nu / bc[1]
                                                        + _EPS_ROOT) + _EPS)
                for lst, v in zip(out, (x + update * neg_lr, mu, nu)):
                    lst.append(v)
            return tuple(out[0] + out[1] + out[2]) + (
                (e,) if keep_history else ())

        # The scan operator itself (not torch's scan() front end, which
        # compiles the body with dynamo first): one trace of the body, and
        # every tensor it reads passed in explicitly.
        extra = (tuple(leaves) + (() if mask is None else (mask,))
                 + tuple(t.view_as(t) for t in ex_leaves))
        zeros = [torch.zeros_like(x) for x in xs]
        with fake_tensor_cache(xs, True):
            out = scan_op(body, [*map(dense, xs), *zeros,
                                 *[z.clone() for z in zeros]], [table], extra)
        return (tuple(out[:n]),
                list(out[3 * n].unbind(0)) if keep_history else [])

    def replay_lbfgs(self, kind, x, iters, keep_history, args):
        gm, leaves = self._take(kind, (x,), args)

        def value_and_grad(x, *inputs):
            g, e = gm(x, *inputs)
            return e, g

        with fake_tensor_cache((x,), True):
            x, _, _, hist = lbfgs_lib.lbfgs_scan(value_and_grad, x, iters,
                                                 keep_history, tuple(leaves))
        return x, hist


def capsule_spec_for(model: SMPLData, stages) -> Optional[Any]:
    """The interpenetration term's capsules, built once per fit, when some
    stage weights the term; else None."""
    if not any(s.w_interpenetration > 0.0 for s in stages):
        return None
    return interp_lib.build_capsule_spec(model)


def fit_smpl_batch(model: SMPLData, joints2d: torch.Tensor,
                   conf: torch.Tensor, cfg: FitConfig = FitConfig(),
                   prior: Any = None, init: Optional[dict] = None
                   ) -> FitResult:
    """Fit SMPL pose/shape/camera to a batch of 2D joints: joints2d
    (B, P, 2) pixels in CPM order, conf (B, P). ``init`` optionally warm
    starts from {'theta', 'beta', 'cam'} batched tensors. Each stage runs
    L-BFGS when ``cfg.optimizer == "lbfgs"`` (``fitting/lbfgs.py``; the
    stage's ``lr`` is then unused), else Adam, as in the JAX package."""
    obs = _normalize_obs(joints2d, cfg)
    params = default_init(model, obs, conf, cfg) if init is None else init
    x = torch.cat([params["theta"], params["beta"], params["cam"]],
                  dim=-1).to(torch.float32)
    capsule_spec = capsule_spec_for(model, cfg.stages)
    x, hists = fit_stages(model, obs, conf, x, cfg, prior, capsule_spec)
    with no_grad():
        final_e = fit_energy(_split(x, cfg), model, obs, conf,
                             cfg.stages[-1], cfg, prior, capsule_spec)
    history = (torch.stack(hists, dim=-1) if cfg.keep_history
               else torch.zeros(x.shape[0], 0, device=x.device))
    p = _split(x, cfg)
    return FitResult(theta=p["theta"], beta=p["beta"], cam=p["cam"],
                     energy=final_e, energy_history=history)


def fit_stages(model: SMPLData, obs: torch.Tensor, conf: torch.Tensor,
               x: torch.Tensor, cfg: FitConfig, prior: Any,
               capsule_spec: Any) -> tuple:
    """``cfg.stages`` on the flat parameters ``x`` (B, 85) from
    normalized observations: (the fitted ``x``, the energy history)."""
    hists = []
    args = (obs, conf, model, prior, capsule_spec)
    for group in _stage_groups(cfg, prior, capsule_spec):
        stage = group[0]
        energy_fn = _stage_energy(stage, cfg)
        mask = _stage_mask(stage, cfg, x.device)
        if cfg.optimizer == "lbfgs":
            x, hist = _run_lbfgs(energy_fn, x, stage.iters, mask,
                                 cfg.keep_history, args)
        elif len(group) == 1:
            x, hist = _run_adam(energy_fn, x, stage.iters, stage.lr, mask,
                                cfg.keep_history, args)
        else:
            x, hist = _run_adam_stages(group, cfg, x, mask, args)
        hists += hist
    return x, hists


def _stage_energy(stage: StageConfig, cfg: FitConfig):
    """``energy_fn(x, obs, conf, model, prior, capsule_spec[, weights])``
    of a stage on the flat parameters; ``weights`` a :class:`_Weights`
    in place of the stage's (:func:`_run_adam_stages`)."""
    def energy_fn(x, obs, conf, model, prior, capsule_spec, weights=None):
        return fit_energy(_split(x, cfg), model, obs, conf, stage, cfg,
                          prior, capsule_spec,
                          None if weights is None else weights.w)
    return energy_fn


def _stage_groups(cfg: FitConfig, prior: Any, capsule_spec: Any) -> list:
    """``cfg.stages`` in runs that :func:`fit_stages` fits together: one
    stage each, but inside an export consecutive Adam stages with the
    same parameter mask and the same energy terms on, whose weights,
    steps and rates may differ, form one run (one loop of the program,
    :func:`_run_adam_stages`)."""
    if _FIT_EXPORT.get() is None or cfg.optimizer == "lbfgs":
        return [[s] for s in cfg.stages]

    def key(s):
        return (s.opt_global, s.opt_pose, s.opt_shape, s.opt_cam,
                prior is not None and s.w_pose_prior > 0.0,
                s.w_angle_prior > 0.0, s.w_shape_prior > 0.0,
                capsule_spec is not None and s.w_interpenetration > 0.0)
    groups = []
    for s in cfg.stages:
        if groups and key(groups[-1][-1]) == key(s):
            groups[-1].append(s)
        else:
            groups.append([s])
    return groups


@dataclasses.dataclass(frozen=True)
class _Weights:
    """A stage's energy weights as a (4,) tensor (``fit_energy``'s
    ``weights``); a dataclass, so that the recorder never takes its dim 0
    for the batch."""
    w: torch.Tensor


def _weights_row(stage: StageConfig) -> list:
    return [stage.w_pose_prior, stage.w_angle_prior, stage.w_shape_prior,
            stage.w_interpenetration]


def _stages_table(group: list, device) -> torch.Tensor:
    """The (Σ iters, 8) rows an Adam scan over several stages steps over:
    the stage's bias corrections at the step (as :func:`_bias_table`),
    −lr, 1 at a stage's first step (the moments restart) and the stage's
    four weights."""
    parts = []
    for s in group:
        rest = torch.tensor([-s.lr, 0.0, *_weights_row(s)],
                            device=device).repeat(s.iters, 1)
        rest[0, 1] = 1.0
        parts.append(torch.cat([_bias_table(s.iters, device), rest], dim=1))
    return torch.cat(parts)


def _run_adam_stages(group: list, cfg: FitConfig, x: torch.Tensor,
                     mask: torch.Tensor, args: tuple):
    """The stages of one of :func:`_stage_groups`' runs in an export. The
    recording run fits them one by one, as the live path does, and
    records one gradient graph, of the first stage's energy with the
    weights as an input; the export replays it in one scan over all their
    steps (:meth:`FitExport.replay_adam`), whose rows
    (:func:`_stages_table`) carry each step's bias corrections, rate and
    weights and restart the moments at each stage's first step. The
    weights and rates enter the same products as the floats of the live
    loop, so the steps are the live loop's."""
    trace = _FIT_EXPORT.get()
    energy_fn = _stage_energy(group[0], cfg)
    kind = ("adam_stages",
            tuple((s.iters, float(s.lr), *map(float, _weights_row(s)))
                  for s in group), True, cfg.keep_history)
    wargs = tuple(args) + (
        _Weights(torch.tensor(_weights_row(group[0]), dtype=torch.float32,
                              device=x.device)),)
    if trace.replaying:
        (x,), hist = trace.replay_adam(kind, (x,), None, None, mask,
                                       cfg.keep_history, wargs)
        return x, hist
    x0, hists = x, []
    with not_recording():
        for s in group:
            x, hist = _run_adam(_stage_energy(s, cfg), x, s.iters, s.lr,
                                mask, cfg.keep_history, args)
            hists += hist
    trace.record(kind, _adam_grad_fn(energy_fn), (x0,), wargs,
                 _stages_table(group, x.device))
    return x, hists


def fit_smpl_single(model: SMPLData, joints2d: torch.Tensor,
                    conf: torch.Tensor, cfg: FitConfig = FitConfig(),
                    prior: Any = None, init: Optional[dict] = None
                    ) -> FitResult:
    """One frame: joints2d (P, 2), conf (P,); unbatched results."""
    if init is not None:
        init = {k: v[None] for k, v in init.items()}
    res = fit_smpl_batch(model, joints2d[None], conf[None], cfg, prior,
                         init)
    return FitResult(*(f[0] for f in res))


def fit_smpl_multistart(model: SMPLData, joints2d: torch.Tensor,
                        conf: torch.Tensor, cfg: FitConfig = FitConfig(),
                        prior: Any = None, restarts: int = 4,
                        return_all: bool = False) -> FitResult:
    """Multi-hypothesis fit, batched over B frames: ``restarts`` global-yaw
    inits per frame (evenly spaced around the limb-order estimate), all
    fitted as one (B·restarts) batch; the lowest final energy wins.
    ``return_all`` returns every hypothesis, fields shaped (B, restarts,
    ...)."""
    b, r = joints2d.shape[0], restarts
    obs = _normalize_obs(joints2d, cfg)
    base = default_init(model, obs, conf, cfg)
    offsets = torch.arange(r, dtype=torch.float32, device=joints2d.device) \
        * (2.0 * math.pi / r)
    yaws = base["theta"][:, 1:2] + offsets                    # (B, R)
    theta = base["theta"].repeat_interleave(r, 0)
    theta[:, 1] = yaws.reshape(-1)
    init = {"theta": theta,
            "beta": base["beta"].repeat_interleave(r, 0),
            "cam": base["cam"].repeat_interleave(r, 0)}
    res = fit_smpl_batch(model, joints2d.repeat_interleave(r, 0),
                         conf.repeat_interleave(r, 0), cfg, prior, init)
    res = FitResult(*(f.reshape(b, r, *f.shape[1:]) for f in res))
    if return_all:
        return res
    # A diverged restart (NaN energy) must never win the argmin.
    energies = torch.where(torch.isnan(res.energy),
                           torch.full_like(res.energy, math.inf), res.energy)
    best = energies.argmin(-1)
    rows = torch.arange(b, device=best.device)
    return FitResult(*(f[rows, best] for f in res))


def reproject(model: SMPLData, result: FitResult, cfg: FitConfig):
    """Project the fitted model's joints back to the fit's observation
    frame, batched."""
    joints = smpl_lib.smpl_joints(model, result.beta, result.theta)
    j3d = joints_lib.select_smpl_joints(joints)
    return camera_lib.project(j3d, result.cam, model=cfg.camera_model,
                              **perspective_kwargs(cfg))
