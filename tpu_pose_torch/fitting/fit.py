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


def _run_adam(energy_fn, x: torch.Tensor, iters: int, lr: float,
              mask: Optional[torch.Tensor] = None,
              keep_history: bool = False, args: tuple = ()):
    """``iters`` Adam steps on ``x`` from fresh state, with optax.adam's
    update in its order of operations: moments ``(1−b)·g + b·m``, bias
    correction ``1 − b^t`` in float32, update ``m̂ / (√(v̂ + eps_root) +
    eps) · (−lr)``. The gradient is of ``energy_fn(x, *args).sum()``,
    masked (when ``mask`` is given) before the update. ``args`` holds
    every tensor the energy reads that is not a constant of the program
    (tensors, dicts, tuples and dataclasses of them): an export replays
    the energy's gradient graph on them (:class:`AdamExport`)."""
    trace = _ADAM_EXPORT.get()
    if trace is not None and trace.replaying:
        return trace.replay(x, iters, lr, mask, keep_history, args)
    x0 = x
    mu = torch.zeros_like(x)
    nu = torch.zeros_like(x)
    hist = []
    bcs = _bias_corrections(iters)
    for t in range(iters):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            e = energy_fn(x, *args)
            (g,) = torch.autograd.grad(e.sum(), x)
        if keep_history:
            hist.append(e.detach())
        with torch.no_grad():
            if mask is not None:
                g = g * mask
            mu = (1 - _B1) * g + _B1 * mu
            nu = (1 - _B2) * (g * g) + _B2 * nu
            bc1, bc2 = float(bcs[t, 0]), float(bcs[t, 1])
            update = (mu / bc1) / (torch.sqrt(nu / bc2 + _EPS_ROOT) + _EPS)
            x = x + update * (-lr)
    if trace is not None:
        trace.record(energy_fn, x0, iters, lr, mask, keep_history, args)
    return x.detach(), hist


# -- the export form of the Adam loop ---------------------------------------

_ADAM_EXPORT: contextvars.ContextVar = contextvars.ContextVar(
    "adam_export", default=None)


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


def _signature(x, iters, lr, mask, keep_history, leaves) -> tuple:
    return (tuple(x.shape[1:]), x.dtype, iters, float(lr), mask is not None,
            keep_history, tuple((t.dim(), t.dtype) for t in leaves))


class AdamExport:
    """The export form of :func:`_run_adam`: each call becomes one
    ``torch._higher_order_ops.scan`` over the (iters, 2) table of bias
    corrections, whose body is the energy's gradient graph.

    ``autograd.grad`` cannot run inside a scan body that an export
    traces, and a ``make_fx`` started inside the export would see its
    fake tensors. So the export runs the traced function twice:

    1. under :meth:`recording`, eagerly on example inputs: each
       ``_run_adam`` call runs its loop and then traces the gradient of its
       energy with ``make_fx`` on its example (``x`` and the tensors of
       ``args`` as explicit inputs; with ``symbolic``, dim 0 of ``x`` and
       of the inputs that share it symbolic, so any batch replays), and
       appends the graph;
    2. under :meth:`replaying_calls`, inside ``torch.export``: each call
       takes the next recorded graph, checks that it was recorded for a
       call of the same kind (shapes' ranks, dtypes, steps, lr, mask,
       history), and emits the scan. A graph used by another call
       raises.

    The scan's update is the eager loop's, op for op; the bias
    corrections come from the table as tensors, so on CUDA the body
    multiplies by their float32 reciprocals, which is what the eager
    loop's division by a Python float does there (and on the CPU it
    divides, as the eager loop does). Either way the steps match the eager
    loop's bit for bit."""

    def __init__(self, symbolic: bool = True):
        self.symbolic = symbolic
        self.graphs: list = []
        self.replaying = False
        self._next = 0

    @contextlib.contextmanager
    def recording(self):
        token = _ADAM_EXPORT.set(self)
        try:
            yield self
        finally:
            _ADAM_EXPORT.reset(token)

    @contextlib.contextmanager
    def replaying_calls(self):
        """Replay mode; the call counter restarts with :meth:`restart`
        (each trace of the exported function starts at the first
        graph)."""
        token = _ADAM_EXPORT.set(self)
        self.replaying, self._next = True, 0
        try:
            yield self
        finally:
            self.replaying = False
            _ADAM_EXPORT.reset(token)

    def restart(self) -> None:
        self._next = 0

    def finish(self) -> None:
        """Raise unless every recorded graph was replayed."""
        if self._next != len(self.graphs):
            raise RuntimeError(
                f"the export replayed {self._next} of the "
                f"{len(self.graphs)} Adam loops recorded: the traced "
                f"function took another path than the recorded run")

    def record(self, energy_fn, x, iters, lr, mask, keep_history,
               args) -> None:
        gm, used, consts = self._trace_gradient(energy_fn, x, args,
                                                self.symbolic)
        self.graphs.append(
            (_signature(x, iters, lr, mask, keep_history, _flatten(args)),
             gm, used, consts))

    @staticmethod
    def _trace_gradient(energy_fn, x, args, symbolic: bool) -> tuple:
        """(gradient graph, the indices of the tensors of ``args`` it
        reads, its tensor constants), traced on ``x``'s and ``args``'
        shapes, the batch symbolic when ``symbolic``."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.fx.experimental.proxy_tensor import make_fx
        from torch.fx.experimental.symbolic_shapes import (
            DimDynamic, ShapeEnv, StatelessSymbolicContext)
        leaves = _flatten(args)

        def grad_fn(x, *leaves):
            x = x.detach().requires_grad_(True)
            with torch.enable_grad():
                e = energy_fn(x, *_unflatten(args, iter(leaves)))
                (g,) = torch.autograd.grad(e.sum(), x)
            return g, e.detach()

        # Symbolic only where the batch can vary: dim 0 of x and of each
        # input whose dim 0 is x's (the observations of a batched fit); the
        # model's and the prior's sizes stay concrete, which keeps the trace
        # cheap.
        env = ShapeEnv()
        mode = FakeTensorMode(shape_env=env, allow_non_fake_inputs=True)
        # Without the fake-tensor cache: rebuilding a cached symbolic
        # output costs more than the meta kernel (measured: the trace
        # takes half the time on the card's host).
        mode.cache_enabled = False
        n = x.shape[0]

        def fake(t):
            dyn = [DimDynamic.DYNAMIC if symbolic and i == 0 and d == n
                   else DimDynamic.STATIC for i, d in enumerate(t.shape)]
            return mode.from_tensor(t.detach(), symbolic_context=(
                StatelessSymbolicContext(dynamic_sizes=dyn)))

        gm = make_fx(grad_fn, tracing_mode="symbolic",
                     _allow_non_fake_inputs=True)(
            fake(x), *[fake(t) for t in leaves])
        # Drop the inputs the gradient never reads (most of the SMPL
        # model's arrays): the scan would carry them for nothing.
        inputs = [n for n in gm.graph.nodes if n.op == "placeholder"]
        used = [i for i, n in enumerate(inputs[1:]) if n.users]
        for n in inputs[1:]:
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

    def replay(self, x, iters, lr, mask, keep_history, args):
        from torch._higher_order_ops.scan import scan_op
        leaves = _flatten(args)
        sig = _signature(x, iters, lr, mask, keep_history, leaves)
        if self._next >= len(self.graphs):
            raise RuntimeError(
                f"Adam loop {self._next} was not recorded (the recorded "
                f"run made {len(self.graphs)})")
        want, gm, used, consts = self.graphs[self._next]
        if want != sig:
            raise RuntimeError(
                f"Adam loop {self._next}: recorded for {want}, replayed "
                f"for {sig}")
        self._next += 1
        table = _bias_corrections(iters)
        on_cuda = x.device.type == "cuda"
        if on_cuda:
            table = (np.float32(1) / table).astype(np.float32)
        table = torch.tensor(table, device=x.device)
        # A view of each input: the scan takes the program's constants (the
        # model's arrays) only as traced tensors.
        leaves = [t.view_as(t) for t in [leaves[i] for i in used] + consts]

        def body(x, mu, nu, bc, *inputs):
            if mask is not None:
                *inputs, m = inputs
            g, e = gm(x, *inputs)
            if mask is not None:
                g = g * m
            mu = (1 - _B1) * g + _B1 * mu
            nu = (1 - _B2) * (g * g) + _B2 * nu
            if on_cuda:
                update = (mu * bc[0]) / (torch.sqrt(nu * bc[1] + _EPS_ROOT)
                                         + _EPS)
            else:
                update = (mu / bc[0]) / (torch.sqrt(nu / bc[1] + _EPS_ROOT)
                                         + _EPS)
            return (x + update * (-lr), mu, nu) + ((e,) if keep_history
                                                    else ())

        # The scan operator itself (not torch's scan() front end, which
        # compiles the body with dynamo first): one trace of the body, and
        # every tensor it reads passed in explicitly.
        extra = tuple(leaves) + (() if mask is None else (mask,))
        x, _, _, *hist = scan_op(
            body, [x, torch.zeros_like(x), torch.zeros_like(x)], [table],
            extra)
        return x, (list(hist[0].unbind(0)) if keep_history else [])


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
    hists = []
    for stage in cfg.stages:
        def energy_fn(x, obs, conf, model, prior, capsule_spec,
                      stage=stage):
            return fit_energy(_split(x, cfg), model, obs, conf, stage, cfg,
                              prior, capsule_spec)
        mask = _stage_mask(stage, cfg, x.device)
        args = (obs, conf, model, prior, capsule_spec)
        if cfg.optimizer == "lbfgs":
            x, hist = lbfgs_lib.run_lbfgs(lambda x: energy_fn(x, *args), x,
                                          stage.iters, mask, cfg.keep_history)
        else:
            x, hist = _run_adam(energy_fn, x, stage.iters, stage.lr, mask,
                                cfg.keep_history, args)
        hists += hist
    with no_grad():
        final_e = fit_energy(_split(x, cfg), model, obs, conf,
                             cfg.stages[-1], cfg, prior, capsule_spec)
    history = (torch.stack(hists, dim=-1) if cfg.keep_history
               else torch.zeros(x.shape[0], 0, device=x.device))
    p = _split(x, cfg)
    return FitResult(theta=p["theta"], beta=p["beta"], cam=p["cam"],
                     energy=final_e, energy_history=history)


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
