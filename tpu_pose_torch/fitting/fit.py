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


def _run_adam(energy_fn, x: torch.Tensor, iters: int, lr: float,
              mask: Optional[torch.Tensor] = None,
              keep_history: bool = False):
    """``iters`` Adam steps on ``x`` from fresh state, with optax.adam's
    update in its order of operations: moments ``(1−b)·g + b·m``, bias
    correction ``1 − b^t`` in float32, update ``m̂ / (√(v̂ + eps_root) +
    eps) · (−lr)``. The gradient is of ``energy_fn(x).sum()``, masked
    (when ``mask`` is given) before the update."""
    mu = torch.zeros_like(x)
    nu = torch.zeros_like(x)
    hist = []
    for t in range(1, iters + 1):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            e = energy_fn(x)
            (g,) = torch.autograd.grad(e.sum(), x)
        if keep_history:
            hist.append(e.detach())
        with torch.no_grad():
            if mask is not None:
                g = g * mask
            mu = (1 - _B1) * g + _B1 * mu
            nu = (1 - _B2) * (g * g) + _B2 * nu
            bc1 = float(np.float32(1) - np.power(np.float32(_B1),
                                                  np.float32(t)))
            bc2 = float(np.float32(1) - np.power(np.float32(_B2),
                                                  np.float32(t)))
            update = (mu / bc1) / (torch.sqrt(nu / bc2 + _EPS_ROOT) + _EPS)
            x = x + update * (-lr)
    return x.detach(), hist


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
        def energy_fn(x, stage=stage):
            return fit_energy(_split(x, cfg), model, obs, conf, stage, cfg,
                              prior, capsule_spec)
        mask = _stage_mask(stage, cfg, x.device)
        if cfg.optimizer == "lbfgs":
            x, hist = lbfgs_lib.run_lbfgs(energy_fn, x, stage.iters, mask,
                                          cfg.keep_history)
        else:
            x, hist = _run_adam(energy_fn, x, stage.iters, stage.lr, mask,
                                cfg.keep_history)
        hists += hist
    with torch.no_grad():
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
