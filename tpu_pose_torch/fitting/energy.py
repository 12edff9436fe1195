"""SMPLify-style fit energy (port of ``tpu_pose/fitting/energy.py``):

    E(θ, β, cam) = Σ_j conf_j · ρ( Π(J3d(θ, β))_j − j2d_j )
                   + λ_θ · pose_prior(θ[3:])
                   + λ_a · angle_prior(θ)
                   + λ_β · ‖β‖²
                   + λ_sp · interpenetration(θ, β)   [optional, default 0]

with ρ the Geman–McClure robustifier (GMoF) and the optional fourth term
SMPLify's capsule self-interpenetration penalty
(``fitting/interpenetration.py``). Batched: one energy per sample,
``(B,)``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from tpu_pose_torch.fitting import interpenetration as interp_lib
from tpu_pose_torch.fitting import priors as priors_lib
from tpu_pose_torch.models import camera as camera_lib
from tpu_pose_torch.models import joints as joints_lib
from tpu_pose_torch.models import smpl as smpl_lib
from tpu_pose_torch.models.smpl_data import SMPLData
from tpu_pose_torch.utils.config import FitConfig, StageConfig

Params = Dict[str, torch.Tensor]  # theta (B, 72), beta (B, 10), cam (B, 3)


def perspective_kwargs(cfg: FitConfig) -> Dict[str, Any]:
    """Projection kwargs putting the perspective camera in the fit's
    observation frame. ``cfg.focal`` is in PIXELS; with ``normalize_obs``
    the effective focal is 2f/S and the center 0."""
    if cfg.camera_model != camera_lib.PERSPECTIVE:
        return {}
    if cfg.normalize_obs:
        return {"focal": cfg.focal * 2.0 / cfg.img_size,
                "center": (0.0, 0.0)}
    return {"focal": cfg.focal,
            "center": (cfg.img_size / 2.0, cfg.img_size / 2.0)}


def gmof(residual: torch.Tensor, sigma: float) -> torch.Tensor:
    """Geman–McClure robustifier: ρ(x) = σ²·x² / (x² + σ²), elementwise."""
    sq = residual * residual
    return sigma * sigma * sq / (sq + sigma * sigma)


def reprojection_energy(joints2d_pred: torch.Tensor,
                        joints2d_obs: torch.Tensor,
                        conf: torch.Tensor, sigma: float) -> torch.Tensor:
    """Confidence-weighted robust reprojection error, (..., P, 2) →
    (...)."""
    res = joints2d_pred - joints2d_obs
    return (conf[..., None] * gmof(res, sigma)).sum((-2, -1))


def fit_energy(params: Params, model: SMPLData,
               joints2d_obs: torch.Tensor,   # (B, P, 2), CPM order
               conf: torch.Tensor,           # (B, P)
               stage: StageConfig, cfg: FitConfig,
               prior: Any = None,
               capsule_spec: Any = None,
               weights: Any = None) -> torch.Tensor:
    """Total energy per sample, (B,). With ``cfg.normalize_obs`` the
    observations arrive in [-1, 1] and ``gmof_sigma`` and the prior
    weights are rescaled into that frame (``scale``). ``capsule_spec``
    (``interpenetration.CapsuleSpec``) enables the interpenetration term
    of stages with a positive weight. ``weights``: the terms' weights as
    a (4,) tensor (pose prior, angle prior, shape prior,
    interpenetration) in place of the stage's, which still decide which
    terms are on (an export's loop over several stages,
    ``fit.FitExport``); the products are the same as with the floats."""
    theta, beta, cam = params["theta"], params["beta"], params["cam"]
    precision = (smpl_lib.EXACT_PRECISION
                 if cfg.smpl_precision == "highest" else None)
    # Joints only: the energy never reads the skinned vertices.
    joints = smpl_lib.smpl_joints(model, beta, theta, precision=precision)
    j3d = joints_lib.select_smpl_joints(joints)
    j2d = camera_lib.project(j3d, cam, model=cfg.camera_model,
                             **perspective_kwargs(cfg))

    scale = (2.0 / cfg.img_size) if cfg.normalize_obs else 1.0
    sigma = cfg.gmof_sigma * scale
    e = reprojection_energy(j2d, joints2d_obs, conf, sigma)

    w_pose, w_angle, w_shape, w_interp = (
        (stage.w_pose_prior, stage.w_angle_prior, stage.w_shape_prior,
         stage.w_interpenetration) if weights is None
        else weights.unbind(0))
    if prior is not None and stage.w_pose_prior > 0.0:
        e = e + w_pose * prior.neg_log_prob(theta[..., 3:]) * scale ** 2
    if stage.w_angle_prior > 0.0:
        e = e + w_angle * priors_lib.angle_prior(theta) * scale ** 2
    if stage.w_shape_prior > 0.0:
        e = e + w_shape * (beta * beta).sum(-1) * scale ** 2
    if capsule_spec is not None and stage.w_interpenetration > 0.0:
        # Capsule overlap hinge² on the 24 posed joints, in m².
        e = e + w_interp * interp_lib.interpenetration_penalty(
            joints, capsule_spec) * scale ** 2
    return e
