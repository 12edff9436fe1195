"""Learned fit initialization: 2D joints → (θ₀, β₀) regressor (port of
``tpu_pose/fitting/init_head.py``).

A small MLP trained to invert the framework's own generative model
(sample (θ*, β*) → SMPL → project with a random camera → corrupt →
regress back) places the fit in the right basin before its first step.
Inputs are root-centered, scale-normalized 2D joints ⊕ confidences; the
loss is parameter MSE plus a 3D joint loss through SMPL.

Everything is batched over a leading axis where the JAX package
``vmap``s. Random numbers come from an explicit ``torch.Generator`` and
differ from ``jax.random``'s; heads carry between the packages through
:func:`save_head` / :func:`load_head` (npz keys ``w{i}``, ``b{i}``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_pose_torch.fitting import fit as fit_lib
from tpu_pose_torch.models import camera as camera_lib
from tpu_pose_torch.models import joints as joints_lib
from tpu_pose_torch.models import smpl as smpl_lib
from tpu_pose_torch.models.smpl_data import SMPLData
from tpu_pose_torch.utils.device import resolve_device

Params = Dict[str, torch.Tensor]

_IN_DIM = 14 * 2 + 14          # centered/normalized joints ⊕ conf
_OUT_DIM = 72 + 10             # theta ⊕ beta


def init_head_params(generator: torch.Generator, hidden: int = 256,
                     depth: int = 3) -> Params:
    """He-initialized MLP parameters on the generator's device; the last
    layer ×0.01, so an untrained head starts near the mean-pose init."""
    dims = [_IN_DIM] + [hidden] * depth + [_OUT_DIM]
    device = generator.device
    params: Params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = torch.randn(a, b, generator=generator,
                                      device=device) * math.sqrt(2.0 / a)
        params[f"b{i}"] = torch.zeros(b, device=device)
    last = f"w{len(dims) - 2}"
    params[last] = params[last] * 0.01
    return params


def _featurize(joints2d_norm: torch.Tensor, conf: torch.Tensor
               ) -> torch.Tensor:
    """Camera-invariant features, (B, 14, 2), (B, 14) → (B, 42):
    conf-weighted centering and RMS scale normalization of the
    observations, flattened, then the confidences."""
    w = conf / (conf.sum(-1, keepdim=True) + 1e-8)
    mean = (w[..., None] * joints2d_norm).sum(-2, keepdim=True)
    centered = joints2d_norm - mean
    rms = torch.sqrt((w[..., None] * centered ** 2).sum((-2, -1))
                     + 1e-8)[..., None, None]
    return torch.cat([(centered / rms).flatten(-2), conf], dim=-1)


def init_head_apply(params: Params, joints2d_norm: torch.Tensor,
                    conf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Observations (B, 14, 2) in the fit's [-1, 1] frame and conf (B, 14)
    → (theta (B, 72), beta (B, 10)). The hidden activation is the tanh
    GELU, ``jax.nn.gelu``'s default."""
    h = _featurize(joints2d_norm, conf)
    n_layers = len(params) // 2
    for i in range(n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = F.gelu(h, approximate="tanh")
    return h[..., :72], h[..., 72:]


def head_init_pytree(params: Params, model: SMPLData,
                     joints2d_norm: torch.Tensor, conf: torch.Tensor,
                     cfg) -> dict:
    """Drop-in replacement for ``fit.default_init``, batched: the head's
    (θ, β) and ``default_init``'s camera. As in the JAX package's code
    (its docstring says otherwise), the camera comes from the
    limb-order-yawed mean rest pose whatever θ the head predicts."""
    theta0, beta0 = init_head_apply(params, joints2d_norm, conf)
    base = fit_lib.default_init(model, joints2d_norm, conf, cfg)
    return {"theta": theta0, "beta": beta0, "cam": base["cam"]}


# -- self-supervised training (invert the generative model) -----------------

def _sample_batch(generator: torch.Generator, model: SMPLData, batch: int,
                  pose_std: float = 0.25, noise_px_norm: float = 0.02,
                  drop_p: float = 0.1):
    """(observations, conf, θ, β, 24 joints): sample → SMPL joints →
    weak-perspective projection with a random camera in the normalized
    frame → noise and dropped joints. On the generator's device."""
    dev = generator.device

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=dev)

    def rand(*shape):
        return torch.rand(*shape, generator=generator, device=dev)

    theta = pose_std * randn(batch, 72)
    theta[:, :3] = 0.4 * randn(batch, 3)
    beta = 0.8 * randn(batch, 10)
    joints = smpl_lib.smpl_joints(model, beta, theta)
    j14 = joints_lib.select_smpl_joints(joints)              # (B, 14, 3)
    s = torch.exp(rand(batch, 1) * 0.8 - 0.4)
    t = 0.2 * randn(batch, 2)
    j2d = camera_lib.weak_perspective_project(j14, torch.cat([s, t], dim=-1))
    noise = noise_px_norm * randn(*j2d.shape)
    keep = (rand(batch, 14) > drop_p).to(torch.float32)
    conf = keep * (0.5 + 0.5 * rand(batch, 14))
    return j2d + noise, conf, theta, beta, joints


def _loss(params: Params, model: SMPLData, j2d, conf, theta_gt, beta_gt,
          joints_gt, w_joint: float = 1.0) -> torch.Tensor:
    """Parameter MSE (β weighted 0.1) plus ``w_joint`` × the root-aligned
    3D joint MSE through SMPL's joints."""
    pred_t, pred_b = init_head_apply(params, j2d, conf)
    l_param = (((pred_t - theta_gt) ** 2).mean()
               + 0.1 * ((pred_b - beta_gt) ** 2).mean())
    joints = smpl_lib.smpl_joints(model, pred_b, pred_t)
    root = joints_gt[:, :1] - joints[:, :1]
    l_joint = ((joints + root - joints_gt) ** 2).mean()
    return l_param + w_joint * l_joint


def _flat(params: Params) -> torch.Tensor:
    return torch.cat([v.reshape(-1) for v in params.values()])


def _unflat(x: torch.Tensor, like: Params) -> Params:
    out, i = {}, 0
    for k, v in like.items():
        out[k] = x[i:i + v.numel()].reshape(v.shape)
        i += v.numel()
    return out


def train_init_head(model: SMPLData, steps: int = 2000, batch: int = 256,
                    lr: float = 1e-3, seed: int = 0, hidden: int = 256,
                    depth: int = 3, w_joint: float = 1.0):
    """``steps`` Adam steps (optax's update, ``fit._run_adam``), each on a
    fresh :func:`_sample_batch` from one ``torch.Generator(seed)`` on the
    model's device. Returns (params, the loss of every step as numpy); the
    losses are read from the device once, at the end."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    params = init_head_params(gen, hidden=hidden, depth=depth)

    def loss_fn(x):
        data = _sample_batch(gen, model, batch)
        return _loss(_unflat(x, params), model, *data, w_joint=w_joint)

    x, losses = fit_lib._run_adam(loss_fn, _flat(params), steps, lr,
                                  keep_history=True)
    return _unflat(x, params), torch.stack(losses).cpu().numpy()


def save_head(path: str, params: Params) -> None:
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in params.items()})


def load_head(path: str, device=None) -> Params:
    """A head saved by either package's ``save_head``, on ``device``."""
    device = resolve_device(device)
    with np.load(path) as z:
        return {k: torch.tensor(np.asarray(z[k], np.float32), device=device)
                for k in z.files}
