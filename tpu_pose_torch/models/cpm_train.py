"""CPM training (port of ``tpu_pose/models/cpm_train.py``): the
intermediate-supervision loss, the straight-through fake-quantized weight
view for quantization-aware training, the train step and the optimizer.

The optimizer is optax's, written out by hand in its order of operations
(as ``fitting/fit.py:_run_adam`` writes out ``optax.adam``):
``optax.adam(lr)`` without a schedule, and with ``total_steps``
``chain(clip_by_global_norm(clip_norm), adam(warmup_cosine_decay_schedule
(0, lr, warmup, total_steps, lr / 50)))``. The schedule reads the step
count before it is incremented, so the first scheduled update has
learning rate 0, as in JAX. Parameters and moments stay float32; the
forward runs in ``cfg.compute_dtype``.

With a ``mesh`` (``parallel/mesh.make_mesh``) the step is data-parallel:
every rank takes its rows of the global batch, and the gradients and the
loss are averaged over the ranks before the optimizer step, as the JAX
step's ``pmean`` inside ``shard_map`` does. Parameters stay replicated.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tpu_pose_torch.models import cpm as cpm_lib
from tpu_pose_torch.parallel import mesh as mesh_lib
from tpu_pose_torch.utils.config import CPMConfig

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def stage_supervision_loss(cpm, images, center_maps, target_heatmaps,
                           cfg: CPMConfig, joint_mask=None,
                           stage1_heatmaps=None,
                           params: Optional[Dict[str, torch.Tensor]] = None
                           ) -> torch.Tensor:
    """Σ_stages ‖b_t − b*‖² / stages (each a mean over batch and pixels):
    every stage is supervised by the same target belief maps, as in the
    CPM paper.

    ``images`` may be raw uint8: they are normalized here (x/256 − 0.5).
    ``joint_mask`` (B, P+1): per-example channel weights for partially
    annotated data; each stage's term is then Σ err·w / max(Σw·H·W, 1).
    ``stage1_heatmaps``: separate targets for stage 1 only (the union maps
    of every person on multi-person frames, while the hinted stages keep
    the target's). ``params``: tensors standing in for ``cpm``'s
    parameters by name (``torch.func.functional_call``), e.g. the
    :func:`fake_quant_params` view. Returns a float32 scalar."""
    if images.dtype == torch.uint8:
        images = images.float() / 256.0 - 0.5
    if params is None:
        beliefs = cpm_lib.cpm_forward(cpm, images, center_maps, cfg)
    else:
        beliefs = torch.func.functional_call(
            cpm, params, (images, center_maps), {"cfg": cfg})
    loss = 0.0
    for si, b in enumerate(beliefs):
        tgt = (stage1_heatmaps
               if si == 0 and stage1_heatmaps is not None
               else target_heatmaps)
        err = (b - tgt) ** 2
        if joint_mask is None:
            loss = loss + err.mean()
        else:
            w = joint_mask[:, None, None, :].to(err.dtype)
            denom = w.sum() * err.shape[1] * err.shape[2]
            loss = loss + (err * w).sum() / torch.clamp_min(denom, 1.0)
    return loss / len(beliefs)


def fake_quant_params(cpm) -> Dict[str, torch.Tensor]:
    """Straight-through fake-quantized view of a :class:`~tpu_pose_torch.
    models.cpm.CPM`'s float32 weights for quantization-aware training:
    each conv weight becomes ``w + (dq(q(w)) − w).detach()``, so the
    forward sees exactly the int8 serving weights (per-output-channel
    scale max(max|w| / 127, 1e-12), as ``cpm.quantize_params`` computes
    it) while the gradient reaches the latent float32 weights. Weights
    only; biases pass through. Returns ``{parameter name: tensor}`` for
    :func:`stage_supervision_loss`'s ``params``."""
    out = {}
    for name, p in cpm.named_parameters():
        if name.endswith(".weight"):
            scale = torch.clamp_min(
                p.abs().amax(dim=(1, 2, 3), keepdim=True) * cpm_lib._INV_127,
                1e-12)
            wq = torch.clamp(torch.round(p / scale), -127, 127) * scale
            p = p + (wq - p).detach()
        out[name] = p
    return out


class TrainOptimizer:
    """optax's Adam, optionally behind the global-norm clip and the
    warmup-cosine schedule (see the module docstring), on a dict of
    float32 tensors. The state is ``{"count": int, "mu": {name: tensor},
    "nu": {name: tensor}}``; the count lives on the host, so a step
    never reads the device."""

    def __init__(self, lr: float = 1e-4, total_steps: Optional[int] = None,
                 warmup_frac: float = 0.05, clip_norm: float = 1.0):
        self.lr = lr
        self.total_steps = total_steps
        self.clip_norm = clip_norm
        self.warmup_steps = None
        if total_steps is not None:
            self.warmup_steps = max(1, int(total_steps * warmup_frac))
            if total_steps - self.warmup_steps <= 0:
                raise ValueError(
                    f"the cosine phase needs positive decay steps: "
                    f"total_steps {total_steps} ≤ warmup "
                    f"{self.warmup_steps}")

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def learning_rate(self, count: int) -> float:
        """The learning rate of the update at step ``count`` (0-based),
        optax's schedule in float32: linear warmup from 0 to ``lr`` over
        the warmup steps, then cosine decay to lr/50 over the rest."""
        if self.total_steps is None:
            return self.lr
        f32 = np.float32
        w = self.warmup_steps
        if count < w:
            frac = f32(1) - f32(min(max(count, 0), w)) / f32(w)
            return float(f32(0.0 - self.lr) * frac + f32(self.lr))
        decay = self.total_steps - w
        alpha = (self.lr / 50.0) / self.lr
        c = f32(min(count - w, decay))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay)))
        return float(f32(self.lr) * (f32(1 - alpha) * cos + f32(alpha)))

    def apply(self, params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor], state: dict) -> dict:
        """One optimizer step in place, as optax's ``update`` then
        ``apply_updates``: clip (with a schedule), Adam moments, bias
        correction by 1 − b^t in float32, m̂ / (√v̂ + eps), times −lr of
        the step count before the increment, ``p += update``. Returns the
        new state. Divisions by a scalar divide by a 0-d tensor on the
        device (a CUDA ``tensor / float`` multiplies by the
        reciprocal)."""
        names = list(grads)
        g = [grads[k] for k in names]
        dev = g[0].device
        with torch.no_grad():
            if self.total_steps is not None:
                g_norm = torch.sqrt(torch.stack(
                    [torch.sum(x * x) for x in g]).sum())
                trigger = g_norm < self.clip_norm
                g = [torch.where(trigger, x, (x / g_norm) * self.clip_norm)
                     for x in g]
            t = state["count"] + 1
            bc1 = torch.full((), float(np.float32(1) - np.power(
                np.float32(_B1), np.float32(t))), device=dev)
            bc2 = torch.full((), float(np.float32(1) - np.power(
                np.float32(_B2), np.float32(t))), device=dev)
            step = -self.learning_rate(state["count"])
            mu, nu = {}, {}
            for k, x in zip(names, g):
                m = (1 - _B1) * x + _B1 * state["mu"][k]
                v = (1 - _B2) * (x * x) + _B2 * state["nu"][k]
                mu[k], nu[k] = m, v
                params[k].add_((m / bc1) / (torch.sqrt(v / bc2) + _EPS)
                               * step)
        return {"count": t, "mu": mu, "nu": nu}


def _on_device(batch: dict, device: torch.device) -> dict:
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = torch.as_tensor(v).to(device, non_blocking=True)
    return out


def make_train_step(cfg: CPMConfig, optimizer: TrainOptimizer,
                    mesh=None, fake_quant: bool = False) -> Callable:
    """Returns ``step(cpm, opt_state, batch) → (cpm, opt_state, loss)``:
    the supervision loss of ``batch`` (numpy arrays or tensors: images,
    center_maps, heatmaps[, joint_mask, heatmaps_stage1]), its gradient
    with respect to ``cpm``'s float32 parameters, and one optimizer step
    applied to them in place. ``loss`` is a 0-d device tensor (read it
    when needed: reading waits for the step).

    ``mesh``: data parallelism. Every rank calls ``step`` with the same
    global batch (its size divisible by the mesh size) and the same
    parameters (``mesh.replicate`` them once). Each computes the loss and
    gradients of its rows (``mesh.shard_batch``); both are averaged over
    the mesh before the optimizer step, so the global-norm clip sees the
    averaged gradients and every rank applies the same update. With
    ``joint_mask`` the loss is the mean of the shards' losses, as in JAX.

    ``fake_quant``: quantization-aware training, the forward on the
    :func:`fake_quant_params` view, so the trained weights land where
    int8 serving rounds them."""

    def step(cpm, opt_state, batch):
        params = dict(cpm.named_parameters())
        if mesh is not None:
            batch = mesh_lib.shard_batch(batch, mesh)
        b = _on_device(batch, next(iter(params.values())).device)
        with torch.enable_grad():
            view = fake_quant_params(cpm) if fake_quant else None
            loss = stage_supervision_loss(
                cpm, b["images"], b["center_maps"], b["heatmaps"], cfg,
                joint_mask=b.get("joint_mask"),
                stage1_heatmaps=b.get("heatmaps_stage1"), params=view)
            grads = torch.autograd.grad(loss, list(params.values()))
        if mesh is not None:
            *grads, loss = mesh_lib.pmean([*grads, loss], mesh)
        opt_state = optimizer.apply(params, dict(zip(params, grads)),
                                    opt_state)
        return cpm, opt_state, loss.detach()

    return step


def init_train_state(seed: int, cfg: CPMConfig, lr: float = 1e-4,
                     total_steps: Optional[int] = None,
                     warmup_frac: float = 0.05, clip_norm: float = 1.0,
                     device=None
                     ) -> Tuple[cpm_lib.CPM, dict, TrainOptimizer]:
    """A fresh He-initialized CPM (``cpm.init_cpm_params(seed)``) on
    ``device`` (default CUDA), its optimizer state and the optimizer:
    plain Adam at ``lr``, or with ``total_steps`` the warmup (5 %) →
    cosine decay (to lr/50) schedule behind global-norm clipping at
    ``clip_norm``."""
    cpm = cpm_lib.init_cpm_params(seed, cfg, device=device)
    opt = TrainOptimizer(lr, total_steps, warmup_frac, clip_norm)
    return cpm, opt.init(dict(cpm.named_parameters())), opt
