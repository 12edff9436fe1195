"""Capsule self-interpenetration penalty, the SMPLify objective's fourth
term (port of ``tpu_pose/fitting/interpenetration.py``). Off by default
(``StageConfig.w_interpenetration = 0``).

- Bones come from the static kintree (``SMPLData.parents``), so the
  sphere endpoints, fractions and the non-adjacent pair list are numpy
  arrays built once, as in the JAX package.
- Per-bone radii come from the model tensors: the mean distance of each
  bone's dominant-LBS vertices to the rest bone axis, floored at
  ``min_radius``. :func:`build_capsule_spec` runs once per fit, outside
  the optimization loop.
- The penalty calibrates itself to the rest pose: each sphere pair's hinge
  threshold is reduced by its rest-pose overlap, so structurally touching
  parts score zero at rest and only new overlap is penalized.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from tpu_pose_torch.models.smpl_data import SMPLData


@dataclasses.dataclass(frozen=True, eq=False)
class CapsuleSpec:
    """Static topology (numpy) and the model's geometry (tensors on the
    model's device) for the penalty: per sphere its bone endpoints into
    the 24 joints, interpolation fraction and radius; per non-adjacent
    sphere pair its indices and hinge threshold r_i + r_j − rest overlap."""
    sphere_a: np.ndarray     # (S,) int32
    sphere_b: np.ndarray     # (S,) int32
    frac: np.ndarray         # (S,) float32
    radius: torch.Tensor     # (S,)
    pair_i: np.ndarray       # (M,) int32
    pair_j: np.ndarray       # (M,) int32
    threshold: torch.Tensor  # (M,)

    @functools.cached_property
    def _device_index(self):
        """The static arrays as tensors on the radius's device, copied
        once: a host→device copy inside the fit loop would wait for the
        stream."""
        dev = self.radius.device

        def idx(a):
            return torch.as_tensor(a, dtype=torch.long, device=dev)

        return (idx(self.sphere_a), idx(self.sphere_b),
                torch.as_tensor(self.frac, device=dev)[:, None],
                idx(self.pair_i), idx(self.pair_j))


def _bones(parents: np.ndarray) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(p), int(c)) for c, p in enumerate(np.asarray(parents))
                 if p >= 0)


def _segment_distance(points: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Distance of each point (N, 3) to each segment a→b, a and b
    (..., 3): (..., N)."""
    ab = b - a
    denom = torch.clamp_min((ab * ab).sum(-1), 1e-9)
    t = torch.clamp(((points - a[..., None, :]) * ab[..., None, :]).sum(-1)
                    / denom[..., None], 0.0, 1.0)
    proj = a[..., None, :] + t[..., None] * ab[..., None, :]
    return torch.linalg.vector_norm(points - proj, dim=-1)


def sphere_centers(joints24: torch.Tensor, spec: CapsuleSpec
                   ) -> torch.Tensor:
    """(..., 24, 3) posed joints → (..., S, 3) sphere centers (gathers and
    a lerp: the only per-step geometry work)."""
    ia, ib, f, _, _ = spec._device_index
    a = joints24.index_select(-2, ia)
    b = joints24.index_select(-2, ib)
    return a * (1.0 - f) + b * f


def build_capsule_spec(model: SMPLData, spheres_per_bone: int = 3,
                       min_radius: float = 0.015) -> CapsuleSpec:
    """The capsule approximation of ``model`` (call once per fit, before
    the optimization loop).

    Radii use the rest mesh (β = 0). The rest joints are
    ``J_regressor @ v_template`` in full float32 (TF32 off): a TF32 rest
    joint would move every threshold. ``torch.argmax`` returns the first
    maximum, as ``jnp.argmax`` does."""
    parents = np.asarray(model.parents)
    bones = _bones(parents)
    n_b = len(bones)
    rest_j = model.joint_basis[0]                              # (24, 3)
    assign = torch.argmax(model.weights, dim=1)                # (6890,)
    par = torch.as_tensor([p for p, _ in bones], device=rest_j.device)
    chi = torch.as_tensor([c for _, c in bones], device=rest_j.device)
    d = _segment_distance(model.v_template, rest_j[par], rest_j[chi])
    mask = (assign[None, :] == chi[:, None]).to(model.v_template.dtype)
    radii_b = torch.clamp_min(
        (d * mask).sum(-1) / torch.clamp_min(mask.sum(-1), 1.0), min_radius)

    s = int(spheres_per_bone)
    fracs = (np.arange(s, dtype=np.float32) + 0.5) / s
    sphere_a = np.repeat([p for p, _ in bones], s).astype(np.int32)
    sphere_b = np.repeat([c for _, c in bones], s).astype(np.int32)
    frac = np.tile(fracs, n_b)
    radius = radii_b.repeat_interleave(s)

    # Non-adjacent bone pairs (no shared joint).
    pair_i, pair_j = [], []
    for b1 in range(n_b):
        j1 = set(bones[b1])
        for b2 in range(b1 + 1, n_b):
            if j1 & set(bones[b2]):
                continue
            for s1 in range(s):
                for s2 in range(s):
                    pair_i.append(b1 * s + s1)
                    pair_j.append(b2 * s + s2)
    pair_i = np.asarray(pair_i, np.int32)
    pair_j = np.asarray(pair_j, np.int32)

    # Rest-pose calibration: threshold = r_i + r_j − rest overlap, so the
    # rest pose scores ~0 and only new overlap is penalized.
    pi = torch.as_tensor(pair_i, dtype=torch.long, device=radius.device)
    pj = torch.as_tensor(pair_j, dtype=torch.long, device=radius.device)
    spec0 = CapsuleSpec(sphere_a, sphere_b, frac, radius, pair_i, pair_j,
                        threshold=radius[pi] + radius[pj])
    centers0 = sphere_centers(rest_j, spec0)
    d0 = torch.linalg.vector_norm(centers0[pi] - centers0[pj], dim=-1)
    rest_overlap = torch.clamp_min(spec0.threshold - d0, 0.0)
    return dataclasses.replace(spec0,
                               threshold=spec0.threshold - rest_overlap)


def interpenetration_penalty(joints24: torch.Tensor, spec: CapsuleSpec
                             ) -> torch.Tensor:
    """Σ hinge(threshold − d)² over the pair list, in m², batched over
    leading axes: (..., 24, 3) → (...).

    The distance is ``sqrt(‖Δ‖² + ε²)`` (ε = 0.1 mm): a plain norm has a
    NaN gradient at exactly coincident centers, which one collapsed
    sample would spread to its whole fit."""
    _, _, _, pi, pj = spec._device_index
    centers = sphere_centers(joints24, spec)
    diff = centers.index_select(-2, pi) - centers.index_select(-2, pj)
    d = torch.sqrt((diff * diff).sum(-1) + 1e-8)
    overlap = torch.clamp_min(spec.threshold - d, 0.0)
    return (overlap * overlap).sum(-1)
