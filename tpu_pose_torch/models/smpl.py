"""SMPL body model in PyTorch (port of ``tpu_pose/models/smpl.py``):

    v = LBS(v_template + Σ β·shapedirs + Σ (R(θ)−I)·posedirs,
            J(β), θ, weights)

Every function is batched over one leading axis ``B`` (the JAX package's
``smpl_forward`` is single-body and ``vmap``-ed). Two precision tiers, as
in the JAX package: the fit tier follows torch's float32 matmul setting;
the exact tier (``precision="highest"``: final meshes, evaluation) runs
full float32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import numpy as np
import torch

from tpu_pose_torch.models.smpl_data import SMPLData
from tpu_pose_torch.utils.device import full_f32_matmul

EXACT_PRECISION = "highest"


class SMPLOutput(NamedTuple):
    vertices: torch.Tensor  # (B, V, 3) posed mesh vertices
    joints: torch.Tensor    # (B, J, 3) posed joint locations (kinematic)
    rotmats: torch.Tensor   # (B, J, 3, 3) per-joint local rotation matrices


def _precision_scope(precision):
    return (full_f32_matmul() if precision == EXACT_PRECISION
            else contextlib.nullcontext())


def rodrigues(r: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) → rotation matrices (..., 3, 3), through the
    quaternion q = [cos(θ/2), sin(θ/2)·axis]. The 1e-16 inside the sqrt
    keeps the gradient finite at θ = 0, where every fit starts."""
    theta = torch.sqrt((r * r).sum(-1, keepdim=True) + 1e-16)
    axis = r / theta
    half = 0.5 * theta
    w = torch.cos(half)[..., 0]
    xyz = torch.sin(half) * axis
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        dim=-1)
    row1 = torch.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        dim=-1)
    row2 = torch.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _rigid(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack rotation (..., 3, 3) + translation (..., 3) into (..., 4, 4)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(*R.shape[:-2], 1, 4, dtype=R.dtype, device=R.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


@functools.lru_cache(maxsize=None)
def _parent_index(parents: tuple, device: torch.device) -> torch.Tensor:
    # One copy per device and kintree: a host→device copy of a Python
    # list waits for the stream, and the chain runs inside the fit loop.
    return torch.tensor((0,) + parents[1:], dtype=torch.long, device=device)


def _world_transforms(rotmats: torch.Tensor, j_rest: torch.Tensor,
                      parents: np.ndarray) -> torch.Tensor:
    """(B, J, 4, 4) world transforms: the kinematic chain unrolled over
    the static, topologically sorted kintree (``parents[k] < k``)."""
    num_j = rotmats.shape[-3]
    parent_idx = tuple(int(p) for p in parents)
    # Local (bone) translations: joint k sits at j_rest[k] - j_rest[parent];
    # the root keeps j_rest[0].
    t_local = j_rest - j_rest.index_select(
        -2, _parent_index(parent_idx, j_rest.device))
    t_local = torch.cat([j_rest[..., :1, :], t_local[..., 1:, :]], dim=-2)
    local = _rigid(rotmats, t_local)
    worlds = [local[..., 0, :, :]]
    for k in range(1, num_j):
        # bmm, what ``@`` runs on (B, 4, 4) operands, named directly: an
        # export trace then skips matmul's shape logic, 23 times a chain.
        worlds.append(torch.bmm(worlds[parent_idx[k]], local[:, k]))
    return torch.stack(worlds, dim=-3)


def global_rigid_transform(rotmats: torch.Tensor, j_rest: torch.Tensor,
                           parents: np.ndarray):
    """Compose the kinematic chain.

    Args:
      rotmats (B, J, 3, 3) local joint rotations; j_rest (B, J, 3).
    Returns:
      joints_world (B, J, 3) and rel_transforms (B, J, 4, 4): world
      transforms with the rest pose removed — what LBS consumes.
    """
    world = _world_transforms(rotmats, j_rest, parents)
    # Remove the rest pose: subtract R_world·j_rest from the translation.
    corr = torch.einsum("...jab,...jb->...ja", world[..., :3, :3], j_rest)
    rel = torch.cat([world[..., :3, :3],
                     (world[..., :3, 3] - corr)[..., None]], dim=-1)
    rel = torch.cat([rel, world[..., 3:, :]], dim=-2)
    return world[..., :3, 3], rel


def smpl_forward(data: SMPLData, beta: torch.Tensor, theta: torch.Tensor,
                 precision=None) -> SMPLOutput:
    """Full SMPL forward, batched: beta (B, 10), theta (B, 72) or
    (B, 24, 3). Shape blend → rest joints → Rodrigues → pose blend →
    kinematic chain → LBS."""
    with _precision_scope(precision):
        num_j = data.parents.shape[0]
        theta = theta.reshape(theta.shape[0], num_j, 3)
        v_shaped = data.v_template + torch.einsum(
            "vcb,nb->nvc", data.shapedirs, beta)
        j_rest = torch.einsum("jv,nvc->njc", data.J_regressor, v_shaped)
        rotmats = rodrigues(theta)
        eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
        pose_feat = (rotmats[:, 1:] - eye).reshape(theta.shape[0], -1)
        v_posed = v_shaped + torch.einsum(
            "vcp,np->nvc", data.posedirs, pose_feat)
        joints_world, rel = global_rigid_transform(rotmats, j_rest,
                                                   data.parents)
        T = torch.einsum("vj,njab->nvab", data.weights, rel)
        verts = (torch.einsum("nvab,nvb->nva", T[..., :3, :3], v_posed)
                 + T[..., :3, 3])
    return SMPLOutput(vertices=verts, joints=joints_world, rotmats=rotmats)


# The JAX package's name for the batched forward (its smpl_forward is one
# body); here every function is batched.
smpl_forward_batch = smpl_forward


def smpl_joints(data: SMPLData, beta: torch.Tensor, theta: torch.Tensor,
                precision=None) -> torch.Tensor:
    """The posed joints of :func:`smpl_forward` (B, J, 3) without the
    6890-vertex blend shapes and skinning. Rest joints are linear in β
    (``J_regressor @ (v_template + shapedirs·β)``), so they come from the
    model's precomputed (J, 3) and (J, 3, 10) joint basis. This is what
    the fit energy runs each step."""
    with _precision_scope(precision):
        j_template, j_shapedirs = data.joint_basis
        num_j = data.parents.shape[0]
        j_rest = j_template + torch.einsum("jcb,nb->njc", j_shapedirs, beta)
        rotmats = rodrigues(theta.reshape(theta.shape[0], num_j, 3))
        world = _world_transforms(rotmats, j_rest, data.parents)
    return world[..., :3, 3]


def regress_joints(data: SMPLData, vertices: torch.Tensor,
                   precision=None) -> torch.Tensor:
    """Joints from posed vertices (B, V, 3) via the joint regressor."""
    with _precision_scope(precision):
        return torch.einsum("jv,nvc->njc", data.J_regressor, vertices)
