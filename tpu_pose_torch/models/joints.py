"""CPM↔SMPL joint correspondence (port of ``tpu_pose/models/joints.py``)."""

from __future__ import annotations

import functools

import numpy as np
import torch

# CPM / MPII 14-joint order (detector output channels 0..13; channel 14 is
# background in the heatmap tensor).
CPM_JOINT_NAMES = [
    "head", "neck", "r_shoulder", "r_elbow", "r_wrist", "l_shoulder",
    "l_elbow", "l_wrist", "r_hip", "r_knee", "r_ankle", "l_hip", "l_knee",
    "l_ankle",
]
NUM_CPM_JOINTS = len(CPM_JOINT_NAMES)

# CPM joint index → SMPL joint index (LSP↔SMPL convention of the SMPLify
# family; 'head' maps to the SMPL head joint).
CPM_TO_SMPL = np.array(
    [15, 12, 17, 19, 21, 16, 18, 20, 2, 5, 8, 1, 4, 7], dtype=np.int32)

# Left↔right channel permutation under a horizontal image flip.
CPM_FLIP_PERM = np.array(
    [0, 1, 5, 6, 7, 2, 3, 4, 11, 12, 13, 8, 9, 10], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _cpm_to_smpl_index(device: torch.device) -> torch.Tensor:
    # One copy per device: a host→device copy of a pageable array waits
    # for the stream, and select_smpl_joints runs inside the fit loop.
    return torch.as_tensor(CPM_TO_SMPL, dtype=torch.long, device=device)


@functools.lru_cache(maxsize=None)
def cpm_flip_index(device: torch.device) -> torch.Tensor:
    """:data:`CPM_FLIP_PERM` as a long tensor on ``device``, one copy per
    device (the flip-TTA merge indexes with it on the card)."""
    return torch.as_tensor(CPM_FLIP_PERM, dtype=torch.long, device=device)


def select_smpl_joints(joints3d_smpl24: torch.Tensor) -> torch.Tensor:
    """(..., 24, 3) SMPL joints → (..., 14, 3) in CPM order."""
    return joints3d_smpl24.index_select(
        -2, _cpm_to_smpl_index(joints3d_smpl24.device))
