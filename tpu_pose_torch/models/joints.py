"""CPM↔SMPL joint correspondence and the external detectors' joint maps
(port of ``tpu_pose/models/joints.py``)."""

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

# SMPL 24-joint names (standard numbering).
SMPL_JOINT_NAMES = [
    "pelvis", "l_hip", "r_hip", "spine1", "l_knee", "r_knee", "spine2",
    "l_ankle", "r_ankle", "spine3", "l_foot", "r_foot", "neck", "l_collar",
    "r_collar", "head", "l_shoulder", "r_shoulder", "l_elbow", "r_elbow",
    "l_wrist", "r_wrist", "l_hand", "r_hand",
]

# CPM joint index → SMPL joint index (LSP↔SMPL convention of the SMPLify
# family; 'head' maps to the SMPL head joint).
CPM_TO_SMPL = np.array(
    [15, 12, 17, 19, 21, 16, 18, 20, 2, 5, 8, 1, 4, 7], dtype=np.int32)

# Per-joint COCO OKS sigmas mapped onto the CPM-14 order (head ≈ nose,
# neck ≈ the shoulders' sigma), for ``utils/metrics.oks_np``.
CPM_OKS_SIGMA = np.array(
    [0.026, 0.079, 0.079, 0.072, 0.062, 0.079, 0.072, 0.062,
     0.107, 0.087, 0.089, 0.107, 0.087, 0.089], dtype=np.float32)

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
    return joints3d_smpl24[..., CPM_TO_SMPL, :]


# COCO 17-keypoint convention (0 nose, 1/2 l/r eye, 3/4 l/r ear,
# 5/6 l/r shoulder, 7/8 l/r elbow, 9/10 l/r wrist, 11/12 l/r hip,
# 13/14 l/r knee, 15/16 l/r ankle), what most external detectors emit.
# Direct CPM slot → COCO id correspondences; CPM's head and neck are
# synthesized (see :func:`coco_to_cpm`).
COCO_KEYPOINT_NAMES = [
    "nose", "l_eye", "r_eye", "l_ear", "r_ear", "l_shoulder",
    "r_shoulder", "l_elbow", "r_elbow", "l_wrist", "r_wrist", "l_hip",
    "r_hip", "l_knee", "r_knee", "l_ankle", "r_ankle",
]
COCO_TO_CPM_DIRECT = {2: 6, 3: 8, 4: 10, 5: 5, 6: 7, 7: 9,
                      8: 12, 9: 14, 10: 16, 11: 11, 12: 13, 13: 15}
# CPM slot → COCO id for every slot: head ≈ nose (0); the neck slot's
# entry is overwritten with the shoulder midpoint.
_COCO_GATHER = np.array([0, 0] + [COCO_TO_CPM_DIRECT[i]
                                  for i in range(2, 14)])

# MPII-16 id → CPM-14 slot (a pure permutation: MPII carries every CPM
# joint; pelvis 6 and thorax 7 are dropped).
MPII16_TO_CPM = np.array([9, 8, 12, 11, 10, 13, 14, 15, 2, 1, 0, 3, 4, 5],
                         dtype=np.int32)


def _check_detector_joints(joints, conf, n: int, what: str) -> None:
    if (tuple(joints.shape[-2:]) != (n, 2)
            or tuple(conf.shape) != tuple(joints.shape[:-1])):
        raise ValueError(
            f"{what} takes (..., {n}, 2) joints with matching (..., {n}) "
            f"conf; got {tuple(joints.shape)}, {tuple(conf.shape)}")


def coco_to_cpm(joints17, conf17):
    """COCO-17 detector output → the CPM-14 convention that ``fit_smpl``
    and the ``/fit`` serving route take.

    The two CPM joints COCO lacks are synthesized: neck = the shoulders'
    midpoint with conf = min(shoulders); head ≈ nose (about half a head
    low, a documented approximation). Eyes and ears are dropped. Numpy
    arrays in, numpy out; tensors in, tensors out; any leading batch
    shape: (..., 17, 2), (..., 17) → ((..., 14, 2), (..., 14))."""
    if not isinstance(joints17, torch.Tensor):
        joints17, conf17 = np.asarray(joints17), np.asarray(conf17)
    _check_detector_joints(joints17, conf17, 17, "coco_to_cpm")
    neck = (joints17[..., 5, :] + joints17[..., 6, :]) / 2.0
    if isinstance(joints17, torch.Tensor):
        conf17 = torch.as_tensor(conf17, device=joints17.device)
        idx = torch.as_tensor(_COCO_GATHER, device=joints17.device)
        j = joints17.index_select(-2, idx).clone()
        c = conf17.index_select(-1, idx).clone()
        neck_c = torch.minimum(conf17[..., 5], conf17[..., 6])
    else:
        j = joints17[..., _COCO_GATHER, :].copy()
        c = conf17[..., _COCO_GATHER].copy()
        neck_c = np.minimum(conf17[..., 5], conf17[..., 6])
    j[..., 1, :] = neck
    c[..., 1] = neck_c
    return j, c


def mpii_to_cpm(joints16, conf16):
    """MPII-16 detector output → the CPM-14 convention that ``fit_smpl``
    and the ``/fit`` serving route take: the pure :data:`MPII16_TO_CPM`
    permutation (MPII annotates head top and upper neck; pelvis and
    thorax are dropped). Numpy or tensors, any leading batch shape:
    (..., 16, 2), (..., 16) → ((..., 14, 2), (..., 14))."""
    if not isinstance(joints16, torch.Tensor):
        joints16, conf16 = np.asarray(joints16), np.asarray(conf16)
        _check_detector_joints(joints16, conf16, 16, "mpii_to_cpm")
        return joints16[..., MPII16_TO_CPM, :], conf16[..., MPII16_TO_CPM]
    conf16 = torch.as_tensor(conf16, device=joints16.device)
    _check_detector_joints(joints16, conf16, 16, "mpii_to_cpm")
    idx = torch.as_tensor(MPII16_TO_CPM, dtype=torch.long,
                          device=joints16.device)
    return joints16.index_select(-2, idx), conf16.index_select(-1, idx)


# Human3.6M 17-joint evaluation convention.
H36M_JOINT_NAMES = [
    "pelvis", "r_hip", "r_knee", "r_ankle", "l_hip", "l_knee", "l_ankle",
    "spine", "neck", "head", "site", "l_shoulder", "l_elbow", "l_wrist",
    "r_shoulder", "r_elbow", "r_wrist",
]
# The SMPL joints closest to the H3.6M convention (spine → spine2,
# head and site → head).
H36M_TO_SMPL = np.array(
    [0, 2, 5, 8, 1, 4, 7, 6, 12, 15, 15, 16, 18, 20, 17, 19, 21],
    dtype=np.int32)


def select_h36m_joints(joints3d_smpl24):
    """(..., 24, 3) SMPL joints → (..., 17, 3) in the H3.6M order, for a
    tensor (on its device) or a numpy array."""
    if isinstance(joints3d_smpl24, torch.Tensor):
        idx = torch.as_tensor(H36M_TO_SMPL, dtype=torch.long,
                              device=joints3d_smpl24.device)
        return joints3d_smpl24.index_select(-2, idx)
    return np.asarray(joints3d_smpl24)[..., H36M_TO_SMPL, :]
