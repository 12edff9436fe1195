"""Frozen config dataclasses — the port's copy of
``tpu_pose/utils/config.py`` (same fields, same defaults).

The one deliberate difference is ``CPMConfig.decode_impl``, whose values
name this package's decode implementations (see the field's comment).
Configs stay frozen and hashable so they can key caches.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Camera-model names, mirrored from models/camera.py (string constants so
# this module stays import-cycle-free).
WEAK_PERSPECTIVE = "weak_perspective"
PERSPECTIVE = "perspective"


@dataclasses.dataclass(frozen=True)
class CPMConfig:
    """Convolutional Pose Machines architecture (arXiv:1602.00134 §3).
    Defaults are the MPII body model family: 368×368 input, stride-8
    46×46 belief maps, 14 parts + background, 6 stages."""
    num_joints: int = 14          # body parts P (output channels = P + 1)
    num_stages: int = 6
    input_size: int = 368
    stride: int = 8
    features: int = 128           # trunk conv width
    stage1_head_width: int = 512
    refine_width: int = 128
    center_sigma: float = 21.0    # px, Gaussian center-map std (CPM default)
    use_center_map: bool = True
    # Conv compute dtype; parameters and belief outputs stay float32.
    compute_dtype: str = "bfloat16"
    # Decode implementation. "auto" and "cuda" (JAX "auto" and "pallas"):
    # the hand-written CUDA soft-argmax kernel's wrapper, which launches
    # the kernel on a CUDA tensor and runs the plain PyTorch version on a
    # CPU tensor. "torch" forces the plain version (JAX "xla").
    decode_impl: str = "auto"
    # Share the full-resolution conv trunk between the stage-1 belief
    # path and the refinement stages. False (default) is the Caffe
    # reference layer layout with two separate 9×9 trunks.
    share_trunk: bool = False

    @property
    def heatmap_size(self) -> int:
        return self.input_size // self.stride

    @property
    def out_channels(self) -> int:
        return self.num_joints + 1


@dataclasses.dataclass(frozen=True)
class StageConfig:
    """One phase of the staged SMPLify schedule."""
    iters: int = 100
    lr: float = 0.02
    opt_pose: bool = True        # optimize body pose θ[3:]
    opt_global: bool = True      # optimize global orientation θ[:3]
    opt_shape: bool = True       # optimize β
    opt_cam: bool = True         # optimize camera params
    # Per-stage prior weights (SMPLify anneals these across stages).
    w_pose_prior: float = 4.0
    w_shape_prior: float = 5.0
    w_angle_prior: float = 15.0
    # Capsule self-interpenetration penalty (fitting/interpenetration.py);
    # off by default.
    w_interpenetration: float = 0.0


# Staged schedules, SMPLify-style: camera + global orientation first, then
# annealed joint optimization. Same constants as the JAX package.
DEFAULT_STAGES: Tuple[StageConfig, ...] = (
    # Stage A: camera + global orientation only.
    StageConfig(iters=40, lr=0.08, opt_pose=False, opt_shape=False,
                opt_global=True, opt_cam=True,
                w_pose_prior=0.0, w_shape_prior=0.0, w_angle_prior=0.0),
    # Stages B..C: everything, with annealed pose-prior weight.
    StageConfig(iters=60, lr=0.02, w_pose_prior=16.0, w_shape_prior=10.0),
    StageConfig(iters=40, lr=0.008, w_pose_prior=4.0, w_shape_prior=5.0),
)

THOROUGH_STAGES: Tuple[StageConfig, ...] = (
    StageConfig(iters=80, lr=0.05, opt_pose=False, opt_shape=False,
                opt_global=True, opt_cam=True,
                w_pose_prior=0.0, w_shape_prior=0.0, w_angle_prior=0.0),
    StageConfig(iters=80, lr=0.02, w_pose_prior=16.0, w_shape_prior=10.0),
    StageConfig(iters=80, lr=0.01, w_pose_prior=8.0, w_shape_prior=6.0),
    StageConfig(iters=120, lr=0.005, w_pose_prior=4.0, w_shape_prior=5.0),
)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """SMPLify-style fit configuration."""
    stages: Tuple[StageConfig, ...] = DEFAULT_STAGES
    camera_model: str = WEAK_PERSPECTIVE
    # Perspective focal length IN PIXELS (f≈5000 px for a 368 crop,
    # principal point at the crop center); converted into the fit's
    # normalized frame by fitting/energy.perspective_kwargs.
    focal: float = 5000.0         # perspective only
    img_size: int = 368           # pixel frame of the 2D observations
    gmof_sigma: float = 100.0     # GMoF robustifier width, in PIXELS
    # Observations are normalized to [-1, 1] inside the fit so one Adam lr
    # serves pose (radians), shape (σ-units) and camera.
    normalize_obs: bool = True
    optimizer: str = "adam"       # "adam" | "lbfgs" (fitting/lbfgs.py)
    num_betas: int = 10
    num_joints_smpl: int = 24
    keep_history: bool = False    # return per-iteration energy trace
    # SMPL matmul precision inside the fit energy: "default" lets the
    # fit tier follow torch's float32 matmul setting; "highest" forces
    # full float32 (TF32 off) for the fit too.
    smpl_precision: str = "default"
    # Video-fit weights (fitting/temporal.py): the smoothness terms, in
    # the priors' scaled units, and the Viterbi yaw-selection weight.
    video_smooth_theta: float = 1000.0
    video_smooth_cam: float = 1000.0
    video_select_weight: float = 0.1
    # Global-yaw init: "limb_order" = closed-form facing estimate from the
    # 2D left/right limb ordering (fitting/fit.yaw_from_limb_order);
    # "zero" = mean-pose init.
    yaw_init: str = "limb_order"


@dataclasses.dataclass(frozen=True)
class FrontEndConfig:
    """PoseEstimator front-end knobs in one hashable place (same fields
    and defaults as the JAX package; the semantics are those of
    ``models/cpm.estimate_2d_from_images`` and ``api.PoseEstimator``)."""
    fit_restarts: int = 1
    refine_center: bool = False
    refine_scale: bool = False
    scale_from_refined: bool = False
    flip_tta: bool = False
    scale_tta: Tuple[float, ...] = ()
    letterbox: bool = False
    int8_min_batch: int = 16
    cpm_microbatch: int = 0
