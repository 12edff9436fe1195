"""Hermetic synthetic pose data (port of ``tpu_pose/data/synthetic.py``).

- :func:`sample_poses` — seeded (θ, β) with bounded joint angles;
- :func:`make_examples` — frames rendered from SMPL: 3D joints → projected
  2D joints → a Gaussian-blob image (one blob per joint, its colour
  encoding the joint, so the image determines the pose) and Gaussian
  target heatmaps at stride resolution;
- :func:`cpm_train_batches` / :func:`eval_batches` — numpy batch
  iterators in the dict schemas of ``models/cpm_train.py`` and
  ``parallel/eval.py``.

The draws are numpy ``RandomState``, as in the JAX package, so θ and β
are bit-identical to its. The SMPL joints come from the port's
``smpl_forward_batch`` on the CPU in float32, where the JAX package runs
its jitted forward: the joints agree to float32 rounding, and a rendered
pixel may differ by one unit where a value lands on a rounding edge.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from tpu_pose_torch.models import joints as joints_lib
from tpu_pose_torch.models import smpl as smpl_lib
from tpu_pose_torch.ops import preprocess as pre
from tpu_pose_torch.utils.config import CPMConfig


def sample_poses(rng: np.random.RandomState, n: int,
                 pose_std: float = 0.25, shape_std: float = 0.8):
    """(θ (n, 72), β (n, 10)) with bounded articulation."""
    theta = rng.randn(n, 72).astype(np.float32) * pose_std
    theta[:, :3] = rng.randn(n, 3).astype(np.float32) * 0.1  # near-frontal
    beta = rng.randn(n, 10).astype(np.float32) * shape_std
    return theta, beta


def _smpl_joints_np(model, theta: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """Host-side SMPL joints: the batched forward on the CPU in float32
    (a model on another device is copied to the CPU first)."""
    if model.device.type != "cpu":
        model = model.to("cpu")
    with torch.no_grad():
        out = smpl_lib.smpl_forward_batch(
            model, torch.from_numpy(np.ascontiguousarray(beta, np.float32)),
            torch.from_numpy(np.ascontiguousarray(theta, np.float32)))
    return out.joints.numpy()


def gaussian_heatmaps(joints_px: np.ndarray, size: int, stride: int,
                      sigma: float = 3.0, bg: bool = True) -> np.ndarray:
    """CPM-style target belief maps: one Gaussian per joint at stride
    resolution (``sigma`` in stride cells) plus a background channel
    1 − max_j.

    Args: joints_px (P, 2) in input-frame pixels. Returns (H, H, P[+1]).
    """
    h = size // stride
    ys, xs = np.mgrid[0:h, 0:h].astype(np.float32)
    # Cell-corner convention (x = col·stride), as the decoders and
    # ops/preprocess.paint_heatmaps use.
    cx = xs * stride
    cy = ys * stride
    maps = []
    for (jx, jy) in joints_px:
        d2 = (cx - jx) ** 2 + (cy - jy) ** 2
        maps.append(np.exp(-d2 / (2.0 * sigma * sigma * stride * stride)))
    hm = np.stack(maps, axis=-1).astype(np.float32)
    if bg:
        hm = np.concatenate([hm, 1.0 - hm.max(-1, keepdims=True)], axis=-1)
    return hm


def render_blob_image(joints_px: np.ndarray, size: int,
                      sigma: float = 9.0) -> np.ndarray:
    """(size, size, 3) uint8 image: per-joint Gaussian blobs whose RGB
    encodes the joint index, so the image determines the 2D pose."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.zeros((size, size, 3), np.float32)
    p = len(joints_px)
    for j, (jx, jy) in enumerate(joints_px):
        g = np.exp(-((xs - jx) ** 2 + (ys - jy) ** 2) / (2 * sigma * sigma))
        # Joint-indexed colour on the RGB simplex.
        frac = j / max(p - 1, 1)
        color = np.array([1.0 - frac, frac, 0.25 + 0.75 * abs(0.5 - frac)])
        img += g[..., None] * color
    img = np.clip(img / max(img.max(), 1e-6), 0, 1)
    return (img * 255).astype(np.uint8)


def make_examples(model, n: int, cfg: CPMConfig = CPMConfig(),
                  seed: int = 0, heatmap_sigma: float = 3.0
                  ) -> Dict[str, np.ndarray]:
    """n frames of fully labelled synthetic data from ``model`` (an
    ``SMPLData``).

    Returns a dict: images (n, S, S, 3) uint8, heatmaps (n, h, h, P+1),
    joints2d (n, 14, 2) px, gt_joints3d (n, 24, 3), theta (n, 72),
    beta (n, 10).
    """
    rng = np.random.RandomState(seed)
    theta, beta = sample_poses(rng, n)
    return _examples_from_params(model, theta, beta, cfg, heatmap_sigma)


def make_video_examples(model, num_frames: int,
                        cfg: CPMConfig = CPMConfig(), seed: int = 0,
                        keyframe_every: int = 16,
                        **kw) -> Dict[str, np.ndarray]:
    """A smooth synthetic motion sequence: keyframe poses sampled as in
    :func:`sample_poses`, joined by a cosine ease, one body shape
    throughout. Same dict schema as :func:`make_examples`, in time
    order."""
    rng = np.random.RandomState(seed)
    n_keys = max(2, num_frames // keyframe_every + 2)
    k_theta, k_beta = sample_poses(rng, n_keys)
    beta = k_beta[0]                      # one body per sequence

    t = np.arange(num_frames, dtype=np.float64) / keyframe_every
    i0 = np.minimum(t.astype(np.int64), n_keys - 2)
    frac = t - i0
    w = (1.0 - np.cos(np.pi * frac)) / 2.0          # cosine ease
    theta = ((1.0 - w)[:, None] * k_theta[i0]
             + w[:, None] * k_theta[i0 + 1]).astype(np.float32)

    return _examples_from_params(
        model, theta, np.tile(beta, (num_frames, 1)), cfg, **kw)


def _examples_from_params(model, theta: np.ndarray, beta: np.ndarray,
                          cfg: CPMConfig, heatmap_sigma: float = 3.0
                          ) -> Dict[str, np.ndarray]:
    """Shared renderer: (θ, β) arrays → the labelled example dict."""
    n = len(theta)
    j3d = _smpl_joints_np(model, theta, beta)
    j3d14 = j3d[:, joints_lib.CPM_TO_SMPL]
    size = cfg.input_size
    extent = np.abs(j3d14 - j3d14.mean(1, keepdims=True)).max(axis=(1, 2))
    scale = 0.8 / np.maximum(extent, 1e-3)
    images = np.zeros((n, size, size, 3), np.uint8)
    heatmaps = np.zeros((n, size // cfg.stride, size // cfg.stride,
                         cfg.num_joints + 1), np.float32)
    joints2d = np.zeros((n, len(joints_lib.CPM_TO_SMPL), 2), np.float32)
    for i in range(n):
        centered = j3d14[i] - j3d14[i].mean(0)
        norm2d = centered[:, :2] * scale[i]
        px = (norm2d + 1.0) * (size / 2.0)
        joints2d[i] = px
        images[i] = render_blob_image(px, size)
        heatmaps[i] = gaussian_heatmaps(px, size, cfg.stride, heatmap_sigma)
    return {
        "images": images, "heatmaps": heatmaps, "joints2d": joints2d,
        "gt_joints3d": j3d.astype(np.float32),
        "theta": theta, "beta": beta,
    }


def cpm_train_batches(model, batch_size: int, num_batches: int,
                      cfg: CPMConfig = CPMConfig(), seed: int = 0,
                      raw_images: bool = False
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Batches for ``models/cpm_train.py``: images, center maps, target
    heatmaps. ``raw_images=True`` yields uint8 images (4× fewer bytes to
    the device; the train step normalizes them); otherwise x/256 − 0.5 in
    float32."""
    cmap = pre.gaussian_center_map(cfg.input_size, cfg.center_sigma,
                                   device="cpu").numpy()
    for b in range(num_batches):
        ex = make_examples(model, batch_size, cfg, seed=seed * 9973 + b)
        yield {
            "images": (ex["images"] if raw_images
                       else ex["images"].astype(np.float32) / 256.0 - 0.5),
            "center_maps": np.broadcast_to(
                cmap, (batch_size, *cmap.shape)).copy(),
            "heatmaps": ex["heatmaps"],
        }


def eval_batches(model, batch_size: int, num_batches: int,
                 cfg: CPMConfig = CPMConfig(), seed: int = 1000
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Batches for ``parallel/eval.py``: uint8 images, ground-truth 3D
    joints (SMPL-24) and 2D joints (CPM-14, for the PCKh accumulator)."""
    for b in range(num_batches):
        ex = make_examples(model, batch_size, cfg, seed=seed * 9973 + b)
        yield {"images": ex["images"], "gt_joints3d": ex["gt_joints3d"],
               "gt_joints2d": ex["joints2d"]}
