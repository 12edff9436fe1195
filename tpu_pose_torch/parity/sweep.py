"""FitConfig auto-sweep: search the port's fit constants to match a
reference pipeline's outputs (port of ``tpu_pose/parity/sweep.py``).

Use case: the reference's fit schedule / λ-weights are UNKNOWN. Given
only its fitted outputs on probe frames, greedy coordinate descent over
the config-visible constants finds the FitConfig that minimizes the
fitted-joints MPJPE gap. The same call works verbatim against the real
reference the day it appears — pass its outputs as ``reference_out``.

Every candidate config is one eager batched fit on ``device``, so the
sweep's cost is its fits: axes hold a handful of candidates each and the
probe batch stays small.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpu_pose_torch.models.smpl_data import SMPLData
from tpu_pose_torch.parity import harness
from tpu_pose_torch.utils.config import FitConfig, StageConfig


def _scale_stages(stages: Sequence[StageConfig], *, iters: float = 1.0,
                  lr: float = 1.0, w_pose: float = 1.0, w_shape: float = 1.0,
                  w_angle: float = 1.0) -> Tuple[StageConfig, ...]:
    return tuple(
        dataclasses.replace(
            s, iters=max(1, int(round(s.iters * iters))), lr=s.lr * lr,
            w_pose_prior=s.w_pose_prior * w_pose,
            w_shape_prior=s.w_shape_prior * w_shape,
            w_angle_prior=s.w_angle_prior * w_angle)
        for s in stages)


# Each axis: name → (candidate values, config-transformer). Multiplicative
# axes compose; the transformer rebuilds a full FitConfig from the base.
def default_axes() -> Dict[str, Tuple[list, Callable]]:
    return {
        "optimizer": (
            ["adam", "lbfgs"],
            lambda cfg, v: dataclasses.replace(cfg, optimizer=v)),
        "gmof_sigma": (
            [25.0, 50.0, 100.0, 200.0],
            lambda cfg, v: dataclasses.replace(cfg, gmof_sigma=v)),
        "iters_scale": (
            [1.0, 2.0, 4.0],
            lambda cfg, v: dataclasses.replace(
                cfg, stages=_scale_stages(cfg.stages, iters=v))),
        "lr_scale": (
            [0.5, 1.0, 2.0],
            lambda cfg, v: dataclasses.replace(
                cfg, stages=_scale_stages(cfg.stages, lr=v))),
        "w_pose_scale": (
            [0.25, 1.0, 4.0],
            lambda cfg, v: dataclasses.replace(
                cfg, stages=_scale_stages(cfg.stages, w_pose=v))),
        "w_shape_scale": (
            [0.25, 1.0, 4.0],
            lambda cfg, v: dataclasses.replace(
                cfg, stages=_scale_stages(cfg.stages, w_shape=v))),
        "w_angle_scale": (
            [0.0, 1.0, 4.0],
            lambda cfg, v: dataclasses.replace(
                cfg, stages=_scale_stages(cfg.stages, w_angle=v))),
    }


def auto_sweep(
    model: SMPLData,
    reference_out: dict,          # {'joints3d': (B,24,3), ...} from the ref
    joints2d_px: np.ndarray,      # (B, 14, 2) the SAME probe inputs
    conf: np.ndarray,             # (B, 14)
    base_cfg: FitConfig = FitConfig(),
    prior: Any = None,
    axes: Optional[Dict] = None,
    passes: int = 2,
    log: Callable[[str], None] = lambda s: None,
    device=None,
) -> dict:
    """Greedy coordinate descent over config axes, each candidate fitted
    on ``device`` (None: the GPU).

    Returns dict with the best config (as kwargs + stage scales), the gap
    trajectory, and per-eval history. Score = mean root-aligned MPJPE (mm)
    between our fitted joints and ``reference_out['joints3d']``.
    """
    axes = dict(axes or default_axes())
    # Neutral start = base_cfg exactly: absolute-valued axes start at the
    # base config's value, multiplicative (*_scale) axes at 1.0.
    neutral = {"optimizer": base_cfg.optimizer,
               "gmof_sigma": base_cfg.gmof_sigma}
    setting = {name: neutral.get(name, 1.0) for name in axes}

    def build(s: dict) -> FitConfig:
        cfg = base_cfg
        for name, value in s.items():
            cfg = axes[name][1](cfg, value)
        return cfg

    cache: Dict[tuple, float] = {}
    history: List[dict] = []

    def score(s: dict) -> float:
        key = tuple(sorted(s.items()))
        if key in cache:
            return cache[key]
        t0 = time.time()
        ours = harness.run_our_fit(model, joints2d_px, conf, build(s),
                                   prior=prior, device=device)
        gap = harness.fit_gap(ours, reference_out)["mpjpe_gap_mm_mean"]
        cache[key] = gap
        history.append({"setting": dict(s), "gap_mm": gap,
                        "seconds": round(time.time() - t0, 2)})
        log(f"  {s} -> {gap:.3f} mm")
        return gap

    best = score(setting)
    trajectory = [best]
    for p in range(passes):
        improved = False
        for name, (values, _) in axes.items():
            cur = setting[name]
            for v in values:
                if v == cur:
                    continue
                trial = dict(setting, **{name: v})
                g = score(trial)
                if g < best - 1e-9:
                    best, setting, improved = g, trial, True
            log(f"pass {p + 1} axis {name}: best {best:.3f} mm "
                f"@ {setting[name]}")
        trajectory.append(best)
        if not improved:
            break

    best_cfg = build(setting)
    return {
        "best_gap_mm": best,
        "best_setting": setting,
        "best_config": {
            "optimizer": best_cfg.optimizer,
            "gmof_sigma": best_cfg.gmof_sigma,
            "camera_model": best_cfg.camera_model,
            "stages": [dataclasses.asdict(s) for s in best_cfg.stages],
        },
        "trajectory_mm": trajectory,
        "evals": len(cache),
        "history": history,
    }


def save_report(path: str, report: dict) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
