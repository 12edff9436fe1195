"""Parity measurement: stagewise deltas + end-to-end fit gap between the
port and a reference-style pipeline (port of
``tpu_pose/parity/harness.py``).

Two levels:

- :func:`stage_parity` — pairwise deltas on every pipeline stage that has
  a closed-form answer (SMPL forward, decode, projection, energy value).
  These must agree to numerical precision regardless of optimizer
  behavior; a mismatch localizes a semantic bug to one stage.
- :func:`fit_gap` — the BASELINE north-star number: MPJPE between the two
  pipelines' FITTED 3D joints on identical 2D inputs.
- :func:`certify` — one call: clean synthetic observations, matched
  constants, same init → reports the achieved gap against the ≤1 mm
  target.

The port's side runs on ``device`` (the GPU unless the caller passes
another); the reference side is any object with the
:class:`~tpu_pose_torch.parity.oracle.OraclePipeline` interface
(``fit_batch(joints2d_px, conf, init=None) → dict``), by default the
float64 host oracle. Arrays cross the boundary as numpy.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from tpu_pose_torch.fitting import fit as fit_lib
from tpu_pose_torch.fitting.energy import fit_energy
from tpu_pose_torch.models import camera as camera_lib
from tpu_pose_torch.models import joints as joints_lib
from tpu_pose_torch.models import smpl as smpl_lib
from tpu_pose_torch.models.smpl_data import SMPLData
from tpu_pose_torch.ops import softargmax as decode_lib
from tpu_pose_torch.parity import oracle as oracle_lib
from tpu_pose_torch.utils.config import FitConfig, StageConfig
from tpu_pose_torch.utils.device import resolve_device


def _f32(x, device) -> torch.Tensor:
    """A float32 tensor of ``x`` (numpy or a tensor) on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    return x.detach().to(device, torch.float32)


def _on(model: SMPLData, prior: Any, device):
    """``device`` resolved (None: the GPU), with the model and the prior
    there."""
    device = resolve_device(device)
    if model.device.type != device.type or (
            device.index is not None and model.device != device):
        model = model.to(device)
    return device, model, (None if prior is None else prior.to(device))


def oracle_gmm(prior: Any) -> Optional[dict]:
    """The oracle's GMM dict of a GMM prior's arrays; None for another
    prior (the oracle then uses its L2-to-zero pose prior)."""
    if prior is None or not hasattr(prior, "precisions"):
        return None
    return {k: getattr(prior, k)
            for k in ("means", "precisions", "log_consts")}


def _our_joints3d(model: SMPLData, theta, beta) -> np.ndarray:
    """(B, 24, 3) joints of the port's SMPL at the exact tier."""
    with torch.no_grad():
        out = smpl_lib.smpl_forward_batch(
            model, _f32(beta, model.device), _f32(theta, model.device),
            precision=smpl_lib.EXACT_PRECISION)
    return out.joints.cpu().numpy()


def root_aligned_mpjpe_mm(a_joints: np.ndarray, b_joints: np.ndarray,
                          root: int = 0) -> np.ndarray:
    """(B,J,3)×2 → (B,) root-aligned MPJPE in millimeters (model units
    assumed meters, as in the real SMPL)."""
    a = a_joints - a_joints[:, root: root + 1]
    b = b_joints - b_joints[:, root: root + 1]
    return 1000.0 * np.linalg.norm(a - b, axis=-1).mean(-1)


def stage_parity(model: SMPLData, pipe: oracle_lib.OraclePipeline,
                 fit_cfg: FitConfig, prior: Any = None,
                 seed: int = 0, device=None) -> dict:
    """Closed-form stage deltas (no optimization involved)."""
    device, model, prior = _on(model, prior, device)
    f64 = torch.float64
    rng = np.random.RandomState(seed)
    report = {}

    # SMPL forward: the port's exact tier vs the oracle's float64 graph.
    theta = 0.3 * rng.randn(72)
    beta = 0.5 * rng.randn(10)
    with torch.no_grad():
        ours = smpl_lib.smpl_forward(
            model, _f32(beta, device)[None], _f32(theta, device)[None],
            precision=smpl_lib.EXACT_PRECISION)
        tverts, tjoints = pipe._smpl_torch(
            torch.tensor(beta, dtype=f64), torch.tensor(theta, dtype=f64))
    report["smpl_verts_max_m"] = float(
        np.abs(ours.vertices[0].cpu().numpy() - tverts.numpy()).max())
    report["smpl_joints_max_m"] = float(
        np.abs(ours.joints[0].cpu().numpy() - tjoints.numpy()).max())

    # Decode: the port's hard argmax vs the oracle's host numpy argmax.
    hm = rng.rand(3, 12, 12, 15).astype(np.float32)
    j_ours, c_ours = decode_lib.hard_argmax(_f32(hm, device),
                                            stride=pipe.cfg.stride)
    j_ref, c_ref = oracle_lib.decode_hard_argmax(hm, stride=pipe.cfg.stride)
    report["decode_max_px"] = float(
        np.abs(j_ours.cpu().numpy() - j_ref).max())
    report["decode_conf_max"] = float(
        np.abs(c_ours.cpu().numpy() - c_ref).max())

    # Projection: ours (normalized frame → px) vs the oracle (px).
    j3d = rng.randn(14, 3) * 0.4
    if fit_cfg.camera_model == camera_lib.WEAK_PERSPECTIVE:
        cam = np.array([1.3, 0.05, -0.1])
        ours_norm = camera_lib.weak_perspective_project(
            _f32(j3d, device), _f32(cam, device))
        ours_px = (ours_norm.cpu().numpy() + 1.0) * (fit_cfg.img_size / 2.0)
    else:
        cam = np.array([0.05, -0.1, 6.0])
        ours_px = camera_lib.perspective_project(
            _f32(j3d, device), _f32(cam, device), focal=fit_cfg.focal,
            center=(fit_cfg.img_size / 2.0, fit_cfg.img_size / 2.0)
        ).cpu().numpy()
    with torch.no_grad():
        ref_px = pipe._project(torch.tensor(j3d, dtype=f64),
                               torch.tensor(cam, dtype=f64)).numpy()
    report["projection_max_px"] = float(np.abs(ours_px - ref_px).max())

    # Energy: our normalized-units energy × (S/2)² must equal the oracle's
    # pixel-units energy (exact proportionality; see oracle.py header).
    j2d_px = rng.rand(14, 2) * fit_cfg.img_size
    conf = rng.rand(14) * 0.5 + 0.5
    params = {"theta": _f32(theta, device)[None],
              "beta": _f32(beta, device)[None],
              "cam": _f32(cam, device)[None]}
    stage = fit_cfg.stages[-1]
    half = fit_cfg.img_size / 2.0
    obs_norm = (_f32(j2d_px, device) - half) / half
    with torch.no_grad():
        e_ours = float(fit_energy(params, model, obs_norm[None],
                                  _f32(conf, device)[None], stage, fit_cfg,
                                  prior)[0])
        lam = torch.tensor([stage.w_pose_prior, stage.w_shape_prior,
                            stage.w_angle_prior], dtype=f64)
        e_ref = float(pipe._energy_torch(
            *(torch.tensor(a, dtype=f64)
              for a in (theta, beta, cam, j2d_px, conf)), lam))
    e_ours_px = e_ours * (half * half)
    report["energy_rel_err"] = float(
        abs(e_ours_px - e_ref) / (abs(e_ref) + 1e-12))
    return report


def run_our_fit(model: SMPLData, joints2d_px: np.ndarray, conf: np.ndarray,
                cfg: FitConfig, prior: Any = None,
                init: Optional[dict] = None, device=None) -> dict:
    """The port's batched fit (``fitting/fit.fit_smpl_batch``) on
    ``device`` → the oracle's dict schema, as numpy."""
    device, model, prior = _on(model, prior, device)
    kw = {}
    if init is not None:
        kw["init"] = {k: _f32(v, device) for k, v in init.items()}
    res = fit_lib.fit_smpl_batch(model, _f32(joints2d_px, device),
                                 _f32(conf, device), cfg, prior, **kw)
    return {
        "theta": res.theta.detach().cpu().numpy(),
        "beta": res.beta.detach().cpu().numpy(),
        "cam": res.cam.detach().cpu().numpy(),
        "energy": res.energy.detach().cpu().numpy(),
        "joints3d": _our_joints3d(model, res.theta, res.beta),
    }


def fit_gap(ours: dict, reference: dict) -> dict:
    """North-star gap between two fitted pipelines' outputs."""
    mm = root_aligned_mpjpe_mm(ours["joints3d"], reference["joints3d"])
    return {
        "mpjpe_gap_mm_mean": float(mm.mean()),
        "mpjpe_gap_mm_max": float(mm.max()),
        "per_frame_mm": mm.tolist(),
    }


def certification_stages(total_iters: int = 2400) -> tuple:
    """A generous L-BFGS-style schedule for the matched-constants
    certification: camera stage then one long joint stage (the port's
    L-BFGS runs a fixed iteration count; the oracle's scipy converges and
    stops early — extra iterations only tighten both)."""
    return (
        StageConfig(iters=max(60, total_iters // 6), lr=0.05,
                    opt_pose=False, opt_shape=False, opt_global=True,
                    opt_cam=True, w_pose_prior=0.0, w_shape_prior=0.0,
                    w_angle_prior=0.0),
        StageConfig(iters=total_iters, lr=0.01, w_pose_prior=4.0,
                    w_shape_prior=5.0, w_angle_prior=15.0),
    )


def oracle_cfg_from_fit_cfg(cfg: FitConfig,
                            maxiter: int = 400) -> oracle_lib.OracleConfig:
    """Mirror a FitConfig's constants into the oracle's schema (for the
    matched-constants certification run)."""
    stages = tuple(
        oracle_lib.OracleStage(
            opt_pose=s.opt_pose, opt_global=s.opt_global,
            opt_shape=s.opt_shape, opt_cam=s.opt_cam,
            w_pose_prior=s.w_pose_prior, w_shape_prior=s.w_shape_prior,
            w_angle_prior=s.w_angle_prior, maxiter=maxiter)
        for s in cfg.stages)
    return oracle_lib.OracleConfig(
        stages=stages, camera_model=cfg.camera_model, focal=cfg.focal,
        img_size=cfg.img_size, gmof_sigma=cfg.gmof_sigma)


def make_clean_observations(model: SMPLData, n: int, img_size: int,
                            seed: int = 0):
    """Noise-free 2D observations projected from known (θ*, β*) through a
    fitted-extent weak-perspective camera. Returns (j2d_px, conf, gt)."""
    rng = np.random.RandomState(seed)
    theta = (0.25 * rng.randn(n, 72)).astype(np.float32)
    theta[:, :3] = 0.1 * rng.randn(n, 3)
    beta = (0.5 * rng.randn(n, 10)).astype(np.float32)
    joints = _our_joints3d(model, theta, beta)
    j14 = joints[:, joints_lib.CPM_TO_SMPL]
    half = img_size / 2.0
    j2d = np.zeros((n, 14, 2), np.float32)
    for i in range(n):
        c = j14[i] - j14[i].mean(0)
        s = 0.8 / max(np.abs(c[:, :2]).max(), 1e-3)
        j2d[i] = (c[:, :2] * s + 1.0) * half
    conf = np.ones((n, 14), np.float32)
    return j2d, conf, {"theta": theta, "beta": beta, "joints3d": joints}


def certify(model: SMPLData, prior: Any = None, n_frames: int = 4,
            fit_cfg: Optional[FitConfig] = None, seed: int = 0,
            target_mm: float = 1.0, oracle_maxiter: int = 400,
            init_noise: float = 0.05, device=None) -> dict:
    """ONE command: stage parity + matched-constants fit gap vs the
    reference-style oracle on clean synthetic observations; the port's
    fits run on ``device`` (None: the GPU), the oracle's on the host.

    Three certifications, strongest to weakest binding:

    1. ``stage_parity`` — SMPL forward / decode / projection / ENERGY
       agree to numerical precision at identical inputs. The energy check
       is the load-bearing one: identical energies ⇒ identical minimizer
       sets.
    2. ``fit_gap`` (the ≤1 mm headline) — a POLISH CHAIN: the reference
       pipeline's own optimizer (scipy L-BFGS-B, float64, tight
       tolerances) is started AT our fitted solution. If our fit
       converged to a true minimum of the reference energy, the polish
       moves it <1 mm; a semantic mismatch or under-converged fit shows
       up as a large polish displacement. (Two correct implementations
       started from the same far init can legitimately pick different
       modes of the multimodal SMPLify landscape — that measures
       basin-hopping luck, not parity, so it is reported separately as
       ``independent_fit_gap_mm``, informational.)
    3. ``gt_mpjpe_mm_*`` — both pipelines' ground-truth error on the
       clean probe set (quality context, not a parity bound).

    Both fits start from the SAME init (ground truth perturbed by
    ``init_noise``) with the same constants. ``seconds`` times each part
    on the host clock: stage parity, the port's fits (the first and the
    restart chain), the oracle's polish and its independent fit;
    ``oracle_evaluations`` counts the last two's energy evaluations.
    """
    device, model, prior = _on(model, prior, device)
    seconds, t0 = {}, time.perf_counter()
    if fit_cfg is None:
        fit_cfg = FitConfig(stages=certification_stages(),
                            optimizer="lbfgs", smpl_precision="highest")
    gmm = oracle_gmm(prior)
    arrays = model.to_numpy()
    pipe = oracle_lib.OraclePipeline(
        arrays, gmm=gmm,
        cfg=oracle_cfg_from_fit_cfg(fit_cfg, maxiter=oracle_maxiter))

    stages = stage_parity(model, pipe, fit_cfg, prior=prior, seed=seed,
                          device=device)
    seconds["stage_parity"] = time.perf_counter() - t0

    j2d, conf, gt = make_clean_observations(
        model, n_frames, fit_cfg.img_size, seed=seed)
    # Shared init: ground truth + bounded perturbation, camera from the
    # port's default heuristic (identical math both sides).
    rng = np.random.RandomState(seed + 1)
    half = fit_cfg.img_size / 2.0
    with torch.no_grad():
        cam0 = fit_lib.default_init(
            model, (_f32(j2d, device) - half) / half, _f32(conf, device),
            fit_cfg)["cam"]
    init_np = {
        "theta": (gt["theta"]
                  + init_noise * rng.randn(*gt["theta"].shape)
                  ).astype(np.float64),
        "beta": (gt["beta"]
                 + init_noise * rng.randn(*gt["beta"].shape)
                 ).astype(np.float64),
        "cam": cam0.cpu().numpy().astype(np.float64),
    }

    t0 = time.perf_counter()
    ours = run_our_fit(model, j2d, conf, fit_cfg, prior=prior,
                       init=init_np, device=device)
    # Restart chain: re-running the fit warm-started from its own output
    # resets the L-BFGS memory/linesearch state, pushing past the float32
    # stalls a single long run can hit.
    last = fit_cfg.stages[-1]
    chain_cfg = dataclasses.replace(
        fit_cfg, stages=(dataclasses.replace(last, iters=800, lr=0.01),))
    for _ in range(3):
        ours = run_our_fit(
            model, j2d, conf, chain_cfg, prior=prior,
            init={k: ours[k] for k in ("theta", "beta", "cam")},
            device=device)
    seconds["our_fit"] = time.perf_counter() - t0

    # The headline: reference-optimizer polish of OUR solution. One long
    # full stage, float64, tight tolerances — pure stationarity check.
    polish_cfg = dataclasses.replace(
        oracle_cfg_from_fit_cfg(fit_cfg),
        stages=(oracle_lib.OracleStage(
            w_pose_prior=last.w_pose_prior,
            w_shape_prior=last.w_shape_prior,
            w_angle_prior=last.w_angle_prior, maxiter=2000),))
    polish_pipe = oracle_lib.OraclePipeline(arrays, gmm=gmm, cfg=polish_cfg)
    our_solution = {k: np.asarray(ours[k], np.float64)
                    for k in ("theta", "beta", "cam")}
    t0 = time.perf_counter()
    polished = polish_pipe.fit_batch(
        j2d, conf, init=our_solution,
        scipy_options={"ftol": 1e-14, "gtol": 1e-10})
    gap = fit_gap(ours, polished)
    seconds["oracle_polish"] = time.perf_counter() - t0

    # Informational: independent same-init fits (basin agreement).
    t0, n0 = time.perf_counter(), pipe.evaluations
    ref = pipe.fit_batch(j2d, conf, init=init_np)
    seconds["oracle_fit"] = time.perf_counter() - t0
    evaluations = {"oracle_polish": polish_pipe.evaluations,
                   "oracle_fit": pipe.evaluations - n0}
    indep = fit_gap(ours, ref)

    gt_mm_ours = root_aligned_mpjpe_mm(ours["joints3d"], gt["joints3d"])
    gt_mm_ref = root_aligned_mpjpe_mm(ref["joints3d"], gt["joints3d"])
    return {
        "stage_parity": stages,
        "fit_gap": gap,
        "independent_fit_gap_mm": indep["mpjpe_gap_mm_mean"],
        "gt_mpjpe_mm_ours": float(gt_mm_ours.mean()),
        "gt_mpjpe_mm_oracle": float(gt_mm_ref.mean()),
        "target_mm": target_mm,
        "certified": bool(gap["mpjpe_gap_mm_mean"] <= target_mm),
        "seconds": seconds,
        "oracle_evaluations": evaluations,
    }
