"""End-to-end self-check (port of ``tpu_pose/tools/selfcheck_e2e.py`` on
argparse, with the same flags, ``results.json`` keys and ``--device``):

1. train the full-width CPM on the easy synthetic set;
2. evaluate the fused estimate → fit path with the trained weights against
   random ones (2D px error, MPJPE, PA-MPJPE); 2a. with an EM-fitted GMM-8
   prior; 2b. single-start fits from the mean pose and from a learned init
   head;
3. temporal warm-start, independent and smooth video fits;
4. two-person frames with the trained weights;
5. the hard set (``data/synthetic_hard.py``): train on it, then the
   refine / flip / scale-TTA ladder, calibrated int8, truncation, scale
   robustness, hard multi-person stills, a tracked crossing video, the
   empty-frame operating point and k = 3 stills;
9. the LSP adapter chain (fabricated ``joints.mat`` and JPEGs → shards →
   PCKh and OKS) and 10. the 3DPW-style chain (SMPL ground truth →
   shards → PVE); both write JPEGs through PIL.

8. the deployment artifact (``export.py``): the trained fused path
   exported at the eval batch, loaded with no estimator, and held against
   the live estimator on the same frames;

Every section is a function of the weights and data it needs (and a
:class:`Run`, which holds the configuration, the results and the log);
:func:`main` calls them in order.

  python -m tpu_pose_torch.tools.selfcheck_e2e --steps 800 --out selfcheck

``--hard_weights`` reruns section 5's evaluations from a previous run's
``cpm_weights_hard.npz`` without training.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import os
import pickle
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from tpu_pose_torch.api import PoseEstimator
from tpu_pose_torch.data import synthetic
from tpu_pose_torch.data import synthetic_hard as sh
from tpu_pose_torch.models import cpm as cpm_lib
from tpu_pose_torch.models import cpm_train, smpl_data
from tpu_pose_torch.models import smpl as smpl_lib
from tpu_pose_torch.tools.eval_2d import _bool_flag
from tpu_pose_torch.utils import checkpoint as ckpt_lib
from tpu_pose_torch.utils import metrics, profiling, tf_converter
from tpu_pose_torch.utils.config import CPMConfig, FitConfig

# Depths the JAX tool fixes in its code (its flags set the rest).
EASY_POOL = 16            # easy training pool, batches
PRIOR_CORPUS = 4000       # poses the GMM-8 prior is fitted to
HEAD_STEPS = 2000         # init-head training steps
HEAD_BATCH = 256
MULTI_FRAMES = 8          # two-person frames (sections 4 and 5)
HARD_VIDEO_FRAMES = 24    # the tracked crossing video
EMPTY_FRAMES = 32         # empty and one-person frames of the operating point
COUNT_FRAMES = 16         # of them, frames per count-accuracy call
CAL_FRAMES = 16           # int8 calibration frames
DATASET_FRAMES = 16       # LSP chain
THREEDPW_FRAMES = 12      # 3DPW chain

# The hard ladder: (results key, scale range, truncation, estimator
# knobs). "calibrate" stands for calibration frames of the hard set.
HARD_LADDER = (
    ("hard_plain", (0.45, 0.95), 0.0, {}),
    ("hard_refine_center", (0.45, 0.95), 0.0, {"refine_center": True}),
    ("hard_rc_flip_tta", (0.45, 0.95), 0.0,
     {"refine_center": True, "flip_tta": True}),
    ("hard_rc_flip_scale_tta", (0.45, 0.95), 0.0,
     {"refine_center": True, "flip_tta": True, "scale_tta": (0.8, 1.25)}),
    ("hard_rc_int8_calibrated", (0.45, 0.95), 0.0,
     {"refine_center": True, "quantize": True, "calibrate": True,
      "int8_min_batch": 0}),
    ("hard_truncated_plain", (0.45, 0.95), 0.3, {}),
    ("hard_truncated_rc_flip", (0.45, 0.95), 0.3,
     {"refine_center": True, "flip_tta": True}),
    ("hard_fixed_scale", (0.75, 0.85), 0.0, {}),
    ("hard_scale_sweep_plain", (0.3, 1.0), 0.0, {}),
    ("hard_scale_sweep_refine_scale", (0.3, 1.0), 0.0,
     {"refine_scale": True}),
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpu-pose-torch-selfcheck",
        description="Train and evaluate tpu_pose_torch end to end on "
        "synthetic data.")
    p.add_argument("--steps", type=int, default=800,
                   help="CPM training steps")
    p.add_argument("--train_batch", type=int, default=16,
                   help="training batch size")
    p.add_argument("--eval_frames", type=int, default=64,
                   help="eval frames (fused pipeline)")
    p.add_argument("--video_frames", type=int, default=32,
                   help="temporal-fit sequence length")
    p.add_argument("--restarts", type=int, default=4,
                   help="fit hypotheses for the eval")
    p.add_argument("--hard_steps", type=int, default=9600,
                   help="CPM training steps on the hard set (0 skips the "
                   "hard section)")
    p.add_argument("--hard_pool", type=int, default=64,
                   help="hard training pool size in batches "
                   "(tools/hard_sweep.py picks it)")
    p.add_argument("--hard_eval_frames", type=int, default=48,
                   help="hard-set eval frames")
    p.add_argument("--hard_distractor_prob", type=float, default=0.35,
                   help="share of hard training frames that render "
                   "non-target bodies (0: none)")
    p.add_argument("--hard_max_distractors", type=int, default=2,
                   help="1..N distractors per triggered frame")
    _bool_flag(p, "hard_union_stage1", True, "supervise stage 1 with the "
               "union heatmaps of every person "
               "(cpm_train.stage_supervision_loss)")
    p.add_argument("--hard_weights", default="", help="load hard-set CPM "
                   "weights from this npz (a previous run's "
                   "cpm_weights_hard.npz) instead of training")
    p.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "tpu_pose_torch_selfcheck"),
        help="output directory")
    p.add_argument("--device", default="cuda", help="torch device")
    return p.parse_args(argv)


def default_setup(device) -> tuple:
    """(CPM config, fit config, SMPL model) of the self-check, hard_sweep
    and track_bench: the repo's default model at full width and the
    synthetic SMPL."""
    return (CPMConfig(), FitConfig(),
            smpl_data.synthetic_smpl(seed=0, device=device))


class Run:
    """One self-check: its arguments, configs, SMPL model (on the device,
    and a host copy for the generators), results, the loss of every train
    step (``train_losses``), the train loops' seconds (``train_seconds``)
    and log. ``setup``: (CPM config, fit config, SMPL model) in place of
    :func:`default_setup`'s."""

    def __init__(self, args: argparse.Namespace,
                 setup: Optional[tuple] = None):
        self.args = args
        self.device = torch.device(args.device)
        self.cfg, self.fit_cfg, self.model = (setup
                                              or default_setup(self.device))
        self.model = self.model.to(self.device)
        self.host_model = self.model.to("cpu")
        self.results: Dict[str, object] = {}
        self.train_losses: Dict[str, list] = {}
        self.train_seconds: Dict[str, float] = {}
        self.t0 = time.time()
        self._hard_frames: Dict[tuple, dict] = {}
        os.makedirs(args.out, exist_ok=True)

    def log(self, msg: str) -> None:
        print(f"[{time.time() - self.t0:6.0f}s] {msg}", flush=True)

    def estimator(self, cpm, **kw) -> PoseEstimator:
        """An estimator on the run's device, model and configs; ``kw``:
        ``prior`` and the constructor's knobs."""
        prior = kw.pop("prior", None)
        return PoseEstimator(cpm, self.model, prior, self.cfg, self.fit_cfg,
                             device=self.device, **kw)

    def hard_frames(self, n: int, seed: int, scale_range,
                    truncation: float = 0.0) -> dict:
        """``make_hard_examples`` at these arguments, made once per run
        (the ladder's rungs share their frames)."""
        key = (n, seed, tuple(scale_range), truncation)
        if key not in self._hard_frames:
            self._hard_frames[key] = sh.make_hard_examples(
                self.host_model, n, self.cfg, seed=seed,
                scale_range=scale_range, truncation=truncation)
        return self._hard_frames[key]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _pool(run: Run, batches) -> list:
    """Training batches moved to the device once (uint8 images: the train
    step normalizes them)."""
    return [{k: torch.from_numpy(np.ascontiguousarray(v)).to(run.device)
             for k, v in b.items()} for b in batches]


def _train(run: Run, seed: int, steps: int, pool: list, every: int,
           tag: str):
    """``steps`` steps of ``cpm_train.make_train_step`` (lr 2e-4, the
    warmup-cosine schedule over ``steps``) from ``init_train_state(seed)``
    cycling through ``pool``; every step's loss into
    ``run.train_losses[tag]``, the loop's seconds into
    ``run.train_seconds[tag]``. Returns (the random CPM, the trained CPM,
    the last loss)."""
    cpm, opt_state, opt = cpm_train.init_train_state(
        seed, run.cfg, lr=2e-4, total_steps=steps, device=run.device)
    rand_cpm = copy.deepcopy(cpm)
    step = cpm_train.make_train_step(run.cfg, opt)
    losses = []
    t0 = time.perf_counter()
    for s in range(steps):
        cpm, opt_state, loss = step(cpm, opt_state, pool[s % len(pool)])
        losses.append(loss)
        if (s + 1) % every == 0:
            run.log(f"{tag} step {s + 1}: loss {float(loss):.5f}")
    run.train_losses[tag] = [float(x) for x in losses]
    run.train_seconds[tag] = time.perf_counter() - t0
    return rand_cpm, cpm, run.train_losses[tag][-1]


# -- 1. train ----------------------------------------------------------------

def train_easy(run: Run):
    """Section 1: the CPM trained ``--steps`` steps on a device-resident
    pool of EASY_POOL easy batches; the weights saved as
    ``cpm_weights.npz``. Returns (random CPM, trained CPM)."""
    run.log("generating training pool...")
    pool = _pool(run, synthetic.cpm_train_batches(
        run.host_model, run.args.train_batch, EASY_POOL, run.cfg, seed=0,
        raw_images=True))
    run.log(f"training {run.args.steps} steps...")
    rand_cpm, cpm, loss = _train(run, 0, run.args.steps, pool, 100, "easy")
    run.results["train_final_loss"] = loss
    ckpt_lib.save_cpm_params(os.path.join(run.args.out, "cpm_weights.npz"),
                             cpm)
    return rand_cpm, cpm


# -- 2. fused-pipeline eval --------------------------------------------------

def eval_examples(run: Run) -> dict:
    """The easy eval frames of sections 2, 2a and 2b."""
    return synthetic.make_examples(run.host_model, run.args.eval_frames,
                                   run.cfg, seed=1234)


def fused_eval(run: Run, tag: str, cpm, ex: dict, **est_kw) -> dict:
    """``estimate_and_fit`` on ``ex``'s frames: mean 2D px error, MPJPE
    after centering and RMS-scale alignment (the monocular scale
    ambiguity) and PA-MPJPE, into ``results[tag]``. The estimator has no
    prior and ``--restarts`` hypotheses unless ``est_kw`` says otherwise."""
    est = run.estimator(cpm, **({"fit_restarts": run.args.restarts}
                                | est_kw))
    res = est.estimate_and_fit(ex["images"])
    profiling.sync(res.theta)
    j2d = _np(res.joints2d)
    px_err = float(np.mean(np.linalg.norm(j2d - ex["joints2d"], axis=-1)))
    pred, gt = _np(res.joints3d), ex["gt_joints3d"]
    pred_c = pred - pred.mean(-2, keepdims=True)
    gt_c = gt - gt.mean(-2, keepdims=True)
    s = (np.sqrt((gt_c ** 2).sum((-2, -1)))
         / (np.sqrt((pred_c ** 2).sum((-2, -1))) + 1e-9))
    mp = float(np.mean(np.linalg.norm(
        pred_c * s[..., None, None] - gt_c, axis=-1))) * 1000
    pa = float(np.mean(metrics.pa_mpjpe_np(pred, gt))) * 1000
    run.log(f"{tag}: 2D px err {px_err:.2f} | MPJPE {mp:.1f} mm | "
            f"PA {pa:.1f} mm")
    run.results[tag] = {"px_err": px_err, "mpjpe_mm": mp, "pa_mpjpe_mm": pa}
    return run.results[tag]


def fused_section(run: Run, rand_cpm, cpm, ex: dict) -> None:
    """Section 2: the fused path with random and with trained weights."""
    fused_eval(run, "fused_random_weights", rand_cpm, ex)
    fused_eval(run, "fused_trained_weights", cpm, ex)


def fitted_prior_section(run: Run, cpm, ex: dict):
    """Section 2a: a GMM-8 prior fitted by EM to PRIOR_CORPUS poses of the
    training distribution (``priors.fit_gmm``), then the fused eval with
    it. Returns the prior."""
    from tpu_pose_torch.fitting import priors as priors_lib
    run.log(f"EM-fitting a GMM-8 prior to {PRIOR_CORPUS} corpus poses...")
    th_corpus, _ = synthetic.sample_poses(np.random.RandomState(7),
                                          PRIOR_CORPUS)
    prior = priors_lib.fit_gmm(th_corpus[:, 3:], num_components=8,
                               device=run.device)
    fused_eval(run, "fused_fitted_prior", cpm, ex, prior=prior)
    return prior


def init_head_section(run: Run, cpm, ex: dict) -> None:
    """Section 2b: single-start fits from the mean pose and from a learned
    init head (HEAD_STEPS steps at HEAD_BATCH, self-supervised from the
    SMPL model), on the same trained CPM."""
    from tpu_pose_torch.fitting import init_head as head_lib
    run.log("training init head (self-supervised from the SMPL model)...")
    head, losses = head_lib.train_init_head(run.model, steps=HEAD_STEPS,
                                            batch=HEAD_BATCH)
    run.results["init_head_final_loss"] = float(losses[-20:].mean())
    fused_eval(run, "fused_meanpose_init", cpm, ex, fit_restarts=1)
    fused_eval(run, "fused_learned_init", cpm, ex, fit_restarts=1,
               init_head=head)


# -- 3. temporal warm-start vs independent -----------------------------------

def video_section(run: Run, cpm, prior) -> None:
    """Section 3: one ``--video_frames`` synthetic sequence decoded once,
    then fitted by ``fit_video`` (temporal), ``fit_video_independent`` and
    ``fit_video_smooth`` (with ``prior``); PA-MPJPE of each."""
    from tpu_pose_torch.fitting import temporal
    vex = synthetic.make_video_examples(run.host_model,
                                        run.args.video_frames, run.cfg,
                                        seed=77)
    est = run.estimator(cpm)
    e2d = est.estimate_2d(vex["images"])
    fits = (
        ("video_temporal", lambda j, c: temporal.fit_video(
            run.model, j, c, cfg=est.fit_cfg)),
        ("video_independent", lambda j, c: temporal.fit_video_independent(
            run.model, j, c, cfg=est.fit_cfg)),
        ("video_smooth", lambda j, c: temporal.fit_video_smooth(
            run.model, j, c, cfg=est.fit_cfg, prior=prior)))
    for tag, fn in fits:
        t1 = time.time()
        res = fn(e2d.joints2d, e2d.conf)
        profiling.sync(res.theta)
        dt = time.time() - t1
        with torch.no_grad():
            out = smpl_lib.smpl_forward_batch(run.model, res.beta, res.theta)
        pa = float(np.mean(metrics.pa_mpjpe_np(
            _np(out.joints), vex["gt_joints3d"]))) * 1000
        run.log(f"{tag}: PA-MPJPE {pa:.1f} mm ({dt:.1f}s)")
        run.results[tag] = {"pa_mpjpe_mm": pa}


# -- 4. multi-person decode with trained weights -----------------------------

def _pair_pa(pred3d, gt3d, mask, swap) -> list:
    """Per-person PA-MPJPE of each kept slot against its matched person
    (two people; ``swap``: the slots match the people crosswise)."""
    pas = []
    for i in range(len(pred3d)):
        order = [1, 0] if swap[i] else [0, 1]
        for slot in range(2):
            if mask[i, slot]:
                pas.append(float(metrics.pa_mpjpe_np(
                    pred3d[i, slot][None], gt3d[i, order[slot]][None])[0]))
    return pas


def multi_section(run: Run, cpm, prior) -> None:
    """Section 4: two half-scale blob people per frame (left and right
    halves) through ``estimate_and_fit_multi``: the matched center error,
    per-person PA-MPJPE of the kept slots, and count accuracy (two kept on
    two-person frames, one on one-person frames)."""
    n_multi = MULTI_FRAMES
    cfg = run.cfg
    exa = synthetic.make_examples(run.host_model, n_multi, cfg, seed=555)
    exb = synthetic.make_examples(run.host_model, n_multi, cfg, seed=556)
    s4 = cfg.input_size // 4
    ja = exa["joints2d"] * 0.5 + np.array([0.0, s4])          # left half
    jb = exb["joints2d"] * 0.5 + np.array([2.0 * s4, s4])     # right half
    frames = np.stack([
        np.maximum(synthetic.render_blob_image(ja[i], cfg.input_size),
                   synthetic.render_blob_image(jb[i], cfg.input_size))
        for i in range(n_multi)])
    est_multi = run.estimator(cpm, prior=prior,
                              fit_restarts=run.args.restarts)
    multi = est_multi.estimate_and_fit_multi(frames, max_people=2)
    profiling.sync(multi.theta)
    pred_c = _np(multi.joints2d.mean(-2))                     # (N, 2, 2)
    gt_c = np.stack([ja.mean(-2), jb.mean(-2)], axis=1)       # (N, 2, 2)
    d_id = np.linalg.norm(pred_c - gt_c, axis=-1).mean(-1)
    d_sw = np.linalg.norm(pred_c - gt_c[:, ::-1], axis=-1).mean(-1)
    center_err = float(np.minimum(d_id, d_sw).mean())
    gt3d_pair = np.stack([exa["gt_joints3d"][:n_multi],
                          exb["gt_joints3d"][:n_multi]], axis=1)
    pas = _pair_pa(_np(multi.joints3d), gt3d_pair, _np(multi.person_mask),
                   d_sw < d_id)
    pa_two_person = float(np.mean(pas)) * 1000
    run.log(f"multi-person per-person PA-MPJPE {pa_two_person:.1f} mm over "
            f"{len(pas)} masked fits (single-person figure: "
            f"{run.results['fused_fitted_prior']['pa_mpjpe_mm']:.1f} mm)")
    counts2 = _np(multi.person_mask.sum(-1))
    single = run.estimator(cpm).estimate_and_fit_multi(
        exa["images"][:n_multi], max_people=2)
    profiling.sync(single.person_mask)
    counts1 = _np(single.person_mask.sum(-1))
    count_acc = float(((counts2 == 2).mean() + (counts1 == 1).mean()) / 2)
    run.log(f"multi-person (trained): mean matched center err "
            f"{center_err:.1f} px over {n_multi} two-person frames; "
            f"count-selection acc {count_acc:.2f} "
            f"(two-person counts {counts2.tolist()}, "
            f"one-person counts {counts1.tolist()})")
    run.results["multi_person"] = {"center_err_px": center_err,
                                   "frames": n_multi,
                                   "count_acc": count_acc,
                                   "pa_mpjpe_mm_per_person": pa_two_person,
                                   "masked_fits": len(pas)}


# -- 5. the hard benchmark ---------------------------------------------------

def hard_weights(run: Run):
    """Section 5's CPM: loaded from ``--hard_weights``, or trained
    ``--hard_steps`` steps (from ``init_train_state(1)``) on a
    device-resident pool of ``--hard_pool`` hard batches with distractors
    and, by default, union stage-1 targets, and saved as
    ``cpm_weights_hard.npz`` before any evaluation."""
    args = run.args
    if args.hard_weights:
        run.log(f"loading hard-set weights from {args.hard_weights} "
                "(skipping training)...")
        return cpm_lib.cpm_params_from_numpy(
            tf_converter.load_params_npz(args.hard_weights), run.cfg,
            run.device)
    run.log("generating HARD training pool (mesh render, clutter, "
            "scale/offset jitter, occlusion)...")
    pool = _pool(run, sh.hard_train_batches(
        run.host_model, args.train_batch, args.hard_pool, run.cfg, seed=0,
        raw_images=True, distractor_prob=args.hard_distractor_prob,
        max_distractors=args.hard_max_distractors,
        union_stage1=args.hard_union_stage1))
    run.log(f"training {args.hard_steps} steps on the hard set...")
    _, cpm_h, loss = _train(run, 1, args.hard_steps, pool, 200, "hard")
    run.results["hard_train_final_loss"] = loss
    ckpt_lib.save_cpm_params(
        os.path.join(args.out, "cpm_weights_hard.npz"), cpm_h)
    return cpm_h


def hard_eval(run: Run, tag: str, cpm_h, prior, scale_range,
              truncation: float = 0.0, **est_kw) -> float:
    """``estimate_and_fit`` on ``--hard_eval_frames`` hard frames (seed
    4321) at ``scale_range`` and ``truncation``: the 2D px error over the
    visible joints and PA-MPJPE, into ``results[tag]``. ``calibrate=True``
    adds CAL_FRAMES hard calibration frames (seed 777). Returns the px
    error."""
    exh = run.hard_frames(run.args.hard_eval_frames, 4321, scale_range,
                          truncation)
    if est_kw.pop("calibrate", False):
        est_kw["calibration_images"] = run.hard_frames(
            CAL_FRAMES, 777, (0.45, 0.95))["images"]
    est = run.estimator(cpm_h, prior=prior, fit_restarts=run.args.restarts,
                        **est_kw)
    res = est.estimate_and_fit(exh["images"])
    profiling.sync(res.theta)
    vis = exh["visibility"] > 0
    d = np.linalg.norm(_np(res.joints2d) - exh["joints2d"], axis=-1)
    px_err = float(d[vis].mean())
    pa = float(np.mean(metrics.pa_mpjpe_np(
        _np(res.joints3d), exh["gt_joints3d"]))) * 1000
    run.log(f"{tag}: 2D px err {px_err:.2f} (visible joints) | "
            f"PA {pa:.1f} mm")
    run.results[tag] = {"px_err": px_err, "pa_mpjpe_mm": pa}
    return px_err


def scale_robustness(run: Run) -> None:
    """``results["scale_robustness"]`` from the ladder's fixed-scale,
    0.3–1.0 sweep and refine_scale sweep rungs."""
    px_fixed = run.results["hard_fixed_scale"]["px_err"]
    px_naive = run.results["hard_scale_sweep_plain"]["px_err"]
    px_rs = run.results["hard_scale_sweep_refine_scale"]["px_err"]
    run.results["scale_robustness"] = {
        "fixed_px": px_fixed, "sweep_plain_px": px_naive,
        "sweep_refine_scale_px": px_rs,
        "ratio_vs_fixed": px_rs / max(px_fixed, 1e-6)}
    run.log(f"scale robustness: refine_scale {px_rs:.2f} px vs fixed "
            f"{px_fixed:.2f} px (ratio {px_rs / max(px_fixed, 1e-6):.2f}"
            f"; naive sweep {px_naive:.2f} px)")


def hard_ladder(run: Run, cpm_h, prior) -> None:
    """Section 5a/b: every rung of HARD_LADDER, then scale robustness."""
    for tag, scale_range, truncation, kw in HARD_LADDER:
        hard_eval(run, tag, cpm_h, prior, scale_range, truncation, **kw)
    scale_robustness(run)


def hard_multi_examples(run: Run) -> dict:
    """The hard two-person stills of sections 5c and 5e."""
    return sh.make_hard_multi_examples(run.host_model, MULTI_FRAMES,
                                       run.cfg, seed=99)


def hard_multi_section(run: Run, est_mh: PoseEstimator, mh: dict) -> None:
    """Section 5c: per-person accuracy on hard two-person stills (depth
    ordered, so one person occludes the other)."""
    rmh = est_mh.estimate_and_fit_multi(mh["images"], max_people=2)
    profiling.sync(rmh.theta)
    pc = _np(rmh.joints2d.mean(-2))
    gc = mh["joints2d"].mean(-2)
    d_id = np.linalg.norm(pc - gc, axis=-1).mean(-1)
    d_sw = np.linalg.norm(pc - gc[:, ::-1], axis=-1).mean(-1)
    pas = _pair_pa(_np(rmh.joints3d), mh["gt_joints3d"],
                   _np(rmh.person_mask), d_sw < d_id)
    out = {"center_err_px": float(np.minimum(d_id, d_sw).mean()),
           "pa_mpjpe_mm_per_person": float(np.mean(pas)) * 1000,
           "masked_fits": len(pas)}
    run.results["hard_multi_person"] = out
    run.log(f"hard multi-person: center err {out['center_err_px']:.1f} px, "
            f"per-person PA {out['pa_mpjpe_mm_per_person']:.1f} mm over "
            f"{len(pas)} masked fits")


def hard_video_section(run: Run, est_mh: PoseEstimator) -> None:
    """Section 5d: a tracked crossing video (two people swap sides, the
    nearer occluding the farther) through
    ``estimate_and_fit_video_multi`` with the anchor refresh and two
    hint passes: identity accuracy under the best global track → person
    matching, center error and per-person PA-MPJPE."""
    vh = sh.make_hard_multi_video(run.host_model, HARD_VIDEO_FRAMES,
                                  run.cfg, seed=7, crossing=True)
    rvm = est_mh.estimate_and_fit_video_multi(
        vh["images"], max_people=2, track_anchor_refresh=0.3,
        hint_passes=2)
    profiling.sync(rvm.theta)
    tc = _np(rvm.joints2d).mean(-2)                  # (T, 2, 2)
    gc = vh["centers"]
    d_id = np.linalg.norm(tc - gc, axis=-1).sum()
    d_sw = np.linalg.norm(tc - gc[:, ::-1], axis=-1).sum()
    order = [0, 1] if d_id <= d_sw else [1, 0]
    ga = gc[:, order]
    per_frame = (np.linalg.norm(tc - ga, axis=-1).sum(-1)
                 <= np.linalg.norm(tc - ga[:, ::-1], axis=-1).sum(-1))
    id_acc = float(per_frame.mean())
    center_err_v = float(np.linalg.norm(tc - ga, axis=-1).mean())
    gj = vh["gt_joints3d"][:, order]                 # (T, 2, 24, 3)
    j3d = _np(rvm.joints3d)
    pa_v = float(np.mean([np.mean(metrics.pa_mpjpe_np(j3d[k], gj[:, k]))
                          for k in range(2)])) * 1000
    run.results["hard_multi_video"] = {
        "id_acc": id_acc, "center_err_px": center_err_v,
        "pa_mpjpe_mm_per_person": pa_v}
    run.log(f"hard multi-video (crossing): id acc {id_acc:.2f}, center "
            f"err {center_err_v:.1f} px, per-person PA {pa_v:.1f} mm")


def empty_frame_section(run: Run, cpm_h, prior, mh: dict) -> None:
    """Section 5e: the empty-frame operating point. The top person-
    evidence peak on person-free hard frames against person frames picks
    the ``min_person_score`` floor (geometric midpoint when they separate,
    else the empty frames' 95th percentile); then count accuracy with
    ``allow_empty`` at that floor on 0-, 1- and 2-person frames, without
    and with the partial-overlap dedupe (``dup_joint_frac=0.5``)."""
    cfg = run.cfg
    emp = sh.make_empty_examples(EMPTY_FRAMES, cfg, seed=1212)
    per = sh.make_hard_examples(run.host_model, EMPTY_FRAMES, cfg,
                                seed=1313, scale_range=(0.45, 0.95))

    def top_scores(images):
        x = torch.from_numpy(images).to(run.device)
        with torch.no_grad():
            return _np(cpm_lib.estimate_2d_multi(cpm_h, x, cfg,
                                                 max_people=2)[3])[:, 0]

    top_emp, top_per = top_scores(emp["images"]), top_scores(per["images"])
    lo, hi = float(top_emp.max()), float(top_per.min())
    floor = (float(np.sqrt(max(lo, 1e-6) * hi)) if hi > lo
             else float(np.quantile(top_emp, 0.95)))
    fp = float((top_emp >= floor).mean())
    tp = float((top_per >= floor).mean())
    est_sel = run.estimator(cpm_h, prior=prior)

    def counts(imgs, dup_joint_frac):
        return _np(est_sel.estimate_and_fit_multi(
            imgs, max_people=2, min_person_score=floor, allow_empty=True,
            dup_joint_frac=dup_joint_frac).person_mask.sum(-1))

    acc = {}
    for suffix, frac in (("", 0.0), ("_ovl", 0.5)):
        for n_people, imgs in ((0, emp["images"][:COUNT_FRAMES]),
                               (1, per["images"][:COUNT_FRAMES]),
                               (2, mh["images"])):
            acc[f"count_acc_{n_people}p{suffix}"] = float(
                (counts(imgs, frac) == n_people).mean())
    run.results["empty_frame_operating_point"] = {
        "floor": floor, "empty_top1_max": lo, "person_top1_min": hi,
        "fp_rate_empty": fp, "tp_retention": tp, **acc}
    run.log(f"empty-frame operating point: floor {floor:.3f} "
            f"(empty max {lo:.3f} vs person min {hi:.3f}) -> FP "
            f"{fp:.2f}, TP {tp:.2f}; allow_empty count acc "
            f"0p {acc['count_acc_0p']:.2f} / 1p {acc['count_acc_1p']:.2f} "
            f"/ 2p {acc['count_acc_2p']:.2f}; with dup_joint_frac=0.5: "
            f"0p {acc['count_acc_0p_ovl']:.2f} / 1p "
            f"{acc['count_acc_1p_ovl']:.2f} / 2p "
            f"{acc['count_acc_2p_ovl']:.2f}")


def hard_k3_section(run: Run, est_mh: PoseEstimator) -> None:
    """Section 5f: k = 3 hard stills at ``max_people=3``: the best of the
    3! slot → person assignments per frame, its center error, per-person
    PA-MPJPE of the kept slots and count accuracy."""
    m3 = sh.make_hard_multi_examples(run.host_model, MULTI_FRAMES, run.cfg,
                                     seed=303, num_people=3)
    r3 = est_mh.estimate_and_fit_multi(m3["images"], max_people=3)
    profiling.sync(r3.theta)
    pc3 = _np(r3.joints2d.mean(-2))                   # (N, 3, 2)
    gc3 = m3["joints2d"].mean(-2)
    perms3 = list(itertools.permutations(range(3)))
    pas3, cents3 = [], []
    mask3 = _np(r3.person_mask)
    j3d = _np(r3.joints3d)
    for i in range(len(pc3)):
        costs = [np.linalg.norm(pc3[i] - gc3[i, list(pp)], axis=-1).mean()
                 for pp in perms3]
        order3 = perms3[int(np.argmin(costs))]
        cents3.append(min(costs))
        for slot in range(3):
            if mask3[i, slot]:
                pas3.append(float(metrics.pa_mpjpe_np(
                    j3d[i, slot][None],
                    m3["gt_joints3d"][i, order3[slot]][None])[0]))
    counts3 = mask3.sum(-1)
    run.results["hard_multi_person_k3"] = {
        "center_err_px": float(np.mean(cents3)),
        "pa_mpjpe_mm_per_person": float(np.mean(pas3)) * 1000,
        "count_acc": float((counts3 == 3).mean()),
        "masked_fits": len(pas3)}
    run.log(f"hard k=3 stills: center err {np.mean(cents3):.1f} px, "
            f"per-person PA {np.mean(pas3) * 1000:.1f} mm over "
            f"{len(pas3)} masked fits, count acc "
            f"{float((counts3 == 3).mean()):.2f}")


def hard_section(run: Run, prior) -> None:
    """Section 5: the hard CPM, its ladder, hard multi-person stills, the
    tracked crossing video, the empty-frame operating point and k = 3
    stills."""
    cpm_h = hard_weights(run)
    hard_ladder(run, cpm_h, prior)
    mh = hard_multi_examples(run)
    est_mh = run.estimator(cpm_h, prior=prior,
                           fit_restarts=run.args.restarts)
    hard_multi_section(run, est_mh, mh)
    hard_video_section(run, est_mh)
    empty_frame_section(run, cpm_h, prior, mh)
    hard_k3_section(run, est_mh)



# -- 8. deployment artifact --------------------------------------------------

def export_section(run: Run, cpm, ex: dict) -> None:
    """Section 8: the trained fused path exported (``export.py``: the
    weights in the program) at the eval batch, loaded with no estimator
    in scope, and held against the live estimator on the same eval
    frames — the ship-an-artifact story with trained weights on the
    device. ``ok``: Δjoints2d < 0.5 px and Δθ < 0.05, the JAX tool's
    rule."""
    from tpu_pose_torch import export as pexport
    run.log("exporting deployment artifact (trained weights)...")
    art_dir = os.path.join(run.args.out, "artifact")
    imgs = ex["images"]
    est_dep = run.estimator(cpm)
    pexport.export_estimator(est_dep, art_dir, fn="estimate_and_fit",
                             batch=int(imgs.shape[0]))
    del est_dep
    out_art = pexport.load(art_dir)(imgs)
    live = run.estimator(cpm).estimate_and_fit(imgs)
    d_j2d = float(np.max(np.abs(out_art["joints2d"] - _np(live.joints2d))))
    d_th = float(np.max(np.abs(out_art["theta"] - _np(live.theta))))
    run.results["export_artifact"] = {
        "program_mb": round(os.path.getsize(
            os.path.join(art_dir, "program.pt2")) / 1e6, 1),
        "max_d_joints2d_px": d_j2d, "max_d_theta": d_th,
        "ok": bool(d_j2d < 0.5 and d_th < 0.05)}
    run.log(f"artifact round-trip: Δjoints2d {d_j2d:.3g} px, Δθ "
            f"{d_th:.3g} → "
            f"{'OK' if run.results['export_artifact']['ok'] else 'MISMATCH'}")


# -- 9. dataset-adapter chain ------------------------------------------------

def dataset_chain_estimator(run: Run, cpm) -> PoseEstimator:
    """The estimator of sections 9 and 10: refine_center and
    refine_scale."""
    return run.estimator(cpm, refine_center=True, refine_scale=True)


def lsp_chain_section(run: Run, est_ds: PoseEstimator) -> None:
    """Section 9: an LSP-format dataset fabricated from labelled synthetic
    frames (``joints.mat`` in the (3, 14, N) layout and JPEGs), converted
    by ``datasets.lsp_to_shards`` and scored by ``evaluate_pckh`` and
    ``evaluate_oks`` over the shards."""
    import scipy.io
    from PIL import Image

    from tpu_pose_torch.data import datasets as ds_lib
    from tpu_pose_torch.data import pipeline as pipe_lib
    from tpu_pose_torch.parallel import eval as eval_lib

    run.log("dataset-adapter chain (LSP fabrication → convert → PCKh)...")
    ds_n = DATASET_FRAMES
    ex_ds = synthetic.make_examples(run.host_model, ds_n, run.cfg, seed=777)
    inv = np.argsort(ds_lib.LSP_TO_CPM)      # CPM order → LSP order
    lsp_xy = ex_ds["joints2d"][:, inv]        # (N, 14, 2)
    lsp = np.transpose(
        np.concatenate([lsp_xy, np.zeros((ds_n, 14, 1))], -1),
        (2, 1, 0))                            # (3, 14, N), flag 0 = visible
    fab = os.path.join(run.args.out, "lsp_fab")
    img_dir = os.path.join(fab, "images")
    os.makedirs(img_dir, exist_ok=True)
    scipy.io.savemat(os.path.join(fab, "joints.mat"), {"joints": lsp})
    for i in range(ds_n):
        Image.fromarray(ex_ds["images"][i]).save(
            os.path.join(img_dir, f"im{i + 1:04d}.jpg"), quality=92)
    shard_dir = os.path.join(fab, "shards")
    ds_lib.lsp_to_shards(os.path.join(fab, "joints.mat"), img_dir,
                         shard_dir, out_size=run.cfg.input_size)
    out_ds = eval_lib.evaluate_pckh(
        est_ds, pipe_lib.batches(
            shard_dir, 8, keys=("images", "gt_joints2d", "conf",
                                "headsize"), shard_by_process=False))
    # The same shards under OKS (keypoint-box area: LSP has no
    # segmentation area).
    out_oks = eval_lib.evaluate_oks(
        est_ds, pipe_lib.batches(
            shard_dir, 8, keys=("images", "gt_joints2d", "conf"),
            shard_by_process=False))
    run.results["dataset_adapter_chain"] = {
        "num_frames": out_ds["num_frames"],
        "pckh_05": round(out_ds["pckh"], 4),
        "mean_oks": round(out_oks["mean_oks"], 4),
        "oks_ap": round(out_oks["ap"], 4),
        "oks_ap50": round(out_oks["ap50"], 4)}
    run.log(f"adapter chain: {out_ds['num_frames']} frames through "
            f"convert→shards→eval, PCKh@0.5 {out_ds['pckh'] * 100:.1f}% "
            f"| mean OKS {out_oks['mean_oks']:.3f}, AP "
            f"{out_oks['ap'] * 100:.1f}, AP50 {out_oks['ap50'] * 100:.1f} "
            f"(rc+rs trained weights, JPEG noise included)")


# -- 10. 3DPW-style chain ----------------------------------------------------

def threedpw_chain_section(run: Run, est_ds: PoseEstimator) -> None:
    """Section 10: one 3DPW sequence file fabricated from the synthetic
    SMPL (world joints at depth z0 behind a pinhole K whose focal length
    makes the median person span 0.8 of the frame; blob frames painted at
    the projected pixels), converted by ``datasets.threedpw_to_shards``
    and scored by ``evaluate_h36m_style``, whose mesh-level PVE / PA-PVE
    come from the shards' ``gt_theta``/``gt_beta``."""
    from PIL import Image

    from tpu_pose_torch.data import datasets as ds_lib
    from tpu_pose_torch.data import pipeline as pipe_lib
    from tpu_pose_torch.models.joints import CPM_TO_SMPL
    from tpu_pose_torch.parallel import eval as eval_lib

    run.log("3DPW-style chain (SMPL-GT fabrication → convert → PVE)...")
    n3 = THREEDPW_FRAMES
    cfg = run.cfg
    size = cfg.input_size
    z0 = 200.0                        # perspective ≈ the painter's view
    # One β per actor (the 3DPW schema); the GT joints use it.
    ex3 = synthetic.make_examples(run.host_model, n3, cfg, seed=888)
    theta3 = ex3["theta"]
    beta3 = np.tile(ex3["beta"][0], (n3, 1))
    j3d24 = synthetic._examples_from_params(
        run.host_model, theta3, beta3, cfg)["gt_joints3d"]  # metres
    j14 = j3d24[:, np.asarray(CPM_TO_SMPL)]
    world = j3d24 - j14.mean(1, keepdims=True)       # camera at origin
    extent = np.abs(j14 - j14.mean(1, keepdims=True)).max(axis=(1, 2))
    f_px = 0.8 / float(np.median(extent)) * (size / 2.0) * z0
    k3 = np.array([[f_px, 0, size / 2.0],
                   [0, f_px, size / 2.0], [0, 0, 1.0]])
    fab3 = os.path.join(run.args.out, "threedpw_fab")
    img3 = os.path.join(fab3, "img")
    os.makedirs(img3, exist_ok=True)
    for i in range(n3):
        uvw = (world[i] + [0, 0, z0]) @ k3.T
        px14 = (uvw[:, :2] / uvw[:, 2:3])[np.asarray(CPM_TO_SMPL)]
        Image.fromarray(synthetic.render_blob_image(px14, size)).save(
            os.path.join(img3, f"image_{i:05d}.jpg"), quality=92)
    cam3 = np.zeros((n3, 4, 4))
    cam3[:, :3, :3] = np.eye(3)
    cam3[:, :3, 3] = [0, 0, z0]
    cam3[:, 3, 3] = 1.0
    seq3 = {"sequence": "fab", "cam_intrinsics": k3, "cam_poses": cam3,
            "img_frame_ids": np.arange(n3), "genders": ["n"],
            "poses": [theta3.astype(np.float64)],
            "betas": [beta3[0].astype(np.float64)],
            "trans": [np.zeros((n3, 3))],
            "jointPositions": [world.reshape(n3, 72).astype(np.float64)],
            "campose_valid": [np.ones(n3)]}
    with open(os.path.join(fab3, "seq.pkl"), "wb") as f:
        pickle.dump(seq3, f, protocol=2)
    shard3 = os.path.join(fab3, "shards")
    ds_lib.threedpw_to_shards(os.path.join(fab3, "seq.pkl"), img3,
                              shard3, out_size=size)
    out3 = eval_lib.evaluate_h36m_style(
        est_ds, pipe_lib.batches(
            shard3, 4, keys=("images", "gt_joints3d", "gt_joints2d",
                             "gt_theta", "gt_beta"),
            shard_by_process=False))
    run.results["threedpw_chain"] = {
        "num_frames": out3["num_frames"],
        "pa_mpjpe_mm": round(out3["pa_mpjpe"] * 1000, 1),
        "pve_mm": round(out3["pve"] * 1000, 1),
        "pa_pve_mm": round(out3["pa_pve"] * 1000, 1)}
    run.log(f"3DPW chain: {out3['num_frames']} frames, PA-MPJPE "
            f"{out3['pa_mpjpe'] * 1000:.1f} mm, PVE "
            f"{out3['pve'] * 1000:.1f} mm, PA-PVE "
            f"{out3['pa_pve'] * 1000:.1f} mm (mesh-level protocol from "
            f"gt_theta/gt_beta; rc+rs trained weights)")


def main(argv=None) -> Optional[dict]:
    args = parse_args(argv)
    run = Run(args)
    rand_cpm, cpm = train_easy(run)
    ex = eval_examples(run)
    fused_section(run, rand_cpm, cpm, ex)
    prior = fitted_prior_section(run, cpm, ex)
    init_head_section(run, cpm, ex)
    video_section(run, cpm, prior)
    multi_section(run, cpm, prior)
    if args.hard_steps > 0:
        hard_section(run, prior)
    export_section(run, cpm, ex)
    est_ds = dataset_chain_estimator(run, cpm)
    lsp_chain_section(run, est_ds)
    threedpw_chain_section(run, est_ds)
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(run.results, f, indent=2)
    run.log(f"done → {args.out}/results.json")
    return run.results


def run():
    """Console entry point (``pyproject.toml`` ``[project.scripts]``)."""
    main()


if __name__ == "__main__":
    run()
