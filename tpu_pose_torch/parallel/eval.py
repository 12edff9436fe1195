"""Dataset-scale evaluation, on one device or data-parallel over a mesh
(port of ``tpu_pose/parallel/eval.py``).

Three streaming evaluators share one loop, :func:`_stream_eval`: a
one-deep pipeline (launch batch i+1's estimator call, then accumulate
batch i's metrics on the host while the device works) with a resumable
cursor and metric sums saved as JSON. Every metric is a float64 numpy
twin from ``utils/metrics.py``, read from one host copy per result
field per batch.

With a ``mesh`` (``parallel/mesh.make_mesh``) every rank runs the same
evaluator on the same global batches: :func:`sharded_fused_fn` and
:func:`sharded_2d_fn` compute this rank's rows and gather the rest, so
each rank accumulates the single-device metrics. An uneven last batch is
edge-padded to the mesh size and its results sliced back. Rank 0 alone
writes the cursor file.

- :func:`evaluate_h36m_style` — the fused ``estimate_and_fit`` scored by
  MPJPE Protocol 1, the scaled MPJPE, PA-MPJPE, PCKh of the decoded 2D
  joints and the mesh-level PVE / PA-PVE;
- :func:`evaluate_pckh` — ``estimate_2d`` under PCKh (head) or the LSP
  torso PCK, with the per-joint table and the AUC of the PCK curve;
- :func:`evaluate_oks` — ``estimate_2d`` under COCO's OKS with the AP
  ladder.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from tpu_pose_torch.parallel import mesh as mesh_lib
from tpu_pose_torch.utils import metrics as metrics_lib


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _float_estimator(estimator):
    """A shallow copy that runs the float (f32/bf16) CPM at every batch
    size: the sharded functions never take the int8 set, whatever the
    global batch (an already-quantized CPM has no float twin and stays)."""
    est = copy.copy(estimator)
    if estimator.cpm_bf16 is not None:
        est.cpm = estimator.cpm_bf16
    est.cpm_bf16 = None
    return est


def _replicate_estimator(est, mesh) -> None:
    """Rank 0's CPM, SMPL model, prior and init head on every rank."""
    mesh_lib.replicate(est.cpm, mesh)
    mesh_lib.replicate(est.smpl_model, mesh)
    if est.prior is not None:
        mesh_lib.replicate(est.prior, mesh)
    if est.init_head is not None:
        mesh_lib.replicate(est.init_head, mesh)


def sharded_fused_fn(estimator, mesh):
    """``estimate_and_fit`` data-parallel over ``mesh``: ``run(images)``
    on the global batch (its size divisible by the mesh size) fits this
    rank's rows and gathers every output field, so each rank returns the
    whole batch's :class:`~tpu_pose_torch.api.EstimateAndFitResult`. The
    CPM is the float set (:func:`_float_estimator`); the parameters are
    replicated from rank 0 once, here. Every rank must call ``run``."""
    est = _float_estimator(estimator)
    _replicate_estimator(est, mesh)

    def run(images):
        rows = mesh_lib.shard_rows(images.shape[0], mesh)
        return mesh_lib.gather_batch(est.estimate_and_fit(images[rows]),
                                     mesh)

    return run


def sharded_2d_fn(estimator, mesh):
    """``estimate_2d`` with the estimator's front-end knobs, data-parallel
    over ``mesh``: ``run(images)`` → the global batch's (heatmaps,
    joints2d, conf) on every rank, as :func:`sharded_fused_fn`."""
    from tpu_pose_torch.api import Estimate2DResult
    est = _float_estimator(estimator)
    _replicate_estimator(est, mesh)

    def run(images):
        rows = mesh_lib.shard_rows(images.shape[0], mesh)
        hm, joints, conf = est._front_end(images[rows], source_frame=True)
        return mesh_lib.gather_batch(Estimate2DResult(hm, joints, conf),
                                     mesh)

    return run


class _JsonState:
    """Atomic JSON save (rank 0 only) and a load that starts over on a
    schema change (partial sums of another metric layout cannot be
    resumed)."""

    def save(self, path: str):
        if not mesh_lib.is_main_process():
            return
        # A crash mid-save must not truncate the resume cursor.
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(self), f)
        os.replace(tmp, path)

    @classmethod
    def _valid(cls, d: dict) -> bool:
        return set(d) == {f.name for f in dataclasses.fields(cls)}

    @classmethod
    def load(cls, path: str):
        if os.path.exists(path):
            with open(path) as f:
                d = json.load(f)
            if cls._valid(d):
                return cls(**d)
        return cls()


@dataclasses.dataclass
class EvalState(_JsonState):
    """Resumable accumulator of :func:`evaluate_h36m_style`."""
    cursor: int = 0
    n: int = 0
    sum_mpjpe_p1: float = 0.0      # root-aligned, no scale (Protocol 1)
    sum_mpjpe_scaled: float = 0.0  # RMS-extent-matched (non-standard)
    sum_pa_mpjpe: float = 0.0      # Procrustes-aligned
    n2d: int = 0                   # frames with 2D ground truth
    sum_pckh: float = 0.0          # PCKh@threshold accumulator
    n_mesh: int = 0                # frames with SMPL mesh ground truth
    sum_pve: float = 0.0           # centroid-aligned per-vertex error
    sum_pa_pve: float = 0.0        # Procrustes-aligned per-vertex error


def _stream_eval(run, batches, state, accumulate, mesh,
                 checkpoint_path: Optional[str]) -> None:
    """The evaluators' shared loop: skip the batches before
    ``state.cursor`` (resume), launch batch i+1's ``run`` before
    accumulating batch i (its host reads wait for the device), and save
    the state at the end. With a mesh, a batch whose size does not divide
    by the mesh size is edge-padded up to a multiple; ``accumulate``
    reads only the real rows."""
    n_dev = mesh.size() if mesh is not None else 1
    pending = None
    for i, batch in enumerate(batches):
        if i < state.cursor:
            continue
        images = batch["images"]
        n_real = int(images.shape[0])
        if n_real % n_dev:
            images, _ = mesh_lib.pad_to_multiple(images, n_dev)
        res = run(images)
        if pending is not None:
            accumulate(*pending)
        pending = (res, batch, n_real, i)
    if pending is not None:
        accumulate(*pending)
    if checkpoint_path:
        state.save(checkpoint_path)
        if mesh is not None:   # the file is there before any rank reads it
            torch.distributed.barrier(group=mesh.get_group())


def evaluate_h36m_style(
    estimator,
    batches: Iterator,          # dicts: images (B,H,W,3), gt_joints3d
    mesh=None,
    select_joints: Optional[Callable] = None,
    checkpoint_path: Optional[str] = None,
    save_every: int = 10,
    root_index: int = 0,
    primary_protocol: str = "p1",
    pckh_threshold: float = 0.5,
    gt_smpl_model=None,
):
    """Streaming evaluation of ``estimator.estimate_and_fit`` under every
    standard protocol at once:

    - ``mpjpe_p1`` — H3.6M Protocol 1: root-aligned, no scale adjustment
      (score it with the perspective camera: a weak-perspective fit has a
      free monocular scale);
    - ``mpjpe_scaled`` — centroid-aligned with a per-frame RMS-extent
      scale match; not a standard protocol, named so it is never taken
      for Protocol 1;
    - ``pa_mpjpe`` — Procrustes-aligned (Protocol 2 family);
    - ``pckh`` — PCKh@``pckh_threshold`` of the decoded 2D joints, for
      batches with ``gt_joints2d`` (the estimator's pixel frame);
    - ``pve`` / ``pa_pve`` — per-vertex error (centroid- / Procrustes-
      aligned) for batches with SMPL ground truth: ``gt_vertices``, or
      ``gt_theta`` (B, 72) + ``gt_beta`` (B, 10) posed through the
      estimator's SMPL model, or through ``gt_smpl_model`` (an
      ``SMPLData``, e.g. the gendered model of the official 3DPW
      protocol).

    ``gt_joints3d`` is in the SMPL 24-joint frame, or ``select_joints``
    maps the predicted (B, 24, 3) joints to the ground truth's convention
    (whose root is ``root_index``). ``primary_protocol`` ('p1' | 'scaled'
    | 'pa') picks what the ``mpjpe`` key repeats. ``checkpoint_path``:
    the JSON cursor file, saved every ``save_every`` batches and at the
    end; an existing one resumes the run. ``mesh``: run
    :func:`sharded_fused_fn` over it (every rank gets the same metrics).
    """
    from tpu_pose_torch.models import smpl as smpl_lib

    state = (EvalState.load(checkpoint_path) if checkpoint_path
             else EvalState())

    def _gt_vertices(batch, n_real):
        if "gt_vertices" in batch:
            return np.asarray(batch["gt_vertices"], np.float64)[:n_real]
        if "gt_theta" in batch and "gt_beta" in batch:
            model = (estimator.smpl_model if gt_smpl_model is None
                     else gt_smpl_model)
            dev = model.device
            with torch.no_grad():
                v = smpl_lib.smpl_forward_batch(
                    model,
                    torch.as_tensor(np.asarray(batch["gt_beta"], np.float32),
                                    device=dev),
                    torch.as_tensor(np.asarray(batch["gt_theta"],
                                               np.float32), device=dev),
                    precision=smpl_lib.EXACT_PRECISION).vertices
            return _host(v).astype(np.float64)[:n_real]
        return None

    def accumulate(res, batch, n_real, batch_index):
        pred = _host(res.joints3d)[:n_real]
        if select_joints is not None:
            pred = np.asarray(select_joints(pred))
        gt = np.asarray(batch["gt_joints3d"])
        state.n += n_real
        state.sum_mpjpe_p1 += float(metrics_lib.mpjpe_np(
            pred, gt, align_root=True, root_index=root_index).sum())
        state.sum_mpjpe_scaled += float(
            metrics_lib.scaled_mpjpe_np(pred, gt).sum())
        state.sum_pa_mpjpe += float(metrics_lib.pa_mpjpe_np(pred, gt).sum())
        if "gt_joints2d" in batch:
            state.n2d += n_real
            state.sum_pckh += float(metrics_lib.pckh_np(
                _host(res.joints2d)[:n_real], batch["gt_joints2d"],
                threshold=pckh_threshold).sum())
        gt_verts = _gt_vertices(batch, n_real)
        if gt_verts is not None:
            pred_v = _host(res.vertices)[:n_real]
            state.n_mesh += n_real
            state.sum_pve += float(
                metrics_lib.pve_np(pred_v, gt_verts).sum())
            state.sum_pa_pve += float(
                metrics_lib.pa_pve_np(pred_v, gt_verts).sum())
        state.cursor = batch_index + 1
        if checkpoint_path and (batch_index + 1) % save_every == 0:
            state.save(checkpoint_path)

    run = (sharded_fused_fn(estimator, mesh) if mesh is not None
           else estimator.estimate_and_fit)
    _stream_eval(run, batches, state, accumulate, mesh, checkpoint_path)
    n = max(state.n, 1)
    out = {
        "mpjpe_p1": state.sum_mpjpe_p1 / n,
        "mpjpe_scaled": state.sum_mpjpe_scaled / n,
        "pa_mpjpe": state.sum_pa_mpjpe / n,
        "num_frames": state.n,
    }
    out["mpjpe"] = out["mpjpe_p1" if primary_protocol == "p1" else
                       "mpjpe_scaled" if primary_protocol == "scaled" else
                       "pa_mpjpe"]
    if state.n2d:
        out["pckh"] = state.sum_pckh / state.n2d
        out["num_frames_2d"] = state.n2d
    if state.n_mesh:
        out["pve"] = state.sum_pve / state.n_mesh
        out["pa_pve"] = state.sum_pa_pve / state.n_mesh
        out["num_frames_mesh"] = state.n_mesh
    return out


@dataclasses.dataclass
class Eval2DState(_JsonState):
    """Resumable accumulator of :func:`evaluate_pckh`. ``norm`` is kept so
    that a resume under another normalizer starts over."""
    cursor: int = 0
    n: int = 0
    sum_pckh: float = 0.0
    norm: str = "head"
    joint_hits: list = dataclasses.field(
        default_factory=lambda: [0.0] * 14)
    joint_counts: list = dataclasses.field(
        default_factory=lambda: [0.0] * 14)
    # The PCK curve at t·k/10, k = 1..10 (the MPII-style curve); the AUC
    # is its mean.
    curve_hits: list = dataclasses.field(
        default_factory=lambda: [0.0] * 10)


def evaluate_pckh(
    estimator,
    batches: Iterator,          # dicts: images, gt_joints2d[, conf, headsize]
    mesh=None,
    threshold: float = 0.5,
    norm: str = "head",
    checkpoint_path: Optional[str] = None,
    save_every: int = 10,
):
    """Streaming 2D-detector evaluation of ``estimator.estimate_2d`` under
    PCK@``threshold`` (the MPII and LSP protocols).

    ``norm``: ``"head"`` (PCKh, MPII): the batch's ``headsize`` (B,)
    when present (the official 0.6 · head-rectangle size), else the
    head–neck ground-truth segment; ``"torso"`` (LSP PCK, e.g. @0.2): the
    left-shoulder ↔ right-hip diameter (CPM slots 5 and 8), and a sample
    without both endpoints annotated is left out.

    Batches carry ``images`` and ``gt_joints2d`` (B, 14, 2) in the same
    pixel frame; ``conf`` (B, 14) > 0 marks the annotated joints. Returns
    the overall fraction (``pckh``), ``per_joint``, the 10-point
    ``per_threshold`` curve and its ``auc``. ``mesh``: run
    :func:`sharded_2d_fn` over it.
    """
    if norm not in ("head", "torso"):
        raise ValueError(f"norm must be 'head' or 'torso', got {norm!r}")
    state = (Eval2DState.load(checkpoint_path) if checkpoint_path
             else Eval2DState())
    if state.norm != norm:
        state = Eval2DState(norm=norm)   # protocol change: start over

    def accumulate(res, batch, n_real, batch_index):
        pred = _host(res.joints2d).astype(np.float64)[:n_real]
        gt = np.asarray(batch["gt_joints2d"], np.float64)[:n_real]
        headsize = (np.asarray(batch["headsize"])[:n_real]
                    if "headsize" in batch else None)
        mask = (np.asarray(batch["conf"])[:n_real] > 0
                if "conf" in batch else np.ones(gt.shape[:2], bool))
        if norm == "torso":
            # An unannotated endpoint sits at the reader's (0, 0) sentinel:
            # leave the sample out rather than score a garbage diameter.
            valid = mask[:, 5] & mask[:, 8]
            pred, gt, mask = pred[valid], gt[valid], mask[valid]
            if headsize is not None:
                headsize = headsize[valid]
        state.n += int(gt.shape[0])
        if norm == "torso":
            hs = np.linalg.norm(gt[:, 5] - gt[:, 8], axis=-1)
        elif headsize is not None:
            hs = np.asarray(headsize, np.float64)
        else:
            hs = np.linalg.norm(gt[:, 0] - gt[:, 1], axis=-1)
        dist = np.linalg.norm(pred - gt, axis=-1)
        hit = (dist <= threshold * hs[:, None]).astype(np.float64)
        m = mask.astype(np.float64)
        denom = np.maximum(m.sum(-1), 1.0)
        state.sum_pckh += float(((hit * m).sum(-1) / denom).sum())
        for k in range(10):
            t_k = threshold * (k + 1) / 10.0
            h_k = (dist <= t_k * hs[:, None]).astype(np.float64)
            state.curve_hits[k] += float(((h_k * m).sum(-1) / denom).sum())
        for j in range(gt.shape[1]):
            state.joint_hits[j] += float((hit[:, j] * m[:, j]).sum())
            state.joint_counts[j] += float(m[:, j].sum())
        state.cursor = batch_index + 1
        if checkpoint_path and (batch_index + 1) % save_every == 0:
            state.save(checkpoint_path)

    run = (sharded_2d_fn(estimator, mesh) if mesh is not None
           else estimator.estimate_2d)
    _stream_eval(run, batches, state, accumulate, mesh, checkpoint_path)

    from tpu_pose_torch.models import joints as joints_lib
    n = max(state.n, 1)
    curve = {round(threshold * (k + 1) / 10.0, 4):
             state.curve_hits[k] / n for k in range(10)}
    out = {"pckh": state.sum_pckh / n,
           "num_frames": state.n,
           "per_threshold": curve,
           "auc": float(np.mean(list(curve.values()))),
           "per_joint": {}}
    for j, name in enumerate(joints_lib.CPM_JOINT_NAMES):
        c = state.joint_counts[j]
        out["per_joint"][name] = state.joint_hits[j] / c if c else 0.0
    return out


# OKS AP thresholds: the COCO ladder 0.50:0.05:0.95.
OKS_THRESHOLDS = tuple(round(0.5 + 0.05 * i, 2) for i in range(10))


@dataclasses.dataclass
class EvalOKSState(_JsonState):
    """Resumable accumulator of :func:`evaluate_oks`."""
    cursor: int = 0
    n: int = 0
    sum_oks: float = 0.0
    hits: list = dataclasses.field(
        default_factory=lambda: [0.0] * len(OKS_THRESHOLDS))

    @classmethod
    def _valid(cls, d: dict) -> bool:
        return super()._valid(d) and len(d["hits"]) == len(OKS_THRESHOLDS)


def evaluate_oks(
    estimator,
    batches: Iterator,          # dicts: images, gt_joints2d[, conf, area]
    mesh=None,
    checkpoint_path: Optional[str] = None,
    save_every: int = 10,
):
    """Streaming 2D-detector evaluation of ``estimator.estimate_2d`` under
    COCO's OKS: per sample ``metrics.oks_np`` of the decoded joints
    against ``gt_joints2d``, gated by ``conf`` > 0, with object scale
    s² = the batch's ``area`` (crop pixels) or the labelled-keypoint bbox
    stand-in. Returns ``mean_oks``, ``ap`` (the mean over t in
    0.50:0.05:0.95 of the fraction of people with OKS ≥ t), ``ap50``,
    ``ap75`` and ``per_threshold``: one hypothesis per ground-truth person,
    so matching is the identity and precision equals recall (the top-down
    convention). ``mesh``: run :func:`sharded_2d_fn` over it."""
    state = (EvalOKSState.load(checkpoint_path) if checkpoint_path
             else EvalOKSState())

    def accumulate(res, batch, n_real, batch_index):
        pred = _host(res.joints2d).astype(np.float64)[:n_real]
        gt = np.asarray(batch["gt_joints2d"], np.float64)[:n_real]
        mask = (np.asarray(batch["conf"])[:n_real] > 0
                if "conf" in batch else np.ones(gt.shape[:2], bool))
        area = (np.asarray(batch["area"], np.float64)[:n_real]
                if "area" in batch
                else metrics_lib.keypoint_bbox_area_np(gt, mask))
        oks = metrics_lib.oks_np(pred, gt, area, mask=mask)
        state.n += n_real
        state.sum_oks += float(oks.sum())
        for k, t in enumerate(OKS_THRESHOLDS):
            state.hits[k] += float((oks >= t).sum())
        state.cursor = batch_index + 1
        if checkpoint_path and (batch_index + 1) % save_every == 0:
            state.save(checkpoint_path)

    run = (sharded_2d_fn(estimator, mesh) if mesh is not None
           else estimator.estimate_2d)
    _stream_eval(run, batches, state, accumulate, mesh, checkpoint_path)

    n = max(state.n, 1)
    per_t = {t: state.hits[k] / n for k, t in enumerate(OKS_THRESHOLDS)}
    return {
        "mean_oks": state.sum_oks / n,
        "ap": float(np.mean(list(per_t.values()))),
        "ap50": per_t[0.5],
        "ap75": per_t[0.75],
        "per_threshold": per_t,
        "num_frames": state.n,
    }
