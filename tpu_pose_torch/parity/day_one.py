"""One-command day-one reference playbook (port of
``tpu_pose/parity/day_one.py``).

The moment a reference directory (or the license-gated files) appears,
this module runs the whole retire-the-risk chain unattended:

    discover assets → convert the TF1 CPM ckpt → load the real SMPL
    pickle (+ GMM prior) → stage parity → ≤1 mm fit-gap certification →
    optional constant auto-sweep → synthetic smoke eval

and emits ONE JSON verdict. ``python -m
tpu_pose_torch.tools.reference_day_one --reference <dir>`` runs it; the
tests prove the chain against a fabricated reference-like directory with
the real on-disk schemas (TF1 checkpoint, chumpy/scipy-sparse SMPL
pickle, SMPLify GMM pickle).
"""

from __future__ import annotations

import json
import os
import pickle
import tempfile
import time
from typing import Optional

import numpy as np

from tpu_pose_torch.utils.config import CPMConfig, FitConfig


def _peek_pickle_kind(path: str) -> str:
    """Classify a .pkl by its payload: 'smpl' (v_template et al.),
    'gmm' (SMPLify means/covars/weights), or 'unknown'."""
    try:
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="latin1")
    except Exception:
        return "unknown"
    if not isinstance(d, dict):
        return "unknown"
    keys = {k.decode() if isinstance(k, bytes) else k for k in d}
    if "v_template" in keys and "kintree_table" in keys:
        return "smpl"
    if {"means", "weights"} <= keys and ("covars" in keys
                                         or "precisions" in keys):
        return "gmm"
    return "unknown"


def _is_params_npz(path: str) -> bool:
    """A pre-converted CPM params npz in ``utils/tf_converter
    .save_params_npz``'s layout: ``<layer>.w`` (or ``<layer>.w_int8``)
    and ``<layer>.b`` keys. (The JAX package's check looks for
    ``<layer>/w`` keys, which that writer never produces.)"""
    try:
        with np.load(path) as z:
            names = list(z.files)
    except Exception:
        return False
    return any(n.endswith((".w", ".w_int8")) for n in names) and any(
        n.endswith(".b") for n in names)


def discover_assets(reference_dir: str) -> dict:
    """Walk a reference-like directory and classify every asset the
    pipeline can consume. Returns {ckpt, cpm_npz, smpl_pkl, gmm_pkl,
    files_seen}; absent assets are None."""
    out = {"ckpt": None, "cpm_npz": None, "smpl_pkl": None,
           "gmm_pkl": None, "files_seen": 0}
    for root, _, files in os.walk(reference_dir):
        for name in sorted(files):
            path = os.path.join(root, name)
            out["files_seen"] += 1
            if name.endswith(".index") and out["ckpt"] is None:
                out["ckpt"] = path[: -len(".index")]  # TF saver prefix
            elif name.endswith(".npz") and out["cpm_npz"] is None:
                if _is_params_npz(path):
                    out["cpm_npz"] = path
            elif name.endswith(".pkl"):
                kind = _peek_pickle_kind(path)
                if kind == "smpl" and out["smpl_pkl"] is None:
                    out["smpl_pkl"] = path
                elif kind == "gmm" and out["gmm_pkl"] is None:
                    out["gmm_pkl"] = path
    return out


def run_day_one(reference_dir: str,
                out_dir: str = os.path.join(tempfile.gettempdir(),
                                            "tpu_pose_torch_day_one"),
                cpm_cfg: CPMConfig = CPMConfig(),
                fit_cfg: Optional[FitConfig] = None,
                frames: int = 4,
                sweep: bool = False,
                sweep_passes: int = 1,
                eval_frames: int = 8,
                eval_batch: int = 4,
                target_mm: float = 1.0,
                seed: int = 0,
                log=print,
                device=None) -> dict:
    """The unattended day-one chain (module docstring) on ``device``
    (None: the GPU). Returns the verdict dict; also writes
    ``<out_dir>/day_one_verdict.json``. ``verdict["seconds"]`` times each
    section on the host clock.

    The reference's own fit is not runnable until its code appears;
    certification therefore runs against the reference-style float64
    oracle (``parity/oracle.py``) built on the LOADED model data — the
    strongest binding available, and exactly the harness the real
    reference's fit slots into (``OraclePipeline.fit_batch`` interface).
    """
    from tpu_pose_torch.api import PoseEstimator
    from tpu_pose_torch.models import cpm as cpm_lib
    from tpu_pose_torch.parity import harness

    t_start = t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    verdict: dict = {"reference_dir": reference_dir,
                     "missing": [], "ok": False}
    seconds = verdict["seconds"] = {}

    # -- 1. discover -------------------------------------------------------
    assets = discover_assets(reference_dir)
    verdict["assets"] = assets
    log(f"day-one: discovered {assets}")
    if assets["smpl_pkl"] is None:
        verdict["missing"].append("smpl_pkl")
    if assets["ckpt"] is None and assets["cpm_npz"] is None:
        verdict["missing"].append("cpm_checkpoint")
    seconds["discover"] = time.perf_counter() - t0

    # -- 2. convert the CPM checkpoint ------------------------------------
    cpm_npz = assets["cpm_npz"]
    if cpm_npz is None and assets["ckpt"] is not None:
        from tpu_pose_torch.utils import tf_converter
        t0 = time.perf_counter()
        layer_names = [d[0] for d in cpm_lib._layer_defs(cpm_cfg)]
        log(f"day-one: converting {assets['ckpt']} "
            f"({len(layer_names)} layers)...")
        params = tf_converter.convert_tf_checkpoint(assets["ckpt"],
                                                    layer_names)
        cpm_npz = os.path.join(out_dir, "cpm_weights.npz")
        tf_converter.save_params_npz(cpm_npz, params)
        verdict["converted_layers"] = len(params)
        seconds["convert"] = time.perf_counter() - t0
        log(f"day-one: wrote {cpm_npz}")

    if verdict["missing"]:
        log(f"day-one: INCOMPLETE — missing {verdict['missing']}")
        _save(out_dir, verdict)
        return verdict

    # -- 3. load everything through the public constructors ---------------
    t0 = time.perf_counter()
    est = PoseEstimator.from_files(
        cpm_npz, assets["smpl_pkl"], gmm_pkl=assets["gmm_pkl"],
        cpm_cfg=cpm_cfg, device=device,
        **({} if fit_cfg is None else {"fit_cfg": fit_cfg}))
    seconds["load"] = time.perf_counter() - t0
    log("day-one: real assets loaded (PoseEstimator.from_files)")

    # -- 4. stage parity + certification vs the reference-style oracle ----
    log(f"day-one: certifying fit parity on {frames} probe frames "
        "(oracle fits run a host scipy loop — minutes, not seconds)...")
    t0 = time.perf_counter()
    cert = harness.certify(est.smpl_model, prior=est.prior,
                           n_frames=frames, seed=seed,
                           target_mm=target_mm, device=est.device)
    seconds["certify"] = time.perf_counter() - t0
    verdict["certification"] = cert
    log(f"day-one: fit gap {cert['fit_gap']['mpjpe_gap_mm_mean']:.3f} mm "
        f"mean (target ≤{target_mm}) → "
        f"{'CERTIFIED' if cert['certified'] else 'NOT CERTIFIED'}")

    # -- 5. optional constants auto-sweep ----------------------------------
    if sweep:
        from tpu_pose_torch.parity import oracle as oracle_lib
        from tpu_pose_torch.parity import sweep as sweep_lib
        t0 = time.perf_counter()
        pipe = oracle_lib.OraclePipeline(est.smpl_model.to_numpy(),
                                         gmm=harness.oracle_gmm(est.prior))
        j2d, conf, _ = harness.make_clean_observations(
            est.smpl_model, frames, pipe.cfg.img_size, seed=seed)
        log("day-one: sweep — running oracle probe fits...")
        ref_out = pipe.fit_batch(j2d, conf)
        verdict["sweep"] = sweep_lib.auto_sweep(
            est.smpl_model, ref_out, j2d, conf, prior=est.prior,
            passes=sweep_passes, log=log, device=est.device)
        seconds["sweep"] = time.perf_counter() - t0

    # -- 6. smoke eval through the fused pipeline --------------------------
    from tpu_pose_torch.data import synthetic
    from tpu_pose_torch.parallel import eval as eval_lib
    t0 = time.perf_counter()
    n_batches = max(1, eval_frames // eval_batch)
    log(f"day-one: smoke eval ({n_batches}×{eval_batch} frames, fused "
        "pipeline with the CONVERTED weights)...")
    batches = synthetic.eval_batches(est.smpl_model, eval_batch,
                                     n_batches, cpm_cfg, seed=seed + 1)
    verdict["smoke_eval"] = eval_lib.evaluate_h36m_style(est, batches)
    seconds["smoke_eval"] = time.perf_counter() - t0
    # Executed-through check, not an accuracy bar: converted weights are
    # whatever the reference shipped; synthetic imagery is off-domain.
    finite = np.isfinite([verdict["smoke_eval"]["mpjpe_p1"],
                          verdict["smoke_eval"]["pa_mpjpe"]]).all()

    verdict["elapsed_s"] = round(time.perf_counter() - t_start, 1)
    verdict["ok"] = bool(cert["certified"] and finite)
    _save(out_dir, verdict)
    log(f"day-one: verdict ok={verdict['ok']} "
        f"({verdict['elapsed_s']}s) → {out_dir}/day_one_verdict.json")
    return verdict


def _save(out_dir: str, verdict: dict) -> None:
    path = os.path.join(out_dir, "day_one_verdict.json")
    with open(path, "w") as f:
        json.dump(verdict, f, indent=2, default=float)
