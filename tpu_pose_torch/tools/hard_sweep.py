"""Hard-set training study (port of ``tpu_pose/tools/hard_sweep.py`` on
argparse, with the same flags and ``--device``): trains a grid of CPM
configurations on the hard set and scores each on the same held-out hard
frames (visible-joint 2D px error and PA-MPJPE, plain and with
refine_center + flip TTA), saving each configuration's weights so other
tools (``track_bench``) can compare them.

Grid syntax: ``--grid name:steps:pool_batches:distractor_prob``
``[:share_trunk[:features[:union[:max_d]]]]``, comma-separated;
``union`` 0/1 switches stage-1 supervision to the union heatmaps (see
``cpm_train.stage_supervision_loss``), ``max_d`` draws 1..N distractors
per triggered frame::

  python -m tpu_pose_torch.tools.hard_sweep --out hard_sweep \\
      --grid r3:2400:32:0.0,dis:2400:32:0.35,u2:9600:64:0.35:0:0:1:2

Every configuration trains from the same init (seed 1) on pools drawn
with the same seeds, so rows differ only in the axis under study. The
training is the self-check's: a device-resident uint8 pool, the
warmup-cosine schedule, batch ``--train_batch``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import List, Optional


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpu-pose-torch-hard-sweep",
        description="Train and score a grid of CPM configurations on the "
        "hard synthetic set.")
    p.add_argument("--grid", default="r3:2400:32:0.0,dis:2400:32:0.35",
                   help="comma list of "
                   "name:steps:pool:distractor[:share_trunk[:features"
                   "[:union[:max_d]]]]")
    p.add_argument("--train_batch", type=int, default=16,
                   help="training batch size")
    p.add_argument("--eval_frames", type=int, default=48,
                   help="held-out hard eval frames")
    p.add_argument("--restarts", type=int, default=2,
                   help="fit hypotheses for the PA eval")
    p.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "tpu_pose_torch_hard_sweep"),
        help="output directory (weights per configuration + sweep.json)")
    p.add_argument("--device", default="cuda", help="torch device")
    return p.parse_args(argv)


def parse_grid(grid: str) -> List[dict]:
    """``--grid``'s rows as dicts: name, steps, pool, distractor and the
    optional share_trunk (False), features (0: the base width), union
    (False) and max_d (1)."""
    configs = []
    for item in grid.split(","):
        parts = item.strip().split(":")
        configs.append({
            "name": parts[0], "steps": int(parts[1]),
            "pool": int(parts[2]), "distractor": float(parts[3]),
            "share_trunk": bool(int(parts[4])) if len(parts) > 4
            else False,
            "features": int(parts[5]) if len(parts) > 5 else 0,
            "union": bool(int(parts[6])) if len(parts) > 6 else False,
            "max_d": int(parts[7]) if len(parts) > 7 else 1})
    return configs


def row_config(base_cfg, c: dict):
    """The CPM configuration of a grid row: ``share_trunk`` and, when
    ``features`` is set, that width for the trunk and the stages."""
    if not (c["share_trunk"] or c["features"]):
        return base_cfg
    return dataclasses.replace(
        base_cfg, share_trunk=c["share_trunk"],
        **({"features": c["features"], "refine_width": c["features"]}
           if c["features"] else {}))


def main(argv=None) -> Optional[dict]:
    args = parse_args(argv)
    import numpy as np
    import torch

    from tpu_pose_torch.api import PoseEstimator
    from tpu_pose_torch.data import synthetic_hard as sh
    from tpu_pose_torch.fitting import priors as priors_lib
    from tpu_pose_torch.models import cpm_train
    from tpu_pose_torch.tools.selfcheck_e2e import default_setup
    from tpu_pose_torch.utils import checkpoint as ckpt_lib
    from tpu_pose_torch.utils import metrics, profiling

    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()

    def log(msg):
        print(f"[{time.time() - t0:6.0f}s] {msg}", flush=True)

    device = torch.device(args.device)
    configs = parse_grid(args.grid)
    base_cfg, fit_cfg, model = default_setup(device)
    prior = priors_lib.synthetic_gmm_prior(0, device=device)
    host_model = model.to("cpu")

    # One held-out eval set for every row (its seed is disjoint from the
    # pools' seed * 9973 + b stream).
    ev = sh.make_hard_examples(host_model, args.eval_frames, base_cfg,
                               seed=4321, scale_range=(0.45, 0.95))

    def eval_row(cpm, cfg, tag, **est_kw):
        est = PoseEstimator(cpm, model, prior, cfg, fit_cfg, device=device,
                            fit_restarts=args.restarts, **est_kw)
        res = est.estimate_and_fit(ev["images"])
        profiling.sync(res.theta)
        vis = ev["visibility"] > 0
        d = np.linalg.norm(res.joints2d.cpu().numpy() - ev["joints2d"],
                           axis=-1)
        px = float(d[vis].mean())
        pa = float(np.mean(metrics.pa_mpjpe_np(
            res.joints3d.cpu().numpy(), ev["gt_joints3d"]))) * 1000
        log(f"  {tag}: {px:.2f} px (visible) | PA {pa:.1f} mm")
        return {"px": round(px, 2), "pa_mm": round(pa, 1)}

    rows, pools = {}, {}
    for c in configs:
        cfg = row_config(base_cfg, c)
        pool_key = (c["pool"], c["distractor"], c["union"], c["max_d"])
        if pool_key not in pools:
            log(f"generating pool {pool_key} "
                f"({c['pool']}×{args.train_batch} frames)...")
            pools[pool_key] = [
                {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in b.items()}
                for b in sh.hard_train_batches(
                    host_model, args.train_batch, c["pool"], base_cfg,
                    seed=0, raw_images=True,
                    distractor_prob=c["distractor"],
                    max_distractors=c["max_d"], union_stage1=c["union"])]
        pool = pools[pool_key]

        log(f"config {c['name']}: {c['steps']} steps, pool {c['pool']}, "
            f"distractor {c['distractor']}, share_trunk "
            f"{c['share_trunk']}")
        cpm, opt_state, opt = cpm_train.init_train_state(
            1, cfg, lr=2e-4, total_steps=c["steps"], device=device)
        step = cpm_train.make_train_step(cfg, opt)
        loss = None
        for s_i in range(c["steps"]):
            cpm, opt_state, loss = step(cpm, opt_state,
                                        pool[s_i % len(pool)])
            if (s_i + 1) % 400 == 0:
                log(f"  step {s_i + 1}: loss {float(loss):.5f}")
        wpath = os.path.join(args.out, f"cpm_{c['name']}.npz")
        ckpt_lib.save_cpm_params(wpath, cpm)
        row = {"config": dict(c), "final_loss": float(loss),
               "weights": wpath}
        row["plain"] = eval_row(cpm, cfg, f"{c['name']} plain")
        row["rc_flip"] = eval_row(cpm, cfg, f"{c['name']} rc+flip",
                                  refine_center=True, flip_tta=True)
        rows[c["name"]] = row
        with open(os.path.join(args.out, "sweep.json"), "w") as f:
            json.dump(rows, f, indent=2)
    log(f"done → {args.out}/sweep.json")
    return rows


def run():
    """Console entry point (``pyproject.toml`` ``[project.scripts]``)."""
    main()


if __name__ == "__main__":
    run()
