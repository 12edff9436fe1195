"""2D-detector evaluation (port of ``tpu_pose/tools/eval_2d.py`` on
argparse, with the same flags and ``--device``): PCKh@t (MPII), torso PCK
(LSP) or COCO OKS with AP over npz shards from
``tools/convert_dataset.py``, streamed through ``estimate_2d`` with the
evaluators' one-deep pipeline and cursor resume
(``parallel/eval.evaluate_pckh`` / ``evaluate_oks``).

  python -m tpu_pose_torch.tools.eval_2d --data_dir mpii_shards \\
      --cpm_npz cpm.npz --batch 64
  python -m tpu_pose_torch.tools.eval_2d --synthetic_batches 5 --batch 32
"""

from __future__ import annotations

import argparse


def _bool_flag(p, name: str, default: bool, help: str) -> None:
    """``--name`` / ``--noname``, as the JAX CLI's boolean flags."""
    p.add_argument(f"--{name}", dest=name, action="store_true",
                   default=default, help=help)
    p.add_argument(f"--no{name}", dest=name, action="store_false",
                   help=argparse.SUPPRESS)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpu-pose-torch-eval-2d",
        description="Evaluate tpu_pose_torch's 2D detector (PCK / OKS).")
    p.add_argument("--data_dir", default="", help="shard directory "
                   "(images/gt_joints2d/conf/headsize)")
    p.add_argument("--synthetic_batches", type=int, default=0,
                   help="evaluate N synthetic batches instead of shards")
    p.add_argument("--batch", type=int, default=32, help="batch size")
    p.add_argument("--cpm_npz", default="", help="CPM weights npz "
                   "(synthetic weights if empty)")
    p.add_argument("--smpl_pkl", default="", help="SMPL pickle; optional, "
                   "the 2D evaluation never fits")
    p.add_argument("--threshold", type=float, default=0.5, help="PCK "
                   "threshold (0.5 for MPII PCKh@0.5, 0.2 for LSP "
                   "PCK@0.2)")
    p.add_argument("--norm", default="head", choices=["head", "torso"],
                   help="normalizer: head = MPII PCKh (headsize or the "
                   "head-neck proxy), torso = LSP PCK (l_shoulder-r_hip)")
    p.add_argument("--protocol", default="pck", choices=["pck", "oks"],
                   help="pck = the threshold metric under --norm; oks = "
                   "COCO OKS with AP@[.50:.05:.95] (the shards' area key "
                   "when present)")
    p.add_argument("--resume", default="", help="cursor checkpoint path "
                   "(json)")
    _bool_flag(p, "refine_center", True, "in-graph person localization "
               "(--norefine_center turns it off)")
    _bool_flag(p, "refine_scale", False, "crop/zoom scale-normalization "
               "second pass")
    _bool_flag(p, "flip_tta", False, "horizontal-flip test-time "
               "augmentation")
    p.add_argument("--scale_tta", default="", help="multi-scale TTA zoom "
                   "factors, comma-separated, e.g. 0.8,1.2")
    p.add_argument("--device", default="cuda", help="torch device")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from tpu_pose_torch.api import PoseEstimator
    from tpu_pose_torch.data import pipeline, synthetic
    from tpu_pose_torch.models import cpm as cpm_lib
    from tpu_pose_torch.models import smpl_data
    from tpu_pose_torch.parallel import eval as eval_lib
    from tpu_pose_torch.parallel import mesh as mesh_lib
    from tpu_pose_torch.utils import tf_converter

    if not (args.synthetic_batches or args.data_dir):
        raise SystemExit("provide --data_dir or --synthetic_batches")
    # Under torchrun with more than one rank: every rank evaluates the same
    # global batches, each fitting its rows; rank 0 prints and writes.
    mesh = mesh_lib.launcher_mesh(args.device)
    say = mesh_lib.rank0_print
    kw = dict(refine_center=args.refine_center,
              refine_scale=args.refine_scale, flip_tta=args.flip_tta,
              scale_tta=tuple(float(s) for s in args.scale_tta.split(",")
                              if s), device=args.device)
    if args.cpm_npz and args.smpl_pkl:
        est = PoseEstimator.from_files(args.cpm_npz, args.smpl_pkl, **kw)
    elif args.cpm_npz:
        est = PoseEstimator(
            cpm_lib.cpm_params_from_numpy(
                tf_converter.load_params_npz(args.cpm_npz),
                device=args.device),
            smpl_data.synthetic_smpl(seed=0, device=args.device), **kw)
    else:
        say("note: no weights supplied — synthetic estimator", flush=True)
        est = PoseEstimator.create_synthetic(seed=0, **kw)

    if args.synthetic_batches:
        batches = synthetic.eval_batches(
            est.smpl_model, args.batch, args.synthetic_batches, est.cpm_cfg)
    else:
        keys = ["images", "gt_joints2d", "conf"]
        if args.protocol == "oks":
            # area is optional: COCO shards carry it, LSP/MPII ones do
            # not (the evaluator then takes the keypoint-bbox stand-in).
            src = pipeline.NpzShardSource(args.data_dir)
            if len(src) and "area" in src[0]:
                keys.append("area")
        else:
            keys.append("headsize")
        batches = pipeline.batches(args.data_dir, args.batch,
                                   keys=tuple(keys), shard_by_process=False)

    if args.protocol == "oks":
        out = eval_lib.evaluate_oks(
            est, batches, mesh=mesh, checkpoint_path=args.resume or None)
        say(f"frames={out['num_frames']}  "
              f"meanOKS={out['mean_oks']:.3f}  "
              f"AP={out['ap'] * 100:.1f}  AP50={out['ap50'] * 100:.1f}  "
              f"AP75={out['ap75'] * 100:.1f}", flush=True)
        return out
    out = eval_lib.evaluate_pckh(
        est, batches, mesh=mesh, threshold=args.threshold, norm=args.norm,
        checkpoint_path=args.resume or None)
    name = "PCKh" if args.norm == "head" else "PCK(torso)"
    say(f"frames={out['num_frames']}  "
          f"{name}@{args.threshold}={out['pckh'] * 100:.1f}%  "
          f"AUC(0..{args.threshold})={out['auc'] * 100:.1f}%", flush=True)
    for joint, v in out["per_joint"].items():
        say(f"  {joint:12s} {v * 100:5.1f}%", flush=True)
    return out


def run():
    """Console entry point (``pyproject.toml`` ``[project.scripts]``)."""
    main()


if __name__ == "__main__":
    run()
