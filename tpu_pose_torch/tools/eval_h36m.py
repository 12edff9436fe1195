"""Dataset-scale 3D evaluation (port of ``tpu_pose/tools/eval_h36m.py``
on argparse, with the same flags and ``--device``): streams batches
through ``estimate_and_fit`` and accumulates MPJPE (Protocol 1, scaled,
PA), PCKh and, for shards with SMPL ground truth, PVE / PA-PVE
(``parallel/eval.evaluate_h36m_style``), resumable from a cursor file.
Human3.6M-style npz shards (images + gt_joints3d in the SMPL 24-joint
frame) or synthetic batches.

  python -m tpu_pose_torch.tools.eval_h36m --synthetic_batches 10 --batch 32
  python -m tpu_pose_torch.tools.eval_h36m --data_dir h36m_shards \\
      --batch 64 --resume eval_cursor.json
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpu-pose-torch-eval-h36m",
        description="Evaluate tpu_pose_torch's fused estimate-and-fit "
        "under the H3.6M protocols.")
    p.add_argument("--data_dir", default="", help="npz-shard directory "
                   "with images/gt_joints3d")
    p.add_argument("--synthetic_batches", type=int, default=0,
                   help="evaluate N synthetic batches instead of shards")
    p.add_argument("--batch", type=int, default=32, help="batch size")
    p.add_argument("--cpm_npz", default="", help="CPM weights npz "
                   "(synthetic weights if empty)")
    p.add_argument("--smpl_pkl", default="", help="SMPL pickle "
                   "(synthetic if empty)")
    p.add_argument("--gmm_pkl", default="", help="GMM prior pickle "
                   "(optional)")
    p.add_argument("--gmm_npz", default="", help="precision-form fitted "
                   "prior (fitting/priors.save_gmm_npz; optional)")
    p.add_argument("--fit_prior", type=int, default=0, help="EM-fit a "
                   "GMM-8 prior on N sampled synthetic poses "
                   "(fitting/priors.fit_gmm); 0 = the default prior")
    p.add_argument("--resume", default="", help="cursor checkpoint path "
                   "(json)")
    p.add_argument("--h36m_joints", action="store_true", help="score in "
                   "the 17-joint H3.6M convention instead of SMPL-24")
    p.add_argument("--restarts", type=int, default=1, help="global-yaw fit "
                   "hypotheses per frame")
    p.add_argument("--protocol", default="p1", choices=["p1", "scaled",
                                                         "pa"],
                   help="primary MPJPE protocol: p1 = H3.6M Protocol 1 "
                   "(root-aligned, no scale; perspective camera); scaled = "
                   "RMS-extent-matched; pa = Procrustes-aligned")
    p.add_argument("--camera", default="", help="override "
                   "FitConfig.camera_model (weak_perspective | "
                   "perspective)")
    p.add_argument("--focal", type=float, default=0.0, help="perspective "
                   "focal length in network-frame pixels; 0 = the median "
                   "focal_px the shards carry, else FitConfig's default")
    p.add_argument("--device", default="cuda", help="torch device")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import numpy as np

    from tpu_pose_torch.api import PoseEstimator
    from tpu_pose_torch.data import pipeline, synthetic
    from tpu_pose_torch.fitting import priors as priors_lib
    from tpu_pose_torch.models import joints as joints_lib
    from tpu_pose_torch.parallel import eval as eval_lib
    from tpu_pose_torch.parallel import mesh as mesh_lib
    from tpu_pose_torch.utils.config import CPMConfig, FitConfig

    if not (args.synthetic_batches or args.data_dir):
        raise SystemExit("provide --data_dir or --synthetic_batches")
    # Under torchrun with more than one rank: every rank evaluates the same
    # global batches, each fitting its rows; rank 0 prints and writes.
    mesh = mesh_lib.launcher_mesh(args.device)
    say = mesh_lib.rank0_print
    # Protocol 1 scores absolute geometry: the perspective camera.
    camera = args.camera or (
        "perspective" if args.protocol == "p1" else "weak_perspective")
    focal_kw = {}
    if args.focal > 0:
        focal_kw["focal"] = args.focal
    elif camera == "perspective" and args.data_dir:
        # The shards' focal_px is in shard-image pixels; the network frame
        # rescales it by input / S (the stock 368 input is assumed).
        src0 = pipeline.NpzShardSource(args.data_dir)
        if len(src0) and "focal_px" in src0[0]:
            n = min(len(src0), 64)
            med = float(np.median([float(src0[i]["focal_px"])
                                   for i in range(n)]))
            s_img = int(src0[0]["images"].shape[0])
            focal_kw["focal"] = med * CPMConfig().input_size / s_img
            say(f"auto focal: median shard focal_px {med:.1f} "
                  f"(image {s_img}px) → {focal_kw['focal']:.1f} px in "
                  f"the network frame", flush=True)
    fit_cfg = FitConfig(camera_model=camera, **focal_kw)

    prior = None
    if args.gmm_npz:
        prior = priors_lib.load_gmm_npz(args.gmm_npz, device=args.device)
    elif args.fit_prior:
        th, _ = synthetic.sample_poses(np.random.RandomState(0),
                                       args.fit_prior)
        prior = priors_lib.fit_gmm(th[:, 3:], num_components=8,
                                   device=args.device)

    if args.cpm_npz and args.smpl_pkl:
        est = PoseEstimator.from_files(
            args.cpm_npz, args.smpl_pkl, args.gmm_pkl or None,
            fit_cfg=fit_cfg, fit_restarts=args.restarts, prior=prior,
            device=args.device)
    else:
        say("note: no weights supplied — synthetic estimator", flush=True)
        est = PoseEstimator.create_synthetic(
            seed=0, fit_cfg=fit_cfg, fit_restarts=args.restarts, prior=prior,
            device=args.device)

    if args.synthetic_batches:
        batches = synthetic.eval_batches(
            est.smpl_model, args.batch, args.synthetic_batches, est.cpm_cfg)
    else:
        # Whatever ground truth the shards carry: 2D labels add PCKh, SMPL
        # parameters (3DPW-style shards) the mesh-level protocol.
        keys = ["images", "gt_joints3d"]
        src = pipeline.NpzShardSource(args.data_dir)
        if len(src):
            keys += [k for k in ("gt_joints2d", "gt_theta", "gt_beta")
                     if k in src[0]]
        batches = pipeline.batches(args.data_dir, args.batch,
                                   keys=tuple(keys), shard_by_process=False)

    select = None
    if args.h36m_joints:
        select = joints_lib.select_h36m_joints

        def to_h36m_gt(bs):
            # SMPL-24 ground truth (e.g. synthetic batches) goes to the
            # same 17-joint convention as the predictions.
            for b in bs:
                gt = b["gt_joints3d"]
                if gt.shape[-2] == 24:
                    b = dict(b, gt_joints3d=gt[..., joints_lib.H36M_TO_SMPL,
                                               :])
                yield b

        batches = to_h36m_gt(batches)
    out = eval_lib.evaluate_h36m_style(
        est, batches, mesh=mesh, select_joints=select,
        checkpoint_path=args.resume or None,
        primary_protocol=args.protocol)
    line = (f"frames={out['num_frames']}  camera={camera}  "
            f"MPJPE-P1={out['mpjpe_p1'] * 1000:.1f} mm  "
            f"MPJPE-scaled={out['mpjpe_scaled'] * 1000:.1f} mm  "
            f"PA-MPJPE={out['pa_mpjpe'] * 1000:.1f} mm")
    if "pckh" in out:
        line += f"  PCKh@0.5={out['pckh'] * 100:.1f}%"
    if "pve" in out:
        line += (f"  PVE={out['pve'] * 1000:.1f} mm  "
                 f"PA-PVE={out['pa_pve'] * 1000:.1f} mm")
    say(line, flush=True)
    return out


def run():
    """Console entry point (``pyproject.toml`` ``[project.scripts]``)."""
    main()


if __name__ == "__main__":
    run()
