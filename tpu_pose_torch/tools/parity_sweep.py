"""Turn-key parity certification + auto-sweep against a reference-style
pipeline (port of ``tpu_pose/tools/parity_sweep.py`` on argparse, with
the same flags and ``--device``).

Modes:
  --certify         stage parity + matched-constants fit gap vs the
                    float64 host oracle on clean synthetic observations;
                    prints the achieved MPJPE gap against the 1 mm target.
  --sweep           treat the oracle's constants as unknown: fit probe
                    frames with BOTH pipelines and greedy-sweep FitConfig
                    (optimizer, iters/lr, λ's, gmof_sigma) to close the
                    output gap. Writes the best config + residual JSON.

The port's fits run on ``--device``, the oracle's on the host. Real
assets slot in via --smpl_pkl/--gmm_pkl; a real reference's fit wrapped
in the ``OraclePipeline`` interface (``fit_batch``) goes to
``harness.fit_gap`` / ``sweep.auto_sweep`` unchanged.

  python -m tpu_pose_torch.tools.parity_sweep --certify
  python -m tpu_pose_torch.tools.parity_sweep --sweep --frames 6 \\
      --out parity.json
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from tpu_pose_torch.tools.eval_2d import _bool_flag


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpu-pose-torch-parity-sweep",
        description="Certify the port's fit against the reference-style "
        "oracle, or sweep its constants to match the oracle's outputs.")
    _bool_flag(p, "certify", False, "run the ≤1 mm certification")
    _bool_flag(p, "sweep", False, "run the config auto-sweep")
    p.add_argument("--frames", type=int, default=4, help="probe frames")
    p.add_argument("--seed", type=int, default=0, help="probe-data seed")
    p.add_argument("--verts", type=int, default=0, help="synthetic model "
                   "vertex count (0 = full 6890)")
    p.add_argument("--smpl_pkl", default="", help="real SMPL pickle "
                   "(synthetic if empty)")
    p.add_argument("--gmm_pkl", default="", help="real GMM prior pickle "
                   "(optional)")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "parity_report.json"),
                   help="JSON report path")
    p.add_argument("--passes", type=int, default=2, help="sweep "
                   "coordinate-descent passes")
    p.add_argument("--target_mm", type=float, default=1.0,
                   help="certification target")
    p.add_argument("--oracle_sigma", default="", help="override the "
                   "oracle's gmof_sigma (simulates unknown reference "
                   "constants for --sweep)")
    p.add_argument("--device", default="cuda", help="torch device of the "
                   "port's fits")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from tpu_pose_torch.fitting import priors as priors_lib
    from tpu_pose_torch.models import smpl_data
    from tpu_pose_torch.parity import harness, oracle, sweep

    if args.smpl_pkl:
        model = smpl_data.load_smpl_pickle(args.smpl_pkl, device=args.device)
    else:
        model = smpl_data.synthetic_smpl(
            seed=0, device=args.device,
            **({"num_verts": args.verts} if args.verts else {}))
    prior = (priors_lib.load_gmm_pickle(args.gmm_pkl, device=args.device)
             if args.gmm_pkl
             else priors_lib.synthetic_gmm_prior(0, device=args.device))

    report = {}
    if args.certify or not args.sweep:
        report["certification"] = harness.certify(
            model, prior=prior, n_frames=args.frames, seed=args.seed,
            target_mm=args.target_mm, device=args.device)
        c = report["certification"]
        print(f"stage parity: {json.dumps(c['stage_parity'])}")
        print(f"fit gap: {c['fit_gap']['mpjpe_gap_mm_mean']:.3f} mm mean / "
              f"{c['fit_gap']['mpjpe_gap_mm_max']:.3f} mm max "
              f"(target ≤{args.target_mm} mm) → "
              f"{'CERTIFIED' if c['certified'] else 'NOT certified'}",
              flush=True)

    if args.sweep:
        ocfg = oracle.OracleConfig(**(
            {"gmof_sigma": float(args.oracle_sigma)}
            if args.oracle_sigma else {}))
        pipe = oracle.OraclePipeline(model.to_numpy(),
                                     gmm=harness.oracle_gmm(prior),
                                     cfg=ocfg)
        j2d, conf, _ = harness.make_clean_observations(
            model, args.frames, ocfg.img_size, seed=args.seed)
        print("running oracle fits (host scipy loop)...", flush=True)
        ref_out = pipe.fit_batch(j2d, conf)
        report["sweep"] = sweep.auto_sweep(
            model, ref_out, j2d, conf, prior=prior, passes=args.passes,
            log=lambda s: print(s, flush=True), device=args.device)
        s = report["sweep"]
        print(f"sweep: best gap {s['best_gap_mm']:.3f} mm after "
              f"{s['evals']} configs; best setting {s['best_setting']}",
              flush=True)

    sweep.save_report(args.out, report)
    print(f"report written to {args.out}", flush=True)
    return report


def run():
    """Console entry point (``pyproject.toml`` ``[project.scripts]``)."""
    main()


if __name__ == "__main__":
    run()
