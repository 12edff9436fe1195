"""Serve the fused pipeline over HTTP (``tpu_pose_torch/serving_http.py``):
micro-batched ``POST /predict`` (or ``/fit``), with ``/healthz``,
``/stats`` and Prometheus ``/metrics``. Port of ``tpu_pose/tools/
serve.py`` on argparse, with the same flags.

  # synthetic weights (no --cpm_npz), on the GPU:
  python -m tpu_pose_torch.tools.serve --port 8080

  # artifact-only serving host (tpu-pose-torch-export wrote the artifact;
  # no model code or weights needed):
  python -m tpu_pose_torch.tools.serve --artifact /srv/pose_artifact

  # converted weights, int8 CPM for large batches:
  tpu-pose-torch-serve --cpm_npz w.npz --smpl_pkl smpl.pkl \\
      --quantize --max_batch 128 --port 8080

  # client:
  python -c "import numpy as np; np.save('f.npy', np.zeros((480, 640, 3), np.uint8))"
  curl -X POST -H 'Content-Type: application/x-npy' --data-binary @f.npy \\
      'http://localhost:8080/predict?fields=joints2d,conf,theta'
"""

from __future__ import annotations

import argparse

DEFAULT_FIELDS = {
    "estimate_and_fit": ("joints2d", "conf", "theta", "beta", "cam",
                         "energy"),
    "estimate_and_fit_multi": ("joints2d", "conf", "person_scores",
                               "person_mask", "theta", "beta", "cam",
                               "energy"),
    "fit_smpl": None,   # FitResult is already compact
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpu-pose-torch-serve",
        description="Serve tpu_pose_torch's fused pipeline over HTTP.")
    p.add_argument("--artifact", default="", help="deployment artifact "
                   "directory (tpu_pose_torch/export.py): serve it with no "
                   "model code or weights; --fn must match its exported fn")
    p.add_argument("--cpm_npz", default="", help="converted CPM weights "
                   "(.npz); synthetic weights if empty and no --artifact")
    p.add_argument("--smpl_pkl", default="", help="SMPL model pickle")
    p.add_argument("--gmm_pkl", default="", help="GMM pose-prior pickle "
                   "(optional)")
    p.add_argument("--quantize", action="store_true", help="int8 CPM "
                   "weights for large batches (batch-size policy)")
    p.add_argument("--device", default="cuda", help="torch device of the "
                   "estimator")
    p.add_argument("--host", default="0.0.0.0", help="bind address")
    p.add_argument("--port", type=int, default=8080,
                   help="bind port (0 = pick a free one)")
    p.add_argument("--max_batch", type=int, default=64,
                   help="largest device batch")
    p.add_argument("--max_queue", type=int, default=-1, help="shed with "
                   "503 + Retry-After once this many requests are queued "
                   "(-1 = 8*max_batch, 0 = unbounded)")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="batch-fill wait after the first queued request")
    p.add_argument("--fn", default="estimate_and_fit",
                   choices=sorted(DEFAULT_FIELDS),
                   help="entry point to serve: the single-person path "
                   "(POST /predict), the multi-person path, or joints-only "
                   "fitting (POST /fit, for external 2D detectors)")
    p.add_argument("--allow_empty", action="store_true", help="multi-person "
                   "servers may report zero people on a person-free frame "
                   "instead of always keeping the top hypothesis")
    p.add_argument("--max_people", type=int, default=2, help="hypothesis "
                   "slots for --fn estimate_and_fit_multi")
    p.add_argument("--fields", default="", help="comma-separated result "
                   "fields; empty = a per-fn default without 'vertices' "
                   "(~80 KB/frame; rebuild it from theta/beta), "
                   "'all' = everything")
    p.add_argument("--verbose", action="store_true", help="log each request")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from tpu_pose_torch.serving_http import PoseHTTPServer

    if args.artifact:
        from tpu_pose_torch.export import ServableProgram
        est = ServableProgram(args.artifact)
        print(f"serving artifact {args.artifact} (fn={est.fn}, platforms="
              f"{est.program.platforms})", flush=True)
    elif args.cpm_npz and args.smpl_pkl:
        from tpu_pose_torch.api import PoseEstimator
        est = PoseEstimator.from_files(
            args.cpm_npz, args.smpl_pkl, args.gmm_pkl or None,
            quantize=args.quantize, letterbox=True, device=args.device)
    else:
        from tpu_pose_torch.api import PoseEstimator
        print("note: no weights supplied — synthetic estimator "
              "(smoke-test mode)", flush=True)
        est = PoseEstimator.create_synthetic(
            seed=0, letterbox=True, quantize=args.quantize,
            device=args.device)
    if args.fields == "all":
        fields = None
    elif args.fields:
        fields = tuple(f for f in args.fields.split(",") if f)
    else:
        fields = DEFAULT_FIELDS[args.fn]
    # An artifact bakes the multi-person knobs at export time.
    fn_kwargs = ({"max_people": args.max_people,
                  "allow_empty": args.allow_empty}
                 if args.fn == "estimate_and_fit_multi" and not args.artifact
                 else None)
    srv = PoseHTTPServer(est, host=args.host, port=args.port,
                         max_batch=args.max_batch,
                         max_wait_ms=args.max_wait_ms,
                         max_queue=(None if args.max_queue < 0
                                    else args.max_queue),
                         fields=fields, fn=args.fn, fn_kwargs=fn_kwargs,
                         verbose=args.verbose)
    route = "/fit" if args.fn == "fit_smpl" else "/predict"
    print(f"listening on http://{srv.host}:{srv.port}  "
          f"(POST {route}, GET /healthz /stats /metrics)", flush=True)
    srv.serve_forever()


def run():
    """Console entry point (``pyproject.toml`` ``[project.scripts]``)."""
    main()


if __name__ == "__main__":
    run()
