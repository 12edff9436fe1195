"""Build, verify and smoke-run a deployment artifact
(``tpu_pose_torch/export.py``): export one of the fused entry points —
weights, SMPL model and prior in the program — then reload it with no
estimator in scope and run frames through it. Port of ``tpu_pose/tools/
export_deploy.py`` on argparse, with the same flags.

  # synthetic estimator, fused single-person path, any batch, on the GPU:
  python -m tpu_pose_torch.tools.export_deploy --out /tmp/pose_artifact

  # real assets, static serving batch, on the CPU:
  tpu-pose-torch-export --out /srv/pose --cpm_npz w.npz \\
      --smpl_pkl smpl.pkl --batch 128 --platforms cpu

  # check an artifact without loading it (exit 1 when it is bad):
  tpu-pose-torch-export --inspect /srv/pose

Prints one JSON line with the artifact's size, platform and the reload
smoke-run timing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpu-pose-torch-export",
        description="Export, check or inspect a tpu_pose_torch deployment "
                    "artifact.")
    p.add_argument("--out", default="tpu_pose_torch_artifact",
                   help="artifact directory")
    p.add_argument("--fn", default="estimate_and_fit",
                   help="estimate_2d | estimate_and_fit | "
                   "estimate_and_fit_multi | estimate_and_fit_video | "
                   "fit_smpl | video_stream | video_multi_stream (the last "
                   "two build streaming-session artifacts; --batch is the "
                   "window chunk)")
    p.add_argument("--video_mode", default="smooth",
                   help="estimate_and_fit_video fit mode: smooth | temporal "
                   "| independent")
    p.add_argument("--n_devices", type=int, default=0,
                   help="0 = single-device program; N = a data-parallel "
                   "artifact over N ranks (static --batch divisible by N; "
                   "under torchrun --nproc_per_node N rank 0 writes it)")
    p.add_argument("--batch", type=int, default=0,
                   help="static batch size; 0 = symbolic (one artifact, "
                   "any batch)")
    p.add_argument("--platforms", default="",
                   help="cuda or cpu: the device the program is traced and "
                   "runs on; empty = cuda")
    p.add_argument("--cpm_npz", default="",
                   help="converted CPM weights (.npz); synthetic if empty")
    p.add_argument("--smpl_pkl", default="",
                   help="SMPL model pickle; synthetic if empty")
    p.add_argument("--gmm_pkl", default="",
                   help="GMM pose-prior pickle (optional)")
    p.add_argument("--quantize", action="store_true",
                   help="int8 CPM weights (needs a static --batch)")
    p.add_argument("--max_people", type=int, default=2,
                   help="slots for estimate_and_fit_multi")
    p.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                   default=True, help="reload the artifact and run a "
                   "synthetic batch through it")
    p.add_argument("--inspect", default="",
                   help="inspect an EXISTING artifact directory (manifest "
                   "summary + sha256 verification, one JSON line) instead "
                   "of building one")
    return p.parse_args(argv)


def _estimator(args, device):
    from tpu_pose_torch.api import PoseEstimator
    if args.cpm_npz:
        return PoseEstimator.from_files(
            args.cpm_npz, args.smpl_pkl, args.gmm_pkl or None,
            quantize=args.quantize, device=device)
    return PoseEstimator.create_synthetic(seed=0, quantize=args.quantize,
                                          device=device)


def _smoke(record: dict, meta: dict, out: str, fn: str, batch: int,
           img_size: int) -> None:
    from tpu_pose_torch import export as pexport
    prog = pexport.load(out)
    b = batch or 2
    rng = np.random.RandomState(0)
    if fn == "fit_smpl":
        p = meta["inputs"][0]["shape"][1]
        args = (rng.uniform(0, img_size, (b, p, 2)).astype(np.float32),
                np.ones((b, p), np.float32))
    else:
        h, w = meta["input"]["shape"][1:3]
        args = (rng.randint(0, 255, (b, h, w, 3)).astype(np.uint8),)
    t0 = time.perf_counter()
    prog(*args)                      # the first call, warm-up included
    record["smoke_first_s"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    out_arrays = prog(*args)
    record["smoke_run_s"] = round(time.perf_counter() - t0, 4)
    record["smoke_outputs"] = {k: list(v.shape)
                               for k, v in sorted(out_arrays.items())}


def main(argv=None) -> None:
    args = parse_args(argv)
    from tpu_pose_torch import export as pexport
    if args.inspect:
        # Pure file I/O: no estimator, no device, no load.
        info = pexport.inspect_artifact(args.inspect)
        print(json.dumps(info))
        if not info["ok"]:
            sys.exit(1)
        return
    from tpu_pose_torch.parallel import mesh as mesh_lib
    platforms = tuple(p for p in args.platforms.split(",") if p) or ("cuda",)
    if args.n_devices and "WORLD_SIZE" in os.environ:
        mesh_lib.init_world(platforms[0])
    est = _estimator(args, platforms[0] if len(platforms) == 1 else "cuda")
    t0 = time.perf_counter()
    if args.fn in ("video_stream", "video_multi_stream"):
        chunk = args.batch or 64
        if args.fn == "video_stream":
            meta = pexport.export_video_stream(est, args.out, chunk=chunk,
                                               platforms=platforms)
        else:
            meta = pexport.export_video_multi_stream(
                est, args.out, chunk=chunk, platforms=platforms,
                max_people=args.max_people)
        size = sum(os.path.getsize(os.path.join(args.out, p))
                   for p in meta["program_sha256"])
        print(json.dumps({
            "artifact": args.out, "fn": args.fn, "chunk": chunk,
            "platforms": meta["platforms"],
            "decode_impl": meta["decode_impl"],
            "program_mb": round(size / 1e6, 2),
            "export_s": round(time.perf_counter() - t0, 2)}))
        return
    kw = {}
    if args.fn == "estimate_and_fit_multi":
        kw["max_people"] = args.max_people
    elif args.fn == "estimate_and_fit_video":
        kw["mode"] = args.video_mode
    meta = pexport.export_estimator(
        est, args.out, fn=args.fn, batch=args.batch or None,
        platforms=platforms, n_devices=args.n_devices or None, **kw)
    record = {"artifact": args.out, "fn": args.fn,
              "platforms": meta["platforms"],
              "decode_impl": meta["decode_impl"],
              "batch": meta["input"]["shape"][0],
              "program_mb": round(os.path.getsize(
                  os.path.join(args.out, "program.pt2")) / 1e6, 2),
              "export_s": round(time.perf_counter() - t0, 2)}
    if args.smoke:
        _smoke(record, meta, args.out, args.fn, args.batch,
               est.fit_cfg.img_size)
    mesh_lib.rank0_print(json.dumps(record))


def run():
    """Console entry point (``pyproject.toml`` ``[project.scripts]``)."""
    main()


if __name__ == "__main__":
    run()
