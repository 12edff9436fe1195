"""Profile an entry point (port of ``tpu_pose/tools/profile_entry.py`` on
argparse, with the same flags and ``--device``): seconds per call, the
FLOPs of one call counted by ``torch.utils.flop_counter.FlopCounterMode``
(``utils/profiling.cost_analysis``), the achieved rate against
``utils/profiling.PEAKS``, and optionally a ``torch.profiler`` trace.

  python -m tpu_pose_torch.tools.profile_entry --fn estimate_and_fit \\
      --batch 128 --quantize --trace_dir pose_trace
  python -m tpu_pose_torch.tools.profile_entry --fn fit_smpl --batch 256

Prints one JSON line: fn, batch, ms_per_call, items_per_s, flops,
flops_per_s, mfu, hbm_frac, trace_dir. PyTorch counts no bytes moved, so
``hbm_frac`` is null. The trace (``trace.json`` in ``--trace_dir``) opens
in Perfetto or chrome://tracing.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

from tpu_pose_torch.tools.eval_2d import _bool_flag

FNS = ("estimate_2d", "estimate_and_fit", "estimate_and_fit_multi",
       "estimate_and_fit_video", "fit_smpl")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpu-pose-torch-profile",
        description="Time and count the FLOPs of one tpu_pose_torch entry "
        "point.")
    p.add_argument("--fn", default="estimate_and_fit", choices=FNS,
                   help="entry point to profile")
    p.add_argument("--batch", type=int, default=32, help="batch size "
                   "(frames for the image functions, people for fit_smpl, "
                   "T for video)")
    p.add_argument("--iters", type=int, default=5,
                   help="timed iterations (after 2 warm-up calls)")
    p.add_argument("--trace_dir", default="", help="write a profiler "
                   "trace of one call here (empty: no trace)")
    p.add_argument("--cpm_npz", default="", help="converted CPM weights "
                   "(synthetic if empty)")
    p.add_argument("--smpl_pkl", default="", help="SMPL pickle (synthetic "
                   "if empty)")
    _bool_flag(p, "quantize", False, "int8 CPM path")
    p.add_argument("--chip", default="h100 sxm", help="row of "
                   "utils/profiling.PEAKS for the utilization")
    p.add_argument("--dtype", default="bf16", choices=("bf16", "f32"),
                   help="peak rate for the utilization")
    p.add_argument("--device", default="cuda", help="torch device")
    return p.parse_args(argv)


def make_inputs(est, fn: str, batch: int) -> tuple:
    """The call's arguments from ``RandomState(0)``: joints and ones
    confidences for fit_smpl, uint8 frames otherwise."""
    import numpy as np
    rng = np.random.RandomState(0)
    size = est.cpm_cfg.input_size
    if fn == "fit_smpl":
        return (rng.uniform(0, est.fit_cfg.img_size,
                            (batch, est.cpm_cfg.num_joints, 2)
                            ).astype(np.float32),
                np.ones((batch, est.cpm_cfg.num_joints), np.float32))
    return (rng.randint(0, 255, (batch, size, size, 3)).astype(np.uint8),)


def main(argv=None) -> Optional[dict]:
    args = parse_args(argv)
    from tpu_pose_torch.api import PoseEstimator
    from tpu_pose_torch.utils import profiling

    if args.cpm_npz and args.smpl_pkl:
        est = PoseEstimator.from_files(args.cpm_npz, args.smpl_pkl,
                                       quantize=args.quantize,
                                       device=args.device)
    else:
        est = PoseEstimator.create_synthetic(seed=0, quantize=args.quantize,
                                             device=args.device)
    call_args = make_inputs(est, args.fn, args.batch)
    call = getattr(est, args.fn)

    sec = profiling.Timer(call, *call_args, warmup=2, iters=args.iters).run()
    cost = profiling.cost_analysis(call, *call_args)
    util = profiling.utilization(sec, cost, chip=args.chip,
                                 peak=f"flops_{args.dtype}")

    if args.trace_dir:
        with profiling.trace(args.trace_dir):
            profiling.sync(call(*call_args))

    record = {
        "fn": args.fn, "batch": args.batch,
        "ms_per_call": round(sec * 1e3, 3),
        "items_per_s": round(args.batch / sec, 1),
        "flops": cost.get("flops"),
        "flops_per_s": round(util["flops_per_s"], 1),
        "mfu": round(util["mfu"], 4),
        "hbm_frac": None,
        "trace_dir": args.trace_dir or None,
    }
    print(json.dumps(record))
    return record


def run():
    """Console entry point (``pyproject.toml`` ``[project.scripts]``)."""
    main()


if __name__ == "__main__":
    run()
