"""One-command day-one reference validation (port of
``tpu_pose/tools/reference_day_one.py`` on argparse, with the same flags
and ``--device``; ``--reference`` has no default here).

When a reference directory (or the real license-gated assets) appears,
run:

  python -m tpu_pose_torch.tools.reference_day_one --reference <dir> \\
      [--sweep] [--out day_one]

and the whole chain — asset discovery, TF1-ckpt conversion, real
SMPL/GMM loading, stage parity, ≤1 mm fit-gap certification, optional
constant sweep, smoke eval — executes unattended and writes one JSON
verdict (``parity/day_one.py``). The exit code is 0 when the verdict is
ok, else 1.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from tpu_pose_torch.tools.eval_2d import _bool_flag


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpu-pose-torch-day-one",
        description="Run the day-one chain on a reference directory.")
    p.add_argument("--reference", required=True, help="reference mount / "
                   "asset directory")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "tpu_pose_torch_day_one"),
                   help="output directory")
    p.add_argument("--frames", type=int, default=4, help="certification "
                   "probe frames")
    _bool_flag(p, "sweep", False, "also auto-sweep fit constants")
    p.add_argument("--sweep_passes", type=int, default=1, help="sweep "
                   "coordinate-descent passes")
    p.add_argument("--eval_frames", type=int, default=8, help="smoke-eval "
                   "frames")
    p.add_argument("--target_mm", type=float, default=1.0,
                   help="certification target")
    p.add_argument("--device", default="cuda", help="torch device")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from tpu_pose_torch.parity import day_one

    verdict = day_one.run_day_one(
        args.reference, out_dir=args.out, frames=args.frames,
        sweep=args.sweep, sweep_passes=args.sweep_passes,
        eval_frames=args.eval_frames, target_mm=args.target_mm,
        log=lambda s: print(s, flush=True), device=args.device)
    raise SystemExit(0 if verdict["ok"] else 1)


def run():
    """Console entry point (``pyproject.toml`` ``[project.scripts]``)."""
    main()


if __name__ == "__main__":
    run()
