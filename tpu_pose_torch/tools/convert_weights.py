"""Convert a TF1 CPM checkpoint to the npz weights the port loads (port of
``tpu_pose/tools/convert_weights.py`` on argparse, with the same flags
and ``--device``).

  python -m tpu_pose_torch.tools.convert_weights --ckpt /path/model.ckpt \\
      --out cpm_weights.npz

The converter (``utils/tf_converter.convert_tf_checkpoint``, which needs
TensorFlow) walks the checkpoint's variable names against the known
naming lineages (tf-slim, tf.layers, plain-variable ports) and writes the
flat npz ``PoseEstimator.from_files`` reads. The converted weights are
then loaded as the CPM on ``--device`` once, so a checkpoint that does
not fit the configuration fails here and not at serving time.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpu-pose-torch-convert-weights",
        description="Convert a TF1 CPM checkpoint to npz weights.")
    p.add_argument("--ckpt", required=True, help="TF1 checkpoint path "
                   "(prefix)")
    p.add_argument("--out", default="cpm_weights.npz", help="output npz "
                   "path")
    p.add_argument("--num_stages", type=int, default=6, help="CPM stages "
                   "in the checkpoint")
    p.add_argument("--device", default="cuda", help="torch device the "
                   "converted weights are loaded on as a check")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from tpu_pose_torch.models import cpm as cpm_lib
    from tpu_pose_torch.utils import tf_converter
    from tpu_pose_torch.utils.config import CPMConfig

    cfg = CPMConfig(num_stages=args.num_stages)
    layer_names = [d[0] for d in cpm_lib._layer_defs(cfg)]
    params = tf_converter.convert_tf_checkpoint(args.ckpt, layer_names)
    tf_converter.save_params_npz(args.out, params)
    cpm_lib.cpm_params_from_numpy(params, cfg, args.device)
    n = sum(v["w"].size + v["b"].size for v in params.values())
    print(f"converted {len(params)} layers ({n / 1e6:.1f} M params) "
          f"→ {args.out}", flush=True)
    return {"layers": len(params), "params": int(n), "out": args.out}


def run():
    """Console entry point (``pyproject.toml`` ``[project.scripts]``)."""
    main()


if __name__ == "__main__":
    run()
