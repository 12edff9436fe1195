"""Convert a public pose dataset's distribution files into npz shards
(port of ``tpu_pose/tools/convert_dataset.py`` on argparse, with the same
flags). Needs scipy (the ``.mat`` readers, 3DPW's rotations) and PIL (the
crops).

  # LSP / LSPET (told apart by the joints.mat layout):
  python -m tpu_pose_torch.tools.convert_dataset --dataset lsp \\
      --annotations lsp/joints.mat --images lsp/images --out lsp_shards

  # MPII (one sample per annotated person):
  python -m tpu_pose_torch.tools.convert_dataset --dataset mpii \\
      --annotations mpii/mpii_human_pose_v1_u12_1.mat \\
      --images mpii/images --out mpii_shards

  # 3DPW (one sequence file; SMPL ground truth → PVE / PA-PVE):
  python -m tpu_pose_torch.tools.convert_dataset --dataset 3dpw \\
      --annotations 3dpw/sequenceFiles/test/downtown_arguing_00.pkl \\
      --images 3dpw/imageFiles/downtown_arguing_00 --out 3dpw_shards

Then ``tools/eval_2d.py --data_dir mpii_shards`` scores the 2D detector,
``tools/eval_h36m.py --data_dir 3dpw_shards`` the 3D fit.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpu-pose-torch-convert-dataset",
        description="Convert LSP / MPII / COCO / 3DPW annotations and "
        "images into npz shards.")
    p.add_argument("--dataset", required=True,
                   choices=["lsp", "mpii", "coco", "3dpw"],
                   help="source format (lsp covers LSPET; coco takes a "
                   "person_keypoints json; 3dpw one sequenceFiles pkl)")
    p.add_argument("--annotations", required=True, help="annotation file "
                   "(.mat, a person_keypoints .json for coco, or a "
                   "sequenceFiles .pkl for 3dpw)")
    p.add_argument("--images", required=True, help="image directory (for "
                   "3dpw the sequence's imageFiles/<name>/)")
    p.add_argument("--out", required=True, help="output shard directory")
    p.add_argument("--size", type=int, default=368,
                   help="output crop size (network input)")
    p.add_argument("--margin", type=float, default=0.0, help="crop margin; "
                   "0 = the dataset's default (1.5 × joint bbox for LSP, "
                   "1.25 × scale·200 for MPII and COCO, 1.3 for 3DPW)")
    p.add_argument("--shard_size", type=int, default=256,
                   help="samples per npz shard")
    p.add_argument("--limit", type=int, default=0, help="convert only the "
                   "first N samples (0 = all)")
    p.add_argument("--gender", default="", help="3dpw only: keep actors of "
                   "this gender (m|f), for the gendered-GT protocol")
    return p.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    from tpu_pose_torch.data import datasets, pipeline

    limit = args.limit or None
    if args.dataset == "lsp":
        paths = datasets.lsp_to_shards(
            args.annotations, args.images, args.out, out_size=args.size,
            margin=args.margin or 1.5, shard_size=args.shard_size,
            limit=limit)
    elif args.dataset == "3dpw":
        paths = datasets.threedpw_to_shards(
            args.annotations, args.images, args.out, out_size=args.size,
            margin=args.margin or 1.3, shard_size=args.shard_size,
            limit=limit, gender=args.gender or None)
    elif args.dataset == "coco":
        paths = datasets.coco_to_shards(
            args.annotations, args.images, args.out, out_size=args.size,
            margin=args.margin or 1.25, shard_size=args.shard_size,
            limit=limit)
    else:
        paths = datasets.mpii_to_shards(
            args.annotations, args.images, args.out, out_size=args.size,
            margin=args.margin or 1.25, shard_size=args.shard_size,
            limit=limit)
    n = len(pipeline.NpzShardSource(args.out))
    print(f"wrote {len(paths)} shard(s), {n} samples → {args.out}",
          flush=True)
    return paths


def run():
    """Console entry point (``pyproject.toml`` ``[project.scripts]``)."""
    main()


if __name__ == "__main__":
    run()
