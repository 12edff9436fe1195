"""Train the CPM (port of ``tpu_pose/tools/train_cpm.py`` on argparse, with
the same flags and ``--device``): on npz shards or, with ``--synthetic``,
on generated data; resumable from ``--ckpt_dir``; ``--export`` writes the
weights as the CPM npz both packages load.

  python -m tpu_pose_torch.tools.train_cpm --synthetic --steps 200 \\
      --batch 32 --ckpt_dir ckpt --export cpm_weights.npz

Data-parallel over N GPUs: ``torchrun --nproc_per_node N -m
tpu_pose_torch.tools.train_cpm ...``. ``--batch`` stays the global batch:
every rank reads the same batches, trains on its rows and averages the
gradients (``models/cpm_train.make_train_step(mesh=)``); rank 0 alone
prints, checkpoints and exports.

Shards with stored targets (``images``, ``center_maps``, ``heatmaps``)
train as they are; converter shards (``images``, ``gt_joints2d``,
``conf``; ``tools/convert_dataset.py``) get painted targets, a joint mask
and flip augmentation, and rotation or scale augmentation with
``--rot_aug`` / ``--scale_aug`` (those two need PIL).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpu-pose-torch-train",
        description="Train tpu_pose_torch's CPM with intermediate "
        "supervision.")
    p.add_argument("--rot_aug", type=float, default=0.0, help="rotation "
                   "augmentation: uniform ±N degrees about the crop center "
                   "for painted-target shards (the MPII recipe uses ~30)")
    p.add_argument("--scale_aug", type=float, default=0.0, help="scale "
                   "augmentation: uniform 1±N zoom about the crop center "
                   "for painted-target shards (~0.25)")
    p.add_argument("--flip_aug", type=float, default=0.5, help="horizontal "
                   "flip probability for painted-target shards "
                   "(CPM_FLIP_PERM relabelling)")
    p.add_argument("--heatmap_sigma", type=float, default=3.0,
                   help="target Gaussian sigma (stride cells) for "
                   "painted-target shards")
    p.add_argument("--data_dir", default="", help="npz-shard directory")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated synthetic data")
    p.add_argument("--steps", type=int, default=1000,
                   help="total optimizer steps")
    p.add_argument("--batch", type=int, default=32, help="batch size")
    p.add_argument("--lr", type=float, default=1e-4,
                   help="peak Adam learning rate")
    p.add_argument("--ckpt_dir", default="", help="train-state checkpoint "
                   "directory (resumes from its latest step)")
    p.add_argument("--ckpt_every", type=int, default=200,
                   help="checkpoint interval (steps)")
    p.add_argument("--export", default="", help="write the final weights "
                   "npz here")
    p.add_argument("--input_size", type=int, default=368,
                   help="CPM input resolution")
    p.add_argument("--log_every", type=int, default=20,
                   help="loss log interval (steps)")
    p.add_argument("--qat", action="store_true", help="quantization-aware "
                   "training: the forward on straight-through "
                   "fake-quantized weights (cpm_train.fake_quant_params)")
    p.add_argument("--device", default="cuda", help="torch device")
    return p.parse_args(argv)


def _rot_scale(img, joints, rng, rot_deg, scale_jit):
    """Random rotation and zoom about the crop center: the image by one
    PIL inverse-affine bilinear resample (grey fill), the joints by the
    forward affine p' = s·R·(p − c) + c."""
    import numpy as np
    from PIL import Image

    size = img.shape[0]
    ang = np.deg2rad(rng.uniform(-rot_deg, rot_deg)) if rot_deg else 0.0
    s = 1.0 + (rng.uniform(-scale_jit, scale_jit) if scale_jit else 0.0)
    if ang == 0.0 and s == 1.0:
        return img, joints
    c = (size - 1) / 2.0
    cos, sin = np.cos(ang), np.sin(ang)
    fwd = np.array([[cos, -sin], [sin, cos]]) * s
    inv = np.linalg.inv(fwd)
    # PIL maps output → input in the half-integer corner convention
    # (pixel i spans [i, i+1)), so its rotation center is c + 0.5 while
    # the joints rotate about c in the pixel-center convention.
    cp = np.array([c + 0.5, c + 0.5])
    off = cp - inv @ cp
    coeffs = (inv[0, 0], inv[0, 1], off[0], inv[1, 0], inv[1, 1], off[1])
    out = np.asarray(Image.fromarray(img).transform(
        (size, size), Image.AFFINE, coeffs, resample=Image.BILINEAR,
        fillcolor=(128, 128, 128)))
    j = (joints - c) @ fwd.T + c
    return out, j.astype(np.float32)


def _painted_batches(data_dir, batch, cfg, flip_prob=0.5, sigma=3.0,
                     rot_deg=0.0, scale_jit=0.0, seed=0):
    """Converter shards (images, gt_joints2d, conf) → CPM train batches:
    stride-resolution Gaussian targets and the standard center map,
    supervision of the annotated joints only (``joint_mask``), flips
    with CPM_FLIP_PERM relabelling, and optional rotation / scale
    augmentation (a joint pushed off the frame keeps its target, which
    decays to an almost-zero map)."""
    import numpy as np

    from tpu_pose_torch.data import pipeline, synthetic
    from tpu_pose_torch.models import joints as joints_lib
    from tpu_pose_torch.ops import preprocess as pre

    cmap = pre.gaussian_center_map(cfg.input_size, cfg.center_sigma,
                                   device="cpu").numpy()
    rng = np.random.RandomState(seed)
    size = cfg.input_size
    for b in pipeline.batches(data_dir, batch,
                              keys=("images", "gt_joints2d", "conf"),
                              shuffle=True, num_epochs=10_000,
                              shard_by_process=False):
        imgs = np.array(b["images"])
        joints = np.array(b["gt_joints2d"], np.float32)
        conf = np.array(b["conf"], np.float32)
        n = len(imgs)
        for i in range(n):
            if flip_prob > 0.0 and rng.rand() < flip_prob:
                imgs[i] = imgs[i][:, ::-1]
                joints[i] = joints[i][joints_lib.CPM_FLIP_PERM]
                joints[i, :, 0] = size - 1.0 - joints[i, :, 0]
                conf[i] = conf[i][joints_lib.CPM_FLIP_PERM]
            if rot_deg or scale_jit:
                imgs[i], joints[i] = _rot_scale(
                    imgs[i], joints[i], rng, rot_deg, scale_jit)
        hms = np.stack([
            synthetic.gaussian_heatmaps(joints[i], size, cfg.stride,
                                        sigma=sigma) for i in range(n)])
        mask = np.concatenate(
            [(conf > 0).astype(np.float32), np.ones((n, 1), np.float32)],
            axis=1)
        yield {"images": imgs,
               "center_maps": np.broadcast_to(
                   cmap, (n, *cmap.shape)).copy(),
               "heatmaps": hms, "joint_mask": mask}


def main(argv=None) -> None:
    args = parse_args(argv)
    import itertools

    import numpy as np

    from tpu_pose_torch.data import pipeline, synthetic
    from tpu_pose_torch.models import cpm_train, smpl_data
    from tpu_pose_torch.parallel import mesh as mesh_lib
    from tpu_pose_torch.utils import checkpoint as ckpt_lib
    from tpu_pose_torch.utils import profiling
    from tpu_pose_torch.utils.config import CPMConfig

    if not (args.synthetic or args.data_dir):
        raise SystemExit("provide --data_dir or --synthetic")
    cfg = CPMConfig(input_size=args.input_size)
    mesh = mesh_lib.launcher_mesh(args.device)
    main_rank = mesh_lib.is_main_process()
    say = mesh_lib.rank0_print
    cpm, opt_state, opt = cpm_train.init_train_state(
        0, cfg, lr=args.lr, total_steps=args.steps, device=args.device)
    start_step = 0
    if args.ckpt_dir and ckpt_lib.latest_step(args.ckpt_dir) is not None:
        start_step, cpm, opt_state = ckpt_lib.restore_train_state(
            args.ckpt_dir, cpm)
        say(f"resumed from step {start_step}", flush=True)
    step_fn = cpm_train.make_train_step(cfg, opt, mesh=mesh,
                                        fake_quant=args.qat)
    if mesh is not None:
        mesh_lib.replicate(cpm, mesh)
        opt_state = mesh_lib.replicate(opt_state, mesh)

    if args.synthetic:
        model = smpl_data.synthetic_smpl(seed=0, device="cpu")
        batches = itertools.chain.from_iterable(
            synthetic.cpm_train_batches(model, args.batch, 10_000, cfg,
                                        seed=e) for e in itertools.count())
    else:
        src = pipeline.NpzShardSource(args.data_dir)
        with np.load(src.paths[0]) as z:
            stored_targets = "heatmaps" in z.files
        if stored_targets:
            batches = pipeline.batches(
                args.data_dir, args.batch,
                keys=("images", "center_maps", "heatmaps"),
                shuffle=True, num_epochs=10_000, shard_by_process=False)
        else:
            say("painting CPM targets from gt_joints2d "
                  f"(flip_aug={args.flip_aug})", flush=True)
            batches = _painted_batches(
                args.data_dir, args.batch, cfg,
                flip_prob=args.flip_aug, sigma=args.heatmap_sigma,
                rot_deg=args.rot_aug, scale_jit=args.scale_aug)

    loss = None
    for step, batch in enumerate(batches, start=start_step):
        if step >= args.steps:
            break
        cpm, opt_state, loss = step_fn(cpm, opt_state, batch)
        if (step + 1) % args.log_every == 0:
            say(f"step {step + 1}: loss {float(loss):.6f}", flush=True)
        if main_rank and args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt_lib.save_train_state(args.ckpt_dir, step + 1, cpm,
                                      opt_state)

    final = float("nan") if loss is None else profiling.sync(loss)
    if main_rank and args.ckpt_dir:
        ckpt_lib.save_train_state(args.ckpt_dir, args.steps, cpm, opt_state)
    if main_rank and args.export:
        ckpt_lib.save_cpm_params(args.export, cpm)
        say(f"exported weights to {args.export}", flush=True)
    say(f"done: {args.steps} steps, final loss {final:.6f}", flush=True)


def run():
    """Console entry point (``pyproject.toml`` ``[project.scripts]``)."""
    main()


if __name__ == "__main__":
    run()
