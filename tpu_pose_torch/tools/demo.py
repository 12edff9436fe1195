"""Demo (port of ``tpu_pose/tools/demo.py`` on argparse, with the same
flags and ``--device``): images → 2D joints → SMPL fit → mesh.

  python -m tpu_pose_torch.tools.demo --images img1.png,img2.png --out_dir demo
  python -m tpu_pose_torch.tools.demo --synthetic 8 --out_dir demo
  # A video file is a frame source (cv2; mp4 needs an FFmpeg cv2 build,
  # MJPG .avi decodes everywhere); --video fits the frames as one
  # sequence, --video_out writes a skeleton-overlay video:
  python -m tpu_pose_torch.tools.demo --images clip.mp4 --video \\
      --stride 2 --video_out demo/overlay.avi
  # Long files, window by window through the session API
  # (api.VideoSession / MultiPersonVideoSession), in bounded memory:
  python -m tpu_pose_torch.tools.demo --images clip.mp4 --video \\
      --stream_chunk 64 --video_out demo/overlay.avi

Without weights (``--cpm_npz`` and ``--smpl_pkl``) it runs the synthetic
estimator. Per image it writes the fitted parameters (``fits.npz``), an
OBJ mesh and 2D-skeleton and mesh overlays (PNG through PIL; without PIL
the overlay arrays go to ``.npy`` files). PIL and cv2 are imported only
where they are needed.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from tpu_pose_torch.tools.eval_2d import _bool_flag


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpu-pose-torch-demo",
        description="Images to 2D joints, SMPL fits and meshes.")
    p.add_argument("--images", default="", help="comma-separated image "
                   "paths (png/jpg through PIL, or .npy), or one video "
                   "file")
    p.add_argument("--synthetic", type=int, default=0, help="render N "
                   "synthetic frames instead of loading images")
    p.add_argument("--out_dir", default=os.path.join(
        tempfile.gettempdir(), "tpu_pose_torch_demo"),
        help="output directory")
    p.add_argument("--cpm_npz", default="", help="converted CPM weights "
                   "(.npz); synthetic weights if empty")
    p.add_argument("--smpl_pkl", default="", help="SMPL model pickle; "
                   "synthetic model if empty")
    p.add_argument("--gmm_pkl", default="", help="GMM pose-prior pickle "
                   "(optional)")
    p.add_argument("--optimizer", default="adam",
                   help="fit optimizer: adam | lbfgs")
    _bool_flag(p, "thorough", False, "use the long fit schedule")
    _bool_flag(p, "letterbox", True, "aspect-preserving resize and pad "
               "(joints come back in source-image pixels)")
    _bool_flag(p, "multi", False, "multi-person: fit up to --max_people "
               "per frame (with --video: identity-tracked; overlays draw "
               "every accepted person, meshes per person or track)")
    p.add_argument("--max_people", type=int, default=2,
                   help="person hypothesis slots for --multi")
    _bool_flag(p, "video", False, "fit the inputs as one ordered sequence "
               "(api.estimate_and_fit_video) instead of frame by frame")
    p.add_argument("--stride", type=int, default=1, help="video-file "
                   "input: keep every stride-th frame")
    p.add_argument("--max_frames", type=int, default=0, help="video-file "
                   "input: cap the kept frames (0: all)")
    p.add_argument("--video_out", default="", help="write a "
                   "skeleton-overlay video here (.avi: MJPG on every cv2 "
                   "build; .mp4 needs FFmpeg cv2); fps: the source's over "
                   "--stride (30 for image inputs)")
    p.add_argument("--stream_chunk", type=int, default=0, help="with "
                   "--video and a video-file input: run the session API "
                   "in windows of this many frames (bounded memory; writes "
                   "--video_out and fits.npz, no per-frame obj/png)")
    p.add_argument("--device", default="cuda", help="torch device")
    return p.parse_args(argv)


def load_images(paths):
    import numpy as np
    out = []
    for p in paths:
        if p.endswith(".npy"):
            out.append(np.load(p))
        else:
            from PIL import Image
            out.append(np.asarray(Image.open(p).convert("RGB")))
    return np.stack(out)


def _open_video_out(args, fps):
    if not args.video_out:
        return None
    from tpu_pose_torch.utils import videoio
    os.makedirs(args.out_dir, exist_ok=True)
    return videoio.VideoWriter(args.video_out, fps=fps)


def _close_video_out(vwriter):
    if vwriter is not None:
        vwriter.close()
        print(f"wrote {vwriter.frames_written}-frame overlay video "
              f"→ {vwriter.path}")


def _scale(est, letterbox: bool, h0: int, w0: int):
    """Network-frame joints → source pixels: letterboxed joints already
    are; square-resized ones rescale."""
    import numpy as np
    if letterbox:
        return np.array([1.0, 1.0], np.float32)
    return np.array([w0 / est.cpm_cfg.input_size,
                     h0 / est.cpm_cfg.input_size], np.float32)


def main(argv=None) -> None:
    args = parse_args(argv)
    import numpy as np

    from tpu_pose_torch.api import PoseEstimator
    from tpu_pose_torch.utils import checkpoint as ckpt_lib
    from tpu_pose_torch.utils import viz
    from tpu_pose_torch.utils.config import FitConfig, THOROUGH_STAGES

    fit_cfg = FitConfig(
        optimizer=args.optimizer,
        **({"stages": THOROUGH_STAGES} if args.thorough else {}))

    # Synthetic frames are made at network size, so the letterbox would do
    # nothing there; real images get the aspect-preserving path.
    letterbox = args.letterbox and not args.synthetic
    if args.cpm_npz and args.smpl_pkl:
        est = PoseEstimator.from_files(
            args.cpm_npz, args.smpl_pkl, args.gmm_pkl or None,
            fit_cfg=fit_cfg, letterbox=letterbox, device=args.device)
    else:
        print("note: no weights supplied — synthetic estimator "
              "(smoke-test mode)")
        est = PoseEstimator.create_synthetic(seed=0, fit_cfg=fit_cfg,
                                             letterbox=letterbox,
                                             device=args.device)

    fps_out = 30.0
    if args.synthetic:
        from tpu_pose_torch.data import synthetic
        ex = synthetic.make_examples(est.smpl_model, args.synthetic,
                                     est.cpm_cfg, seed=0)
        images = ex["images"]
    elif args.images:
        paths = args.images.split(",")
        from tpu_pose_torch.utils import videoio
        if len(paths) == 1 and videoio.is_video_path(paths[0]):
            src_fps = videoio.video_info(paths[0])["fps"] or 30.0
            fps_out = src_fps / max(args.stride, 1)
            if args.stream_chunk:
                if not args.video:
                    raise SystemExit("--stream_chunk needs --video")
                return _run_stream(args, est, paths[0], letterbox, fps_out)
            images = videoio.read_video(paths[0], stride=args.stride,
                                        limit=args.max_frames)
            print(f"read {len(images)} frames from {paths[0]} "
                  f"(stride {args.stride})")
        else:
            images = load_images(paths)
    else:
        raise SystemExit("provide --images or --synthetic N")

    if args.stream_chunk:
        # Only a video-file input takes it (and returned above).
        raise SystemExit("--stream_chunk needs a single video-file input "
                         "(got images/synthetic frames)")
    if args.multi:
        return _run_multi(args, est, images, letterbox, fps_out)
    res = (est.estimate_and_fit_video(images) if args.video
           else est.estimate_and_fit(images))

    os.makedirs(args.out_dir, exist_ok=True)
    ckpt_lib.save_fit_results(
        os.path.join(args.out_dir, "fits.npz"),
        res.theta, res.beta, res.cam, energy=res.energy,
        extra={"joints2d": res.joints2d, "conf": res.conf})
    h0, w0 = images.shape[1:3]
    s = _scale(est, letterbox, h0, w0)
    faces = est.smpl_model.faces.cpu().numpy()
    verts, joints = res.vertices.cpu().numpy(), res.joints2d.cpu().numpy()
    conf, cams = res.conf.cpu().numpy(), res.cam.cpu().numpy()
    affine = None
    if letterbox:
        from tpu_pose_torch.ops import preprocess as pre
        affine = pre.letterbox_affine(h0, w0, est.cpm_cfg.input_size)
    vwriter = _open_video_out(args, fps_out)
    for i in range(len(images)):
        viz.save_obj(os.path.join(args.out_dir, f"mesh_{i:03d}.obj"),
                     verts[i], faces)
        overlay = viz.draw_skeleton(images[i], joints[i] * s, conf[i])
        viz.save_image(os.path.join(args.out_dir, f"pose2d_{i:03d}.png"),
                       overlay)
        if vwriter is not None:
            vwriter.write(overlay)
        viz.save_mesh_overlay(
            os.path.join(args.out_dir, f"mesh2d_{i:03d}.png"),
            images[i], verts[i], cams[i], est.fit_cfg.img_size,
            faces=faces, affine=affine)
    _close_video_out(vwriter)
    print(f"wrote {len(images)} fits to {args.out_dir} "
          f"(mean energy {float(res.energy.mean()):.4f})")


def _run_stream(args, est, video_path, letterbox, fps_out):
    """--stream_chunk: a video file through the session API:
    ``utils/videoio.iter_video`` feeds fixed windows to
    ``api.VideoSession`` / ``MultiPersonVideoSession`` as a camera would,
    each window's results render as it completes, and the overlay video
    is written as it goes. Memory is bounded by the window for any file
    length (no per-frame obj/png; fits.npz gathers the parameters)."""
    import numpy as np

    from tpu_pose_torch import api as api_lib
    from tpu_pose_torch.utils import checkpoint as ckpt_lib
    from tpu_pose_torch.utils import videoio
    from tpu_pose_torch.utils import viz

    os.makedirs(args.out_dir, exist_ok=True)
    chunk = args.stream_chunk
    sess = (api_lib.MultiPersonVideoSession(
                est, max_people=args.max_people, chunk=chunk)
            if args.multi else api_lib.VideoSession(est, chunk=chunk))
    vwriter = _open_video_out(args, fps_out)
    thetas, betas, cams, energies = [], [], [], []
    n_frames = 0

    def render(win_frames, res):
        nonlocal n_frames
        h0, w0 = win_frames.shape[1:3]
        s = _scale(est, letterbox, h0, w0)
        joints = res.joints2d.cpu().numpy()
        conf = res.conf.cpu().numpy()
        t_win = joints.shape[0]
        mask = (res.frame_mask.cpu().numpy()[:t_win] if args.multi
                else None)
        for i in range(min(t_win, len(win_frames))):
            img = win_frames[i]
            if args.multi:
                for k in range(joints.shape[1]):
                    if mask[i, k]:
                        img = viz.draw_skeleton(img, joints[i, k] * s,
                                                conf[i, k])
            else:
                img = viz.draw_skeleton(img, joints[i] * s, conf[i])
            if vwriter is not None:
                vwriter.write(img)
        thetas.append(res.theta.cpu().numpy())
        betas.append(res.beta.cpu().numpy())
        cams.append(res.cam.cpu().numpy())
        energies.append(res.energy.cpu().numpy())
        n_frames += min(t_win, len(win_frames))

    # Push whole windows so each push completes one and its frames can
    # render and be freed at once.
    leftover = None
    for frames in videoio.iter_video(video_path, chunk, stride=args.stride,
                                     limit=args.max_frames):
        res = sess.push(frames)
        if res is not None:
            render(frames, res)
        else:
            leftover = frames
    res = sess.flush()
    if res is not None and leftover is not None:
        render(leftover, res)

    _close_video_out(vwriter)
    if not thetas:
        raise SystemExit(f"no decodable frames in {video_path!r}")
    # Multi results are track-major: time is axis 1 (theta (K, T, 72)).
    t_axis = 1 if args.multi else 0
    ckpt_lib.save_fit_results(
        os.path.join(args.out_dir, "fits.npz"),
        np.concatenate(thetas, axis=t_axis),
        np.concatenate(betas, axis=t_axis),
        np.concatenate(cams, axis=t_axis),
        energy=np.concatenate(
            [np.atleast_1d(e) for e in energies], axis=0))
    print(f"streamed {n_frames} frames in {len(thetas)} window(s) "
          f"→ {args.out_dir}")


def _run_multi(args, est, images, letterbox, fps_out=30.0):
    """--multi: every accepted person per frame on one overlay, one OBJ
    per (frame, person), or per (frame, track) with --video, where track
    k keeps one colour across frames."""
    import numpy as np

    from tpu_pose_torch.utils import checkpoint as ckpt_lib
    from tpu_pose_torch.utils import viz

    if args.video:
        res = est.estimate_and_fit_video_multi(
            images, max_people=args.max_people)
        # Track-major (K, T, ...) → frame-major views for rendering.
        mask = res.frame_mask.cpu().numpy()            # (T, K)
        verts = np.transpose(res.vertices.cpu().numpy(), (1, 0, 2, 3))
    else:
        res = est.estimate_and_fit_multi(images,
                                         max_people=args.max_people)
        mask = res.person_mask.cpu().numpy()           # (B, K)
        verts = res.vertices.cpu().numpy()             # (B, K, V, 3)
    joints = res.joints2d.cpu().numpy()
    conf = res.conf.cpu().numpy()

    os.makedirs(args.out_dir, exist_ok=True)
    extra = {"joints2d": joints, "conf": conf,
             "person_mask": mask.astype(np.float32)}
    if args.video:
        extra["perm"] = res.perm
    ckpt_lib.save_fit_results(
        os.path.join(args.out_dir, "fits.npz"), res.theta, res.beta,
        res.cam, energy=res.energy, extra=extra)

    h0, w0 = images.shape[1:3]
    s = _scale(est, letterbox, h0, w0)
    faces = est.smpl_model.faces.cpu().numpy()
    vwriter = _open_video_out(args, fps_out)
    for i in range(len(images)):
        img = np.array(images[i], copy=True)
        for k in range(joints.shape[1]):
            if not mask[i, k]:
                continue
            img = viz.draw_skeleton(img, joints[i, k] * s, conf[i, k])
            viz.save_obj(
                os.path.join(args.out_dir, f"mesh_{i:03d}_p{k}.obj"),
                verts[i, k], faces)
        viz.save_image(
            os.path.join(args.out_dir, f"pose2d_{i:03d}.png"), img)
        if vwriter is not None:
            vwriter.write(img)
    _close_video_out(vwriter)
    n_people = (int(res.track_mask.sum()) if args.video
                else int(mask.sum()))
    what = "tracks" if args.video else "person fits"
    print(f"wrote {len(images)} frames, {n_people} {what} "
          f"to {args.out_dir}")


def run():
    """Console entry point (``pyproject.toml`` ``[project.scripts]``)."""
    main()


if __name__ == "__main__":
    run()
