"""Multi-seed tracked-video benchmark (port of
``tpu_pose/tools/track_bench.py`` on argparse, with the same flags and
``--device``): N seeds per scenario, means reported with the per-seed
spread (one video's identity accuracy is a lottery over seeds).

Scenarios (``--mode``):

- ``crossing``: two people swap sides through a mutual occlusion
  (``data/synthetic_hard.make_hard_multi_video``, crossing=True);
- ``k3``: three people, every pair crossing (3! assignments per frame);
- ``k4``: four people, every pair crossing (4! per frame);
- ``enterleave``: three identities in a two-slot world, B leaves for good
  and C enters later (``make_hard_enterleave_video``): track birth and
  death (``--death_frames``), presence-count accuracy and per-segment
  identity consistency.

Weights: ``--weights``, an npz of a CPM trained on the hard set (by
``selfcheck_e2e`` or ``train_cpm``; random weights make tracking
meaningless)::

  python -m tpu_pose_torch.tools.track_bench \\
      --weights selfcheck/cpm_weights_hard.npz \\
      --mode crossing,k3,enterleave --seeds 10 --out track_bench.json
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time
from typing import Optional

from tpu_pose_torch.tools.eval_2d import _bool_flag


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="tpu-pose-torch-track-bench",
        description="Multi-seed tracked-video benchmark on the hard "
        "synthetic set.")
    p.add_argument("--weights", default="", help="trained CPM weights npz "
                   "(required)")
    p.add_argument("--mode", default="crossing", help="comma list: "
                   "crossing,k3,k4,enterleave")
    p.add_argument("--seeds", type=int, default=10,
                   help="videos per scenario")
    p.add_argument("--frames", type=int, default=26,
                   help="frames per video")
    p.add_argument("--restarts", type=int, default=2,
                   help="fit yaw hypotheses")
    _bool_flag(p, "temporal_hints", True, "hinted second decode")
    p.add_argument("--hint_passes", type=int, default=1, help="smooth → "
                   "re-decode hint rounds (each extra pass costs one CPM "
                   "forward)")
    p.add_argument("--anchor_refresh", type=float, default=0.0,
                   help="gated re-ID anchor EMA rate (0: frozen birth "
                   "anchors)")
    p.add_argument("--death_frames", type=int, default=8, help="track "
                   "death (enterleave mode; 0 disables)")
    p.add_argument("--birth_cost", type=float, default=0.05,
                   help="track birth cost (appearance-MSE units)")
    p.add_argument("--min_person_score", type=float, default=0.05,
                   help="absolute person-evidence floor")
    p.add_argument("--nms_radius", type=float, default=96.0,
                   help="NMS suppression radius px of the person-peak "
                   "proposals")
    p.add_argument("--presence_keep_frac", type=float, default=1.0,
                   help="presence hysteresis: a present track stays "
                   "present while it clears the score gates scaled by "
                   "this fraction (< 1 enables; births pay the full gate)")
    _bool_flag(p, "hint_crop", False, "hint-centered crop re-decode on "
               "every hinted pass")
    _bool_flag(p, "hint_crop_all", False, "hint_crop='all': "
               "unconditional crop substitution (kept for comparison "
               "runs)")
    p.add_argument("--hint_crop_min_conf", type=float, default=0.0,
                   help="gate of the selective hint_crop: substitute the "
                   "crop decode only when its mean conf clears this "
                   "fraction of the frame's best plain-slot conf (0: no "
                   "gate)")
    _bool_flag(p, "reassociate", False, "associate again on the final "
               "hinted decodes (track_reassociate; needs temporal_hints)")
    p.add_argument("--x_span", type=float, default=0.0, help="start "
                   "spread of the crossing/k modes as a fraction of the "
                   "frame width (0: the generator's layout; a fair k4 run "
                   "pairs e.g. 0.8 with --nms_radius 80)")
    p.add_argument("--slack_slots", type=int, default=0, help="proposal "
                   "and track slots beyond the scene's k (crossing/k3/k4): "
                   "spare tracks are not scored")
    _bool_flag(p, "stream", False, "run enterleave through "
               "MultiPersonVideoSession windows (chunk 10) instead of one "
               "call, exercising the birth/death carry")
    p.add_argument("--out", default="", help="write the result dict as "
                   "JSON here")
    p.add_argument("--device", default="cuda", help="torch device")
    return p.parse_args(argv)


STREAM_CHUNK = 10


def _best_perm(costs):
    """costs: (k!, ...) summed assignment costs → index of the best."""
    import numpy as np
    return int(np.argmin(costs))


def _match_metrics(res, gt_centers, gt_j3d, metrics_mod):
    """Global σ: track → identity matching over the whole sequence, then
    per-frame identity accuracy under it (a swap shows as frames that
    prefer another assignment), center error and per-person PA-MPJPE
    under σ, for any k.

    More tracks than identities (slack slots): σ is the best injection of
    the identities into the tracks; spare tracks are not scored (the
    frame mask should kill them, which the enterleave metrics grade). The
    square case is the plain bijection."""
    import numpy as np
    tc = np.asarray(res.joints2d).mean(-2)           # (T, kt, 2)
    kt = tc.shape[1]
    n_gt = gt_centers.shape[1]
    injs = list(itertools.permutations(range(kt), n_gt))
    totals = [np.linalg.norm(tc[:, list(p)] - gt_centers,
                             axis=-1).sum() for p in injs]
    sigma = list(injs[_best_perm(totals)])           # gt id → track
    frame_costs = np.stack(
        [np.linalg.norm(tc[:, list(p)] - gt_centers, axis=-1).sum(-1)
         for p in injs], -1)                         # (T, |injs|)
    ident = injs.index(tuple(sigma))
    id_acc = float((frame_costs.argmin(-1) == ident).mean())
    center_err = float(
        np.linalg.norm(tc[:, sigma] - gt_centers, axis=-1).mean())
    pa = float(np.mean([
        np.mean(metrics_mod.pa_mpjpe_np(
            np.asarray(res.joints3d)[sigma[q]], gt_j3d[:, q]))
        for q in range(n_gt)])) * 1000
    # Coverage of the final decodes: the share of frames where some
    # injection puts every person within 40 px of a distinct track.
    d_all = np.stack(
        [np.linalg.norm(tc[:, list(p)] - gt_centers, axis=-1).max(-1)
         for p in injs], -1)                         # (T, |injs|)
    cover40 = float((d_all.min(-1) < 40.0).mean())
    return {"id_acc": id_acc, "center_err_px": center_err,
            "pa_mpjpe_mm": pa, "cover40": cover40}


def _enterleave_metrics(res, el):
    """Presence-count accuracy and per-segment identity consistency for
    the three-identities, two-slots world. Per frame the present
    identities are matched to tracks by an exclusive min-cost assignment
    over the track axis (a track need not be frame-mask live to be
    matched: presence errors are scored by count_acc alone). Per identity
    the majority matched track is its track; id_acc is the share of
    present frames matched to it."""
    import numpy as np
    tc = np.asarray(res.joints2d).mean(-2)           # (T, k, 2)
    fmask = np.asarray(res.frame_mask)               # (T, k)
    present = el["present"]                          # (T, 3)
    t_frames, k = fmask.shape
    n_id = present.shape[1]
    n_pred = fmask.sum(-1)
    n_gt = present.sum(-1)
    count_acc = float((n_pred == n_gt).mean())
    # Over- and under-counts, and whether each error sits within ±1 frame
    # of a presence transition (where the 60 %-of-joints threshold is
    # arbitrary) or in steady state.
    err = n_pred != n_gt
    change = np.zeros(t_frames, bool)
    chg = np.nonzero(np.diff(n_gt) != 0)[0]
    for c in chg:
        change[max(c - 1, 0):min(c + 3, t_frames)] = True
    count_over = float((n_pred > n_gt).mean())
    count_under = float((n_pred < n_gt).mean())
    count_err_transition = float((err & change).mean())
    count_err_steady = float((err & ~change).mean())
    # match[t, ident] = exclusively assigned track (or -1 if absent).
    match = -np.ones((t_frames, n_id), np.int64)
    for t in range(t_frames):
        ids = np.nonzero(present[t] > 0)[0]
        if not len(ids):
            continue
        best, best_cost = None, np.inf
        for pp in itertools.permutations(range(k), len(ids)):
            cost = sum(np.linalg.norm(tc[t, pp[j]]
                                      - el["centers"][t, ids[j]])
                       for j in range(len(ids)))
            if cost < best_cost:
                best, best_cost = pp, cost
        for j, ident in enumerate(ids):
            match[t, ident] = best[j]
    seg_consistency, id_correct, id_total = [], 0, 0
    majority = {}
    for ident in range(n_id):
        on = np.nonzero(present[:, ident] > 0)[0]
        if not len(on):
            continue
        vals, counts = np.unique(match[on, ident], return_counts=True)
        maj = int(vals[counts.argmax()])
        majority[ident] = maj
        ok = match[on, ident] == maj
        seg_consistency.append(float(ok.mean()))
        id_correct += int(ok.sum())
        id_total += len(on)
    # A (identity 0) and whichever of B and C is present must land on
    # distinct tracks; with track death, C may reuse B's slot.
    distinct = (majority.get(1, -1) != majority.get(0, -2)
                and majority.get(2, -1) != majority.get(0, -2))
    return {"count_acc": count_acc,
            "count_over": count_over, "count_under": count_under,
            "count_err_transition": count_err_transition,
            "count_err_steady": count_err_steady,
            "id_acc": id_correct / max(id_total, 1),
            "seg_consistency_min": float(min(seg_consistency)),
            "ab_c_distinct_tracks": bool(distinct),
            "c_track_reuses_b_slot": bool(
                majority.get(1) is not None
                and majority.get(1) == majority.get(2))}


def _tracked(est, args, images, k: int):
    """``estimate_and_fit_video_multi`` with the crossing/k modes' knobs
    at ``k`` people (plus the slack slots)."""
    return est.estimate_and_fit_video_multi(
        images, max_people=k + args.slack_slots,
        min_person_score=args.min_person_score,
        temporal_hints=args.temporal_hints, hint_passes=args.hint_passes,
        hint_crop=("all" if args.hint_crop_all else args.hint_crop),
        hint_crop_min_conf=args.hint_crop_min_conf,
        track_reassociate=args.reassociate,
        track_birth_cost=args.birth_cost,
        track_anchor_refresh=args.anchor_refresh,
        nms_radius_px=args.nms_radius)


def _on_host(res):
    """A result's tensors copied to the host (the metrics are numpy)."""
    return res._replace(**{f: v.cpu() for f, v in res._asdict().items()})


def enterleave_kwargs(args) -> dict:
    """The enterleave mode's tracking knobs (two slots, track death)."""
    return dict(
        max_people=2, min_person_score=args.min_person_score,
        temporal_hints=args.temporal_hints, hint_passes=args.hint_passes,
        hint_crop=("all" if args.hint_crop_all else args.hint_crop),
        hint_crop_min_conf=args.hint_crop_min_conf,
        track_reassociate=args.reassociate,
        presence_keep_frac=args.presence_keep_frac, allow_empty=False,
        track_birth_cost=args.birth_cost,
        track_death_frames=args.death_frames,
        track_anchor_refresh=args.anchor_refresh)


def main(argv=None) -> Optional[dict]:
    args = parse_args(argv)
    import numpy as np
    import torch

    from tpu_pose_torch.api import (MultiPersonVideoSession, PoseEstimator,
                                    _concat_video_multi)
    from tpu_pose_torch.data import synthetic_hard as sh
    from tpu_pose_torch.fitting import priors as priors_lib
    from tpu_pose_torch.models import cpm as cpm_lib
    from tpu_pose_torch.tools.selfcheck_e2e import default_setup
    from tpu_pose_torch.utils import metrics, tf_converter

    if not args.weights or not os.path.exists(args.weights):
        raise SystemExit(f"--weights not found: {args.weights!r} "
                         f"(train via selfcheck_e2e or train_cpm first)")
    device = torch.device(args.device)
    cfg, fit_cfg, model = default_setup(device)
    prior = priors_lib.synthetic_gmm_prior(0, device=device)
    host_model = model.to("cpu")
    cpm = cpm_lib.cpm_params_from_numpy(
        tf_converter.load_params_npz(args.weights), cfg, device)
    est = PoseEstimator(cpm, model, prior, cfg, fit_cfg, device=device,
                        fit_restarts=args.restarts)
    t0 = time.time()

    def log(msg):
        print(f"[{time.time() - t0:6.0f}s] {msg}", flush=True)

    results = {"config": {
        "weights": args.weights, "seeds": args.seeds,
        "frames": args.frames, "restarts": args.restarts,
        "temporal_hints": args.temporal_hints,
        "hint_passes": args.hint_passes,
        "hint_crop": args.hint_crop,
        "hint_crop_all": args.hint_crop_all,
        "hint_crop_min_conf": args.hint_crop_min_conf,
        "reassociate": args.reassociate,
        "presence_keep_frac": args.presence_keep_frac,
        "anchor_refresh": args.anchor_refresh,
        "death_frames": args.death_frames,
        "birth_cost": args.birth_cost,
        "nms_radius": args.nms_radius,
        "x_span": args.x_span}}
    modes = [m.strip() for m in args.mode.split(",") if m.strip()]

    for mode in modes:
        per_seed = []
        for seed in range(args.seeds):
            if mode in ("crossing", "k3", "k4"):
                k = {"crossing": 2, "k3": 3, "k4": 4}[mode]
                vh = sh.make_hard_multi_video(
                    host_model, args.frames, cfg, seed=seed, crossing=True,
                    num_people=k, x_span=args.x_span)
                res = _on_host(_tracked(est, args, vh["images"], k))
                m = _match_metrics(res, vh["centers"], vh["gt_joints3d"],
                                   metrics)
            elif mode == "enterleave":
                el = sh.make_hard_enterleave_video(host_model, args.frames,
                                                   cfg, seed=seed)
                kwargs = enterleave_kwargs(args)
                if args.stream:
                    sess = MultiPersonVideoSession(est, chunk=STREAM_CHUNK,
                                                   **kwargs)
                    outs = [r for r in (sess.push(el["images"]),
                                        sess.flush()) if r is not None]
                    res = _concat_video_multi(outs)
                else:
                    res = est.estimate_and_fit_video_multi(el["images"],
                                                           **kwargs)
                m = _enterleave_metrics(_on_host(res), el)
            else:
                raise SystemExit(f"unknown mode {mode!r}")
            per_seed.append(m)
            log(f"{mode} seed {seed}: " + json.dumps(
                {k_: (round(v, 3) if isinstance(v, float) else v)
                 for k_, v in m.items()}))
        agg = {}
        for key in per_seed[0]:
            vals = [float(m[key]) for m in per_seed]
            agg[key] = {"mean": round(float(np.mean(vals)), 4),
                        "min": round(float(np.min(vals)), 4),
                        "max": round(float(np.max(vals)), 4)}
        results[mode] = {"per_seed": per_seed, "aggregate": agg}
        log(f"{mode} aggregate: " + json.dumps(agg))

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
        log(f"wrote {args.out}")
    return results


def run():
    """Console entry point (``pyproject.toml`` ``[project.scripts]``)."""
    main()


if __name__ == "__main__":
    run()
