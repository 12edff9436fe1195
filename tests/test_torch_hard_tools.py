"""The port's tools on the hard set (tpu_pose_torch/tools/: track_bench,
hard_sweep, selfcheck_e2e, demo, profile_entry): track_bench's metrics
against the JAX package's on tests/test_track_bench.py's inputs, the sweep
grid, a selfcheck ladder rung on carried weights against the same rung
through JAX's PoseEstimator, and every CLI end to end at a small size on
the CPU (the tests patch the CLIs' configs to small widths)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from test_track_bench import _Metrics, _Res, _video
from tpu_pose.api import PoseEstimator as JaxEstimator
from tpu_pose.fitting import priors as jax_priors
from tpu_pose.models import smpl_data as jax_smpl_data
from tpu_pose.tools import track_bench as jax_tb
from tpu_pose.utils import config as jc
from tpu_pose.utils import metrics as jax_metrics
from tpu_pose_torch import api as api_lib
from tpu_pose_torch.api import PoseEstimator
from tpu_pose_torch.fitting import priors
from tpu_pose_torch.models import cpm as cpm_lib
from tpu_pose_torch.models import smpl_data
from tpu_pose_torch.tools import (demo, hard_sweep, profile_entry,
                                  selfcheck_e2e, track_bench)
from tpu_pose_torch.utils import checkpoint, tf_converter
from tpu_pose_torch.utils import config as tc
from torch_threads import one_thread

one_thread()

MM = 1e-3                 # BASELINE.json's budget, metres
PX = 0.05


def _cfgs(cfg_mod, iters=(10, 20)):
    """A small float32 CPM (64², 3 stages) and a short two-stage fit."""
    cpm = cfg_mod.CPMConfig(input_size=64, features=16, stage1_head_width=32,
                            refine_width=16, num_stages=3,
                            compute_dtype="float32")
    fit = cfg_mod.FitConfig(
        stages=(cfg_mod.StageConfig(iters=iters[0], lr=0.05, opt_pose=False,
                                    opt_shape=False, w_pose_prior=0,
                                    w_shape_prior=0, w_angle_prior=0),
                cfg_mod.StageConfig(iters=iters[1], lr=0.02,
                                    w_pose_prior=0.5, w_shape_prior=1.0)),
        img_size=64)
    return cpm, fit


# -- track_bench's metrics ---------------------------------------------------

def _relabelled(k=3):
    res, gc, gj = _video(k=k)
    relabel = [2, 0, 1]
    return _Res(res.joints2d[:, relabel], res.joints3d[relabel],
                res.frame_mask[:, relabel]), gc, gj


def _slack():
    res, gc, gj = _video(k=3)
    t = res.joints2d.shape[0]
    rng = np.random.RandomState(5)
    spare = rng.uniform(300, 360, (t, 1, 14, 2)).astype(np.float32)
    return _Res(np.concatenate([res.joints2d[:, :2], spare,
                                res.joints2d[:, 2:]], 1),
                np.concatenate([res.joints3d[:2],
                                rng.rand(1, t, 24, 3).astype(np.float32),
                                res.joints3d[2:]], 0),
                np.ones((t, 4), bool)), gc, gj


def _off_track():
    res, gc, gj = _video(t=10)
    j2 = np.asarray(res.joints2d).copy()
    j2[5:, 0] += np.array([60.0, 0.0])
    return _Res(j2, np.asarray(res.joints3d), res.frame_mask), gc, gj


MATCH_CASES = {"perfect": lambda: _video(),
               "swap": lambda: _video(t=10, swap_from=5),
               "k3_relabelled": _relabelled,
               "slack_track": _slack,
               "off_track": _off_track}


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_match_metrics_equal_jax(case):
    res, gc, gj = MATCH_CASES[case]()
    assert (track_bench._match_metrics(res, gc, gj, _Metrics)
            == jax_tb._match_metrics(res, gc, gj, _Metrics))


def _enterleave(all_live: bool):
    t = 12
    present = np.zeros((t, 3), np.float32)
    present[:, 0] = 1
    present[:6, 1] = 1
    present[8:, 2] = 1
    centers = np.zeros((t, 3, 2), np.float32)
    centers[:, 0] = [80, 100]
    centers[:, 1] = [260, 100]
    centers[:, 2] = [240, 140]
    tj = np.zeros((t, 2, 14, 2), np.float32)
    tj[:, 0] = centers[:, 0, None]
    tj[:6, 1] = centers[:6, 1, None]
    tj[6:, 1] = centers[6:, 2, None]
    fmask = np.ones((t, 2), bool)
    if not all_live:
        fmask[6:8, 1] = False
    return _Res(tj, None, fmask), {"present": present, "centers": centers}


@pytest.mark.parametrize("all_live", [False, True])
def test_enterleave_metrics_equal_jax(all_live):
    res, el = _enterleave(all_live)
    got = track_bench._enterleave_metrics(res, el)
    assert got == jax_tb._enterleave_metrics(res, el)
    assert got["count_acc"] == (10 / 12 if all_live else 1.0)


def test_best_perm_equals_jax():
    costs = np.random.RandomState(0).rand(24)
    assert track_bench._best_perm(costs) == jax_tb._best_perm(costs)


# -- hard_sweep's grid -------------------------------------------------------

def test_hard_sweep_grid_every_field():
    rows = hard_sweep.parse_grid(
        "r3:2400:32:0.0, dis:2400:32:0.35,st:10:2:0.1:1,"
        "u2:9600:64:0.35:0:0:1:2,w:5:1:0.0:0:64")
    assert rows == [
        {"name": "r3", "steps": 2400, "pool": 32, "distractor": 0.0,
         "share_trunk": False, "features": 0, "union": False, "max_d": 1},
        {"name": "dis", "steps": 2400, "pool": 32, "distractor": 0.35,
         "share_trunk": False, "features": 0, "union": False, "max_d": 1},
        {"name": "st", "steps": 10, "pool": 2, "distractor": 0.1,
         "share_trunk": True, "features": 0, "union": False, "max_d": 1},
        {"name": "u2", "steps": 9600, "pool": 64, "distractor": 0.35,
         "share_trunk": False, "features": 0, "union": True, "max_d": 2},
        {"name": "w", "steps": 5, "pool": 1, "distractor": 0.0,
         "share_trunk": False, "features": 64, "union": False, "max_d": 1}]
    base = tc.CPMConfig()
    assert hard_sweep.row_config(base, rows[0]) is base
    assert hard_sweep.row_config(base, rows[2]).share_trunk
    wide = hard_sweep.row_config(base, rows[4])
    assert (wide.features, wide.refine_width, wide.share_trunk) == (64, 64,
                                                                   False)


# -- a selfcheck ladder rung against JAX -------------------------------------

@pytest.fixture(scope="module")
def carried():
    """The same small float32 weights, SMPL (300 vertices) and GMM-8 prior
    for JAX's estimator and the port's selfcheck Run on the CPU."""
    params = cpm_lib.cpm_params_to_numpy(
        cpm_lib.init_cpm_params(0, _cfgs(tc)[0], device="cpu"))
    jm = jax_smpl_data.synthetic_smpl(seed=0, num_verts=300)
    jp = jax_priors.synthetic_gmm_prior(0)
    smpl = {k: np.asarray(v) for k, v in jm._asdict().items()}
    prior = {k: np.asarray(getattr(jp, k))
             for k in ("means", "precisions", "log_consts")}
    return params, jm, jp, smpl, prior


@pytest.mark.parametrize("rung", ["hard_rc_flip_tta",
                                  "hard_scale_sweep_refine_scale"])
def test_selfcheck_rung_matches_jax(carried, rung, tmp_path):
    """selfcheck_e2e.hard_eval on carried weights against the same rung
    through JAX's PoseEstimator (the JAX tool's hard_eval formulas): the
    visible-joint px error within 0.05 px, PA-MPJPE within 1 mm."""
    params, jm, jp, smpl, prior = carried
    _, scale_range, truncation, kw = next(
        r for r in selfcheck_e2e.HARD_LADDER if r[0] == rung)
    args = selfcheck_e2e.parse_args(
        ["--hard_eval_frames", "3", "--restarts", "2", "--out",
         str(tmp_path), "--device", "cpu"])
    cpm_cfg, fit_cfg = _cfgs(tc)
    model = smpl_data.SMPLData.from_numpy(smpl, "cpu")
    run = selfcheck_e2e.Run(args, setup=(cpm_cfg, fit_cfg, model))
    selfcheck_e2e.hard_eval(
        run, rung, cpm_lib.cpm_params_from_numpy(params, cpm_cfg, "cpu"),
        priors.gmm_prior_from_numpy(device="cpu", **prior), scale_range,
        truncation, **kw)
    exh = run.hard_frames(3, 4321, scale_range, truncation)
    est = JaxEstimator(jax.tree.map(jnp.asarray, params), jm, jp,
                       *_cfgs(jc), fit_restarts=2, **kw)
    res = est.estimate_and_fit(jnp.asarray(exh["images"]))
    vis = exh["visibility"] > 0
    d = np.linalg.norm(np.asarray(res.joints2d) - exh["joints2d"], axis=-1)
    pa = float(np.mean(jax_metrics.pa_mpjpe_np(
        np.asarray(res.joints3d), exh["gt_joints3d"]))) * 1000
    got = run.results[rung]
    assert abs(got["px_err"] - float(d[vis].mean())) <= PX
    assert abs(got["pa_mpjpe_mm"] - pa) <= MM * 1000


# -- the CLIs end to end -----------------------------------------------------

def _small_setup(device):
    cpm_cfg, fit_cfg = _cfgs(tc, iters=(3, 3))
    return (cpm_cfg, fit_cfg,
            smpl_data.synthetic_smpl(seed=0, num_verts=300, device=device))


SELFCHECK_DEPTH = dict(EASY_POOL=2, PRIOR_CORPUS=200, HEAD_STEPS=3,
                       HEAD_BATCH=8, MULTI_FRAMES=2, HARD_VIDEO_FRAMES=4,
                       EMPTY_FRAMES=4, COUNT_FRAMES=2, CAL_FRAMES=2,
                       DATASET_FRAMES=8, THREEDPW_FRAMES=4)
SELFCHECK_ARGV = ["--steps", "3", "--train_batch", "2", "--eval_frames",
                  "2", "--video_frames", "3", "--restarts", "2",
                  "--hard_steps", "3", "--hard_pool", "1",
                  "--hard_eval_frames", "2", "--device", "cpu"]
# results.json's keys: the JAX tool's.
SELFCHECK_KEYS = {
    "train_final_loss", "fused_random_weights", "fused_trained_weights",
    "fused_fitted_prior", "init_head_final_loss", "fused_meanpose_init",
    "fused_learned_init", "video_temporal", "video_independent",
    "video_smooth", "multi_person", "hard_train_final_loss", "hard_plain",
    "hard_refine_center", "hard_rc_flip_tta", "hard_rc_flip_scale_tta",
    "hard_rc_int8_calibrated", "hard_truncated_plain",
    "hard_truncated_rc_flip", "hard_fixed_scale", "hard_scale_sweep_plain",
    "hard_scale_sweep_refine_scale", "scale_robustness",
    "hard_multi_person", "hard_multi_video", "empty_frame_operating_point",
    "hard_multi_person_k3", "export_artifact", "dataset_adapter_chain",
    "threedpw_chain"}


@pytest.fixture
def small_selfcheck(monkeypatch):
    monkeypatch.setattr(selfcheck_e2e, "default_setup", _small_setup)
    for k, v in SELFCHECK_DEPTH.items():
        monkeypatch.setattr(selfcheck_e2e, k, v)


def test_selfcheck_cli(small_selfcheck, tmp_path, capsys):
    """Every section, 8 to 10 included: results.json with the JAX tool's
    keys, the deployment artifact within its rule, both weights npz files
    in the JAX package's format; --hard_weights loads the saved hard
    weights in place of training."""
    out = str(tmp_path / "sc")
    res = selfcheck_e2e.main(SELFCHECK_ARGV + ["--out", out])
    assert set(res) == SELFCHECK_KEYS
    assert res["export_artifact"]["ok"]
    assert os.path.exists(os.path.join(out, "artifact", "meta.json"))
    with open(os.path.join(out, "results.json")) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    assert res["dataset_adapter_chain"]["num_frames"] == 8
    assert res["threedpw_chain"]["num_frames"] == 4
    for name in ("cpm_weights.npz", "cpm_weights_hard.npz"):
        params = tf_converter.load_params_npz(os.path.join(out, name))
        assert set(params) == {n for n, *_ in cpm_lib._layer_defs(
            _small_setup("cpu")[0])}
    assert "done →" in capsys.readouterr().out
    hard_npz = os.path.join(out, "cpm_weights_hard.npz")
    again = selfcheck_e2e.Run(selfcheck_e2e.parse_args(
        SELFCHECK_ARGV + ["--out", str(tmp_path / "again"), "--hard_weights",
                          hard_npz]))
    loaded = cpm_lib.cpm_params_to_numpy(selfcheck_e2e.hard_weights(again))
    saved = tf_converter.load_params_npz(hard_npz)
    assert "hard_train_final_loss" not in again.results
    for layer, wb in saved.items():
        for k, v in wb.items():
            np.testing.assert_array_equal(loaded[layer][k], v)
    skipped = selfcheck_e2e.parse_args(["--hard_steps", "0",
                                        "--nohard_union_stage1"])
    assert skipped.hard_steps == 0 and not skipped.hard_union_stage1
    defaults = selfcheck_e2e.parse_args([])
    assert (defaults.steps, defaults.hard_steps, defaults.hard_pool,
            defaults.device, defaults.hard_union_stage1) == (
        800, 9600, 64, "cuda", True)


def test_hard_sweep_and_track_bench_clis(monkeypatch, tmp_path):
    """hard_sweep trains two rows (one with union targets and max_d 2)
    and writes each row's weights; track_bench scores every mode on them,
    enterleave through the session windows too."""
    monkeypatch.setattr(selfcheck_e2e, "default_setup", _small_setup)
    out = str(tmp_path / "sweep")
    rows = hard_sweep.main(["--grid", "a:12:1:0.0,b:12:1:0.5:0:0:1:2",
                            "--train_batch", "2", "--eval_frames", "2",
                            "--out", out, "--device", "cpu"])
    assert list(rows) == ["a", "b"] and rows["b"]["config"]["union"]
    with open(os.path.join(out, "sweep.json")) as f:
        assert set(json.load(f)) == {"a", "b"}
    for row in rows.values():
        assert set(row["plain"]) == set(row["rc_flip"]) == {"px", "pa_mm"}
        assert os.path.exists(row["weights"])
    js = str(tmp_path / "tb.json")
    argv = ["--weights", rows["b"]["weights"], "--seeds", "1", "--frames",
            "12", "--device", "cpu", "--out", js]
    res = track_bench.main(argv + ["--mode", "crossing,k3"])
    assert set(res["crossing"]["aggregate"]) == {
        "id_acc", "center_err_px", "pa_mpjpe_mm", "cover40"}
    assert res["config"]["seeds"] == 1
    res = track_bench.main(argv + ["--mode", "k4", "--slack_slots", "1",
                                   "--hint_crop_all", "--reassociate",
                                   "--x_span", "0.8", "--nms_radius",
                                   "16"])
    assert len(res["k4"]["per_seed"]) == 1
    streamed = track_bench.main(argv + ["--mode", "enterleave",
                                        "--stream"])
    whole = track_bench.main(argv + ["--mode", "enterleave"])
    keys = {"count_acc", "count_over", "count_under",
            "count_err_transition", "count_err_steady", "id_acc",
            "seg_consistency_min", "ab_c_distinct_tracks",
            "c_track_reuses_b_slot"}
    assert set(streamed["enterleave"]["per_seed"][0]) == keys
    assert set(whole["enterleave"]["per_seed"][0]) == keys
    with open(js) as f:
        assert "enterleave" in json.load(f)
    with pytest.raises(SystemExit):
        track_bench.main(["--weights", str(tmp_path / "none.npz"),
                          "--device", "cpu"])
    with pytest.raises(SystemExit):
        track_bench.main(argv + ["--mode", "k9"])


@pytest.fixture
def small_synthetic(monkeypatch):
    """The CLIs' synthetic estimator at the small size on the CPU."""
    real = PoseEstimator.create_synthetic.__func__
    small_cpm, small_fit = _cfgs(tc, iters=(3, 3))

    def create(cls, seed=0, fit_cfg=None, **kw):
        fit = dataclasses.replace(fit_cfg or tc.FitConfig(),
                                  stages=small_fit.stages, img_size=64)
        return real(cls, seed, cpm_cfg=small_cpm, fit_cfg=fit, **kw)

    monkeypatch.setattr(api_lib.PoseEstimator, "create_synthetic",
                        classmethod(create))


@pytest.mark.parametrize("mode", ["single", "multi", "video", "video_multi"])
def test_demo_cli(small_synthetic, tmp_path, capsys, mode):
    out = str(tmp_path / mode)
    argv = ["--synthetic", "2", "--device", "cpu", "--out_dir", out]
    argv += {"single": [], "multi": ["--multi"], "video": ["--video"],
             "video_multi": ["--multi", "--video"]}[mode]
    demo.main(argv)
    files = set(os.listdir(out))
    fits = checkpoint.load_fit_results(os.path.join(out, "fits.npz"))
    assert {"pose2d_000.png", "pose2d_001.png"} <= files
    if mode in ("single", "video"):
        assert {"mesh_000.obj", "mesh_001.obj", "mesh2d_000.png",
                "mesh2d_001.png"} <= files
        assert fits["theta"].shape == (2, 72)
    else:
        kept = {f"mesh_{i:03d}_p{k}.obj"
                for i, k in zip(*np.nonzero(fits["person_mask"] > 0))}
        assert kept and kept <= files
        assert ("perm" in fits) == (mode == "video_multi")
    assert "note: no weights supplied" in capsys.readouterr().out


def test_demo_inputs(small_synthetic, tmp_path):
    frames = np.random.RandomState(0).randint(0, 255, (2, 48, 80, 3),
                                              np.uint8)
    paths = []
    for i, f in enumerate(frames):
        paths.append(str(tmp_path / f"f{i}.npy"))
        np.save(paths[-1], f)
    np.testing.assert_array_equal(demo.load_images(paths), frames)
    out = str(tmp_path / "lb")
    demo.main(["--images", ",".join(paths), "--device", "cpu", "--out_dir",
               out])
    fits = checkpoint.load_fit_results(os.path.join(out, "fits.npz"))
    assert fits["joints2d"].shape == (2, 14, 2)
    for argv in (["--device", "cpu"],
                 ["--synthetic", "2", "--stream_chunk", "4", "--device",
                  "cpu"]):
        with pytest.raises(SystemExit):
            demo.main(argv + ["--out_dir", out])
    assert demo.parse_args([]).letterbox
    assert not demo.parse_args(["--noletterbox"]).letterbox


@pytest.mark.parametrize("fn", ["estimate_and_fit", "fit_smpl"])
def test_profile_entry_cli(small_synthetic, tmp_path, capsys, fn):
    """One JSON line with the JAX tool's keys; flops equal FlopCounterMode's
    count of one call, hbm_frac null (no byte count), a Chrome trace."""
    trace = str(tmp_path / "trace")
    rec = profile_entry.main(["--fn", fn, "--batch", "2", "--iters", "1",
                              "--device", "cpu", "--trace_dir", trace])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == rec
    assert set(rec) == {"fn", "batch", "ms_per_call", "items_per_s",
                        "flops", "flops_per_s", "mfu", "hbm_frac",
                        "trace_dir"}
    assert rec["hbm_frac"] is None and rec["trace_dir"] == trace
    assert os.path.exists(os.path.join(trace, "trace.json"))
    est = PoseEstimator.create_synthetic(seed=0, device="cpu")
    inputs = profile_entry.make_inputs(est, fn, 2)
    getattr(est, fn)(*inputs)
    with FlopCounterMode(display=False) as counter:
        getattr(est, fn)(*inputs)
    assert rec["flops"] == counter.get_total_flops() > 0
    args = profile_entry.parse_args([])
    assert (args.chip, args.dtype, args.device) == ("h100 sxm", "bf16",
                                                    "cuda")
