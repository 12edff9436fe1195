"""The port's dataset-scale evaluators (tpu_pose_torch/parallel/eval.py)
against the JAX package's on the same carried estimator and batches, at
the small float32 size on the CPU; the cursor resume; and the eval and
convert CLIs."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_datasets import _lsp_mat, _write_lsp_images
from tpu_pose.api import PoseEstimator as JaxEstimator
from tpu_pose.fitting import priors as jax_priors
from tpu_pose.models import joints as jax_joints
from tpu_pose.models import smpl_data as jax_smpl_data
from tpu_pose.parallel import eval as jax_eval
from tpu_pose.utils import config as jc
from tpu_pose_torch import api as api_lib
from tpu_pose_torch.api import PoseEstimator
from tpu_pose_torch.data import pipeline, synthetic
from tpu_pose_torch.models import cpm as cpm_lib
from tpu_pose_torch.models import joints, smpl_data
from tpu_pose_torch.parallel import eval as eval_lib
from tpu_pose_torch.tools import convert_dataset, eval_2d, eval_h36m
from tpu_pose_torch.utils import config as tc
from torch_threads import one_thread

one_thread()

# BASELINE.json's budget for fitted joints, and so for every 3D metric of
# them (a metric of joints that moved ≤ 1 mm moves ≤ 1 mm).
MM = 1e-3


def _cfgs(cfg_mod, camera="perspective"):
    """tests/test_api.py's small CPM in float32 and a short fit with the
    perspective camera (eval_h36m's Protocol-1 setting) at a 64 px focal
    scale."""
    cpm = cfg_mod.CPMConfig(input_size=64, features=16, stage1_head_width=32,
                            refine_width=16, num_stages=2,
                            compute_dtype="float32")
    fit = cfg_mod.FitConfig(
        stages=(cfg_mod.StageConfig(iters=10, lr=0.05, opt_pose=False,
                                    opt_shape=False, w_pose_prior=0,
                                    w_shape_prior=0, w_angle_prior=0),
                cfg_mod.StageConfig(iters=20, lr=0.02, w_pose_prior=0.5,
                                    w_shape_prior=1.0)),
        img_size=64, camera_model=camera, focal=870.0)
    return cpm, fit


@pytest.fixture(scope="module")
def estimators():
    """(JAX, port) estimators on the same weights, SMPL model and prior:
    He-initialized CPM weights in the JAX package's layout (numpy draws),
    the synthetic SMPL and GMM-8 (identical in both packages)."""
    params = cpm_lib.cpm_params_to_numpy(
        cpm_lib.init_cpm_params(0, _cfgs(tc)[0], device="cpu"))
    jest = JaxEstimator(jax.tree.map(jnp.asarray, params),
                        jax_smpl_data.synthetic_smpl(seed=0),
                        jax_priors.synthetic_gmm_prior(0), *_cfgs(jc))
    smpl = {k: np.asarray(v) for k, v in jest.smpl_model._asdict().items()}
    prior = {k: np.asarray(getattr(jest.prior, k))
             for k in ("means", "precisions", "log_consts")}
    return jest, PoseEstimator.from_numpy(params, smpl, prior, *_cfgs(tc),
                                          device="cpu")


@pytest.fixture(scope="module")
def batches(estimators):
    """Two batches of two synthetic frames with every ground truth: 3D
    (SMPL-24) and 2D joints, SMPL θ/β, a conf mask, head sizes, areas."""
    _, test = estimators
    out = []
    for b in range(2):
        ex = synthetic.make_examples(test.smpl_model, 2, _cfgs(tc)[0],
                                     seed=50 + b)
        rng = np.random.RandomState(b)
        conf = (rng.rand(2, 14) > 0.2).astype(np.float32)
        conf[:, [5, 8]] = 1.0
        out.append({"images": ex["images"], "gt_joints3d": ex["gt_joints3d"],
                    "gt_joints2d": ex["joints2d"], "gt_theta": ex["theta"],
                    "gt_beta": ex["beta"], "conf": conf,
                    "headsize": rng.uniform(6, 12, 2).astype(np.float32),
                    "area": rng.uniform(300, 900, 2).astype(np.float32)})
    return out


def _pick(bs, *keys):
    return [{k: b[k] for k in ("images",) + keys} for b in bs]


def test_fitted_joints_within_budget(estimators, batches):
    """The evaluated call itself: joints3d and vertices of the port's
    estimate_and_fit within 1 mm of JAX's on every batch."""
    jest, test = estimators
    for b in batches:
        want = jest.estimate_and_fit(jnp.asarray(b["images"]))
        got = test.estimate_and_fit(b["images"])
        for k in ("joints3d", "vertices"):
            d = np.linalg.norm(got._asdict()[k].numpy()
                               - np.asarray(want._asdict()[k]), axis=-1)
            assert d.mean() <= MM, (k, d.mean())


def _assert_metrics_close(got: dict, want: dict, n2d: int = 0):
    assert set(got) == set(want)
    for k, w in want.items():
        if k.startswith("num_frames"):
            assert got[k] == w, k
        elif k == "pckh":
            # Decoded 2D joints agree to ~1e-4 px: at most one joint of
            # the frames can sit on the threshold.
            assert abs(got[k] - w) <= 1.0 / (14 * n2d) + 1e-12, k
        else:
            assert abs(got[k] - w) <= MM, (k, got[k], w)


@pytest.mark.parametrize("case", ["smpl24_theta", "h36m_vertices_pa",
                                  "gendered_scaled"])
def test_evaluate_h36m_style_matches_jax(estimators, batches, case):
    jest, test = estimators
    kw_jax, kw = {}, {}
    if case == "smpl24_theta":
        bs = _pick(batches, "gt_joints3d", "gt_joints2d", "gt_theta",
                   "gt_beta")
    elif case == "h36m_vertices_pa":
        bs = []
        for b in batches:
            verts = _gt_vertices(test, b)
            bs.append({"images": b["images"], "gt_vertices": verts,
                       "gt_joints3d": b["gt_joints3d"][
                           ..., joints.H36M_TO_SMPL, :]})
        kw_jax = dict(select_joints=jax_joints.select_h36m_joints,
                      primary_protocol="pa", root_index=0)
        kw = dict(kw_jax, select_joints=joints.select_h36m_joints)
    else:
        bs = _pick(batches, "gt_joints3d", "gt_theta", "gt_beta")
        kw_jax = dict(gt_smpl_model=jax_smpl_data.synthetic_smpl(seed=99),
                      primary_protocol="scaled", pckh_threshold=0.3)
        kw = dict(kw_jax, gt_smpl_model=smpl_data.synthetic_smpl(
            seed=99, device="cpu"))
    want = jax_eval.evaluate_h36m_style(jest, iter(bs), **kw_jax)
    got = eval_lib.evaluate_h36m_style(test, iter(bs), **kw)
    _assert_metrics_close(got, want, n2d=4)
    assert got["num_frames"] == 4
    if case == "smpl24_theta":
        assert {"pckh", "pve", "pa_pve"} <= set(got)
        assert got["mpjpe"] == got["mpjpe_p1"]
    if case == "h36m_vertices_pa":
        assert got["mpjpe"] == got["pa_mpjpe"] and "pve" in got
    if case == "gendered_scaled":
        assert got["mpjpe"] == got["mpjpe_scaled"]


def _gt_vertices(est, b):
    from tpu_pose_torch.models import smpl as smpl_lib
    with torch.no_grad():
        return smpl_lib.smpl_forward_batch(
            est.smpl_model, torch.from_numpy(b["gt_beta"]),
            torch.from_numpy(b["gt_theta"])).vertices.numpy()


@pytest.mark.parametrize("norm,keys", [("head", ()),
                                       ("head", ("conf", "headsize")),
                                       ("torso", ("conf",))])
def test_evaluate_pckh_matches_jax(estimators, batches, norm, keys):
    jest, test = estimators
    bs = _pick(batches, "gt_joints2d", *keys)
    want = jax_eval.evaluate_pckh(jest, iter(bs), threshold=0.5, norm=norm)
    got = eval_lib.evaluate_pckh(test, iter(bs), threshold=0.5, norm=norm)
    assert set(got) == set(want) and got["num_frames"] == want["num_frames"]
    one = 1.0 / (14 * want["num_frames"]) + 1e-12   # one joint's hit
    for k in ("pckh", "auc"):
        assert abs(got[k] - want[k]) <= one, k
    assert got["per_threshold"].keys() == want["per_threshold"].keys()
    for t, v in want["per_threshold"].items():
        assert abs(got["per_threshold"][t] - v) <= one, t
    assert got["per_joint"].keys() == want["per_joint"].keys()
    for j, v in want["per_joint"].items():
        assert abs(got["per_joint"][j] - v) <= 1.0 / want["num_frames"], j
    with pytest.raises(ValueError, match="norm"):
        eval_lib.evaluate_pckh(test, iter(bs), norm="elbow")


@pytest.mark.parametrize("keys", [(), ("conf", "area")])
def test_evaluate_oks_matches_jax(estimators, batches, keys):
    jest, test = estimators
    bs = _pick(batches, "gt_joints2d", *keys)
    want = jax_eval.evaluate_oks(jest, iter(bs))
    got = eval_lib.evaluate_oks(test, iter(bs))
    assert set(got) == set(want) and got["num_frames"] == 4
    # OKS is smooth in the joints: ~1e-4 px apart moves it ≤ 1e-4.
    assert abs(got["mean_oks"] - want["mean_oks"]) <= 1e-4
    one = 1.0 / want["num_frames"] + 1e-12          # one person's hit
    for k in ("ap", "ap50", "ap75"):
        assert abs(got[k] - want[k]) <= one, k
    assert got["per_threshold"].keys() == want["per_threshold"].keys()


@pytest.mark.parametrize("evaluator", ["h36m", "pckh", "oks"])
def test_cursor_resume_gives_the_same_result(estimators, batches, evaluator,
                                             tmp_path):
    """A cursor file written after batch 1 (save_every=1) resumes at batch
    2 and gives the uninterrupted run's result dict; the file is the JAX
    package's (same JSON fields, read by its loader)."""
    _, test = estimators
    bs = _pick(batches, "gt_joints3d", "gt_joints2d", "conf", "area")
    fn, state_cls, jax_cls = {
        "h36m": (eval_lib.evaluate_h36m_style, eval_lib.EvalState,
                 jax_eval.EvalState),
        "pckh": (eval_lib.evaluate_pckh, eval_lib.Eval2DState,
                 jax_eval.Eval2DState),
        "oks": (eval_lib.evaluate_oks, eval_lib.EvalOKSState,
                jax_eval.EvalOKSState)}[evaluator]
    assert ([f.name for f in dataclasses.fields(state_cls)]
            == [f.name for f in dataclasses.fields(jax_cls)])
    full = fn(test, iter(bs))
    ckpt = str(tmp_path / "cursor.json")
    fn(test, iter(bs[:1]), checkpoint_path=ckpt, save_every=1)
    assert state_cls.load(ckpt).cursor == 1
    assert jax_cls.load(ckpt) == jax_cls(**json.load(open(ckpt)))
    resumed = fn(test, iter(bs), checkpoint_path=ckpt, save_every=1)
    assert resumed == full
    assert state_cls.load(ckpt).cursor == 2
    # Another metric layout's file starts the run over.
    with open(ckpt, "w") as f:
        json.dump({"cursor": 1, "n": 2}, f)
    assert state_cls.load(ckpt) == state_cls()
    assert fn(test, iter(bs), checkpoint_path=ckpt) == full


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------

@pytest.fixture
def small_synthetic(monkeypatch):
    """The CLIs' synthetic estimator at the small size on the CPU (their
    own camera, focal and prior kept)."""
    real = PoseEstimator.create_synthetic.__func__
    cpm_cfg, fit_cfg = _cfgs(tc)

    def create(cls, seed=0, fit_cfg=None, **kw):
        fit = fit_cfg or tc.FitConfig()
        fit = dataclasses.replace(fit, stages=_cfgs(tc)[1].stages,
                                  img_size=64)
        return real(cls, seed, cpm_cfg=cpm_cfg, fit_cfg=fit, **kw)

    monkeypatch.setattr(api_lib.PoseEstimator, "create_synthetic",
                        classmethod(create))


def test_eval_h36m_cli(small_synthetic, tmp_path, capsys):
    resume = str(tmp_path / "cursor.json")
    argv = ["--synthetic_batches", "2", "--batch", "2", "--device", "cpu",
            "--h36m_joints", "--fit_prior", "64", "--resume", resume]
    out = eval_h36m.main(argv)
    line = capsys.readouterr().out
    assert "camera=perspective" in line and "MPJPE-P1=" in line
    assert "PCKh@0.5=" in line and out["num_frames"] == 4
    assert eval_lib.EvalState.load(resume).cursor == 2
    # The finished cursor resumes to the same numbers without new frames.
    assert eval_h36m.main(argv) == out
    # A prior saved by save_gmm_npz: --gmm_npz loads it.
    from tpu_pose_torch.fitting import priors
    gmm = str(tmp_path / "gmm.npz")
    priors.save_gmm_npz(gmm, priors.fit_gmm(
        np.random.RandomState(0).randn(64, 69) * 0.2, 8, device="cpu"))
    out_pa = eval_h36m.main(["--synthetic_batches", "1", "--batch", "2",
                             "--device", "cpu", "--protocol", "pa",
                             "--gmm_npz", gmm])
    assert "camera=weak_perspective" in capsys.readouterr().out
    assert out_pa["mpjpe"] == out_pa["pa_mpjpe"]
    with pytest.raises(SystemExit):
        eval_h36m.main(["--device", "cpu"])


@pytest.mark.parametrize("protocol", ["pck", "oks"])
def test_eval_2d_cli(small_synthetic, capsys, protocol):
    argv = ["--synthetic_batches", "1", "--batch", "2", "--device", "cpu",
            "--protocol", protocol]
    if protocol == "pck":
        argv += ["--norm", "torso", "--threshold", "0.2", "--flip_tta",
                 "--norefine_center", "--scale_tta", "0.9,1.1"]
    out = eval_2d.main(argv)
    text = capsys.readouterr().out
    assert out["num_frames"] == 2
    if protocol == "pck":
        assert "PCK(torso)@0.2=" in text and "r_ankle" in text
    else:
        assert "meanOKS=" in text and 0.0 <= out["ap"] <= 1.0
    args = eval_2d.parse_args(argv)
    assert args.refine_center == (protocol == "oks")


def test_convert_dataset_cli(tmp_path, capsys):
    """LSPET annotations and images → shards in the 2D evaluator's
    schema; the flags' defaults."""
    mat, xy, _ = _lsp_mat(tmp_path, "lspet", n=3)
    images = _write_lsp_images(tmp_path, xy)
    out = str(tmp_path / "shards")
    paths = convert_dataset.main(["--dataset", "lsp", "--annotations", mat,
                                  "--images", images, "--out", out,
                                  "--size", "64", "--shard_size", "2"])
    assert len(paths) == 2 and "3 samples" in capsys.readouterr().out
    src = pipeline.NpzShardSource(out)
    assert src[0]["images"].shape == (64, 64, 3)
    assert set(src[0]) == {"images", "gt_joints2d", "conf", "headsize"}
    args = convert_dataset.parse_args(["--dataset", "coco", "--annotations",
                                       "a", "--images", "b", "--out", "c"])
    assert args.size == 368 and args.margin == 0.0 and args.limit == 0
