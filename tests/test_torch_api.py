"""The slice as a whole: the JAX package's PoseEstimator, carried into the
port with from_numpy, runs estimate_and_fit on the same uint8 batch in
both packages; every output is compared."""

import dataclasses
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from tpu_pose.api import PoseEstimator as JaxEstimator
from tpu_pose.utils import config as jc
from tpu_pose.utils import tf_converter as jax_conv
from tpu_pose_torch.api import PoseEstimator
from tpu_pose_torch.models import cpm as cpm_lib
from tpu_pose_torch.utils import config as tc
from torch_threads import one_thread

one_thread()


def _cfgs(cfg_mod, compute_dtype):
    """tests/test_api.py's SMALL_CPM / SMALL_FIT in either package."""
    cpm = cfg_mod.CPMConfig(input_size=64, features=16, stage1_head_width=32,
                            refine_width=16, num_stages=2,
                            compute_dtype=compute_dtype)
    fit = cfg_mod.FitConfig(
        stages=(cfg_mod.StageConfig(iters=20, lr=0.05, opt_pose=False,
                                    opt_shape=False, w_pose_prior=0,
                                    w_shape_prior=0, w_angle_prior=0),
                cfg_mod.StageConfig(iters=40, lr=0.02, w_pose_prior=0.5,
                                    w_shape_prior=1.0)),
        img_size=64)
    return cpm, fit


def _carry(jax_est, compute_dtype):
    cpm_cfg, fit_cfg = _cfgs(tc, compute_dtype)
    params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in jax_est.cpm_params.items()}
    smpl = {k: np.asarray(v) for k, v in jax_est.smpl_model._asdict().items()}
    prior = {k: np.asarray(getattr(jax_est.prior, k))
             for k in ("means", "precisions", "log_consts")}
    return PoseEstimator.from_numpy(params, smpl, prior, cpm_cfg, fit_cfg,
                                    device="cpu")


@pytest.fixture(scope="module")
def estimators():
    """(JAX, port) pairs in float32 and bf16 from the same JAX weights."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jest = JaxEstimator.create_synthetic(0, *_cfgs(jc, dtype))
        out[dtype] = (jest, _carry(jest, dtype))
    return out


def _images(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (2, h, w, 3)).astype(
        np.uint8)


def _mpjpe_mm(a, b):
    return 1000.0 * float(np.linalg.norm(a - b, axis=-1).mean())


@pytest.mark.parametrize("hw", [(64, 64), (80, 60)])
def test_estimate_and_fit_matches_jax_f32(estimators, hw):
    """Float32 end to end. Bounds: joints2d 1e-2 px; θ/β/cam 1e-3 after
    60 Adam steps; joints3d MPJPE and mean vertex error ≤ 1 mm (the
    BASELINE.json budget); energy rtol 1e-3."""
    jest, test = estimators["float32"]
    imgs = _images(*hw, seed=hw[1])
    want = jest.estimate_and_fit(jnp.asarray(imgs))
    got = test.estimate_and_fit(imgs)
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    got = {k: v.detach().numpy() for k, v in got._asdict().items()}
    np.testing.assert_allclose(got["joints2d"], want["joints2d"], rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(got["conf"], want["conf"], rtol=0,
                               atol=1e-4 * np.abs(want["conf"]).max())
    for k in ("theta", "beta", "cam"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3,
                                   err_msg=k)
    np.testing.assert_allclose(got["energy"], want["energy"], rtol=1e-3)
    assert _mpjpe_mm(got["joints3d"], want["joints3d"]) <= 1.0
    assert _mpjpe_mm(got["vertices"], want["vertices"]) <= 1.0
    assert got["vertices"].shape == (2, 6890, 3)


def test_estimate_and_fit_bf16(estimators):
    """bf16 convs round at other places in the two frameworks (see
    tests/test_torch_cpm.py), so the 2D joints may differ by up to one
    heatmap cell and the fit starts from slightly different observations:
    joints2d within 8 px, and the fitted joints3d within 25 mm MPJPE of
    JAX's. Every output is finite and shaped as JAX's."""
    jest, test = estimators["bfloat16"]
    imgs = _images(64, 64, seed=9)
    want = {k: np.asarray(v)
            for k, v in jest.estimate_and_fit(jnp.asarray(imgs))
            ._asdict().items()}
    got = {k: v.detach().numpy()
           for k, v in test.estimate_and_fit(imgs)._asdict().items()}
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.isfinite(got[k]).all(), k
    np.testing.assert_allclose(got["joints2d"], want["joints2d"], rtol=0,
                               atol=8)
    assert _mpjpe_mm(got["joints3d"], want["joints3d"]) <= 25.0


def test_estimate_2d_and_fit_smpl_entry_points(estimators):
    jest, test = estimators["float32"]
    imgs = _images(80, 60, seed=3)
    r = test.estimate_2d(imgs)
    assert r.heatmaps.shape == (2, 8, 8, 15)
    assert r.joints2d.shape == (2, 14, 2) and r.conf.shape == (2, 14)
    rng = np.random.RandomState(1)
    j = (rng.rand(14, 2) * 64).astype(np.float32)
    c = np.ones(14, np.float32)
    single = test.fit_smpl(j, c)
    assert single.theta.shape == (72,)
    batch = test.fit_smpl(j[None], c[None])
    assert batch.theta.shape == (1, 72)
    torch.testing.assert_close(single.theta, batch.theta[0])
    multi = test.fit_smpl(j[None], c[None], restarts=2)
    assert multi.theta.shape == (1, 72)
    assert torch.isfinite(multi.energy).all()
    with pytest.raises(ValueError, match="exclusive"):
        test.fit_smpl(j, c, init={"theta": torch.zeros(72)}, restarts=2)


def test_entry_points_reject_malformed_inputs(estimators):
    """Same ValueErrors as the JAX package's entry points."""
    _, test = estimators["float32"]
    for call in (test.estimate_2d, test.estimate_and_fit):
        with pytest.raises(ValueError, match="frame stack"):
            call(np.zeros((64, 64, 3), np.uint8))
        with pytest.raises(ValueError, match="frame stack"):
            call(np.zeros((2, 64, 64, 2), np.uint8))
    with pytest.raises(ValueError, match="fit_smpl takes"):
        test.fit_smpl(np.zeros((2, 10, 2)), np.zeros((2, 10)))
    with pytest.raises(ValueError, match="fit_smpl takes"):
        test.fit_smpl(np.zeros((2, 14, 2)), np.zeros((3, 14)))
    with pytest.raises(ValueError, match="fit_smpl takes"):
        test.fit_smpl(np.zeros((2, 14, 3)), np.zeros((2, 14)))


class _ChumpyLike:
    """Stand-in for chumpy.Ch: real SMPL pickles wrap arrays whose dense
    payload is ``.r``."""

    def __init__(self, value):
        self.r = np.asarray(value)


def test_from_files_loads_what_jax_loads(estimators, tmp_path):
    """The real-asset formats — the JAX package's CPM npz, an SMPL pickle
    in the real schema (chumpy-style wrappers, scipy-sparse J_regressor,
    uint32 kintree with the 4294967295 root sentinel, byte keys) and a
    SMPLify gmm_08.pkl — load into the same arrays in both packages
    (exact: both cast the same float64 values to float32)."""
    jest, _ = estimators["float32"]
    npz = str(tmp_path / "cpm.npz")
    jax_conv.save_params_npz(npz, jest.cpm_params)
    m = {k: np.asarray(v) for k, v in jest.smpl_model._asdict().items()}
    kintree = np.stack([m["parents"].astype(np.uint32),
                        np.arange(24, dtype=np.uint32)])
    kintree[0, 0] = np.uint32(4294967295)
    smpl_pkl = str(tmp_path / "smpl.pkl")
    with open(smpl_pkl, "wb") as f:
        pickle.dump({b"v_template": _ChumpyLike(m["v_template"]),
                     b"shapedirs": _ChumpyLike(np.concatenate(
                         [m["shapedirs"], np.ones((6890, 3, 2))], -1)),
                     b"posedirs": _ChumpyLike(m["posedirs"].reshape(-1, 207)),
                     b"J_regressor": scipy.sparse.csc_matrix(
                         m["J_regressor"].astype(np.float64)),
                     b"weights": _ChumpyLike(m["weights"]),
                     b"kintree_table": kintree,
                     b"f": m["faces"].astype(np.uint32)}, f, protocol=2)
    rng = np.random.RandomState(7)
    a = 0.1 * rng.randn(8, 69, 69)
    gmm_pkl = str(tmp_path / "gmm_08.pkl")
    with open(gmm_pkl, "wb") as f:
        pickle.dump({"means": 0.2 * rng.randn(8, 69),
                     "covars": 0.3 * np.eye(69) + a @ a.transpose(0, 2, 1),
                     "weights": rng.dirichlet(np.full(8, 2.0))}, f,
                    protocol=2)
    cpm_cfg, fit_cfg = _cfgs(jc, "float32")
    want = JaxEstimator.from_files(npz, smpl_pkl, gmm_pkl, cpm_cfg, fit_cfg)
    got = PoseEstimator.from_files(npz, smpl_pkl, gmm_pkl,
                                   *_cfgs(tc, "float32"), device="cpu")
    for k, v in want.smpl_model._asdict().items():
        got_v = getattr(got.smpl_model, k)
        np.testing.assert_array_equal(
            got_v if k == "parents" else got_v.numpy(), np.asarray(v),
            err_msg=k)
    for k in ("means", "precisions", "log_consts"):
        np.testing.assert_array_equal(getattr(got.prior, k).numpy(),
                                      np.asarray(getattr(want.prior, k)))
    back = cpm_lib.cpm_params_to_numpy(got.cpm)
    for layer, wb in want.cpm_params.items():
        for kind, v in wb.items():
            np.testing.assert_array_equal(back[layer][kind], np.asarray(v))


def test_unported_knobs_raise(estimators):
    """The knobs that raised before they were ported construct and reach
    the estimator: init_head (a dict of arrays, held as float32 tensors
    on the estimator's device) and the front-end knobs (as keywords or
    via front_end=); mixing both ways is an error."""
    _, test = estimators["float32"]
    args = (test.cpm, test.smpl_model, test.prior, test.cpm_cfg,
            test.fit_cfg)
    head = {"w0": np.ones((42, 4)), "b0": np.zeros(4),
            "w1": np.zeros((4, 82), np.float32), "b1": np.zeros(82)}
    est = PoseEstimator(*args, device="cpu", init_head=head)
    assert sorted(est.init_head) == sorted(head)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in est.init_head.values())
    assert PoseEstimator(*args, device="cpu").init_head is None
    for kw in (dict(refine_center=True), dict(letterbox=True),
               dict(flip_tta=True), dict(scale_tta=(0.8,)),
               dict(front_end=tc.FrontEndConfig(refine_scale=True))):
        est = PoseEstimator(*args, device="cpu", **kw)
        fe = kw.get("front_end") or tc.FrontEndConfig(**kw)
        assert est.front_end == fe
        assert (est.refine_center, est.refine_scale, est.letterbox,
                est.flip_tta, est.scale_tta) == (
            fe.refine_center, fe.refine_scale, fe.letterbox, fe.flip_tta,
            fe.scale_tta)
    with pytest.raises(ValueError, match="not both"):
        PoseEstimator(*args, device="cpu", fit_restarts=2,
                      front_end=tc.FrontEndConfig())
    r = test.estimate_2d(_images(64, 64, 0), flip_tta=True)
    assert r.joints2d.shape == (2, 14, 2)
    est = PoseEstimator(*args, device="cpu",
                        front_end=tc.FrontEndConfig(fit_restarts=2))
    assert est.fit_restarts == 2
    assert dataclasses.asdict(est.front_end)["fit_restarts"] == 2


def test_module_level_api_and_lazy_exports(estimators, monkeypatch):
    """api.estimate_2d / fit_smpl / estimate_and_fit run on the default
    estimator (here a small CPU one) or a given one, and the package
    exports the JAX package's names lazily, the serving classes
    included."""
    import tpu_pose_torch
    from tpu_pose_torch import api
    _, test = estimators["float32"]
    monkeypatch.setattr(api, "_default_estimator", test)
    imgs = _images(64, 64, seed=4)
    r2d = api.estimate_2d(imgs)
    assert isinstance(r2d, api.Estimate2DResult)
    torch.testing.assert_close(r2d.joints2d, test.estimate_2d(imgs).joints2d)
    fit = api.fit_smpl(r2d.joints2d[0].numpy(), r2d.conf[0].numpy())
    assert fit.theta.shape == (72,)
    res = api.estimate_and_fit(imgs, estimator=test)
    assert isinstance(res, api.EstimateAndFitResult)
    assert res.vertices.shape == (2, 6890, 3)
    for name in ("PoseEstimator", "estimate_2d", "fit_smpl",
                 "estimate_and_fit", "MultiPersonVideoSession",
                 "VideoSession"):
        assert getattr(tpu_pose_torch, name) is getattr(api, name)
    from tpu_pose_torch import serving, serving_http
    assert tpu_pose_torch.BatchingServer is serving.BatchingServer
    assert tpu_pose_torch.PoseHTTPServer is serving_http.PoseHTTPServer
    with pytest.raises(AttributeError):
        tpu_pose_torch.no_such_name
