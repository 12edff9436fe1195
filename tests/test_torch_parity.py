"""The port's parity harness (tpu_pose_torch/parity/) without
TensorFlow: the counterparts of tests/test_parity.py's cases, with the
same thresholds, on the port's float64 torch oracle and the port's fit
on the CPU; the oracle's SMPL against the independent numpy oracle; and
asset discovery of a converted npz. The port's certification runs once
per module: test_certify_under_1mm reads it, and so does the comparison
with JAX's certification, which needs TensorFlow (the JAX package's
oracle) and skips without it."""

import json
import os

import numpy as np
import pytest
import torch

from tests import oracle_numpy
from tpu_pose_torch.fitting import priors as priors_lib
from tpu_pose_torch.models import cpm as cpm_lib
from tpu_pose_torch.models import smpl_data
from tpu_pose_torch.parity import day_one, harness, oracle, sweep
from tpu_pose_torch.utils import tf_converter
from tpu_pose_torch.utils.config import CPMConfig, FitConfig
from torch_threads import one_thread

one_thread()

VERTS = 400  # tests/test_parity.py's small synthetic model


@pytest.fixture(scope="module")
def model():
    return smpl_data.synthetic_smpl(seed=0, num_verts=VERTS, device="cpu")


@pytest.fixture(scope="module")
def prior():
    return priors_lib.synthetic_gmm_prior(0, device="cpu")


@pytest.fixture(scope="module")
def pipe(model, prior):
    return oracle.OraclePipeline(model.to_numpy(),
                                 gmm=harness.oracle_gmm(prior))


def test_stage_parity_numerical(model, prior, pipe):
    """Every closed-form stage agrees between the port and the float64
    oracle: SMPL forward, hard-argmax decode, projection, and — load-
    bearing — the ENERGY VALUE at identical parameters."""
    rep = harness.stage_parity(model, pipe, FitConfig(), prior=prior,
                               device="cpu")
    assert rep["smpl_verts_max_m"] < 1e-5
    assert rep["smpl_joints_max_m"] < 1e-5
    assert rep["decode_max_px"] == 0.0
    assert rep["decode_conf_max"] < 1e-6
    assert rep["projection_max_px"] < 1e-3
    assert rep["energy_rel_err"] < 1e-5


def test_stage_parity_perspective(model, prior):
    """Projection + energy parity with the PERSPECTIVE camera: the
    normalized-frame fit energy stays exactly proportional to the
    oracle's pixel-frame energy under the pixel-focal contract."""
    pipe = oracle.OraclePipeline(
        model.to_numpy(), gmm=harness.oracle_gmm(prior),
        cfg=oracle.OracleConfig(camera_model="perspective", focal=5000.0))
    cfg = FitConfig(camera_model="perspective", focal=5000.0)
    rep = harness.stage_parity(model, pipe, cfg, prior=prior, seed=1,
                               device="cpu")
    assert rep["projection_max_px"] < 1e-2, rep
    assert rep["energy_rel_err"] < 1e-5, rep


def test_oracle_decode_matches_hard_argmax():
    rng = np.random.RandomState(0)
    hm = rng.rand(2, 8, 8, 15).astype(np.float32)
    j, c = oracle.decode_hard_argmax(hm, stride=8)
    assert j.shape == (2, 14, 2) and c.shape == (2, 14)
    flat = hm[0, :, :, 3].ravel()
    idx = flat.argmax()
    assert j[0, 3, 0] == (idx % 8) * 8 and j[0, 3, 1] == (idx // 8) * 8


def test_oracle_fit_reduces_energy(model, pipe):
    """The oracle's staged scipy fit actually optimizes: final energy far
    below the init energy on a clean observation."""
    j2d, conf, _ = harness.make_clean_observations(model, 1, 368, seed=3)
    theta0, beta0, cam0 = pipe._init_params(j2d[0],
                                            np.asarray(conf[0], np.float64))
    f64 = torch.float64
    e0 = float(pipe._energy_torch(
        *(torch.tensor(np.asarray(a, np.float64), dtype=f64)
          for a in (theta0, beta0, cam0, j2d[0], conf[0])),
        torch.tensor([4.0, 5.0, 15.0], dtype=f64)))
    out = pipe.fit(j2d[0], conf[0])
    assert out["energy"] < 0.5 * e0, (out["energy"], e0)
    assert np.isfinite(out["joints3d"]).all()


def _recorded_certify(harness_mod, *args, **kw):
    """``certify``'s report and the fit it certified: the last
    ``run_our_fit`` of its restart chain."""
    fits = []
    real = harness_mod.run_our_fit

    def record(*a, **k):
        fits.append(real(*a, **k))
        return fits[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness_mod, "run_our_fit", record)
        report = harness_mod.certify(*args, **kw)
    return report, fits[-1]


@pytest.fixture(scope="module")
def port_certified(model, prior):
    """The port's certification on the 400-vertex model, 2 probe frames,
    seed 0, on the CPU, with the fit it certified: run once for the two
    tests that read it."""
    return _recorded_certify(harness, model, prior=prior, n_frames=2,
                             seed=0, device="cpu")


def test_certify_under_1mm(port_certified):
    """The north-star certification: the polish chain — the oracle's
    optimizer started at the port's solution — moves it less than 1 mm
    MPJPE on clean synthetic observations."""
    out, _ = port_certified
    assert out["stage_parity"]["energy_rel_err"] < 1e-5
    assert out["certified"], out["fit_gap"]
    assert out["fit_gap"]["mpjpe_gap_mm_mean"] <= 1.0
    assert out["gt_mpjpe_mm_oracle"] < 500.0
    assert set(out["seconds"]) == {"stage_parity", "our_fit",
                                   "oracle_polish", "oracle_fit"}


def test_certify_matches_jax(port_certified):
    """The port's certify against JAX's on the same 400-vertex model,
    prior and probe frames: both certified within 1 mm, and the two
    packages' certified fits' joints3d ≤ 1 mm apart (the L-BFGS bound of
    ROADMAP §C)."""
    pytest.importorskip("tensorflow")
    from tpu_pose.fitting import priors as jax_priors
    from tpu_pose.models import smpl_data as jax_smpl_data
    from tpu_pose.parity import harness as jax_harness
    want, want_fit = _recorded_certify(
        jax_harness, jax_smpl_data.synthetic_smpl(seed=0, num_verts=VERTS),
        prior=jax_priors.synthetic_gmm_prior(0), n_frames=2, seed=0)
    got, got_fit = port_certified
    assert want["certified"] and got["certified"], (want, got)
    assert got["fit_gap"]["mpjpe_gap_mm_mean"] <= 1.0
    assert set(want) <= set(got)
    mm = harness.root_aligned_mpjpe_mm(got_fit["joints3d"],
                                       np.asarray(want_fit["joints3d"]))
    assert mm.max() <= 1.0, mm


def test_sweep_recovers_mismatched_sigma(model, prior):
    """With the oracle's gmof_sigma deliberately different from the
    port's default, the sweep reduces the output gap by moving the
    config toward the oracle's."""
    pipe40 = oracle.OraclePipeline(model.to_numpy(),
                                   gmm=harness.oracle_gmm(prior),
                                   cfg=oracle.OracleConfig(gmof_sigma=40.0))
    j2d, conf, _ = harness.make_clean_observations(model, 2, 368, seed=1)
    ref_out = pipe40.fit_batch(j2d, conf)
    axes = dict(sweep.default_axes())
    axes = {"gmof_sigma": axes["gmof_sigma"],
            "w_pose_scale": axes["w_pose_scale"]}
    report = sweep.auto_sweep(model, ref_out, j2d, conf, prior=prior,
                              axes=axes, passes=1, device="cpu")
    assert report["evals"] >= 3
    assert report["best_gap_mm"] <= report["trajectory_mm"][0] + 1e-9
    assert report["best_gap_mm"] < np.inf
    json.dumps(report)


def test_scale_stages_helper():
    cfg = FitConfig()
    scaled = sweep._scale_stages(cfg.stages, iters=2.0, w_pose=0.5)
    assert scaled[0].iters == 2 * cfg.stages[0].iters
    assert scaled[1].w_pose_prior == 0.5 * cfg.stages[1].w_pose_prior
    assert scaled[1].lr == cfg.stages[1].lr


@pytest.mark.parametrize("seed,pose_scale", [(0, 0.0), (1, 0.3), (2, 1.2)])
def test_oracle_smpl_matches_numpy_oracle(model, pipe, seed, pose_scale):
    """The oracle's float64 SMPL against tests/oracle_numpy.smpl_np (the
    loop-based equations, written without either package), atol 1e-9."""
    rng = np.random.RandomState(seed)
    beta = rng.randn(10) * 0.5
    theta = rng.randn(72) * pose_scale
    arrays = model.to_numpy()
    v_np, j_np = oracle_numpy.smpl_np(
        arrays["v_template"], arrays["shapedirs"], arrays["posedirs"],
        arrays["J_regressor"], arrays["weights"], arrays["parents"], beta,
        theta)
    with torch.no_grad():
        v, j = pipe._smpl_torch(torch.tensor(beta), torch.tensor(theta))
    np.testing.assert_allclose(v.numpy(), v_np, rtol=0, atol=1e-9)
    np.testing.assert_allclose(j.numpy(), j_np, rtol=0, atol=1e-9)


def test_oracle_takes_tensors_on_any_device_as_host_float64(model, prior):
    """Model and prior given as float32 tensors land in the oracle as
    float64 CPU tensors equal to their numpy values."""
    pipe = oracle.OraclePipeline(
        {k: getattr(model, k) for k in ("v_template", "shapedirs",
                                        "posedirs", "J_regressor",
                                        "weights", "parents")},
        gmm=harness.oracle_gmm(prior))
    for name in ("_v_template", "_J_regressor", "_weights"):
        t = getattr(pipe, name)
        assert t.dtype == torch.float64 and t.device.type == "cpu"
    np.testing.assert_array_equal(pipe._gmm["precisions"].numpy(),
                                  prior.precisions.numpy())


def test_port_fit_defaults_to_cuda(model, monkeypatch):
    """Without CUDA and without device=, the harness's fits raise rather
    than run on the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    j2d, conf, _ = harness.make_clean_observations(model, 1, 368, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        harness.run_our_fit(model, j2d, conf, FitConfig())


def test_discover_assets_finds_a_converted_npz(tmp_path):
    """A save_params_npz file (``layer.kind`` keys) is discovered as the
    CPM weights; the JAX package's check looks for ``layer/w`` keys and
    misses it (ROADMAP §C)."""
    from tpu_pose.parity import day_one as jax_day_one
    cfg = CPMConfig(input_size=64, features=8, stage1_head_width=16,
                    refine_width=8, num_stages=2)
    path = str(tmp_path / "w" / "cpm_weights.npz")
    os.makedirs(os.path.dirname(path))
    tf_converter.save_params_npz(path, cpm_lib.cpm_params_to_numpy(
        cpm_lib.init_cpm_params(0, cfg, device="cpu")))
    np.savez(str(tmp_path / "other.npz"), a=np.zeros(3))
    assets = day_one.discover_assets(str(tmp_path))
    assert assets["cpm_npz"] == path and assets["files_seen"] == 2
    assert day_one._is_params_npz(path)
    assert not day_one._is_params_npz(str(tmp_path / "other.npz"))
    assert not jax_day_one._is_params_npz(path)
