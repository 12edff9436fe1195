"""The port's parity harness and TF converter against the JAX package's,
where TensorFlow imports (the TensorFlow tests of the port are in this
file, so the import is paid once per worker; the certification against
JAX's shares the port's certification with test_torch_parity.py's and
sits there): the port's float64 torch oracle against the JAX package's
TF oracle (SMPL, energy and gradient, a staged fit), stage parity against
JAX's on the same inputs, the TF1-checkpoint converter, the day-one chain
and the three CLIs at small size on the CPU."""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from test_day_one import _fabricate_reference  # noqa: E402
from test_tf_converter import _write_tf1_ckpt  # noqa: E402
from tpu_pose.fitting import priors as jax_priors  # noqa: E402
from tpu_pose.models import cpm as jax_cpm  # noqa: E402
from tpu_pose.models import smpl_data as jax_smpl_data  # noqa: E402
from tpu_pose.parity import harness as jax_harness  # noqa: E402
from tpu_pose.parity import oracle as jax_oracle  # noqa: E402
from tpu_pose.utils import config as jc  # noqa: E402
from tpu_pose_torch.fitting import priors  # noqa: E402
from tpu_pose_torch.models import cpm as cpm_lib  # noqa: E402
from tpu_pose_torch.models import smpl_data  # noqa: E402
from tpu_pose_torch.parity import day_one, harness, oracle, sweep  # noqa
from tpu_pose_torch.tools import (convert_weights, parity_sweep,  # noqa
                                  reference_day_one)
from tpu_pose_torch.utils import config as tc  # noqa: E402
from tpu_pose_torch.utils import tf_converter  # noqa: E402
from torch_threads import one_thread

one_thread()

VERTS = 400
F64 = torch.float64
# tests/test_tf_converter.py's small CPM, in each package's config.
SMALL = dict(input_size=64, features=8, stage1_head_width=16,
             refine_width=8, num_stages=2)
# Float64 agreement of the two oracles, relative to the largest value.
ORACLE_RTOL = 1e-9


@pytest.fixture(scope="module")
def model():
    return smpl_data.synthetic_smpl(seed=0, num_verts=VERTS, device="cpu")


@pytest.fixture(scope="module")
def prior():
    return priors.synthetic_gmm_prior(0, device="cpu")


@pytest.fixture(scope="module")
def jax_model():
    return jax_smpl_data.synthetic_smpl(seed=0, num_verts=VERTS)


@pytest.fixture(scope="module")
def jax_prior():
    return jax_priors.synthetic_gmm_prior(0)


def _gmm(prior):
    return {k: np.asarray(getattr(prior, k))
            for k in ("means", "precisions", "log_consts")}


def _pipes(jax_model, jax_prior, **cfg):
    """(TF oracle, torch oracle) over the same numpy arrays."""
    arrays = {k: np.asarray(v) for k, v in jax_model._asdict().items()}
    return (jax_oracle.OraclePipeline(arrays, gmm=_gmm(jax_prior),
                                      cfg=jax_oracle.OracleConfig(**cfg)),
            oracle.OraclePipeline(arrays, gmm=_gmm(jax_prior),
                                  cfg=oracle.OracleConfig(**cfg)))


@pytest.fixture(scope="module")
def pipes(jax_model, jax_prior):
    """Both oracles per camera model, built once: the TF graph traces at
    its first call, seconds each."""
    return {cam: _pipes(jax_model, jax_prior, camera_model=cam)
            for cam in ("weak_perspective", "perspective")}


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_packages_build_the_same_small_model(model, prior, jax_model,
                                             jax_prior):
    """The 400-vertex synthetic SMPL and the GMM-8 are bit-identical
    across the packages, so the two harnesses see the same inputs."""
    arrays = model.to_numpy()
    for k, v in jax_model._asdict().items():
        np.testing.assert_array_equal(arrays[k], np.asarray(v), err_msg=k)
    for k, v in _gmm(jax_prior).items():
        np.testing.assert_array_equal(getattr(prior, k).numpy(), v)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_smpl_matches_tf_oracle(pipes, seed):
    """Vertices and joints of the two oracles' float64 SMPL graphs
    within ORACLE_RTOL of the largest coordinate."""
    tf_pipe, pipe = pipes["weak_perspective"]
    rng = np.random.RandomState(seed)
    theta, beta = 0.3 * (1 + seed) * rng.randn(72), 0.5 * rng.randn(10)
    v_tf, j_tf = tf_pipe._smpl_tf(tf.constant(beta, tf.float64),
                                  tf.constant(theta, tf.float64))
    with torch.no_grad():
        v, j = pipe._smpl_torch(torch.tensor(beta), torch.tensor(theta))
    assert _rel(v.numpy(), v_tf.numpy()) <= ORACLE_RTOL
    assert _rel(j.numpy(), j_tf.numpy()) <= ORACLE_RTOL


@pytest.mark.parametrize("camera", ["weak_perspective", "perspective"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_energy_and_gradient_match_tf_oracle(pipes, seed, camera):
    """The pixel-unit energy within ORACLE_RTOL relative, its gradient
    (torch.autograd against tf.GradientTape) within ORACLE_RTOL of the
    gradient's largest component, at stage weights of the fit's last
    stage."""
    tf_pipe, pipe = pipes[camera]
    rng = np.random.RandomState(seed)
    cam = (np.array([1.3, 0.05, -0.1]) if camera == "weak_perspective"
           else np.array([0.05, -0.1, 6.0])) + 0.01 * rng.randn(3)
    args = (0.3 * rng.randn(72), 0.5 * rng.randn(10), cam,
            rng.rand(14, 2) * 368, rng.rand(14) * 0.5 + 0.5,
            np.array([4.0, 5.0, 15.0]))
    e_tf, *g_tf = tf_pipe._vg(*(tf.constant(a, tf.float64) for a in args))
    e, *g = pipe._energy_and_grad(*(torch.tensor(a, dtype=F64)
                                    for a in args))
    assert abs(float(e) - float(e_tf)) <= ORACLE_RTOL * abs(float(e_tf))
    assert _rel(torch.cat(g).numpy(),
                np.concatenate([x.numpy() for x in g_tf])) <= ORACLE_RTOL


def test_oracle_staged_fit_matches_tf_oracle(model, jax_model, jax_prior):
    """One frame, the oracle's two-stage schedule cut to 20 + 40 L-BFGS-B
    iterations, from the oracle's own init: the two oracles' fitted
    joints3d within 1e-3 mm. Longer runs amplify the float64 rounding
    of the two graphs: at the default 60 + 200 the two fits end 7 mm
    apart at energies 1e-3 apart, neither converged."""
    arrays = {k: np.asarray(v) for k, v in jax_model._asdict().items()}
    pipes = [lib.OraclePipeline(arrays, gmm=_gmm(jax_prior),
                                cfg=lib.OracleConfig(stages=tuple(
                                    dataclasses.replace(s, maxiter=n)
                                    for s, n in zip(lib.OracleConfig().stages,
                                                    (20, 40)))))
             for lib in (jax_oracle, oracle)]
    tf_pipe, pipe = pipes
    j2d, conf, _ = harness.make_clean_observations(model, 1, 368, seed=3)
    want = tf_pipe.fit(j2d[0], conf[0])
    got = pipe.fit(j2d[0], conf[0])
    assert 1000.0 * np.abs(got["joints3d"] - want["joints3d"]).max() <= 1e-3
    assert got["energy"] == pytest.approx(want["energy"], rel=1e-6)


@pytest.mark.parametrize("camera", ["weak_perspective", "perspective"])
def test_stage_parity_matches_jax(model, prior, jax_model, jax_prior,
                                  pipes, camera):
    """The port's stage-parity report against JAX's on the same inputs:
    the same keys, both within tests/test_parity.py's bounds, decode
    identical, each delta within its bound of JAX's."""
    bounds = {"smpl_verts_max_m": 1e-5, "smpl_joints_max_m": 1e-5,
              "decode_max_px": 0.0, "decode_conf_max": 1e-6,
              "projection_max_px": 1e-2, "energy_rel_err": 1e-5}
    kw = {} if camera == "weak_perspective" else dict(focal=5000.0)
    tf_pipe, pipe = pipes[camera]
    want = jax_harness.stage_parity(
        jax_model, tf_pipe, jc.FitConfig(camera_model=camera, **kw),
        prior=jax_prior, seed=1)
    got = harness.stage_parity(
        model, pipe, tc.FitConfig(camera_model=camera, **kw), prior=prior,
        seed=1, device="cpu")
    assert set(got) == set(want) == set(bounds)
    for k, bound in bounds.items():
        assert got[k] <= bound and want[k] <= bound, (k, got[k], want[k])
        assert abs(got[k] - want[k]) <= bound, k


# -- the TF1-checkpoint converter --------------------------------------------

def _small_defs():
    defs = cpm_lib._layer_defs(tc.CPMConfig(**SMALL))
    assert defs == jax_cpm._layer_defs(jc.CPMConfig(**SMALL))
    return defs


@pytest.mark.parametrize("style", ["slim", "layers", "plain"])
def test_convert_real_tf1_checkpoint(tmp_path, style):
    """A checkpoint written with tf.compat.v1 in each naming style
    converts back bit for bit, float32 HWIO."""
    defs = _small_defs()
    ckpt = str(tmp_path / f"model_{style}.ckpt")
    expected = _write_tf1_ckpt(ckpt, defs, style)
    params = tf_converter.convert_tf_checkpoint(ckpt, [d[0] for d in defs])
    assert set(params) == set(expected)
    for name in expected:
        for kind in ("w", "b"):
            assert params[name][kind].dtype == np.float32
            np.testing.assert_array_equal(params[name][kind],
                                          expected[name][kind])


def test_convert_missing_layer_raises(tmp_path):
    defs = _small_defs()
    ckpt = str(tmp_path / "model.ckpt")
    _write_tf1_ckpt(ckpt, defs[:-1], "slim")
    with pytest.raises(KeyError):
        tf_converter.convert_tf_checkpoint(ckpt, [d[0] for d in defs])


def test_converted_params_forward_matches_jax(tmp_path):
    """Converted weights drive the port's CPM directly, and its float32
    beliefs match the JAX forward on the same weights within 1e-4·max|b|
    (tests/test_torch_cpm.py's bound)."""
    import jax.numpy as jnp
    from tpu_pose.ops import preprocess as jax_pre
    defs = _small_defs()
    ckpt = str(tmp_path / "model.ckpt")
    _write_tf1_ckpt(ckpt, defs, "slim")
    params = tf_converter.convert_tf_checkpoint(ckpt, [d[0] for d in defs])
    tcfg = tc.CPMConfig(**SMALL, compute_dtype="float32")
    jcfg = jc.CPMConfig(**SMALL, compute_dtype="float32")
    cpm = cpm_lib.cpm_params_from_numpy(params, tcfg, "cpu")
    x = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32) - 0.5
    cm = np.broadcast_to(
        np.asarray(jax_pre.gaussian_center_map(64, tcfg.center_sigma)),
        (1, 64, 64, 1)).copy()
    want = jax_cpm.cpm_forward(
        {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
         for k, v in params.items()}, jnp.asarray(x), jnp.asarray(cm), jcfg)
    with torch.no_grad():
        got = cpm_lib.cpm_forward(cpm, torch.from_numpy(x),
                                  torch.from_numpy(cm), tcfg)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (1, 8, 8, 15)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


# -- the day-one chain --------------------------------------------------------

def test_day_one_chain_runs_unattended(tmp_path, model):
    """tests/test_day_one.py's chain on the port: a fabricated reference
    (TF1 checkpoint, real-schema SMPL pickle, SMPLify GMM pickle) →
    convert → load → certify → smoke eval, unattended, one JSON verdict."""
    ref = str(tmp_path / "reference")
    out = str(tmp_path / "out")
    _fabricate_reference(ref, model)

    assets = day_one.discover_assets(ref)
    assert assets["ckpt"].endswith("model.ckpt")
    assert assets["smpl_pkl"].endswith("basicModel_neutral.pkl")
    assert assets["gmm_pkl"].endswith("gmm_08.pkl")

    small = tc.CPMConfig(**SMALL)
    verdict = day_one.run_day_one(
        ref, out_dir=out, cpm_cfg=small, frames=2, eval_frames=2,
        eval_batch=2, log=lambda *a: None, device="cpu")

    assert verdict["missing"] == []
    assert verdict["converted_layers"] == len(cpm_lib._layer_defs(small))
    cert = verdict["certification"]
    assert cert["stage_parity"]["energy_rel_err"] < 1e-5
    assert cert["certified"], cert["fit_gap"]
    assert np.isfinite(verdict["smoke_eval"]["pa_mpjpe"])
    assert verdict["ok"] is True
    assert {"discover", "convert", "load", "certify",
            "smoke_eval"} <= set(verdict["seconds"])
    with open(os.path.join(out, "day_one_verdict.json")) as f:
        on_disk = json.load(f)
    assert on_disk["ok"] is True
    assert on_disk["converted_layers"] == verdict["converted_layers"]


def test_day_one_reports_missing_assets(tmp_path):
    """An empty (or partial) mount yields an INCOMPLETE verdict naming
    exactly what is missing — never a crash."""
    ref = str(tmp_path / "empty_ref")
    os.makedirs(ref)
    verdict = day_one.run_day_one(ref, out_dir=str(tmp_path / "o"),
                                  cpm_cfg=tc.CPMConfig(**SMALL),
                                  log=lambda *a: None, device="cpu")
    assert verdict["ok"] is False
    assert set(verdict["missing"]) == {"smpl_pkl", "cpm_checkpoint"}


# -- the three CLIs, at small size on the CPU ---------------------------------

def test_convert_weights_cli(tmp_path, monkeypatch, capsys):
    """convert_weights --num_stages 2 on a small checkpoint (the CLI's
    CPMConfig patched to the small widths): the npz equals the
    checkpoint and loads as the CPM on --device."""
    monkeypatch.setattr(tc, "CPMConfig", functools.partial(
        tc.CPMConfig, **{k: v for k, v in SMALL.items()
                         if k != "num_stages"}))
    ckpt = str(tmp_path / "model.ckpt")
    expected = _write_tf1_ckpt(ckpt, _small_defs(), "layers")
    out = str(tmp_path / "cpm_weights.npz")
    rec = convert_weights.main(["--ckpt", ckpt, "--out", out,
                                "--num_stages", "2", "--device", "cpu"])
    assert rec["layers"] == len(expected)
    assert f"converted {len(expected)} layers" in capsys.readouterr().out
    got = tf_converter.load_params_npz(out)
    for name in expected:
        np.testing.assert_array_equal(got[name]["w"], expected[name]["w"])
        np.testing.assert_array_equal(got[name]["b"], expected[name]["b"])


def test_parity_sweep_cli_sweep(tmp_path, monkeypatch):
    """parity_sweep --sweep on the 400-vertex model, one probe frame, the
    oracle's gmof_sigma at 40, two axes (tests/test_parity.py's): the
    JSON report is written and the best gap is no worse than the
    first."""
    axes = sweep.default_axes()
    monkeypatch.setattr(sweep, "default_axes", lambda: {
        k: axes[k] for k in ("gmof_sigma", "w_pose_scale")})
    out = str(tmp_path / "parity.json")
    report = parity_sweep.main(
        ["--sweep", "--frames", "1", "--passes", "1", "--verts", "400",
         "--oracle_sigma", "40", "--out", out, "--device", "cpu"])
    s = report["sweep"]
    assert "certification" not in report and s["evals"] >= 3
    assert s["best_gap_mm"] <= s["trajectory_mm"][0] + 1e-9
    with open(out) as f:
        assert json.load(f)["sweep"]["evals"] == s["evals"]


def test_parity_sweep_cli_certify_routing(tmp_path, monkeypatch, capsys):
    """Without --sweep the CLI certifies: the flags reach
    harness.certify (recorded here, the certification itself is
    test_torch_parity.py's) and its report is printed and written."""
    calls = []

    def certify(model, prior=None, **kw):
        calls.append(dict(kw, verts=model.v_template.shape[0],
                          prior=type(prior).__name__))
        return {"stage_parity": {"energy_rel_err": 0.0}, "certified": True,
                "fit_gap": {"mpjpe_gap_mm_mean": 0.25,
                            "mpjpe_gap_mm_max": 0.5}}

    monkeypatch.setattr(harness, "certify", certify)
    out = str(tmp_path / "parity.json")
    parity_sweep.main(["--frames", "3", "--seed", "5", "--verts", "400",
                       "--target_mm", "0.5", "--out", out, "--device",
                       "cpu"])
    assert calls == [dict(n_frames=3, seed=5, target_mm=0.5, device="cpu",
                          verts=400, prior="GMMPrior")]
    assert "0.250 mm mean / 0.500 mm max" in capsys.readouterr().out
    with open(out) as f:
        assert json.load(f)["certification"]["certified"] is True


def test_reference_day_one_cli_missing_assets(tmp_path):
    """reference_day_one on an empty directory exits 1 with the verdict
    naming what is missing (a complete directory runs through the same
    main in tests/test_torch_chip_smoke.py's day-one phase)."""
    ref = str(tmp_path / "empty")
    os.makedirs(ref)
    with pytest.raises(SystemExit) as exc:
        reference_day_one.main(["--reference", ref, "--out",
                                str(tmp_path / "o"), "--device", "cpu"])
    assert exc.value.code == 1
    with open(tmp_path / "o" / "day_one_verdict.json") as f:
        verdict = json.load(f)
    assert set(verdict["missing"]) == {"smpl_pkl", "cpm_checkpoint"}


def test_cli_defaults_match_jax():
    """The three CLIs keep the JAX CLIs' flag names and defaults (apart
    from the temporary-directory outputs and the required --reference),
    and add --device."""
    conv = convert_weights.parse_args(["--ckpt", "m.ckpt"])
    assert (conv.out, conv.num_stages, conv.device) == (
        "cpm_weights.npz", 6, "cuda")
    ps = parity_sweep.parse_args([])
    assert (ps.certify, ps.sweep, ps.frames, ps.seed, ps.verts, ps.smpl_pkl,
            ps.gmm_pkl, ps.passes, ps.target_mm, ps.oracle_sigma,
            ps.device) == (False, False, 4, 0, 0, "", "", 2, 1.0, "",
                           "cuda")
    assert ps.out.endswith("parity_report.json")
    d1 = reference_day_one.parse_args(["--reference", "r"])
    assert (d1.frames, d1.sweep, d1.sweep_passes, d1.eval_frames,
            d1.target_mm, d1.device) == (4, False, 1, 8, 1.0, "cuda")


def test_chip_smoke_tf_converter_check(monkeypatch, capsys):
    """chip_smoke.py's tf_converter_check on the CPU with the small CPM:
    each naming style's checkpoint converts bit for bit, and estimate_2d
    on the converted weights equals the source weights' (0 px)."""
    import chip_smoke
    cfg = tc.CPMConfig(input_size=64, features=16, stage1_head_width=32,
                       refine_width=16, num_stages=3)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "MAIN_CPM", cfg)
    out = chip_smoke.phase_tf_converter_check()
    assert set(out["styles"]) == {"slim", "layers", "plain"}
    assert all(r["bit_equal"] and r["max_px"] == 0.0
               for r in out["styles"].values())
    assert '"phase": "tf_converter_check"' in capsys.readouterr().out
