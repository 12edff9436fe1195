"""Port SMPL model, data and priors vs the JAX package and the naive numpy
oracle (tests/oracle_numpy.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle_numpy import smpl_np
from tpu_pose.fitting import priors as jax_priors
from tpu_pose.models import smpl as jax_smpl, smpl_data as jax_data
from tpu_pose_torch.fitting import priors as torch_priors
from tpu_pose_torch.models import smpl as torch_smpl
from tpu_pose_torch.models import smpl_data as torch_data
from torch_threads import one_thread

one_thread()

# Vertices/joints in metres: float32 sums over 6890 vertices and a 24-deep
# chain of 4×4 products taken in another order, well under 1e-5 m.
M_TOL = dict(rtol=0, atol=1e-5)
# Priors: a 69×69 quadratic form in float32 (rtol 1e-5 of values ~1e2).
PRIOR_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    return (jax_data.synthetic_smpl(seed=0),
            torch_data.synthetic_smpl(seed=0, device="cpu"))


def test_synthetic_smpl_bit_equal(models):
    jm, tm = models
    for f in dataclasses.fields(jm):
        a = np.asarray(getattr(jm, f.name))
        b = tm.to_numpy()[f.name]
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_synthetic_gmm_prior_bit_equal():
    jp = jax_priors.synthetic_gmm_prior(3)
    tp = torch_priors.synthetic_gmm_prior(3, device="cpu")
    for name in ("means", "precisions", "log_consts"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                      getattr(tp, name).numpy())


def _poses(n=3):
    rng = np.random.RandomState(7)
    return {"zero": np.zeros((n, 72), np.float32),
            "random": (0.3 * rng.randn(n, 72)).astype(np.float32),
            "extreme": (2.5 * rng.randn(n, 72)).astype(np.float32)}


@pytest.mark.parametrize("kind", ["zero", "random", "extreme"])
def test_rodrigues_matches_jax(kind):
    r = _poses()[kind].reshape(-1, 3)
    np.testing.assert_allclose(
        torch_smpl.rodrigues(torch.from_numpy(r)).numpy(),
        np.asarray(jax_smpl.rodrigues(jnp.asarray(r))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["zero", "random", "extreme"])
def test_smpl_forward_matches_jax_and_oracle(models, kind):
    jm, tm = models
    theta = _poses()[kind]
    beta = (np.random.RandomState(1).randn(3, 10)).astype(np.float32)
    out = torch_smpl.smpl_forward(tm, torch.from_numpy(beta),
                                  torch.from_numpy(theta),
                                  precision=torch_smpl.EXACT_PRECISION)
    ref = jax_smpl.smpl_forward_batch(jm, jnp.asarray(beta),
                                      jnp.asarray(theta),
                                      precision=jax_smpl.EXACT_PRECISION)
    np.testing.assert_allclose(out.vertices.numpy(),
                               np.asarray(ref.vertices), **M_TOL)
    np.testing.assert_allclose(out.joints.numpy(), np.asarray(ref.joints),
                               **M_TOL)
    # Joints-only forward (what the fit runs) equals the full forward's.
    np.testing.assert_allclose(
        torch_smpl.smpl_joints(tm, torch.from_numpy(beta),
                               torch.from_numpy(theta)).numpy(),
        out.joints.numpy(), **M_TOL)
    arrays = tm.to_numpy()
    v_np, j_np = smpl_np(arrays["v_template"], arrays["shapedirs"],
                         arrays["posedirs"], arrays["J_regressor"],
                         arrays["weights"], arrays["parents"], beta[0],
                         theta[0])
    np.testing.assert_allclose(out.vertices[0].numpy(), v_np, **M_TOL)
    np.testing.assert_allclose(out.joints[0].numpy(), j_np, **M_TOL)


def test_regress_joints_matches_jax(models):
    jm, tm = models
    v = np.random.RandomState(2).randn(2, 6890, 3).astype(np.float32)
    got = torch_smpl.regress_joints(tm, torch.from_numpy(v),
                                    precision=torch_smpl.EXACT_PRECISION)
    for i in range(2):
        np.testing.assert_allclose(
            got[i].numpy(),
            np.asarray(jax_smpl.regress_joints(
                jm, jnp.asarray(v[i]), precision=jax.lax.Precision.HIGHEST)),
            **M_TOL)


@pytest.mark.parametrize("mode", ["max", "sum"])
def test_gmm_prior_matches_jax(mode):
    jp = jax_priors.synthetic_gmm_prior(0)
    tp = torch_priors.synthetic_gmm_prior(0, device="cpu")
    pose = (0.4 * np.random.RandomState(3).randn(4, 69)).astype(np.float32)
    got = tp.neg_log_prob(torch.from_numpy(pose), mode=mode).numpy()
    want = np.array([float(jp.neg_log_prob(jnp.asarray(p), mode=mode))
                     for p in pose])
    np.testing.assert_allclose(got, want, **PRIOR_TOL)


def test_l2_and_angle_priors_match_jax():
    pose = (0.4 * np.random.RandomState(4).randn(4, 72)).astype(np.float32)
    jl = jax_priors.l2_prior(np.full(69, 0.1))
    tl = torch_priors.l2_prior(np.full(69, 0.1), device="cpu")
    got = tl.neg_log_prob(torch.from_numpy(pose[:, 3:])).numpy()
    want = [float(jl.neg_log_prob(jnp.asarray(p[3:]))) for p in pose]
    np.testing.assert_allclose(got, want, **PRIOR_TOL)
    got = torch_priors.angle_prior(torch.from_numpy(pose)).numpy()
    want = [float(jax_priors.angle_prior(jnp.asarray(p))) for p in pose]
    np.testing.assert_allclose(got, want, **PRIOR_TOL)


def test_npz_round_trips(tmp_path, models):
    """SMPL and GMM npz files written by the JAX package load in the port."""
    jm, tm = models
    jax_data.save_npz(str(tmp_path / "smpl.npz"), jm)
    loaded = torch_data.load_npz(str(tmp_path / "smpl.npz"), device="cpu")
    for name, arr in tm.to_numpy().items():
        np.testing.assert_array_equal(loaded.to_numpy()[name], arr)
    jp = jax_priors.synthetic_gmm_prior(0)
    jax_priors.save_gmm_npz(str(tmp_path / "gmm.npz"), jp)
    tp = torch_priors.load_gmm_npz(str(tmp_path / "gmm.npz"), device="cpu")
    np.testing.assert_array_equal(tp.precisions.numpy(),
                                  np.asarray(jp.precisions))
