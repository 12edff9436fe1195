"""The port's capsule interpenetration term
(tpu_pose_torch/fitting/interpenetration.py) against the JAX package's:
the capsule spec, the penalty and its gradient, the energy term and an
Adam fit with the term on.

Bounds, and why:
- Spec: the static arrays equal; radii within 1e-6; thresholds within
  2e-6. Both packages compute the rest joints J_regressor @ v_template
  as float32 sums of 6890 terms in another order: XLA's CPU dot lands
  8.8e-7 from the float64 value, the port's 2.6e-7, and a threshold is a
  distance between two such joints' spheres.
- Penalty and gradient within 1e-5 (relative and absolute). On the rest
  pose every calibrated threshold sits on its hinge's kink, so there the
  penalty and gradient are rounding noise of the thresholds: that case is
  held on the JAX spec's geometry, the others on both specs.
- The energy with the term on: tests/test_torch_fit.py's E_TOL, on the
  JAX spec's geometry (the port's own thresholds move the hinges by their
  2e-6); its gradient within rtol 1e-5 and 1e-5·max|g|: through the
  kinematic chain it sums ≈ 2,000 hinge pairs that partly cancel, so a
  small entry carries the rounding of the large ones. The fit's end
  state: tests/test_torch_fit.py's END_TOL and ≤ 1 mm MPJPE.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pose.fitting import energy as jax_energy, fit as jax_fit
from tpu_pose.fitting import interpenetration as jax_interp
from tpu_pose.fitting import priors as jax_priors
from tpu_pose.models import camera as jax_camera, joints as jax_joints
from tpu_pose.models import smpl as jax_smpl, smpl_data as jax_data
from tpu_pose.utils import config as jc
from tpu_pose_torch.fitting import energy as torch_energy, fit as torch_fit
from tpu_pose_torch.fitting import interpenetration as interp
from tpu_pose_torch.fitting import priors as torch_priors
from tpu_pose_torch.models import smpl as smpl_lib
from tpu_pose_torch.models import smpl_data as torch_data
from tpu_pose_torch.utils import config as tc
from torch_threads import one_thread

one_thread()

PENALTY_TOL = dict(rtol=1e-5, atol=1e-5)
E_TOL = dict(rtol=1e-5, atol=1e-6)
END_TOL = dict(rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def assets():
    jm = jax_data.synthetic_smpl(seed=0)
    tm = torch_data.synthetic_smpl(seed=0, device="cpu")
    return jm, tm, jax.jit(jax_interp.build_capsule_spec)(jm), \
        interp.build_capsule_spec(tm)


def _rest_joints(jm):
    return np.asarray(jnp.matmul(jm.J_regressor, jm.v_template))


def test_capsule_spec_matches_jax(assets):
    jm, tm, want, got = assets
    for f in ("sphere_a", "sphere_b", "frac", "pair_i", "pair_j"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_allclose(got.radius.numpy(), np.asarray(want.radius),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.threshold.numpy(),
                               np.asarray(want.threshold), rtol=0, atol=2e-6)
    assert (got.radius >= 0.015 - 1e-7).all()
    # The dominant-LBS assignment has no exact ties that another read
    # order could break differently (both argmaxes take the first).
    w = np.sort(np.asarray(jm.weights), axis=1)
    assert (w[:, -1] > w[:, -2]).all()


def _with_jax_geometry(spec, jax_spec):
    return dataclasses.replace(
        spec, radius=torch.from_numpy(np.array(jax_spec.radius)),
        threshold=torch.from_numpy(np.array(jax_spec.threshold)))


def _joints(jm, case):
    rng = np.random.RandomState(0)
    rest = _rest_joints(jm)
    return {"rest": rest,
            "collapsed": np.zeros((24, 3)) + 0.01,
            "near_collapse": 0.01 + 1e-3 * rng.randn(24, 3),
            "batch": rest[None] + 0.1 * rng.randn(5, 24, 3)}[case].astype(
                np.float32)


CASES = [("rest", "jax_spec"), ("collapsed", "jax_spec"),
         ("near_collapse", "jax_spec"), ("batch", "jax_spec"),
         ("collapsed", "port_spec"), ("near_collapse", "port_spec"),
         ("batch", "port_spec")]


@pytest.mark.parametrize("case,spec_from", CASES)
def test_penalty_and_gradient_match_jax(assets, case, spec_from):
    jm, _, jspec, tspec = assets
    if spec_from == "jax_spec":
        tspec = _with_jax_geometry(tspec, jspec)
    j = _joints(jm, case)
    flat = j.reshape(-1, 24, 3)
    p_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(
        lambda x: jax_interp.interpenetration_penalty(x, jspec))))(
            jnp.asarray(flat))
    x = torch.from_numpy(j).requires_grad_(True)
    p_t = interp.interpenetration_penalty(x, tspec)
    (g_t,) = torch.autograd.grad(p_t.sum(), x)
    assert p_t.shape == j.shape[:-2]
    np.testing.assert_allclose(p_t.detach().numpy().reshape(-1),
                               np.asarray(p_j), **PENALTY_TOL)
    np.testing.assert_allclose(g_t.numpy().reshape(flat.shape),
                               np.asarray(g_j), **PENALTY_TOL)
    assert np.isfinite(g_t.numpy()).all()
    if case == "rest":
        assert float(p_t.detach()) == pytest.approx(0.0, abs=1e-10)
    if case in ("collapsed", "near_collapse"):
        assert (p_t > 1e-4).all()


def _observations(jm, n=2, seed=4):
    """tests/test_interpenetration.py:77's bodies (θ 0.3σ, β 0.5σ) under a
    fixed camera in a 64 px frame, confidence 1."""
    rng = np.random.RandomState(seed)
    theta = (0.3 * rng.randn(n, 72)).astype(np.float32)
    beta = (0.5 * rng.randn(n, 10)).astype(np.float32)
    j3d = jax_joints.select_smpl_joints(jax_smpl.smpl_forward_batch(
        jm, jnp.asarray(beta), jnp.asarray(theta)).joints)
    cam = jnp.asarray([2.0, 0.1, -0.05])
    px = np.asarray((jax_camera.project(j3d, cam) + 1.0) * 32.0, np.float32)
    return px, np.ones((n, 14), np.float32)


def _cfg(cfg_mod, w):
    return cfg_mod.FitConfig(
        stages=(cfg_mod.StageConfig(iters=12, lr=0.05, opt_pose=False,
                                    opt_shape=False, w_pose_prior=0,
                                    w_shape_prior=0, w_angle_prior=0,
                                    w_interpenetration=w),
                cfg_mod.StageConfig(iters=25, lr=0.02, w_pose_prior=0.5,
                                    w_shape_prior=1.0,
                                    w_interpenetration=w)),
        img_size=64)


def test_energy_term_matches_jax(assets):
    """fit_energy with the term on (w = 5e3, the full stage) at a pose
    with overlap: energy and gradient per sample."""
    jm, tm, jspec, tspec = assets
    px, conf = _observations(jm)
    jcfg, tcfg = _cfg(jc, 5e3), _cfg(tc, 5e3)
    obs = jax_fit._normalize_obs(jnp.asarray(px), jcfg)
    rng = np.random.RandomState(1)
    params = {"theta": np.float32(0.8 * rng.randn(2, 72)),
              "beta": np.float32(rng.randn(2, 10)),
              "cam": np.float32([[0.9, 0.0, 0.0]] * 2)}
    fn = functools.partial(jax_energy.fit_energy, model=jm,
                           stage=jcfg.stages[1], cfg=jcfg,
                           capsule_spec=jspec)
    e_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, o, c: fn(p, joints2d_obs=o, conf=c))))(
            {k: jnp.asarray(v) for k, v in params.items()}, obs,
            jnp.asarray(conf))
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    e_t = torch_energy.fit_energy(tp, tm, torch.from_numpy(np.asarray(obs)),
                                  torch.from_numpy(conf), tcfg.stages[1],
                                  tcfg, capsule_spec=_with_jax_geometry(
                                      tspec, jspec))
    off = torch_energy.fit_energy(tp, tm, torch.from_numpy(np.asarray(obs)),
                                  torch.from_numpy(conf), tcfg.stages[1],
                                  tcfg)
    assert (e_t > off).all()
    grads = torch.autograd.grad(e_t.sum(), list(tp.values()))
    np.testing.assert_allclose(e_t.detach().numpy(), np.asarray(e_j),
                               **E_TOL)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in g_j.values())
    for k, g in zip(tp, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j[k]), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=k)


def test_adam_fit_with_interpenetration_matches_jax(assets):
    """tests/test_interpenetration.py:77's fit (w = 5e3 on both stages)
    against JAX's, batched; and, as there, the term-on solution carries no
    more capsule overlap than the term-off fit. With the GMM-8 prior: the
    rotations of joints 7, 8, 20 and 21 move only the unobserved feet and
    hands, so without a pose prior their gradient at the pose stage's
    first step is the hinges' rounding noise (≈ 1e-7), and Adam's first
    step moves each by ±lr whichever its sign, in either package."""
    jm, tm, _, tspec = assets
    jp = jax_priors.synthetic_gmm_prior(0)
    tp = torch_priors.synthetic_gmm_prior(0, device="cpu")
    px, conf = _observations(jm)
    want = jax.jit(functools.partial(jax_fit.fit_smpl_batch,
                                     cfg=_cfg(jc, 5e3), prior=jp))(
        jm, jnp.asarray(px), jnp.asarray(conf))
    got = torch_fit.fit_smpl_batch(tm, torch.from_numpy(px),
                                   torch.from_numpy(conf), _cfg(tc, 5e3), tp)
    for k in ("theta", "beta", "cam"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), **END_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=1e-3)
    ja, jb = (jax_smpl.smpl_forward_batch(
        jm, jnp.asarray(np.asarray(r.beta)),
        jnp.asarray(np.asarray(r.theta))).joints for r in (got, want))
    assert 1000.0 * float(jnp.linalg.norm(ja - jb, axis=-1).mean()) <= 1.0
    off = torch_fit.fit_smpl_batch(tm, torch.from_numpy(px),
                                   torch.from_numpy(conf), _cfg(tc, 0.0), tp)

    def overlap(r):
        return interp.interpenetration_penalty(
            smpl_lib.smpl_joints(tm, r.beta, r.theta), tspec)

    assert (overlap(got) <= overlap(off) + 1e-8).all()
