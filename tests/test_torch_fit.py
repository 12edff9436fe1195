"""Port SMPLify fit vs the JAX package: the init, the energy and its
gradient at the init, and the end state of the batched and multistart
fits under tests/test_api.py's SMALL_FIT schedule."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pose.fitting import energy as jax_energy, fit as jax_fit
from tpu_pose.fitting import priors as jax_priors
from tpu_pose.models import joints as jax_joints, smpl as jax_smpl
from tpu_pose.models import smpl_data as jax_data
from tpu_pose.utils import config as jc
from tpu_pose_torch.fitting import energy as torch_energy, fit as torch_fit
from tpu_pose_torch.fitting import priors as torch_priors
from tpu_pose_torch.models import smpl_data as torch_data
from tpu_pose_torch.utils import config as tc
from torch_threads import one_thread

one_thread()


def _small_fit(cfg_mod, **kw):
    """tests/test_api.py's SMALL_FIT in either package's config types."""
    return cfg_mod.FitConfig(
        stages=(cfg_mod.StageConfig(iters=20, lr=0.05, opt_pose=False,
                                    opt_shape=False, w_pose_prior=0,
                                    w_shape_prior=0, w_angle_prior=0),
                cfg_mod.StageConfig(iters=40, lr=0.02, w_pose_prior=0.5,
                                    w_shape_prior=1.0)),
        img_size=64, **kw)


# Energy and gradient at the init: float32 sums in another order.
E_TOL = dict(rtol=1e-5, atol=1e-6)
G_TOL = dict(rtol=1e-5, atol=1e-5)
# End state after 60 Adam steps; 1 mm MPJPE is BASELINE.json's budget.
END_TOL = dict(rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def assets():
    return (jax_data.synthetic_smpl(seed=0),
            torch_data.synthetic_smpl(seed=0, device="cpu"),
            jax_priors.synthetic_gmm_prior(0),
            torch_priors.synthetic_gmm_prior(0, device="cpu"))


def _observations(jm, n=3, img=64, seed=5):
    """2D joints (pixels) of known bodies under a weak-perspective camera,
    with 1 px noise, and per-joint confidences."""
    rng = np.random.RandomState(seed)
    theta = (0.2 * rng.randn(n, 72)).astype(np.float32)
    theta[:, 1] += np.pi * rng.rand(n)
    beta = rng.randn(n, 10).astype(np.float32)
    out = jax_smpl.smpl_forward_batch(jm, jnp.asarray(beta),
                                      jnp.asarray(theta))
    j14 = np.asarray(jax_joints.select_smpl_joints(out.joints))
    norm = 0.9 * j14[..., :2] * np.array([1.0, -1.0])
    px = (norm * img / 2 + img / 2 + rng.randn(n, 14, 2)).astype(np.float32)
    conf = rng.uniform(0.3, 1.0, (n, 14)).astype(np.float32)
    return px, conf


def _jax_init(jm, px, conf, cfg):
    obs = jax_fit._normalize_obs(jnp.asarray(px), cfg)
    return obs, jax.jit(jax.vmap(
        lambda o, c: jax_fit.default_init(jm, o, c, cfg)))(
            obs, jnp.asarray(conf))


@pytest.mark.parametrize("camera", ["weak_perspective", "perspective"])
@pytest.mark.parametrize("yaw_init", ["limb_order", "zero"])
def test_default_init_matches_jax(assets, camera, yaw_init):
    jm, tm, _, _ = assets
    px, conf = _observations(jm)
    jcfg = _small_fit(jc, camera_model=camera, yaw_init=yaw_init)
    tcfg = _small_fit(tc, camera_model=camera, yaw_init=yaw_init)
    _, want = _jax_init(jm, px, conf, jcfg)
    obs = torch_fit._normalize_obs(torch.from_numpy(px), tcfg)
    got = torch_fit.default_init(tm, obs, torch.from_numpy(conf), tcfg)
    for k in ("theta", "beta", "cam"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("camera", ["weak_perspective", "perspective"])
@pytest.mark.parametrize("stage_idx", [0, 1])
@pytest.mark.parametrize("with_prior", [False, True])
def test_energy_and_gradient_at_init(assets, camera, stage_idx, with_prior):
    """One step agrees: energy and its gradient at the init, per sample,
    for the camera-only stage and the full stage with all priors."""
    jm, tm, jp, tp = assets
    px, conf = _observations(jm)
    jcfg = _small_fit(jc, camera_model=camera)
    tcfg = _small_fit(tc, camera_model=camera)
    obs, init = _jax_init(jm, px, conf, jcfg)
    stage = jcfg.stages[stage_idx]
    fn = functools.partial(jax_energy.fit_energy, model=jm, stage=stage,
                           cfg=jcfg, prior=jp if with_prior else None)
    e_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, o, c: fn(p, joints2d_obs=o, conf=c))))(
            init, obs, jnp.asarray(conf))
    params = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in init.items()}
    e_t = torch_energy.fit_energy(
        params, tm, torch.from_numpy(np.array(obs)),
        torch.from_numpy(conf), tcfg.stages[stage_idx], tcfg,
        tp if with_prior else None)
    grads = torch.autograd.grad(e_t.sum(), [params[k] for k in params])
    np.testing.assert_allclose(e_t.detach().numpy(), np.asarray(e_j),
                               **E_TOL)
    for k, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j[k]), **G_TOL,
                                   err_msg=k)


def _mpjpe_mm(jm, a, b):
    ja = jax_smpl.smpl_forward_batch(jm, jnp.asarray(a.beta),
                                     jnp.asarray(a.theta)).joints
    jb = jax_smpl.smpl_forward_batch(jm, jnp.asarray(b.beta),
                                     jnp.asarray(b.theta)).joints
    return 1000.0 * float(jnp.linalg.norm(ja - jb, axis=-1).mean())


def test_fit_smpl_batch_end_state(assets):
    jm, tm, jp, tp = assets
    px, conf = _observations(jm)
    jcfg, tcfg = _small_fit(jc, keep_history=True), \
        _small_fit(tc, keep_history=True)
    want = jax.jit(functools.partial(jax_fit.fit_smpl_batch, cfg=jcfg,
                                     prior=jp))(jm, jnp.asarray(px),
                                                jnp.asarray(conf))
    got = torch_fit.fit_smpl_batch(tm, torch.from_numpy(px),
                                   torch.from_numpy(conf), tcfg, tp)
    got = jax_fit.FitResult(*(np.asarray(f) for f in got))
    for k in ("theta", "beta", "cam"):
        np.testing.assert_allclose(getattr(got, k),
                                   np.asarray(getattr(want, k)), **END_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(got.energy, np.asarray(want.energy),
                               rtol=1e-3)
    assert got.energy_history.shape == (3, 60)
    np.testing.assert_allclose(got.energy_history,
                               np.asarray(want.energy_history), rtol=1e-3)
    assert _mpjpe_mm(jm, got, want) <= 1.0


def test_fit_smpl_multistart_end_state(assets):
    jm, tm, jp, tp = assets
    px, conf = _observations(jm, n=2, seed=6)
    jcfg, tcfg = _small_fit(jc), _small_fit(tc)
    single = jax.jit(functools.partial(
        jax_fit.fit_smpl_multistart, cfg=jcfg, prior=jp, restarts=3))
    want = [single(jm, jnp.asarray(p), jnp.asarray(c))
            for p, c in zip(px, conf)]
    want = jax_fit.FitResult(*(np.stack([np.asarray(getattr(w, f))
                                         for w in want])
                               for f in jax_fit.FitResult._fields))
    got = torch_fit.fit_smpl_multistart(tm, torch.from_numpy(px),
                                        torch.from_numpy(conf), tcfg, tp,
                                        restarts=3)
    got = jax_fit.FitResult(*(np.asarray(f) for f in got))
    for k in ("theta", "beta", "cam"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   **END_TOL, err_msg=k)
    np.testing.assert_allclose(got.energy, want.energy, rtol=1e-3)
    assert _mpjpe_mm(jm, got, want) <= 1.0
    every = torch_fit.fit_smpl_multistart(
        tm, torch.from_numpy(px), torch.from_numpy(conf), tcfg, tp,
        restarts=3, return_all=True)
    assert every.theta.shape == (2, 3, 72)


def test_fit_smpl_single_and_unported(assets):
    """fit_smpl_single is the batch's one row, also with the options that
    were not ported before (the L-BFGS stage, the interpenetration term),
    which now run (tests/test_torch_lbfgs.py and
    tests/test_torch_interpenetration.py hold them against JAX)."""
    _, tm, _, tp = assets
    px, conf = _observations(assets[0], n=1)
    tcfg = tc.FitConfig(stages=(tc.StageConfig(iters=5),), img_size=64)
    stages = (dataclasses.replace(tcfg.stages[0], w_interpenetration=1e3),)
    for cfg in (tcfg, dataclasses.replace(tcfg, optimizer="lbfgs"),
                dataclasses.replace(tcfg, stages=stages)):
        one = torch_fit.fit_smpl_single(tm, torch.from_numpy(px[0]),
                                        torch.from_numpy(conf[0]), cfg, tp)
        batch = torch_fit.fit_smpl_batch(tm, torch.from_numpy(px),
                                         torch.from_numpy(conf), cfg, tp)
        assert one.theta.shape == (72,)
        torch.testing.assert_close(one.theta, batch.theta[0])
        assert torch.isfinite(batch.energy).all()


def _pose_corpus(n=400, seed=0):
    """Body poses from three clusters, the kind of corpus fit_gmm builds a
    prior from."""
    rng = np.random.RandomState(seed)
    centers = 0.3 * rng.randn(3, 69)
    return centers[rng.randint(3, size=n)] + 0.1 * rng.randn(n, 69)


def test_fit_gmm_matches_jax():
    """Host numpy in float64 in both packages, the same calls in the same
    order: the same prior within 1e-6 (float32 storage)."""
    samples = _pose_corpus()
    want = jax_priors.fit_gmm(samples, num_components=4, iters=15, seed=1)
    got = torch_priors.fit_gmm(samples, num_components=4, iters=15, seed=1,
                               device="cpu")
    for k in ("means", "precisions", "log_consts"):
        w = np.asarray(getattr(want, k))
        np.testing.assert_allclose(getattr(got, k).numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_gmm_npz_both_ways(tmp_path):
    """save_gmm_npz of either package loads in the other, exactly."""
    jp = jax_priors.synthetic_gmm_prior(3, num_components=2)
    tp = torch_priors.synthetic_gmm_prior(3, num_components=2, device="cpu")
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_priors.save_gmm_npz(a, jp)
    torch_priors.save_gmm_npz(b, tp)
    from_jax = torch_priors.load_gmm_npz(a, device="cpu")
    from_port = jax_priors.load_gmm_npz(b)
    for k in ("means", "precisions", "log_consts"):
        np.testing.assert_array_equal(getattr(from_jax, k).numpy(),
                                      np.asarray(getattr(jp, k)))
        np.testing.assert_array_equal(np.asarray(getattr(from_port, k)),
                                      getattr(tp, k).numpy())
