"""The port's learned fit initialization (tpu_pose_torch/fitting/
init_head.py) against the JAX package's: heads carried across in the npz
format both ways, the features, the MLP, the training loss and its
gradient on one identical batch, training itself, the camera quirk of
``head_init_pytree``, and PoseEstimator(init_head=...) on every entry
point that uses it.

Bounds: features and predictions within 1e-5; the loss and its gradient
within 1e-4 relative (the port's SMPL joints come from the joint basis,
JAX's from the full forward: float32 sums in another order); the
estimators' fits as tests/test_torch_multiperson.py's ``compare_fits``
(θ without the leaf rotations, β, cam 1e-3; joints3d ≤ 1 mm)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import two_people_frames
from tpu_pose.api import PoseEstimator as JaxEstimator
from tpu_pose.fitting import fit as jax_fit, init_head as jax_head
from tpu_pose.models import smpl_data as jax_data
from tpu_pose.utils import config as jc
from tpu_pose_torch.api import PoseEstimator
from tpu_pose_torch.fitting import fit as torch_fit, init_head as head
from tpu_pose_torch.models import smpl_data as torch_data
from tpu_pose_torch.utils import config as tc
from torch_threads import one_thread

one_thread()

SMALL_CPM = dict(input_size=64, features=16, stage1_head_width=32,
                 refine_width=16, num_stages=2, compute_dtype="float32")
LEAF = [3 * j + a for j in (10, 11, 22, 23) for a in range(3)]
DRIVEN = np.setdiff1d(np.arange(72), LEAF)


@pytest.fixture(scope="module")
def heads(tmp_path_factory):
    """A small JAX head whose last layer is scaled up (an untrained head
    predicts ≈ 0), saved by JAX's save_head and loaded by the port's."""
    params = jax_head.init_head_params(jax.random.PRNGKey(3), hidden=32,
                                       depth=2)
    params = dict(params, w2=params["w2"] * 30.0)
    path = str(tmp_path_factory.mktemp("head") / "jax_head.npz")
    jax_head.save_head(path, params)
    return params, head.load_head(path, device="cpu")


@pytest.fixture(scope="module")
def models():
    """tests/test_init_head.py's 300-vertex model: the head reads joints
    only."""
    return (jax_data.synthetic_smpl(seed=0, num_verts=300),
            torch_data.synthetic_smpl(seed=0, num_verts=300, device="cpu"))


@pytest.fixture(scope="module")
def batch(models):
    """One training batch of 16 from JAX's _sample_batch, as numpy."""
    return [np.asarray(x) for x in jax.jit(
        jax_head._sample_batch, static_argnums=2)(
            jax.random.PRNGKey(1), models[0], 16)]


def test_head_npz_both_ways(heads, tmp_path):
    params, got = heads
    assert sorted(got) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
    back = str(tmp_path / "port_head.npz")
    head.save_head(back, got)
    for k, v in jax_head.load_head(back).items():
        np.testing.assert_array_equal(np.asarray(v), got[k].numpy())


def test_featurize_and_apply_match_jax(heads, batch):
    params, tparams = heads
    j2d, conf = batch[:2]
    want = jax.vmap(jax_head._featurize)(jnp.asarray(j2d),
                                         jnp.asarray(conf))
    got = head._featurize(torch.from_numpy(j2d), torch.from_numpy(conf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want = jax.vmap(lambda j, c: jax_head.init_head_apply(params, j, c))(
        jnp.asarray(j2d), jnp.asarray(conf))
    got = head.init_head_apply(tparams, torch.from_numpy(j2d),
                               torch.from_numpy(conf))
    assert got[0].shape == (16, 72) and got[1].shape == (16, 10)
    assert float(np.abs(np.asarray(want[0])).max()) > 0.1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_loss_and_gradient_match_jax(heads, models, batch):
    params, tparams = heads
    jm, tm = models
    loss_j, grad_j = jax.jit(jax.value_and_grad(jax_head._loss))(
        params, jm, *map(jnp.asarray, batch))
    tp = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    loss_t = head._loss(tp, tm, *map(torch.from_numpy, batch))
    grads = torch.autograd.grad(loss_t, list(tp.values()))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-4)
    for k, g in zip(tp, grads):
        w = np.asarray(grad_j[k])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_train_init_head_lowers_loss(models):
    """40 steps at batch 64 from its own generator: the last ten losses
    average below 0.95 of the first ten; the result is a head of the
    requested shape that init_head_apply runs."""
    params, losses = head.train_init_head(models[1], steps=40, batch=64,
                                          hidden=32, depth=2, seed=0)
    assert losses.shape == (40,) and np.isfinite(losses).all()
    assert losses[-10:].mean() < 0.95 * losses[:10].mean()
    assert params["w0"].shape == (42, 32) and params["w2"].shape == (32, 82)
    theta, beta = head.init_head_apply(params, torch.zeros(1, 14, 2),
                                       torch.ones(1, 14))
    assert theta.shape == (1, 72) and torch.isfinite(theta).all()


def test_head_init_camera_is_the_mean_pose_one(heads, models, batch):
    """Reference quirk, reproduced: head_init_pytree's docstring says the
    camera comes from the predicted rest pose, but its code takes
    default_init's camera — the limb-order-yawed mean rest pose's —
    whatever θ the head predicts."""
    params, tparams = heads
    jm, tm = models
    j2d, conf = (x[:4] for x in batch[:2])
    cfg_j, cfg_t = jc.FitConfig(img_size=64), tc.FitConfig(img_size=64)
    want = jax.jit(jax.vmap(lambda j, c: jax_head.head_init_pytree(
        params, jm, j, c, cfg_j)))(jnp.asarray(j2d), jnp.asarray(conf))
    got = head.head_init_pytree(tparams, tm, torch.from_numpy(j2d),
                                torch.from_numpy(conf), cfg_t)
    base = torch_fit.default_init(tm, torch.from_numpy(j2d),
                                  torch.from_numpy(conf), cfg_t)
    assert torch.equal(got["cam"], base["cam"])
    assert (got["theta"][:, 1] - base["theta"][:, 1]).abs().max() > 0.05
    for k in ("theta", "beta", "cam"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    jbase = jax.jit(jax.vmap(lambda j, c: jax_fit.default_init(
        jm, j, c, cfg_j)))(jnp.asarray(j2d), jnp.asarray(conf))
    np.testing.assert_array_equal(np.asarray(want["cam"]),
                                  np.asarray(jbase["cam"]))


def _fit_cfg(m):
    """One full stage: the head already placed the camera's yaw."""
    return m.FitConfig(stages=(m.StageConfig(iters=15, lr=0.02,
                                             w_pose_prior=0.5,
                                             w_shape_prior=1.0),),
                       img_size=64)


def _compare(got, want):
    got = {k: v.detach().numpy() for k, v in got._asdict().items()}
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    for k in ("theta", "beta", "cam"):
        g, w = got[k], want[k]
        assert g.shape == w.shape, k
        if k == "theta":
            g, w = g[..., DRIVEN], w[..., DRIVEN]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3, err_msg=k)
    if "joints3d" in got:
        mpjpe = 1000.0 * np.linalg.norm(got["joints3d"] - want["joints3d"],
                                        axis=-1).mean()
        assert mpjpe <= 1.0, mpjpe
    return got


def test_estimator_init_head_matches_jax(heads):
    """PoseEstimator(init_head=...) in both packages: fit_smpl,
    estimate_and_fit and estimate_and_fit_multi (on the flat B·k batch)
    start from the head, with JAX's results; without the head the port's
    fits differ."""
    params, _ = heads
    jest = JaxEstimator.create_synthetic(0, jc.CPMConfig(**SMALL_CPM),
                                         _fit_cfg(jc), init_head=params)
    carried = dict(
        cpm_params={k: {kk: np.asarray(vv) for kk, vv in v.items()}
                    for k, v in jest.cpm_params.items()},
        smpl_arrays={k: np.asarray(v)
                     for k, v in jest.smpl_model._asdict().items()},
        prior_arrays={k: np.asarray(getattr(jest.prior, k))
                      for k in ("means", "precisions", "log_consts")},
        cpm_cfg=tc.CPMConfig(**SMALL_CPM), fit_cfg=_fit_cfg(tc),
        device="cpu")
    test = PoseEstimator.from_numpy(
        init_head={k: np.asarray(v) for k, v in params.items()}, **carried)
    plain = PoseEstimator.from_numpy(**carried)
    rng = np.random.RandomState(2)
    j = (rng.rand(3, 14, 2) * 40 + 12).astype(np.float32)
    c = np.ones((3, 14), np.float32)
    got = _compare(test.fit_smpl(j, c),
                   jest.fit_smpl(jnp.asarray(j), jnp.asarray(c)))
    assert np.abs(got["theta"] - plain.fit_smpl(j, c).theta.numpy()).max() \
        > 0.01
    frames = two_people_frames(2, 72, 96, seed=3)
    _compare(test.estimate_and_fit(frames),
             jest.estimate_and_fit(jnp.asarray(frames)))
    got = _compare(test.estimate_and_fit_multi(frames, nms_radius_px=32.0),
                   jest.estimate_and_fit_multi(jnp.asarray(frames),
                                               nms_radius_px=32.0))
    assert got["theta"].shape == (2, 2, 72)
