"""The accuracy front end of the port against the JAX package: letterbox,
the crop geometry and ``_crop_zoom``, the person geometry, every knob of
``estimate_2d_from_images`` on tests/test_api.py's small CPM in float32,
and ``PoseEstimator.estimate_and_fit`` with the front end on.

The images of the whole-network cases are smooth (a coarse random field
resized up): on per-pixel noise the random-weight network's crop geometry
turns float32 rounding differences of 1e-6 into shifts of a tenth of a
pixel, which would test the noise's conditioning, not the port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pose.api import PoseEstimator as JaxEstimator
from tpu_pose.fitting import priors as jax_priors
from tpu_pose.models import cpm as jax_cpm
from tpu_pose.models import smpl_data as jax_data
from tpu_pose.models.joints import CPM_FLIP_PERM
from tpu_pose.ops import preprocess as jax_pre
from tpu_pose.utils import config as jc
from tpu_pose_torch.api import PoseEstimator
from tpu_pose_torch.models import cpm as torch_cpm
from tpu_pose_torch.ops import preprocess as torch_pre
from tpu_pose_torch.utils import config as tc
from torch_threads import one_thread

one_thread()

SMALL = dict(input_size=64, features=16, stage1_head_width=32,
             refine_width=16, num_stages=3)
HM_TOL = 1e-4          # × max|b|, float32 convs summed in another order
JOINT_TOL = 1e-2       # px


def _cfgs(compute_dtype="float32"):
    return (jc.CPMConfig(**SMALL, compute_dtype=compute_dtype),
            tc.CPMConfig(**SMALL, compute_dtype=compute_dtype))


@functools.lru_cache(maxsize=None)
def _params():
    """The JAX weights and the port's CPM holding them."""
    jcfg, tcfg = _cfgs()
    params = jax_cpm.init_cpm_params(jax.random.PRNGKey(0), jcfg)
    np_params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                 for k, v in params.items()}
    return params, np_params


def _port_cpm(tcfg):
    return torch_cpm.cpm_params_from_numpy(_params()[1], tcfg, "cpu")


def _smooth_images(b, h, w, seed):
    """uint8 (b, h, w, 3): a 6×5 random field bilinearly interpolated up
    (numpy)."""
    lo = np.random.RandomState(seed).rand(b, 6, 5, 3) * 255.0
    ys = np.linspace(0, 5, h)
    xs = np.linspace(0, 4, w)
    y0 = np.minimum(ys.astype(int), 4)
    x0 = np.minimum(xs.astype(int), 3)
    fy = (ys - y0)[None, :, None, None]
    fx = (xs - x0)[None, None, :, None]
    top = lo[:, y0][:, :, x0] * (1 - fx) + lo[:, y0][:, :, x0 + 1] * fx
    bot = lo[:, y0 + 1][:, :, x0] * (1 - fx) + lo[:, y0 + 1][:, :, x0 + 1] * fx
    return np.clip(np.round(top * (1 - fy) + bot * fy), 0, 255).astype(
        np.uint8)


# -- letterbox ---------------------------------------------------------------

LETTERBOX = [(80, 60, 64), (30, 50, 64), (64, 64, 64), (500, 400, 368),
             (200, 300, 368)]


@pytest.mark.parametrize("h0,w0,size", LETTERBOX)
@pytest.mark.parametrize("dtype,fill", [("uint8", 128.0), ("float32", 0.0)])
def test_letterbox_image_matches_jax(h0, w0, size, dtype, fill):
    """Geometry and affine exactly; the image within 1e-3 in 0–255 units
    (the resize's float32 sums in another order), down- and up-scaling,
    non-square, uint8 and float, two fills."""
    rng = np.random.RandomState(h0 + w0)
    img = (rng.randint(0, 256, (h0, w0, 3)).astype(np.uint8)
           if dtype == "uint8" else
           (rng.rand(h0, w0, 3) * 255).astype(np.float32))
    assert torch_pre._letterbox_geometry(h0, w0, size) == \
        jax_pre._letterbox_geometry(h0, w0, size)
    np.testing.assert_array_equal(torch_pre.letterbox_affine(h0, w0, size),
                                  jax_pre.letterbox_affine(h0, w0, size))
    want = np.asarray(jax.jit(functools.partial(
        jax_pre.letterbox_image, size=size, fill=fill))(jnp.asarray(img)))
    got = torch_pre.letterbox_image(torch.from_numpy(img)[None], size,
                                    fill=fill)[0]
    assert got.shape == (size, size, 3) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("h0,w0,size", LETTERBOX)
def test_letterbox_frame_maps_round_trip(h0, w0, size):
    """Source → network → source is the identity, and both maps equal
    JAX's (rtol 1e-5)."""
    affine = jax_pre.letterbox_affine(h0, w0, size)
    src = (np.random.RandomState(1).rand(3, 14, 2)
           * [w0, h0]).astype(np.float32)
    net = torch_pre.joints_to_network_frame(torch.from_numpy(src), affine)
    np.testing.assert_allclose(
        net.numpy(), np.asarray(jax_pre.joints_to_network_frame(
            jnp.asarray(src), affine)), rtol=1e-5, atol=1e-5)
    back = torch_pre.joints_to_source_frame(net, affine)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jax_pre.joints_to_source_frame(
            jnp.asarray(net.numpy()), affine)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), src, rtol=1e-5, atol=1e-4)


def test_gaussian_center_maps_per_image():
    """The batched hint equals JAX's single-image map at each center."""
    centers = np.array([[20.0, 41.5], [31.5, 31.5], [-3.0, 70.0]],
                       np.float32)
    got = torch_pre.gaussian_center_maps(64, 21.0, torch.from_numpy(centers))
    for g, c in zip(got.numpy(), centers):
        np.testing.assert_allclose(g, np.asarray(jax_pre.gaussian_center_map(
            64, 21.0, jnp.asarray(c))), rtol=0, atol=1e-6)


# -- crop geometry and _crop_zoom ---------------------------------------------

def _affine_inputs(seed):
    rng = np.random.RandomState(seed)
    s = np.array([0.5, 0.75, 1.5, 3.0], np.float32)
    t = (rng.randn(4, 2) * 20).astype(np.float32)
    joints = (rng.rand(4, 14, 2) * 368).astype(np.float32)
    return s, t, joints


def test_crop_index_translation_and_joints_from_crop_frame():
    s, t, joints = _affine_inputs(0)
    np.testing.assert_allclose(
        torch_cpm.crop_index_translation(torch.from_numpy(s),
                                         torch.from_numpy(t)).numpy(),
        np.asarray(jax_cpm.crop_index_translation(jnp.asarray(s),
                                                  jnp.asarray(t))),
        rtol=1e-5)
    np.testing.assert_allclose(
        torch_cpm.joints_from_crop_frame(torch.from_numpy(joints),
                                         torch.from_numpy(s),
                                         torch.from_numpy(t)).numpy(),
        np.asarray(jax_cpm.joints_from_crop_frame(
            jnp.asarray(joints), jnp.asarray(s), jnp.asarray(t))),
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("target_frac,max_zoom", [(0.6, 3.0), (0.8, 2.0)])
def test_crop_affine_from_geometry(target_frac, max_zoom):
    """Extents from 1 px (zoom clamped at max_zoom) to 400 px (clamped at
    min_zoom 0.5)."""
    centers = np.array([[184.0, 184.0], [50.0, 300.0], [0.0, 0.0],
                        [367.0, 10.0]], np.float32)
    extent = np.array([1.0, 40.0, 110.0, 400.0], np.float32)
    jcfg, tcfg = jc.CPMConfig(), tc.CPMConfig()
    s_j, t_j = jax_cpm.crop_affine_from_geometry(
        jnp.asarray(centers), jnp.asarray(extent), jcfg, target_frac,
        max_zoom)
    s_t, t_t = torch_cpm.crop_affine_from_geometry(
        torch.from_numpy(centers), torch.from_numpy(extent), tcfg,
        target_frac, max_zoom)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=1e-5)
    assert float(s_t.max()) == max_zoom and float(s_t.min()) == 0.5


@pytest.mark.parametrize("scale", [0.5, 0.75, 1.5, 3.0])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("fill", [0.0, 0.3])
def test_crop_zoom_matches_jax(scale, channels, fill):
    """``jax.image.scale_and_translate`` rebuilt from per-image weight
    matrices: atol 1e-4 on normalized pixels, random translations."""
    rng = np.random.RandomState(int(scale * 4) + channels)
    im = (rng.rand(3, 64, 64, channels) - 0.5).astype(np.float32)
    s = np.full((3,), scale, np.float32)
    t = (rng.randn(3, 2) * 12).astype(np.float32)
    want = jax.jit(functools.partial(jax_cpm._crop_zoom, fill=fill))(
        jnp.asarray(im), jnp.asarray(s), jnp.asarray(t))
    got = torch_cpm._crop_zoom(torch.from_numpy(im), torch.from_numpy(s),
                               torch.from_numpy(t), fill=fill)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def _planted_beliefs(seed):
    """(3, 8, 8, 15) stage-1-like beliefs with one peak per part, some
    confidences negative."""
    rng = np.random.RandomState(seed)
    b = (rng.rand(3, 8, 8, 15) * 0.3 - 0.1).astype(np.float32)
    for i in range(3):
        for j in range(14):
            b[i, (2 * i + j) % 8, (3 * j + i) % 8, j] = 1.0 + 0.1 * j
    b[1, :, :, 4] -= 2.0                  # an all-negative part
    return b


def test_person_geometry_matches_jax():
    """estimate_person_geometry (β = 30 decode), person_geometry_from_joints
    and estimate_person_centers on planted beliefs: 1e-3 px."""
    b = _planted_beliefs(0)
    jcfg, tcfg = _cfgs()
    c_j, e_j = jax_cpm.estimate_person_geometry(jnp.asarray(b), jcfg)
    c_t, e_t = torch_cpm.estimate_person_geometry(torch.from_numpy(b), tcfg)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-3)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), atol=1e-3)
    rng = np.random.RandomState(1)
    joints = (rng.rand(3, 14, 2) * 64).astype(np.float32)
    conf = rng.randn(3, 14).astype(np.float32)
    c_j, e_j = jax_cpm.person_geometry_from_joints(jnp.asarray(joints),
                                                   jnp.asarray(conf))
    c_t, e_t = torch_cpm.person_geometry_from_joints(torch.from_numpy(joints),
                                                     torch.from_numpy(conf))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-3)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), atol=1e-3)
    np.testing.assert_allclose(
        torch_cpm.estimate_person_centers(torch.from_numpy(b), tcfg).numpy(),
        np.asarray(jax_cpm.estimate_person_centers(jnp.asarray(b), jcfg)),
        atol=1e-3)


# -- estimate_2d_from_images --------------------------------------------------

KNOBS = {
    "refine_center": dict(refine_center=True),
    "refine_scale": dict(refine_scale=True),
    "refine_scale_iters2": dict(refine_scale=True, scale_iters=2),
    "scale_from_refined": dict(refine_scale=True, scale_from_refined=True),
    "flip_tta": dict(flip_tta=True),
    "scale_tta": dict(scale_tta=(0.8, 1.25)),
    "flip_x_scale": dict(flip_tta=True, scale_tta=(0.8, 1.0, 1.25)),
    "flip_x_scale_refine_scale": dict(flip_tta=True, scale_tta=(0.8, 1.25),
                                      refine_scale=True),
    "letterbox_source_frame": dict(letterbox=True),
    "letterbox_network_frame": dict(letterbox=True, source_frame=False),
    "everything": dict(letterbox=True, refine_scale=True, flip_tta=True,
                       scale_tta=(0.8, 1.25), max_zoom=2.0,
                       scale_target_frac=0.7),
}


def _compare_2d(got, want, joint_tol=JOINT_TOL, hm_tol=HM_TOL):
    hm_j = np.asarray(want[0])
    scale = np.abs(hm_j).max()
    np.testing.assert_allclose(got[0].numpy(), hm_j, rtol=0,
                               atol=hm_tol * scale)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=joint_tol)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=hm_tol * scale)


@pytest.mark.parametrize("case", sorted(KNOBS))
def test_estimate_2d_knobs_match_jax(case):
    """Every knob and their compositions in float32: heatmaps and conf
    within 1e-4·max|b|, joints within 1e-2 px (non-square 80×60 input)."""
    jcfg, tcfg = _cfgs()
    kw = KNOBS[case]
    imgs = _smooth_images(2, 80, 60, seed=2)
    want = jax.jit(functools.partial(jax_cpm.estimate_2d_from_images,
                                     cfg=jcfg, **kw))(_params()[0],
                                                      jnp.asarray(imgs))
    with torch.no_grad():
        got = torch_cpm.estimate_2d_from_images(
            _port_cpm(tcfg), torch.from_numpy(imgs), tcfg, **kw)
    assert got[0].shape == (2, 8, 8, 15) and got[1].shape == (2, 14, 2)
    _compare_2d(got, want)


def test_estimate_2d_microbatched_with_knobs():
    """Micro-chunks of 2 over an uneven batch of 5 with the knobs on,
    against JAX's lax.map chunks."""
    jcfg, tcfg = _cfgs()
    kw = dict(letterbox=True, refine_scale=True, flip_tta=True,
              scale_tta=(0.8,))
    imgs = _smooth_images(5, 60, 80, seed=3)
    want = jax.jit(functools.partial(jax_cpm.estimate_2d_microbatched,
                                     cfg=jcfg, chunk=2, **kw))(
        _params()[0], jnp.asarray(imgs))
    with torch.no_grad():
        got = torch_cpm.estimate_2d_microbatched(
            _port_cpm(tcfg), torch.from_numpy(imgs), tcfg, chunk=2, **kw)
    _compare_2d(got, want)


def test_estimate_2d_bf16_front_end():
    """bf16 convs round at other places in the two frameworks: with flip
    and scale TTA the joints stay within one 8 px cell."""
    jcfg, tcfg = _cfgs("bfloat16")
    kw = dict(flip_tta=True, scale_tta=(0.8, 1.25))
    imgs = _smooth_images(2, 64, 64, seed=4)
    want = jax.jit(functools.partial(jax_cpm.estimate_2d_from_images,
                                     cfg=jcfg, **kw))(_params()[0],
                                                      jnp.asarray(imgs))
    with torch.no_grad():
        got = torch_cpm.estimate_2d_from_images(
            _port_cpm(tcfg), torch.from_numpy(imgs), tcfg, **kw)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=8)


@pytest.mark.parametrize("scale_tta", [(), (0.8, 1.25)])
def test_flip_tta_mirror_equivariance(scale_tta):
    """As tests/test_cpm.py holds for JAX: TTA(flip(img)) equals
    mirror(TTA(img)), the passes swapping roles (the centered zoom
    commutes with the mirror)."""
    _, tcfg = _cfgs()
    cpm = _port_cpm(tcfg)
    imgs = torch.from_numpy(np.random.RandomState(3).randint(
        0, 255, (2, 64, 64, 3)).astype(np.uint8))
    with torch.no_grad():
        _, j, c = torch_cpm.estimate_2d_from_images(
            cpm, imgs, tcfg, flip_tta=True, scale_tta=scale_tta)
        _, jf, cf = torch_cpm.estimate_2d_from_images(
            cpm, imgs.flip(2), tcfg, flip_tta=True, scale_tta=scale_tta)
    want = j.numpy().copy()
    want[..., 0] = tcfg.input_size - 1.0 - want[..., 0]
    np.testing.assert_allclose(jf.numpy(), want[:, CPM_FLIP_PERM], atol=1e-3)
    np.testing.assert_allclose(cf.numpy(), c.numpy()[:, CPM_FLIP_PERM],
                               atol=1e-5)


# -- PoseEstimator ------------------------------------------------------------

FRONT_END = dict(letterbox=True, refine_scale=True, flip_tta=True,
                 scale_tta=(0.8, 1.25))


def _fit_cfg(cfg_mod):
    return cfg_mod.FitConfig(
        stages=(cfg_mod.StageConfig(iters=20, lr=0.05, opt_pose=False,
                                    opt_shape=False, w_pose_prior=0,
                                    w_shape_prior=0, w_angle_prior=0),
                cfg_mod.StageConfig(iters=40, lr=0.02, w_pose_prior=0.5,
                                    w_shape_prior=1.0)), img_size=64)


@functools.lru_cache(maxsize=None)
def _estimators():
    jcfg, tcfg = _cfgs()
    jest = JaxEstimator(_params()[0], jax_data.synthetic_smpl(seed=0),
                        jax_priors.synthetic_gmm_prior(0), jcfg,
                        _fit_cfg(jc), **FRONT_END)
    smpl = {k: np.asarray(v) for k, v in jest.smpl_model._asdict().items()}
    prior = {k: np.asarray(getattr(jest.prior, k))
             for k in ("means", "precisions", "log_consts")}
    test = PoseEstimator.from_numpy(_params()[1], smpl, prior, tcfg,
                                    _fit_cfg(tc), device="cpu", **FRONT_END)
    return jest, test


def test_estimate_and_fit_front_end_matches_jax():
    """letterbox + refine_scale + flip + scale TTA, float32, through
    estimate_and_fit: source-pixel joints 1e-2 px, θ/β/cam 1e-3 after 60
    Adam steps, joints3d MPJPE ≤ 1 mm."""
    jest, test = _estimators()
    imgs = _smooth_images(2, 60, 80, seed=5)
    want = {k: np.asarray(v) for k, v in
            jest.estimate_and_fit(jnp.asarray(imgs))._asdict().items()}
    got = {k: v.detach().numpy()
           for k, v in test.estimate_and_fit(imgs)._asdict().items()}
    np.testing.assert_allclose(got["joints2d"], want["joints2d"], rtol=0,
                               atol=JOINT_TOL)
    for k in ("theta", "beta", "cam"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3,
                                   err_msg=k)
    np.testing.assert_allclose(got["energy"], want["energy"], rtol=1e-3)
    mpjpe = 1000.0 * np.linalg.norm(got["joints3d"] - want["joints3d"],
                                    axis=-1).mean()
    assert mpjpe <= 1.0


def test_estimate_2d_knobs_default_to_the_constructor():
    """estimate_2d's per-call knobs take the constructor's settings when
    None, and a per-call value overrides it (as tpu_pose/api.py)."""
    jest, test = _estimators()
    imgs = _smooth_images(2, 60, 80, seed=6)
    want = jest.estimate_2d(jnp.asarray(imgs))
    _compare_2d(test.estimate_2d(imgs), want)
    want = jest.estimate_2d(jnp.asarray(imgs), flip_tta=False,
                            scale_tta=(), letterbox=False)
    _compare_2d(test.estimate_2d(imgs, flip_tta=False, scale_tta=(),
                                 letterbox=False), want)


@pytest.mark.parametrize("bad", [(0.0,), (-1.0,), (16.0,), (0.8, 20.0)])
def test_scale_tta_validation(bad):
    """Factors outside (0, 16) fail at construction, as in JAX."""
    _, test = _estimators()
    with pytest.raises(ValueError, match="scale_tta"):
        PoseEstimator(test.cpm, test.smpl_model, test.prior, test.cpm_cfg,
                      test.fit_cfg, device="cpu", scale_tta=bad)
