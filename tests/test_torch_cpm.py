"""Port CPM vs the JAX package, with the JAX weights carried across:
every stage's beliefs, both trunk layouts, and estimate_2d_from_images."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pose.models import cpm as jax_cpm
from tpu_pose.ops import preprocess as jax_pre
from tpu_pose.utils import config as jax_config, tf_converter as jax_conv
from tpu_pose_torch.models import cpm as torch_cpm
from tpu_pose_torch.utils import config as torch_config
from tpu_pose_torch.utils import tf_converter as torch_conv
from torch_threads import one_thread

one_thread()

# tests/test_api.py's SMALL_CPM, in float32 so the comparison is of the
# algorithm rather than of where bf16 rounds.
SMALL = dict(input_size=64, features=16, stage1_head_width=32,
             refine_width=16, num_stages=3, compute_dtype="float32")


def _cfgs(**kw):
    return (jax_config.CPMConfig(**{**SMALL, **kw}),
            torch_config.CPMConfig(**{**SMALL, **kw}))


@functools.lru_cache(maxsize=None)
def _jax_params(share_trunk):
    # One JAX init per layer layout: the compute dtype does not change the
    # parameters, and each init compiles a program.
    return jax_cpm.init_cpm_params(
        jax.random.PRNGKey(0), _cfgs(share_trunk=share_trunk)[0])


def _carry(jcfg, tcfg):
    params = _jax_params(jcfg.share_trunk)
    np_params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                 for k, v in params.items()}
    return params, torch_cpm.cpm_params_from_numpy(np_params, tcfg, "cpu")


def _jax_estimate_2d(params, imgs, cfg):
    return jax.jit(functools.partial(jax_cpm.estimate_2d_from_images,
                                     cfg=cfg))(params, jnp.asarray(imgs))


def _images(b=2, h=64, w=64, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, h, w, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("share_trunk", [False, True])
def test_cpm_forward_every_stage_f32(share_trunk):
    """Float32: beliefs within 1e-4·max|b| (float32 conv sums over up to
    11·11·48 terms, accumulated in another order)."""
    jcfg, tcfg = _cfgs(share_trunk=share_trunk)
    params, cpm = _carry(jcfg, tcfg)
    x = np.stack([np.asarray(jax_pre.preprocess(jnp.asarray(i), 64))
                  for i in _images()])
    cm = np.broadcast_to(np.asarray(jax_pre.gaussian_center_map(64, 21.0)),
                         (2, 64, 64, 1))
    want = jax.jit(functools.partial(jax_cpm.cpm_forward, cfg=jcfg))(
        params, jnp.asarray(x), jnp.asarray(cm))
    with torch.no_grad():
        got = torch_cpm.cpm_forward(cpm, torch.from_numpy(x),
                                    torch.from_numpy(cm.copy()), tcfg)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (2, 8, 8, 15)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("hw", [(64, 64), (80, 60)])
def test_estimate_2d_from_images_f32(hw):
    """Raw uint8 images → heatmaps, joints (1e-2 px), conf."""
    jcfg, tcfg = _cfgs()
    params, cpm = _carry(jcfg, tcfg)
    imgs = _images(h=hw[0], w=hw[1], seed=2)
    hm_j, j_j, c_j = _jax_estimate_2d(params, imgs, jcfg)
    with torch.no_grad():
        hm_t, j_t, c_t = torch_cpm.estimate_2d_from_images(
            cpm, torch.from_numpy(imgs), tcfg)
    hm_j = np.asarray(hm_j)
    np.testing.assert_allclose(hm_t.numpy(), hm_j, rtol=0,
                               atol=1e-4 * np.abs(hm_j).max())
    np.testing.assert_allclose(j_t.numpy(), np.asarray(j_j), rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0,
                               atol=1e-4 * np.abs(hm_j).max())


def test_estimate_2d_bf16():
    """bf16 convs: both frameworks round activations to bf16 after every
    layer but accumulate and order the sums differently, so single
    activations can land one bf16 ulp (2^-8 relative) apart and that
    propagates through 14 layers. Bounds: heatmaps within 5% of max|b|,
    decoded joints within one heatmap cell (8 px)."""
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16")
    params, cpm = _carry(jcfg, tcfg)
    imgs = _images(seed=4)
    hm_j, j_j, _ = _jax_estimate_2d(params, imgs, jcfg)
    with torch.no_grad():
        hm_t, j_t, _ = torch_cpm.estimate_2d_from_images(
            cpm, torch.from_numpy(imgs), tcfg)
    hm_j = np.asarray(hm_j)
    np.testing.assert_allclose(hm_t.numpy(), hm_j, rtol=0,
                               atol=0.05 * np.abs(hm_j).max())
    np.testing.assert_allclose(j_t.numpy(), np.asarray(j_j), rtol=0, atol=8)


def test_unported_knobs_raise():
    """The front-end knobs that raised before they were ported now run
    through both entry points, and micro-chunks of 2 over an uneven batch
    give the whole batch's results (float32)."""
    _, tcfg = _cfgs()
    cpm = torch_cpm.CPM(tcfg)
    imgs = torch.from_numpy(_images(b=3))
    for kw in (dict(refine_center=True), dict(flip_tta=True),
               dict(letterbox=True), dict(scale_tta=(1.25,))):
        with torch.no_grad():
            whole = torch_cpm.estimate_2d_from_images(cpm, imgs, tcfg, **kw)
            chunked = torch_cpm.estimate_2d_microbatched(cpm, imgs, tcfg,
                                                         chunk=2, **kw)
        for w, c in zip(whole, chunked):
            torch.testing.assert_close(c, w, rtol=1e-5, atol=1e-5)


def test_params_npz_round_trip(tmp_path):
    """JAX save_params_npz → port load_params_npz → CPM → back to the same
    HWIO arrays; a wrong layer set or shape raises."""
    jcfg, tcfg = _cfgs()
    params, _ = _carry(jcfg, tcfg)
    path = str(tmp_path / "cpm.npz")
    jax_conv.save_params_npz(path, params)
    cpm = torch_cpm.cpm_params_from_numpy(torch_conv.load_params_npz(path),
                                          tcfg, "cpu")
    back = torch_cpm.cpm_params_to_numpy(cpm)
    assert set(back) == set(params)
    for k in params:
        np.testing.assert_array_equal(back[k]["w"], np.asarray(params[k]["w"]))
        np.testing.assert_array_equal(back[k]["b"], np.asarray(params[k]["b"]))
    torch_conv.save_params_npz(str(tmp_path / "again.npz"), back)
    again = jax_conv.load_params_npz(str(tmp_path / "again.npz"))
    np.testing.assert_array_equal(np.asarray(again["Mconv5_stage3"]["w"]),
                                  np.asarray(params["Mconv5_stage3"]["w"]))
    with pytest.raises(ValueError, match="missing"):
        torch_cpm.cpm_params_from_numpy(
            {k: v for k, v in back.items() if k != "conv1_stage1"}, tcfg,
            "cpu")
    bad = dict(back, conv1_stage1={"w": back["conv1_stage1"]["w"][:, :, :2],
                                   "b": back["conv1_stage1"]["b"]})
    with pytest.raises(ValueError, match="expected w"):
        torch_cpm.cpm_params_from_numpy(bad, tcfg, "cpu")
    with pytest.raises(ValueError, match="extra"):
        torch_cpm.cpm_params_from_numpy(
            back, dataclasses.replace(tcfg, num_stages=2), "cpu")
