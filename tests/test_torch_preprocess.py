"""Port preprocessing vs the JAX package: normalize, the antialiased
bilinear resize, the Gaussian center map and its 9×9/stride-8 SAME
average-pool downsample, on the same seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pose.ops import preprocess as jax_pre
from tpu_pose_torch.ops import preprocess as torch_pre
from torch_threads import one_thread

one_thread()


def _image(h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


def test_normalize_image():
    img = _image(37, 23)
    np.testing.assert_allclose(
        torch_pre.normalize_image(torch.from_numpy(img)).numpy(),
        np.asarray(jax_pre.normalize_image(jnp.asarray(img))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw,size", [((80, 60), 64), ((500, 400), 368),
                                     ((200, 300), 368), ((368, 368), 368)])
def test_resize_image_matches_jax(hw, size):
    """jax.image.resize(method="linear") antialiases when it scales down;
    the port applies the same triangle-kernel weights as two matmuls.
    Bound: 1e-3 in 0–255 units (float32 sums in another order; the
    weights are built in float64 here, in float32 by JAX)."""
    img = _image(*hw, seed=sum(hw))
    got = torch_pre.resize_image(torch.from_numpy(img)[None], size)[0]
    want = np.asarray(jax_pre.resize_image(jnp.asarray(img), size))
    assert got.shape == (size, size, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("letterbox", [False, True])
def test_preprocess_batch_matches_jax(letterbox):
    """A batch through the square resize or the letterbox (fill 128),
    normalized: within 1e-3/256 of JAX's per-image preprocess."""
    imgs = np.stack([_image(80, 60, seed=s) for s in range(2)])
    got = torch_pre.preprocess(torch.from_numpy(imgs), 64,
                               letterbox=letterbox).numpy()
    want = np.stack([np.asarray(jax_pre.preprocess(
        jnp.asarray(i), 64, letterbox=letterbox)) for i in imgs])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 / 256)


@pytest.mark.parametrize("size,center", [(368, None), (64, None),
                                         (64, (20.0, 41.5))])
def test_gaussian_center_map(size, center):
    got = torch_pre.gaussian_center_map(size, 21.0, center=center).numpy()
    want = np.asarray(jax_pre.gaussian_center_map(
        size, 21.0, None if center is None else jnp.asarray(center)))
    assert got.shape == (size, size, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [368, 64, 61])
def test_downsample_center_map(size):
    """SAME pads 0 before / 1 after at 368 and 64 (1/1 at the odd 61) and
    always divides by 81."""
    cm = np.random.RandomState(size).rand(2, size, size, 1).astype(np.float32)
    got = torch_pre.downsample_center_map(torch.from_numpy(cm), 8).numpy()
    want = np.asarray(jax_pre.downsample_center_map(jnp.asarray(cm), 8))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
