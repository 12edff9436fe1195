"""The port's host letterbox: ops/preprocess.letterbox_image_np and its
twins against the JAX package's numpy path bit for bit, and the native
C++ letterbox (tpu_pose_torch/native) within 1 uint8 LSB of it."""

import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

import tpu_pose.native as jax_native
from tpu_pose.ops import preprocess as jax_pre
from tpu_pose_torch import native
from tpu_pose_torch.ops import preprocess as pre

SHAPES = [
    (720, 540),    # downscale, portrait
    (480, 640),    # downscale, landscape
    (100, 200),    # mild downscale, wide
    (64, 64),      # upscale, square (no pad)
    (800, 100),    # thin vertical strip
    (400, 368),    # one axis lands on the network size
    (1, 37),       # one pixel tall
    (53, 1),       # one pixel wide
]


@pytest.fixture
def numpy_path(monkeypatch):
    """Both packages' letterbox_image_np with the native path declined,
    so the numpy paths run."""
    monkeypatch.setattr(native, "letterbox_u8", lambda *a, **k: None)
    monkeypatch.setattr(jax_native, "letterbox_u8", lambda *a, **k: None)


@pytest.fixture(scope="module")
def built():
    """The native library, built here; skipped only without g++ (where
    the numpy path serves), never for a failing build."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native letterbox cannot be built here")
    assert native.available(), "g++ is present but the build failed"


def _img(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, shape + (3,))
    return img.astype(np.uint8) if dtype == "uint8" else (
        img + rng.rand(*shape, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("size", [368, 64])
def test_letterbox_image_np_matches_jax(numpy_path, size, dtype):
    """Float and uint8, upscale and downscale, 1-pixel frames: the numpy
    path is bit-equal to JAX's, the affine too, the dtype kept."""
    for shape in SHAPES:
        img = _img(shape, dtype, seed=shape[0])
        got, aff = pre.letterbox_image_np(img, size, fill=77.0)
        want, jaff = jax_pre.letterbox_image_np(img, size, fill=77.0)
        assert got.dtype == img.dtype and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want, err_msg=str(shape))
        np.testing.assert_array_equal(
            pre.letterbox_numpy(img, size, fill=77.0), want)
        np.testing.assert_array_equal(aff, jaff)


def test_resample_plan_and_resize_match_jax():
    for n_in, n_out in [(480, 368), (200, 245), (1, 368), (640, 276),
                        (7, 3)]:
        for a, b in zip(pre._resample_weights_np(n_in, n_out),
                        jax_pre._resample_weights_np(n_in, n_out)):
            np.testing.assert_array_equal(a, b)
    img = _img((45, 70), "float32")
    np.testing.assert_array_equal(pre.resize_bilinear_np(img, 30, 91),
                                  jax_pre.resize_bilinear_np(img, 30, 91))


@pytest.mark.parametrize("shape", SHAPES)
def test_native_within_1lsb_of_numpy(built, shape):
    img = _img(shape, "uint8", seed=sum(shape))
    out = native.letterbox_u8(img, 368)
    if pre._letterbox_geometry(*shape, 368)[:2] == shape:
        assert out is None  # identity geometry: the numpy path pads
        return
    assert out is not None and out.shape == (368, 368, 3)
    ref = pre.letterbox_numpy(img, 368)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_letterbox_image_np_routes_uint8_through_native(built):
    img = _img((480, 640), "uint8")
    out, aff = pre.letterbox_image_np(img, 368)
    np.testing.assert_array_equal(out, native.letterbox_u8(img, 368))
    np.testing.assert_array_equal(aff, pre.letterbox_affine(480, 640, 368))
    assert native.letterbox_u8(img.astype(np.float32), 368) is None


def test_fill_value_in_pad_region(built):
    img = np.zeros((100, 400, 3), np.uint8)  # wide: top and bottom pad
    out = native.letterbox_u8(img, 368, fill=77)
    nh, _, off_y, _ = pre._letterbox_geometry(100, 400, 368)
    assert (out[:off_y] == 77).all() and (out[off_y + nh:] == 77).all()
    assert (out[off_y:off_y + nh] == 0).all()


def test_concurrent_clients_threadsafe(built):
    img = _img((480, 640), "uint8", seed=2)
    expect = native.letterbox_u8(img, 368)
    with ThreadPoolExecutor(max_workers=4) as pool:
        outs = list(pool.map(lambda _: native.letterbox_u8(img, 368),
                             range(16)))
    for o in outs:
        np.testing.assert_array_equal(o, expect)


def test_build_lands_outside_the_package(built):
    """The library goes to build/tpu_pose_torch/ at the checkout's root,
    named by the source's and flags' hash; nothing is written into the
    package."""
    package = Path(native.__file__).resolve().parent.parent
    lib = native.library_path()
    assert lib.exists()
    assert lib.parent == package.parent / "build" / "tpu_pose_torch"
    assert lib.name.startswith("libletterbox-")
    assert not list(package.rglob("*.so"))
