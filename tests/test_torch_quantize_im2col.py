"""Kernel B2's fused form, ``quantize_im2col``, against the JAX package:
its plain version gives the im2col rows of JAX's ``_quantize_act`` output
bit for bit, ``int8_conv`` through it gives XLA's int32 conv sums, the
dynamic scale is the whole tensor's, and the int8 forward gathers once per
tile. Inputs are made with numpy from a seed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pose.models import cpm as jax_cpm
from tpu_pose_torch.models import cpm as torch_cpm
from tpu_pose_torch.ops import cuda_kernels
from tpu_pose_torch.ops import quantize as quant_lib
from tpu_pose_torch.utils import config as tc
from torch_threads import one_thread

one_thread()

KS = [1, 5, 9, 11]
CS = [3, 32, 48]


def _x(c, seed, b=2, h=7, w=9):
    """(B, H, W, C) float32 activations, odd H and W."""
    return (np.random.RandomState(seed).randn(b, h, w, c) * 2).astype(
        np.float32)


def _k_pad(k, c):
    return -(-k * k * c // 8) * 8


def _numpy_im2col(q, k, k_pad):
    """(B·H·W, K_pad) int8 rows of a SAME k×k window over int8 ``q``,
    K ordered (kh, kw, c), zero columns after K_real."""
    b, h, w, c = q.shape
    p = k // 2
    padded = np.pad(q, ((0, 0), (p, p), (p, p), (0, 0)))
    win = np.lib.stride_tricks.sliding_window_view(padded, (k, k),
                                                   axis=(1, 2))
    rows = win.transpose(0, 1, 2, 4, 5, 3).reshape(b, h, w, k * k * c)
    out = np.zeros((b, h, w, k_pad), np.int8)
    out[..., :k * k * c] = rows
    return out


def _tile_budgets(b, h, w, row_bytes):
    """TILE_BYTES values that give one tile, one image per tile, and
    runs of two rows of one image."""
    return [2 ** 40, h * w * row_bytes, 2 * w * row_bytes]


@pytest.mark.parametrize("scales", ["static", "dynamic"])
@pytest.mark.parametrize("c", CS)
@pytest.mark.parametrize("k", KS)
def test_quantize_im2col_matches_jax(monkeypatch, k, c, scales):
    """Every tile's rows equal numpy's im2col of JAX's _quantize_act
    output (eager, so it divides), for whole-batch tiles, whole-image
    tiles and tiles of two rows; the scale is JAX's."""
    x = _x(c, 10 * k + c)
    a_scale = np.float32(0.05) if scales == "static" else None
    jq, js = jax_cpm._quantize_act(jnp.asarray(x), None if a_scale is None
                                   else jnp.asarray(a_scale))
    tx = torch.from_numpy(x)
    scale = quant_lib.act_scale(tx, None if a_scale is None
                                else torch.tensor(a_scale))
    assert scale.item() == float(js)
    k_pad = _k_pad(k, c)
    want = _numpy_im2col(np.asarray(jq), k, k_pad)
    b, h, w, _ = x.shape
    seen = set()
    for budget in _tile_budgets(b, h, w, k_pad):
        monkeypatch.setattr(quant_lib, "TILE_BYTES", budget)
        tiles = list(quant_lib._tiles(b, h, w * k_pad))
        seen.add(len(tiles))
        for b0, b1, h0, h1 in tiles:
            out = torch.full(((b1 - b0) * (h1 - h0) * w, k_pad), 7,
                             dtype=torch.int8)
            got = quant_lib.quantize_im2col(tx, scale, k, (b0, b1, h0, h1),
                                            out)
            assert got is out
            np.testing.assert_array_equal(
                got.numpy(), want[b0:b1, h0:h1].reshape(-1, k_pad))
    assert seen == {1, b, b * -(-h // 2)}


def test_quantize_im2col_bf16_and_int8_inputs():
    """bf16 activations quantize in float32 like JAX's
    ``_quantize_act(x.astype(float32))``; int8 input is gathered as it
    is, with no scale."""
    x = _x(32, 3)
    xb = torch.from_numpy(x).bfloat16()
    scale = quant_lib.act_scale(xb)
    jq, js = jax_cpm._quantize_act(
        jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32), None)
    assert scale.item() == float(js)
    out = torch.empty(2 * 7 * 9, 9 * 9 * 32, dtype=torch.int8)
    quant_lib.quantize_im2col(xb, scale, 9, (0, 2, 0, 7), out)
    want = _numpy_im2col(np.asarray(jq), 9, 9 * 9 * 32).reshape(-1, 2592)
    np.testing.assert_array_equal(out.numpy(), want)
    q = torch.from_numpy(np.asarray(jq))
    out2 = torch.empty_like(out)
    quant_lib.quantize_im2col(q, None, 9, (0, 2, 0, 7), out2)
    assert torch.equal(out2, out)


def _jax_int32_conv(jq, w_hwio):
    return np.asarray(jax.lax.conv_general_dilated(
        jq, jnp.asarray(w_hwio), window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("scales", ["static", "dynamic"])
@pytest.mark.parametrize("c", CS)
@pytest.mark.parametrize("k", KS)
def test_int8_conv_matches_jax_conv(monkeypatch, k, c, scales):
    """int8_conv on float activations and the whole tensor's scale (the
    fused route; a 1×1 conv quantizes first, as _conv_q does) gives the
    int32 sums of XLA's conv on JAX's quantized input, tiled into runs of
    two rows."""
    x = _x(c, 100 + 10 * k + c)
    n = 16
    w = np.random.RandomState(k + c).randint(-127, 128, (k, k, c, n)).astype(
        np.int8)
    layer = torch_cpm.QuantizedConv(k, c, n)
    layer.set_weights(torch.from_numpy(w), torch.ones(n), torch.zeros(n))
    a_scale = np.float32(0.05) if scales == "static" else None
    jq, _ = jax_cpm._quantize_act(jnp.asarray(x), None if a_scale is None
                                  else jnp.asarray(a_scale))
    want = _jax_int32_conv(jq, w)
    monkeypatch.setattr(quant_lib, "TILE_BYTES",
                        2 * 9 * (_k_pad(k, c) + 8 * n))
    tx = torch.from_numpy(x)
    scale = quant_lib.act_scale(tx, None if a_scale is None
                                else torch.tensor(a_scale))
    if k == 1 and c % 8 == 0:
        tx, scale = quant_lib.quantize_act(tx, scale)[0], None
    got = quant_lib.int8_conv(tx, layer.w_int8.t(), k, n,
                              lambda acc: acc.double(), torch.float64, scale)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float64))


def test_dynamic_scale_is_the_whole_tensors(monkeypatch):
    """With a dynamic scale, a one-image tile whose own max|x| is far
    below the tensor's still quantizes with the whole tensor's scale: the
    int8 conv equals JAX's _conv_q at that scale, bit for bit, and a
    per-tile scale would have given other int8 rows."""
    x = _x(16, 7, b=3)
    x[2, 3, 4, 5] = 40.0                      # the max lies in image 2 only
    k, c, n = 5, 16, 8
    rng = np.random.RandomState(8)
    w = rng.randint(-127, 128, (k, k, c, n)).astype(np.int8)
    layer = torch_cpm.QuantizedConv(k, c, n)
    # Zero biases: XLA may fuse the epilogue's multiply-add, which is only
    # bit-equal to two roundings when the addend is 0.
    layer.set_weights(torch.from_numpy(w),
                      torch.from_numpy(rng.rand(n).astype(np.float32)),
                      torch.zeros(n))
    assert layer.a_scale is None
    monkeypatch.setattr(quant_lib, "TILE_BYTES", 7 * 9 * (400 + 64))
    tiles = list(quant_lib._tiles(3, 7, 9 * (400 + 64)))
    assert tiles == [(0, 1, 0, 7), (1, 2, 0, 7), (2, 3, 0, 7)]
    _, js = jax_cpm._quantize_act(jnp.asarray(x), None)
    jp = {"w_int8": jnp.asarray(w), "w_scale": jnp.asarray(layer.w_scale),
          "b": jnp.asarray(layer.b), "a_scale": js}
    want = np.asarray(jax.jit(functools.partial(
        jax_cpm._conv_q, relu=True, act_dtype=jnp.float32))(
            jnp.asarray(x), jp))
    got = torch_cpm._conv_q(torch.from_numpy(x).permute(0, 3, 1, 2), layer,
                            True, torch.float32)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    tx = torch.from_numpy(x)
    whole = torch.empty(63, 400, dtype=torch.int8)
    own = torch.empty_like(whole)
    quant_lib.quantize_im2col(tx, quant_lib.act_scale(tx), k, tiles[0], whole)
    quant_lib.quantize_im2col(tx, quant_lib.act_scale(tx[:1]), k, tiles[0],
                              own)
    assert not torch.equal(whole, own)


SMALL = dict(input_size=64, features=16, stage1_head_width=32,
             refine_width=16, num_stages=3, compute_dtype="bfloat16")


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_int8_forward_gathers_once_per_tile(monkeypatch, scales):
    """Through the int8 CPM forward: every conv with k > 1 reaches the
    fused gather once per tile of _tiles, with the float activation (an
    NHWC view with unit channel stride: no copy before the gather) and
    the whole input's scale; 1×1 convs go to the standalone quantizer and
    are never gathered."""
    cfg = tc.CPMConfig(**SMALL)
    cpm = torch_cpm.init_cpm_params(0, cfg, device="cpu")
    x = torch.from_numpy(_x(3, 9, b=2, h=64, w=64) * np.float32(0.2))
    # Broadcast over the batch, as the estimator passes it.
    cm = torch.rand(1, 64, 64, 1, generator=torch.Generator().manual_seed(0)
                    ).expand(2, 64, 64, 1)
    scales_ = (torch_cpm.calibrate_act_scales(cpm, x, cm, cfg)
               if scales == "static" else None)
    qcpm = torch_cpm.quantize_params(cpm, scales_)
    monkeypatch.setattr(quant_lib, "TILE_BYTES", 2 ** 16)
    gathers, quantized, inputs = [], [], {}
    real_gather = cuda_kernels.quantize_im2col_cuda
    real_quantize = cuda_kernels.quantize_act_cuda

    def gather(xh, scale, k, tile, out):
        gathers.append((xh.shape, k, tile))
        assert xh.dtype != torch.int8 and xh.stride(3) == 1
        assert xh.is_contiguous()            # NHWC memory, read in place
        assert scale.item() == quant_lib.act_scale(xh).item() \
            if scales == "dynamic" else scale.dim() == 0
        return real_gather(xh, scale, k, tile, out)

    def quantize(xh, a_scale=None):
        quantized.append(xh.shape)
        return real_quantize(xh, a_scale)

    monkeypatch.setattr(cuda_kernels, "quantize_im2col_cuda", gather)
    monkeypatch.setattr(cuda_kernels, "quantize_act_cuda", quantize)
    with torch.no_grad():
        torch_cpm.cpm_forward(qcpm, x, cm, cfg, on_conv_input=lambda n, h:
                              inputs.update({n: tuple(h.shape)}))
    want_gathers, want_quantized = [], 0
    for name, layer in qcpm.named_children():
        b, c, h, w = inputs[name]
        if layer.kernel_size == 1:
            want_quantized += 1
            continue
        n_pad, k_pad = layer.w_int8.shape
        for tile in quant_lib._tiles(b, h, w * (k_pad + 8 * n_pad)):
            want_gathers.append(((b, h, w, c), layer.kernel_size, tile))
    assert [(tuple(s), k, t) for s, k, t in gathers] == want_gathers
    assert len(quantized) == want_quantized == 6
    assert len(want_gathers) > len(qcpm._modules) - 6   # some convs split
