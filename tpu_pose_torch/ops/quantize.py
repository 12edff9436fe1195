"""int8 serving-path arithmetic (port of ``tpu_pose/models/cpm.py``'s
``_quantize_act`` and the int8 half of ``_conv_q``).

Kernel B2 (``tpu_pose/ops/pallas_kernels.py:quantize_act_pallas``) has two
CUDA forms in ``csrc/quantize_act.cu``; their plain PyTorch versions are:

- :func:`act_scale` and :func:`quantize_act` — symmetric per-tensor int8
  activation quantization (the scale, then the int8 values);
- :func:`quantize_im2col` — the same quantization fused with the gather
  of one tile's im2col rows, which is how every conv with k > 1 gets its
  A operand.

:func:`int8_conv` is a SAME, stride-1 conv with int8 weights, accumulated
in int32: the JAX package leaves it to XLA's
``conv_general_dilated(preferred_element_type=int32)``; here it is im2col
plus ``torch._int_mm``, tiled over output rows, with the float epilogue
applied tile by tile. With a symbolic batch (an export with ``batch=None``)
the tiles cannot be cut from the batch: the batch is padded to a multiple
of a fixed group of images and a ``map`` runs the group's tiles over the
groups (:func:`_group_tiles`).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch
import torch.nn.functional as F

# Budget for one tile's temporaries (im2col rows, the int32 product and
# its float32 epilogue), whatever the batch: untiled, the 9×9×128 conv at
# 184² would need 16·184²·10368 B ≈ 5.6 GB of im2col at batch 16.
TILE_BYTES = 512 * 2 ** 20
# Most images in one group when the batch is symbolic: the static path's
# tile of whole images, capped so that a small batch is padded by few.
GROUP_IMAGES = 8


def act_scale(x: torch.Tensor, a_scale=None) -> torch.Tensor:
    """The 0-d float32 scale of ``x`` on ``x``'s device (no host sync):
    ``a_scale`` (a calibrated static scale) when given, else
    ``max(max|x| / 127, 1e-12)`` over the whole tensor (dynamic). The
    divisor 127 is a tensor on purpose: PyTorch's CUDA ``tensor / python
    scalar`` multiplies by the reciprocal instead."""
    if a_scale is not None:
        return torch.as_tensor(a_scale, dtype=torch.float32, device=x.device)
    amax = x.float().abs().amax()
    return torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8, in float32: a true
    division and a half-to-even round, as ``jnp.round``."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def quantize_act(x: torch.Tensor, a_scale=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(int8 values in x's shape, scale)``: ``q = clip(round(x /
    scale), -127, 127)`` elementwise with ``scale = act_scale(x,
    a_scale)``. float32 and bf16 inputs are computed in float32."""
    scale = act_scale(x, a_scale)
    return _quantize(x, scale), scale


def quantize_im2col(x: torch.Tensor, scale, k: int,
                    tile: Tuple[int, int, int, int],
                    out: torch.Tensor) -> torch.Tensor:
    """Fill ``out`` (m, K_pad) int8 with the im2col rows of one tile
    ``(b0, b1, h0, h1)`` of a SAME, stride-1 ``k×k`` conv's output rows
    over ``x`` (B, H, W, C), and return it: row ``((b - b0)·(h1 - h0) +
    h - h0)·W + w`` holds the window at output pixel (b, h, w), K ordered
    (kh, kw, c), positions outside the image 0 and columns K_real..K_pad
    0. ``x`` is float32 or bf16 and quantized with the 0-d ``scale`` as in
    :func:`quantize_act` (quantize(0) = 0, so the padding is the quantized
    padding), or int8 values taken as they are (``scale`` None).

    The plain version of the kernel behind
    ``ops/cuda_kernels.quantize_im2col_cuda``: quantize the rows the tile
    reads, pad them, and copy their ``unfold`` windows."""
    b0, b1, h0, h1 = tile
    h, w, c = x.shape[1:]
    p = k // 2
    lo, hi = max(h0 - p, 0), min(h1 + p, h)
    q = x[b0:b1, lo:hi]
    if x.dtype != torch.int8:
        q = _quantize(q, scale)
    q = F.pad(q, (0, 0, p, p, p - (h0 - lo), p - (hi - h1)))
    k_real = k * k * c
    win = q.unfold(1, k, 1).unfold(2, k, 1)     # (b, h, w, c, kh, kw)
    out[:, :k_real].view(b1 - b0, h1 - h0, w, k, k, c).copy_(
        win.permute(0, 1, 2, 4, 5, 3))
    out[:, k_real:].zero_()
    return out


def int8_gemm(a: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """``(M, K) int8 @ (K, N) int8 → (M, N) int32`` through
    ``torch._int_mm``. On CUDA that call refuses M ≤ 16 and a K or N that
    is not a multiple of 8 (it takes the right operand row- or
    column-major); K and N are padded when the weights are laid out
    (``models/cpm.QuantizedConv``), a short M is padded here, and any
    other shape raises before the call."""
    m, k = a.shape
    n = w_t.shape[1]
    if k % 8 or n % 8 or w_t.shape[0] != k:
        raise ValueError(
            f"int8_gemm takes (M, K) @ (K, N) with K and N multiples of 8; "
            f"got {tuple(a.shape)} @ {tuple(w_t.shape)}")
    if m <= 16:
        return torch._int_mm(F.pad(a, (0, 0, 0, 17 - m)), w_t)[:m]
    return torch._int_mm(a, w_t)


def _tiles(b: int, h: int, row_bytes: int
           ) -> Iterator[Tuple[int, int, int, int]]:
    """``(b0, b1, h0, h1)`` blocks of output rows whose temporaries stay
    within :data:`TILE_BYTES`: whole images while one fits, else runs of
    rows of one image."""
    per_image = h * row_bytes
    if per_image <= TILE_BYTES:
        n = max(1, TILE_BYTES // per_image)
        for b0 in range(0, b, n):
            yield b0, min(b, b0 + n), 0, h
        return
    rows = max(1, TILE_BYTES // row_bytes)
    for b0 in range(b):
        for h0 in range(0, h, rows):
            yield b0, b0 + 1, h0, min(h, h0 + rows)


def _group_tiles(h: int, row_bytes: int) -> tuple:
    """(images per group, the tiles of one group) for a symbolic batch:
    the images of the static path's whole-image tile, at most
    :data:`GROUP_IMAGES`, or one image cut into runs of rows when one
    image exceeds :data:`TILE_BYTES`."""
    g = max(1, min(GROUP_IMAGES, TILE_BYTES // (h * row_bytes)))
    return g, list(_tiles(g, h, row_bytes))


def int8_conv(x: torch.Tensor, w_t: torch.Tensor, k: int, n_out: int,
              epilogue, out_dtype: torch.dtype,
              a_scale: torch.Tensor | None = None,
              epilogue_args: tuple = ()) -> torch.Tensor:
    """SAME stride-1 ``k×k`` conv of ``x`` (B, H, W, C) with the im2col
    weights ``w_t`` (K_pad, N_pad) int8, K ordered (kh, kw, C). ``x`` is
    int8 values (``a_scale`` None), or float32/bf16 activations with the
    0-d scale ``a_scale`` of the whole tensor, which every tile quantizes
    as it gathers its rows (kernel B2's fused form,
    ``cuda_kernels.quantize_im2col_cuda``: no int8 copy of ``x`` and no
    padded copy is made). Any strides with a unit channel stride. Each
    tile's int32 product goes through ``epilogue(acc[:, :n_out],
    *epilogue_args)``; its float result is cast into the (B, H, W, n_out)
    ``out_dtype`` output, which is returned. A 1×1 conv of int8 values
    with K_pad = C needs no gather: the GEMM reads ``x`` as it is. A
    symbolic batch takes :func:`_int8_conv_grouped`."""
    from tpu_pose_torch.ops import cuda_kernels   # it imports this module
    b, h, w, c = x.shape
    k_real = k * k * c
    k_pad, n_pad = w_t.shape
    if not 0 <= k_pad - k_real < 8:
        raise ValueError(f"int8_conv: weights have K = {k_pad}, the input "
                         f"needs {k_real} (padded to a multiple of 8)")
    if (x.dtype == torch.int8) != (a_scale is None):
        raise ValueError(f"int8_conv takes int8 values without a scale or "
                         f"float activations with one; got {x.dtype} and "
                         f"a_scale={a_scale}")
    if isinstance(b, torch.SymInt):
        return _int8_conv_grouped(x, w_t, k, n_out, epilogue, out_dtype,
                                  a_scale, epilogue_args)
    out = torch.empty((b, h, w, n_out), dtype=out_dtype, device=x.device)
    direct = k == 1 and k_pad == c and a_scale is None
    buf = None
    for tile in _tiles(b, h, w * (k_pad + 8 * n_pad)):
        b0, b1, h0, h1 = tile
        m = (b1 - b0) * (h1 - h0) * w
        if direct:
            a = x[b0:b1, h0:h1].reshape(m, c)
        else:
            if buf is None:                     # the first tile is the largest
                buf = torch.empty((m, k_pad), dtype=torch.int8,
                                  device=x.device)
            a = cuda_kernels.quantize_im2col_cuda(x, a_scale, k, tile,
                                                  buf[:m])
        y = epilogue(int8_gemm(a, w_t)[:, :n_out], *epilogue_args)
        out[b0:b1, h0:h1].view(m, n_out).copy_(y)
    return out


def _int8_conv_grouped(x: torch.Tensor, w_t: torch.Tensor, k: int,
                       n_out: int, epilogue, out_dtype: torch.dtype,
                       a_scale: torch.Tensor | None = None,
                       epilogue_args: tuple = ()) -> torch.Tensor:
    """:func:`int8_conv` for any batch, symbolic included: the batch
    padded to a multiple of the group of :func:`_group_tiles` (the pad
    repeats the last image; its rows are dropped after), then one ``scan``
    step per group runs the group's tiles, each gathered by B2's
    functional form (``cuda_kernels.quantize_im2col_tile_cuda``: a loop
    body writes into no buffer of its caller). The GEMM is exact and the
    epilogue elementwise, so the output is :func:`int8_conv`'s, bit for
    bit. The scale was taken over the real images, before the pad.

    torch 2.11's eager ``scan`` runs its first step once more to learn the
    shapes of its outputs (later versions do not): there, an exported
    program computes the first group of each conv twice. (``map``, which
    does not, is traced as a ``scan`` by torch 2.13's export.)"""
    from torch._higher_order_ops.scan import scan_op
    from tpu_pose_torch.ops import cuda_kernels   # it imports this module
    b, h, w, c = x.shape
    k_pad, n_pad = w_t.shape
    g, tiles = _group_tiles(h, w * (k_pad + 8 * n_pad))
    direct = k == 1 and k_pad == c and a_scale is None
    n_groups = (b + g - 1) // g
    idx = torch.clamp(torch.arange(n_groups * g, device=x.device), max=b - 1)
    groups = x.index_select(0, idx).view(n_groups, g, h, w, c)
    scale = () if a_scale is None else (a_scale,)

    def body(done, xg, w_t, *rest):
        a_scale = rest[0] if scale else None
        args = rest[len(scale):]
        parts = []
        for tile in tiles:
            b0, b1, h0, h1 = tile
            m = (b1 - b0) * (h1 - h0) * w
            if direct:
                a = xg[b0:b1, h0:h1].reshape(m, c)
            else:
                a = cuda_kernels.quantize_im2col_tile_cuda(xg, a_scale, k,
                                                           tile, k_pad)
            y = epilogue(int8_gemm(a, w_t)[:, :n_out], *args)
            parts.append(y.to(out_dtype).view(b1 - b0, h1 - h0, w, n_out))
        # One tile of whole images, or one image's runs of rows.
        return done + 1, (parts[0] if len(parts) == 1
                          else torch.cat(parts, dim=1))

    done = torch.zeros((), dtype=torch.int64, device=x.device)
    _, y = scan_op(body, [done], [groups],
                   (w_t,) + scale + tuple(epilogue_args))
    # A gather of the b real images: a slice's length would be min(b, n·g)
    # and a narrow's bound b ≤ n·g, neither of which the tracer proves.
    return y.view(n_groups * g, h, w, n_out).index_select(
        0, torch.arange(b, device=x.device))
