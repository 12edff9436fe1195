"""int8 serving-path arithmetic (port of ``tpu_pose/models/cpm.py``'s
``_quantize_act`` and the int8 half of ``_conv_q``).

- :func:`quantize_act` — the plain PyTorch version of kernel B2
  (``tpu_pose/ops/pallas_kernels.py:quantize_act_pallas``; the CUDA kernel
  is ``csrc/quantize_act.cu``): symmetric per-tensor int8 activation
  quantization.
- :func:`int8_conv` — a SAME, stride-1 conv of an int8 NHWC tensor with
  int8 weights, accumulated in int32: the JAX package leaves it to XLA's
  ``conv_general_dilated(preferred_element_type=int32)``; here it is
  im2col plus ``torch._int_mm``, tiled over output rows, with the float
  epilogue applied tile by tile.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch
import torch.nn.functional as F

# Budget for one tile's temporaries (im2col rows, the int32 product and
# its float32 epilogue), whatever the batch: untiled, the 9×9×128 conv at
# 184² would need 16·184²·10368 B ≈ 5.6 GB of im2col at batch 16.
TILE_BYTES = 512 * 2 ** 20


def quantize_act(x: torch.Tensor, a_scale=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(int8 values, scale)``: ``q = clip(round(x / scale), -127, 127)``
    elementwise, in ``x``'s shape. ``scale`` is ``a_scale`` (a calibrated
    static scale) when given, else ``max(max|x| / 127, 1e-12)`` (dynamic).

    float32 and bf16 inputs are computed in float32. The division is a
    true division and the round is half to even, as ``jnp.round``; the
    scale stays a 0-d tensor on ``x``'s device (no host sync). The
    divisor 127 is a tensor on purpose: PyTorch's CUDA ``tensor / python
    scalar`` multiplies by the reciprocal instead."""
    x = x.float()
    if a_scale is None:
        amax = x.abs().amax()
        scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
    else:
        scale = torch.as_tensor(a_scale, dtype=torch.float32,
                                device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


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


def int8_conv(q: torch.Tensor, w_t: torch.Tensor, k: int, n_out: int,
              epilogue, out_dtype: torch.dtype) -> torch.Tensor:
    """SAME stride-1 ``k×k`` conv of ``q`` (B, H, W, C) int8 contiguous
    with the im2col weights ``w_t`` (K_pad, N_pad) int8, K ordered
    (kh, kw, C). Each tile's int32 product goes through
    ``epilogue(acc[:, :n_out])``; its float result is cast into the
    (B, H, W, n_out) ``out_dtype`` output, which is returned."""
    b, h, w, c = q.shape
    k_real = k * k * c
    k_pad, n_pad = w_t.shape
    if not 0 <= k_pad - k_real < 8:
        raise ValueError(f"int8_conv: weights have K = {k_pad}, the input "
                         f"needs {k_real} (padded to a multiple of 8)")
    out = torch.empty((b, h, w, n_out), dtype=out_dtype, device=q.device)
    direct = k == 1 and k_pad == c              # a 1×1 conv needs no im2col
    if not direct:
        p = k // 2
        q = F.pad(q, (0, 0, p, p, p, p))       # quantize(0) = 0
    buf = None
    for b0, b1, h0, h1 in _tiles(b, h, w * (k_pad + 8 * n_pad)):
        m = (b1 - b0) * (h1 - h0) * w
        if direct:
            a = q[b0:b1, h0:h1].reshape(m, c)
        else:
            if buf is None:                     # the first tile is the largest
                buf = torch.empty((m, k_pad), dtype=torch.int8,
                                  device=q.device)
                buf[:, k_real:].zero_()
            a = buf[:m]
            win = q[b0:b1, h0:h1 + k - 1].unfold(1, k, 1).unfold(2, k, 1)
            a[:, :k_real].view(b1 - b0, h1 - h0, w, k, k, c).copy_(
                win.permute(0, 1, 2, 4, 5, 3))
        y = epilogue(int8_gemm(a, w_t)[:, :n_out])
        out[b0:b1, h0:h1].view(m, n_out).copy_(y)
    return out
