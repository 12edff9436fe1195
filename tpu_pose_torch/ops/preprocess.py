"""Image preprocessing (port of ``tpu_pose/ops/preprocess.py``): resize
or letterbox → x/256 − 0.5, the letterbox's frame maps, the Gaussian
person-center map with its 9×9/stride-8 average-pool downsample, and the
bilinear sampler of ``jax.scipy.ndimage.map_coordinates``.

Images are NHWC, batched over a leading axis: ``(B, H, W, 3)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """CPM input normalization: x/256 − 0.5. Accepts uint8 or float32 in
    [0, 255]."""
    return img.to(torch.float32) / 256.0 - 0.5


@functools.lru_cache(maxsize=64)
def _resize_weights_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) triangle-kernel resampling matrix of
    ``jax.image.resize(method="linear")`` (its ``compute_weight_mat``):
    half-pixel-center sampling, the kernel widened by 1/scale when
    downscaling (antialiasing), columns renormalized, samples outside the
    input zeroed. Computed in float32 in XLA's order of operations: the
    sample coordinates round at float32 resolution (~3e-5 at 500 px), so
    float64 weights would differ from JAX's by that much. JAX takes the
    scale as a Python float and inverts it in float64 before rounding to
    float32. XLA fuses the coordinate's multiply and subtract into one FMA
    (one rounding); the float64 product of two float32 values is exact,
    so rounding ``(i + 0.5)·s − 0.5`` from float64 once reproduces it."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float64) + 0.5)
                * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :]
               - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)                # (n_in, n_out)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, f32(0.0))
    return np.ascontiguousarray(w.T.astype(f32))          # (n_out, n_in)


def resize_image(img: torch.Tensor, size) -> torch.Tensor:
    """(..., H, W, C) → (..., nh, nw, C) float32, bilinear with
    ``jax.image.resize``'s antialiasing, as two small matmuls (one per
    axis). ``size`` is ``nh = nw`` or ``(nh, nw)``. Cast only when the
    image already has the target size."""
    nh, nw = (size, size) if isinstance(size, int) else size
    img = img.to(torch.float32)
    h, w = img.shape[-3], img.shape[-2]
    if h == nh and w == nw:
        return img
    wy = torch.as_tensor(_resize_weights_np(h, nh), device=img.device)
    wx = torch.as_tensor(_resize_weights_np(w, nw), device=img.device)
    out = torch.einsum("oh,...hwc->...owc", wy, img)
    # einsum leaves the axes permuted in memory; the CPM's convs (and the
    # int8 path's gather) read NHWC memory.
    return torch.einsum("pw,...owc->...opc", wx, out).contiguous()


def preprocess(img: torch.Tensor, size: int = 368,
               letterbox: bool = False, fill: float = 128.0) -> torch.Tensor:
    """Input pipeline: resize (or letterbox) → normalize. ``(..., H, W,
    3)`` → ``(..., size, size, 3)`` float32 NHWC memory.

    ``letterbox=False`` resizes straight to the square, which distorts a
    non-square input (the person is assumed centered). ``letterbox=True``
    scales to fit, keeping the aspect, and pads the rest with ``fill``;
    :func:`letterbox_affine` and :func:`joints_to_source_frame` map
    decoded joints back to source pixels."""
    if letterbox:
        return normalize_image(letterbox_image(img, size, fill=fill))
    return normalize_image(resize_image(img, size))


# -- aspect-preserving letterbox (resize → pad) -----------------------------

def _letterbox_geometry(h0: int, w0: int, size: int):
    """(new_h, new_w, off_y, off_x) for scale-to-fit + centered pad, from
    the static shapes."""
    scale = size / max(h0, w0)
    nh = max(1, min(size, round(h0 * scale)))
    nw = max(1, min(size, round(w0 * scale)))
    return nh, nw, (size - nh) // 2, (size - nw) // 2


def letterbox_affine(h0: int, w0: int, size: int) -> np.ndarray:
    """Affine mapping source pixels → network pixels for the letterbox,
    ``net = src * scale + offset``, as ``[sx, sy, ox, oy]`` float32 on the
    host. The offsets fold in the resize's half-pixel-center convention
    (output pixel i samples input coordinate (i + 0.5)/s − 0.5), so image
    content round-trips source → net → source to sub-pixel accuracy."""
    nh, nw, off_y, off_x = _letterbox_geometry(h0, w0, size)
    sx, sy = nw / w0, nh / h0
    return np.array([sx, sy,
                     off_x + 0.5 * sx - 0.5,
                     off_y + 0.5 * sy - 0.5], np.float32)


def letterbox_image(img: torch.Tensor, size: int,
                    fill: float = 128.0) -> torch.Tensor:
    """Aspect-preserving resize + centered constant pad: ``(..., H, W,
    C)`` → ``(..., size, size, C)`` float32 in [0, 255], NHWC memory."""
    h0, w0, c = img.shape[-3:]
    nh, nw, off_y, off_x = _letterbox_geometry(h0, w0, size)
    r = resize_image(img, (nh, nw))
    if (nh, nw) == (size, size):
        return r
    out = torch.full((*img.shape[:-3], size, size, c), float(fill),
                     dtype=torch.float32, device=img.device)
    out[..., off_y:off_y + nh, off_x:off_x + nw, :] = r
    return out


# -- host twins for the serving front end ------------------------------------

def _resample_weights_np(n_in: int, n_out: int):
    """Separable triangle-kernel resampling plan, (idx (n_out, k) int64,
    w (n_out, k) float32), with ``jax.image.resize(method="linear")``'s
    conventions: half-pixel-center sampling, the kernel widened by
    1/scale when downscaling, weights renormalized at the borders. The
    JAX package's host plan, in float64 throughout (``scale`` included),
    so both packages' host letterboxes agree bit for bit; the native
    letterbox takes its plan from here."""
    scale = n_out / n_in
    support = max(1.0, 1.0 / scale)           # triangle half-width (input px)
    k = int(np.ceil(2.0 * support)) + 1
    coords = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    left = np.floor(coords - support).astype(np.int64) + 1
    idx = left[:, None] + np.arange(k)[None, :]
    dist = (idx - coords[:, None]) * min(scale, 1.0)
    w = np.clip(1.0 - np.abs(dist), 0.0, None)
    valid = (idx >= 0) & (idx < n_in)
    w = np.where(valid, w, 0.0)
    idx = np.clip(idx, 0, n_in - 1)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return idx, w.astype(np.float32)


def resize_bilinear_np(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """(H, W, C) → (nh, nw, C) float32 on the host, by the plan of
    :func:`_resample_weights_np` (a gather and a weighted sum per axis)."""
    x = np.asarray(img, np.float32)
    iy, wy = _resample_weights_np(x.shape[0], nh)
    ix, wx = _resample_weights_np(x.shape[1], nw)
    x = np.einsum("okwc,ok->owc", x[iy], wy)       # rows
    x = np.einsum("hokc,ok->hoc", x[:, ix], wx)    # cols
    return x


def letterbox_image_np(img: np.ndarray, size: int, fill: float = 128.0):
    """Host letterbox of one (H, W, C) frame, for the server's per-request
    preprocessing (mixed resolutions letterbox at submit time, so a batch
    has one shape on the device). Returns ``(net_image, affine)``:
    ``net_image`` (size, size, C) in the input's dtype family (uint8
    stays uint8, a quarter of float32's bytes to the device) and
    ``affine`` the :func:`letterbox_affine` source → network map.

    A uint8 frame goes through the native letterbox
    (``tpu_pose_torch/native``: the same plan, within 1 LSB of the numpy
    path, and it releases the GIL) when that is built; otherwise, and for
    other dtypes, the numpy path below runs."""
    img = np.asarray(img)
    affine = letterbox_affine(img.shape[0], img.shape[1], size)
    if img.dtype == np.uint8:
        from tpu_pose_torch import native
        out = native.letterbox_u8(img, size, fill=int(fill))
        if out is not None:
            return out, affine
    return letterbox_numpy(img, size, fill), affine


def letterbox_numpy(img: np.ndarray, size: int,
                    fill: float = 128.0) -> np.ndarray:
    """The numpy path of :func:`letterbox_image_np` (the JAX package's,
    bit for bit): the frame alone, whatever its dtype, never native."""
    h0, w0, c = img.shape
    nh, nw, off_y, off_x = _letterbox_geometry(h0, w0, size)
    r = (resize_bilinear_np(img, nh, nw) if (nh, nw) != (h0, w0)
         else np.asarray(img, np.float32))
    if (nh, nw) == (size, size):
        out = r
    else:
        out = np.full((size, size, c), np.float32(fill))
        out[off_y:off_y + nh, off_x:off_x + nw] = r
    if img.dtype == np.uint8:
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out


def _affine_floats(affine):
    return [float(v) for v in np.asarray(affine, np.float32)]


def joints_to_source_frame(joints_net: torch.Tensor,
                           affine) -> torch.Tensor:
    """Map (..., P, 2) network-frame pixel joints back to source-image
    pixels through a :func:`letterbox_affine` (inverse affine). The
    affine's values enter as scalars: no host → device copy."""
    sx, sy, ox, oy = _affine_floats(affine)
    return torch.stack([(joints_net[..., 0] - ox) / sx,
                        (joints_net[..., 1] - oy) / sy], dim=-1)


def joints_to_network_frame(joints_src: torch.Tensor,
                            affine) -> torch.Tensor:
    """Map source-image pixel joints into the letterboxed network frame
    (forward affine)."""
    sx, sy, ox, oy = _affine_floats(affine)
    return torch.stack([joints_src[..., 0] * sx + ox,
                        joints_src[..., 1] * sy + oy], dim=-1)


def gaussian_center_map(size: int = 368, sigma: float = 21.0,
                        center=None, device=None) -> torch.Tensor:
    """(size, size, 1) Gaussian centered at ``center`` (x, y) (default:
    the image center) — the CPM person-centering hint."""
    if center is None:
        center = ((size - 1) / 2.0, (size - 1) / 2.0)
    ys = torch.arange(size, dtype=torch.float32, device=device)
    xs = torch.arange(size, dtype=torch.float32, device=device)
    dy = (ys - center[1])[:, None]
    dx = (xs - center[0])[None, :]
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    return g[..., None]


def gaussian_center_maps(size: int, sigma: float,
                         centers: torch.Tensor) -> torch.Tensor:
    """Per-image hints: ``centers`` (B, 2) (x, y) on the device →
    (B, size, size, 1), each :func:`gaussian_center_map` at its center."""
    grid = torch.arange(size, dtype=torch.float32, device=centers.device)
    dy = (grid[None, :] - centers[:, 1:2])[:, :, None]
    dx = (grid[None, :] - centers[:, 0:1])[:, None, :]
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    return g[..., None]


def map_coordinates_linear(img: torch.Tensor, ys: torch.Tensor,
                           xs: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.ndimage.map_coordinates(order=1, mode="nearest")`` of
    each channel, batched: ``img`` (N, H, W, C) sampled at (N, ...)
    coordinates ``ys`` (rows), ``xs`` (cols) → (N, ..., C). JAX's
    arithmetic in float32: floor each coordinate, weights (1 − f, f), tap
    indices clamped to [0, n − 1], the four taps' (w_y·w_x)·value summed
    in JAX's order."""
    n, h, w, c = img.shape
    flat = img.reshape(n, h * w, c)

    def nodes(coord, size):
        lo = torch.floor(coord)
        upper = coord - lo
        i = lo.to(torch.int64)
        return [(i.clamp(0, size - 1), 1 - upper),
                (torch.clamp(i + 1, 0, size - 1), upper)]

    out = None
    for (iy, wy) in nodes(ys, h):
        for (ix, wx) in nodes(xs, w):
            idx = (iy * w + ix).reshape(n, -1, 1).expand(-1, -1, c)
            tap = flat.gather(1, idx).reshape(*ys.shape, c)
            term = (wy * wx)[..., None] * tap
            out = term if out is None else out + term
    return out


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """(before, after) padding of a SAME window: output ceil(n/s), the
    extra element going after (XLA's convention)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def downsample_center_map(cmap: torch.Tensor, stride: int = 8
                          ) -> torch.Tensor:
    """Average-pool the full-res center map to belief-map resolution (the
    Caffe ``pool_center_lower`` 9×9/stride-8 SAME pool, always ÷81 — the
    padding counts as zeros). ``(..., H, W, 1)`` → ``(..., h, w, 1)``."""
    lead = cmap.shape[:-3]
    h, w = cmap.shape[-3], cmap.shape[-2]
    # One batch axis needs no reshape (and a traced symbolic batch then
    # needs no guard on the expanded map's strides).
    batched = len(lead) == 1
    x = (cmap if batched else cmap.reshape(-1, h, w, 1)).permute(0, 3, 1, 2)
    py, px = same_padding(h, 9, stride), same_padding(w, 9, stride)
    x = F.pad(x, (px[0], px[1], py[0], py[1]))
    y = F.avg_pool2d(x, 9, stride, divisor_override=81).permute(0, 2, 3, 1)
    return y if batched else y.reshape(*lead, *y.shape[1:])


def paint_heatmaps(joints_px: torch.Tensor, size: int, stride: int,
                   sigma_px: float, num_channels: int) -> torch.Tensor:
    """Ground-truth belief maps from joint pixels (training and tests):
    one Gaussian per part at heatmap resolution (cell-corner grid,
    x = col·stride), zero maps up to ``num_channels − 1``, then the
    background channel 1 − max over the parts.

    joints_px: (P, 2) in input-pixel coords. Returns (H, H, num_channels)
    float32 on ``joints_px``'s device."""
    joints_px = torch.as_tensor(joints_px, dtype=torch.float32)
    hm = size // stride
    grid = torch.arange(hm, dtype=torch.float32,
                        device=joints_px.device) * stride
    dy = grid[:, None, None] - joints_px[None, None, :, 1]   # (hm, 1, P)
    dx = grid[None, :, None] - joints_px[None, None, :, 0]   # (1, hm, P)
    d2 = dx * dx + dy * dy
    parts = torch.exp(-d2 / (2.0 * sigma_px * sigma_px))     # (hm, hm, P)
    bg = 1.0 - parts.amax(dim=-1, keepdim=True)
    pad = num_channels - joints_px.shape[0] - 1
    if pad > 0:
        parts = torch.cat([parts, parts.new_zeros((hm, hm, pad))], dim=-1)
    return torch.cat([parts, bg], dim=-1)
