"""Convolutional Pose Machines in PyTorch (port of
``tpu_pose/models/cpm.py``, the layer layout of the MPII Caffe deploy
graph):

  stage 1:   conv1..3_stage1 (9×9×128 + 3×3/2 max pools) → conv4_stage1
             (5×5×32) → conv5_stage1 (9×9×512) → conv6 (1×1×512)
             → conv7 (1×1×(P+1)) — belief maps b₁ (46×46)
  trunk:     conv1..3_stage2 (9×9×128 + pools), computed once and reused
             by every refinement stage (or conv1..3_stage1's output with
             ``share_trunk``)
  stage t≥2: a 5×5×32 conv on the trunk, then concat(feat_t, b_{t−1},
             center_lowres) → Mconv1..3_stageT (11×11×128) → Mconv4
             (1×1×128) → Mconv5 (1×1×(P+1)) = b_t

The module's parameters are keyed by the Caffe layer names
(``conv1_stage1.weight`` …), OIHW. Inside it runs NCHW; the public
functions take and return NHWC like the JAX package.

The int8 serving path (``quantize_params``, ``calibrate_act_scales``,
:class:`QuantizedCPM`) runs the same forward with every conv replaced by
``_conv_q``: quantize the input as its im2col rows are gathered (kernel
B2, ``csrc/quantize_act.cu``), int8 × int8 → int32
(``ops/quantize.int8_conv``), float32 epilogue. Its activations are NCHW
views of NHWC memory, the layout the gather reads.

Multi-person frames (:func:`estimate_2d_multi`): stage 1 and the
refinement trunk once per image, up to k person centers from NMS'd peaks
of :func:`person_evidence` (or the caller's ``center_hints``), the
refinement stages per hypothesis on the B·k fold, and
:func:`select_people` for the person count.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_pose_torch.models import joints as joints_lib
from tpu_pose_torch.ops import cuda_kernels
from tpu_pose_torch.ops import preprocess as pre
from tpu_pose_torch.ops import quantize as quant_lib
from tpu_pose_torch.ops import softargmax as decode_lib
from tpu_pose_torch.utils.config import CPMConfig
from tpu_pose_torch.utils.device import (full_f32_conv, full_f32_matmul,
                                         resolve_device)


def _layer_defs(cfg: CPMConfig):
    """(name, kernel, in_ch, out_ch, has_relu) for every conv layer."""
    p1 = cfg.out_channels
    f = cfg.features
    defs = [
        ("conv1_stage1", 9, 3, f, True),
        ("conv2_stage1", 9, f, f, True),
        ("conv3_stage1", 9, f, f, True),
        ("conv4_stage1", 5, f, 32, True),
        ("conv5_stage1", 9, 32, cfg.stage1_head_width, True),
        ("conv6_stage1", 1, cfg.stage1_head_width, cfg.stage1_head_width,
         True),
        ("conv7_stage1", 1, cfg.stage1_head_width, p1, False),
    ]
    if not cfg.share_trunk:
        defs += [
            ("conv1_stage2", 9, 3, f, True),
            ("conv2_stage2", 9, f, f, True),
            ("conv3_stage2", 9, f, f, True),
        ]
    cat_ch = 32 + p1 + (1 if cfg.use_center_map else 0)
    for t in range(2, cfg.num_stages + 1):
        feat_name = "conv4_stage2" if t == 2 else f"conv1_stage{t}"
        defs.append((feat_name, 5, f, 32, True))
        defs += [
            (f"Mconv1_stage{t}", 11, cat_ch, cfg.refine_width, True),
            (f"Mconv2_stage{t}", 11, cfg.refine_width, cfg.refine_width,
             True),
            (f"Mconv3_stage{t}", 11, cfg.refine_width, cfg.refine_width,
             True),
            (f"Mconv4_stage{t}", 1, cfg.refine_width, cfg.refine_width,
             True),
            (f"Mconv5_stage{t}", 1, cfg.refine_width, p1, False),
        ]
    return defs


class CPM(nn.Module):
    """The CPM's conv layers, one ``nn.Conv2d`` per Caffe layer name.
    ``forward`` is :func:`cpm_forward` (NHWC in, per-stage NHWC beliefs
    out) with this module's config, or with ``cfg`` (its compute dtype,
    for instance) when given."""

    def __init__(self, cfg: CPMConfig = CPMConfig()):
        super().__init__()
        self.cfg = cfg
        for name, k, cin, cout, _ in _layer_defs(cfg):
            self.add_module(name, nn.Conv2d(cin, cout, k, padding=k // 2))

    def forward(self, images, center_map=None, num_stages=None, cfg=None):
        return cpm_forward(self, images, center_map, cfg or self.cfg,
                           num_stages=num_stages)


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


class QuantizedConv(nn.Module):
    """One int8 conv layer (the JAX package's ``{w_int8, w_scale, b,
    a_scale}``), as buffers:

    - ``w_int8`` (N_pad, K_pad) int8: the weights in im2col order,
      K = (kh, kw, in), zero-padded to multiples of 8 for ``torch._int_mm``;
    - ``w_scale`` (out,) and ``b`` (out,) float32;
    - ``a_scale``: a 0-d float32 static input scale, or None (dynamic)."""

    def __init__(self, k: int, cin: int, cout: int):
        super().__init__()
        self.kernel_size, self.in_channels, self.out_channels = k, cin, cout
        self.register_buffer("w_int8", torch.zeros(
            (_pad8(cout), _pad8(k * k * cin)), dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(cout))
        self.register_buffer("b", torch.zeros(cout))
        self.register_buffer("a_scale", None)

    def set_weights(self, w_hwio: torch.Tensor, w_scale, b,
                    a_scale=None) -> None:
        """Fill the buffers from int8 HWIO weights (the JAX package's
        layout) and float32 scales."""
        k, cin, cout = self.kernel_size, self.in_channels, self.out_channels
        if tuple(w_hwio.shape) != (k, k, cin, cout):
            raise ValueError(f"expected int8 weights {(k, k, cin, cout)} "
                             f"(HWIO), got {tuple(w_hwio.shape)}")
        self.w_int8.zero_()
        self.w_int8[:cout, :k * k * cin] = w_hwio.reshape(-1, cout).t()
        self.w_scale.copy_(torch.as_tensor(w_scale, dtype=torch.float32))
        self.b.copy_(torch.as_tensor(b, dtype=torch.float32))
        self.a_scale = (None if a_scale is None else torch.tensor(
            a_scale, dtype=torch.float32, device=self.w_scale.device))

    def weight_hwio(self) -> torch.Tensor:
        """The int8 weights back in HWIO."""
        k, cin, cout = self.kernel_size, self.in_channels, self.out_channels
        return self.w_int8[:cout, :k * k * cin].t().reshape(k, k, cin, cout)


class QuantizedCPM(nn.Module):
    """The int8 CPM: one :class:`QuantizedConv` per Caffe layer name. Built
    by :func:`quantize_params` or :func:`cpm_params_from_numpy` (from an
    already-quantized parameter set); ``forward`` is :func:`cpm_forward`."""

    def __init__(self, cfg: CPMConfig = CPMConfig()):
        super().__init__()
        self.cfg = cfg
        for name, k, cin, cout, _ in _layer_defs(cfg):
            self.add_module(name, QuantizedConv(k, cin, cout))

    def forward(self, images, center_map=None, num_stages=None):
        return cpm_forward(self, images, center_map, self.cfg,
                           num_stages=num_stages)


# XLA folds the ``/ 127.0`` of the JAX package's jitted quantize_params
# into a multiply by this float32 constant; the port does the same, so the
# weight scales are bit-equal (ROADMAP.md §C).
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_params(cpm: CPM, act_scales: dict | None = None
                    ) -> QuantizedCPM:
    """Per-output-channel symmetric int8 weights (port of the JAX
    ``quantize_params``): ``w_scale = max(max|w| over (in, kh, kw) / 127,
    1e-12)``, the ``/ 127`` computed as the JAX package's jitted code
    computes it (:data:`_INV_127`), then ``w_int8 = clip(round(w /
    w_scale), -127, 127)`` (true division, half to even); bias kept in
    float32. ``act_scales`` (from
    :func:`calibrate_act_scales`) adds each listed layer's static input
    scale; without it the activation scales are dynamic. On ``cpm``'s
    device."""
    qcpm = QuantizedCPM(cpm.cfg).to(next(cpm.parameters()).device)
    with torch.no_grad():
        for name, conv in cpm.named_children():
            w = conv.weight.float()
            scale = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)) * _INV_127,
                                    1e-12)
            w_q = torch.clamp(torch.round(w / scale[:, None, None, None]),
                              -127, 127).to(torch.int8)
            a = None
            if act_scales and name in act_scales:
                a = np.float32(act_scales[name])
            getattr(qcpm, name).set_weights(w_q.permute(2, 3, 1, 0), scale,
                                            conv.bias, a)
    return qcpm


def _is_quantized(params: dict) -> bool:
    return "w_int8" in next(iter(params.values()))


def cpm_params_from_numpy(params: dict, cfg: CPMConfig = CPMConfig(),
                          device=None):
    """A :class:`CPM` holding ``params`` — the JAX package's parameter
    layout, ``{layer: {"w": HWIO, "b": (out,)}}`` as numpy arrays — or,
    for a quantized set (``{"w_int8": HWIO int8, "w_scale", "b"[,
    "a_scale"]}``, what the JAX ``quantize_params`` returns and
    ``save_params_npz`` writes), a :class:`QuantizedCPM`. Raises on a
    missing or extra layer or a wrong shape."""
    names = {name for name, *_ in _layer_defs(cfg)}
    missing, extra = names - set(params), set(params) - names
    if missing or extra:
        raise ValueError(f"CPM params do not match {cfg}: missing "
                         f"{sorted(missing)}, extra {sorted(extra)}")
    if _is_quantized(params):
        return _quantized_from_numpy(params, cfg).to(resolve_device(device))
    cpm = CPM(cfg)
    state = {}
    for name in names:
        conv = getattr(cpm, name)
        w = np.asarray(params[name]["w"], np.float32)
        b = np.asarray(params[name]["b"], np.float32)
        o, i, kh, kw = conv.weight.shape
        want = (kh, kw, i, o)
        if w.shape != want or b.shape != (conv.out_channels,):
            raise ValueError(
                f"{name}: expected w {want} (HWIO) and b "
                f"({conv.out_channels},), got {w.shape} and {b.shape}")
        state[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        state[f"{name}.bias"] = torch.from_numpy(b.copy())
    cpm.load_state_dict(state)
    return cpm.to(resolve_device(device))


def _quantized_from_numpy(params: dict, cfg: CPMConfig) -> QuantizedCPM:
    qcpm = QuantizedCPM(cfg)
    for name, k, cin, cout, _ in _layer_defs(cfg):
        p = params[name]
        w = np.array(p["w_int8"])                # writable copies
        scale = np.array(p["w_scale"], np.float32)
        b = np.array(p["b"], np.float32)
        if (w.dtype != np.int8 or w.shape != (k, k, cin, cout)
                or scale.shape != (cout,) or b.shape != (cout,)):
            raise ValueError(
                f"{name}: expected w_int8 {(k, k, cin, cout)} int8 (HWIO), "
                f"w_scale and b ({cout},), got {w.dtype} {w.shape}, "
                f"{scale.shape} and {b.shape}")
        a = p.get("a_scale")
        getattr(qcpm, name).set_weights(
            torch.from_numpy(w), torch.from_numpy(scale),
            torch.from_numpy(b), None if a is None else np.float32(a))
    return qcpm


def cpm_params_to_numpy(cpm) -> dict:
    """The inverse of :func:`cpm_params_from_numpy`: numpy params in the
    JAX package's layout (what ``utils/tf_converter.save_params_npz``
    writes) — HWIO ``w``/``b``, or for a :class:`QuantizedCPM` HWIO int8
    ``w_int8``, ``w_scale``, ``b`` and, where set, a 0-d ``a_scale``."""
    if isinstance(cpm, QuantizedCPM):
        out = {}
        for name, layer in cpm.named_children():
            p = {"w_int8": layer.weight_hwio().cpu().numpy(),
                 "w_scale": layer.w_scale.cpu().numpy().copy(),
                 "b": layer.b.cpu().numpy().copy()}
            if layer.a_scale is not None:
                p["a_scale"] = layer.a_scale.cpu().numpy().copy()
            out[name] = p
        return out
    return {name: {"w": conv.weight.detach().cpu().numpy()
                   .transpose(2, 3, 1, 0).copy(),
                   "b": conv.bias.detach().cpu().numpy().copy()}
            for name, conv in cpm.named_children()}


def init_cpm_params(seed: int = 0, cfg: CPMConfig = CPMConfig(),
                    device=None) -> CPM:
    """He-initialized CPM, zero biases, drawn in HWIO order from numpy
    ``RandomState(seed)``. These are not the JAX package's weights for the
    same seed (its draws come from ``jax.random``); to hold the two
    packages against each other, carry the JAX weights across with
    :func:`cpm_params_from_numpy`."""
    rng = np.random.RandomState(seed)
    params = {}
    for name, k, cin, cout, _ in _layer_defs(cfg):
        w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
        params[name] = {"w": w * np.float32(np.sqrt(2.0 / (k * k * cin))),
                        "b": np.zeros((cout,), np.float32)}
    return cpm_params_from_numpy(params, cfg, device)


# ---------------------------------------------------------------------------
# Forward pass (NCHW inside)
# ---------------------------------------------------------------------------

def _conv(x, conv: nn.Conv2d, relu: bool, dtype):
    """SAME conv (stride 1, odd kernel: symmetric k//2 padding) + bias
    (+ReLU) in ``dtype``. As in the JAX package, the bias is added to the
    conv output already rounded to ``dtype``."""
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None,
                 padding=conv.padding)
    y = y + conv.bias.to(dtype)[:, None, None]
    if relu:
        y = torch.relu_(y)
    return y


def _pool(x):
    """Caffe CPM pooling: 3×3 max, stride 2, SAME. XLA pads SAME windows
    with the odd element AFTER (368→184 pads 0 before, 1 after); torch's
    ``padding=`` pads both sides, so the padding is explicit here."""
    py = pre.same_padding(x.shape[-2], 3, 2)
    px = pre.same_padding(x.shape[-1], 3, 2)
    x = F.pad(x, (px[0], px[1], py[0], py[1]), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def _conv_q(x, layer: QuantizedConv, relu: bool, act_dtype):
    """int8 conv (port of the JAX ``_conv_q``): quantize the NCHW input
    (through its NHWC view) with kernel B2, int8 × int8 → int32, then the
    float32 epilogue in JAX's order — ``acc * (a_scale * w_scale) + b``,
    ReLU — cast to ``act_dtype``. Returns an NCHW view of the NHWC output.

    The scale is the whole input's (static, or one abs-max pass over all
    of it). A 1×1 conv quantizes its input in one pass, whose int8 output
    the GEMM reads as it is; a k×k conv hands the float input and the
    scale to ``int8_conv``, whose tiles quantize as they gather their
    im2col rows."""
    x = x.permute(0, 2, 3, 1)
    if layer.kernel_size == 1:
        x, a_scale = cuda_kernels.quantize_act_cuda(x, layer.a_scale)
        tile_scale = None
    else:
        a_scale = tile_scale = cuda_kernels.act_scale_cuda(x, layer.a_scale)
    scale = a_scale * layer.w_scale

    def epilogue(acc, scale, b):
        y = acc.float().mul_(scale).add_(b)
        return torch.relu_(y) if relu else y

    y = quant_lib.int8_conv(x, layer.w_int8.t(), layer.kernel_size,
                            layer.out_channels, epilogue, act_dtype,
                            tile_scale, (scale, layer.b))
    return y.permute(0, 3, 1, 2)


def _make_conv(cpm, cfg: CPMConfig, on_conv_input=None):
    """Layer applier ``c(name, h, relu)`` + the activation dtype.
    ``on_conv_input(name, h)`` sees every conv's input (the calibration
    tap). As in the JAX package, an int8 CPM's dtype is float32: the
    previous beliefs and the center hint enter the concat before each
    Mconv1 in float32, which promotes it from the bf16 features."""
    quantized = isinstance(cpm, QuantizedCPM)
    act = getattr(torch, cfg.compute_dtype)
    dtype = torch.float32 if quantized else act

    def c(name, h, relu=True):
        if on_conv_input is not None:
            on_conv_input(name, h)
        if quantized:
            return _conv_q(h, getattr(cpm, name), relu, act)
        return _conv(h, getattr(cpm, name), relu, dtype)

    return c, dtype


def _stage1_forward(c, images):
    """Stage-1 path → (trunk1 at 1/8 res, beliefs_1 f32)."""
    trunk1 = _pool(c("conv1_stage1", images))
    trunk1 = _pool(c("conv2_stage1", trunk1))
    trunk1 = _pool(c("conv3_stage1", trunk1))
    h = c("conv4_stage1", trunk1)
    h = c("conv5_stage1", h)
    h = c("conv6_stage1", h)
    b = c("conv7_stage1", h, relu=False).float()
    return trunk1, b


def _refine_trunk(c, images, trunk1, cfg):
    """The refinement stages' image-feature trunk (computed once)."""
    if cfg.share_trunk:
        return trunk1
    f = _pool(c("conv1_stage2", images))
    f = _pool(c("conv2_stage2", f))
    return _pool(c("conv3_stage2", f))


def _refine_forward(c, dtype, images, trunk1, belief1, center_map, cfg,
                    n_stages):
    """Stages 2..n_stages given stage-1 results; ``center_map`` is the
    full-res NHWC hint. Returns the refined NCHW beliefs."""
    f = _refine_trunk(c, images, trunk1, cfg)
    if cfg.use_center_map:
        if center_map is None:
            raise ValueError(
                "cfg.use_center_map=True requires a center_map for a "
                ">1-stage forward (stages 2+ concat the downsampled center "
                "hint); pass one or set use_center_map=False")
        cmap_lo = pre.downsample_center_map(center_map, cfg.stride)
        cmap_lo = cmap_lo.permute(0, 3, 1, 2).to(dtype)
    else:
        cmap_lo = None
    return _refine_stages(c, dtype, f, belief1, cmap_lo, n_stages)


def _cat_channels(parts):
    """``torch.cat(parts, dim=1)`` of NCHW tensors, written as NHWC memory,
    the layout the CPM's convs keep (and the int8 path's gather reads in
    place): ``torch.cat`` alone picks NCHW when the parts' layouts differ,
    as the broadcast center hint's does. Unconditional, not read from the
    parts' strides: a traced program (``export.py``) sees fake CUDA conv
    outputs as NCHW, and its next conv would run another cuDNN kernel
    than the live path's."""
    return torch.cat([p.permute(0, 2, 3, 1) for p in parts],
                     dim=3).permute(0, 3, 1, 2)


def _refine_stages(c, dtype, f, belief1, cmap_lo, n_stages):
    """The stage-2..n refinement loop over features ``f``, stage-1 beliefs
    and an optional low-res center hint (all NCHW)."""
    beliefs = []
    prev = belief1
    for t in range(2, n_stages + 1):
        feat_name = "conv4_stage2" if t == 2 else f"conv1_stage{t}"
        parts = [c(feat_name, f), prev.to(dtype)]
        if cmap_lo is not None:
            parts.append(cmap_lo)
        h = _cat_channels(parts)
        h = c(f"Mconv1_stage{t}", h)
        h = c(f"Mconv2_stage{t}", h)
        h = c(f"Mconv3_stage{t}", h)
        h = c(f"Mconv4_stage{t}", h)
        prev = c(f"Mconv5_stage{t}", h, relu=False).float()
        beliefs.append(prev)
    return beliefs


def cpm_forward(cpm, images: torch.Tensor,
                center_map: torch.Tensor | None = None,
                cfg: CPMConfig = CPMConfig(),
                on_conv_input=None,
                num_stages: int | None = None) -> List[torch.Tensor]:
    """All-stage forward pass of a :class:`CPM` or a :class:`QuantizedCPM`.

    Args:
      images: (B, S, S, 3) normalized inputs (ops/preprocess.py).
      center_map: (B, S, S, 1) full-res center map, or None.
      on_conv_input: optional tap ``f(layer_name, input)`` called on every
        conv's input (used by :func:`calibrate_act_scales`).
    Returns:
      per-stage belief maps, each (B, H, H, P+1) float32 and
      NHWC-contiguous: the NCHW convs keep the channels-last layout of
      the NHWC input (the CUDA decode takes any strides).
    """
    c, dtype = _make_conv(cpm, cfg, on_conv_input)
    x = images.permute(0, 3, 1, 2)
    trunk1, b1 = _stage1_forward(c, x)
    n_stages = cfg.num_stages if num_stages is None else num_stages
    beliefs = [b1]
    if n_stages > 1:
        beliefs += _refine_forward(c, dtype, x, trunk1, b1, center_map, cfg,
                                   n_stages)
    return [b.permute(0, 2, 3, 1) for b in beliefs]


def calibrate_act_scales(cpm: CPM, images: torch.Tensor,
                         center_map: torch.Tensor | None = None,
                         cfg: CPMConfig = CPMConfig(),
                         margin: float = 1.1) -> dict:
    """Post-training calibration (port of the JAX
    ``calibrate_act_scales``): one float forward in ``cfg.compute_dtype``
    records every layer's max|input|; the static scales are
    ``max(amax · margin / 127, 1e-12)`` as Python floats. The maxima are
    read back to the host once, at the end."""
    amaxes = {}

    def tap(name, x):
        amaxes[name] = x.abs().amax().float()

    with torch.no_grad():
        cpm_forward(cpm, images, center_map, cfg, on_conv_input=tap)
    values = torch.stack(list(amaxes.values())).tolist()
    return {name: max(a * margin / 127.0, 1e-12)
            for name, a in zip(amaxes, values)}


def _decode(heatmaps: torch.Tensor, cfg: CPMConfig, beta: float):
    """Heatmaps → (joints_px, conf); the single dispatch point for every
    decode caller. ``auto`` and ``cuda`` go to the kernel's wrapper, which
    launches the CUDA kernel on a CUDA tensor (or raises — no fallback)
    and runs the plain version on a CPU tensor; ``torch`` forces the plain
    version."""
    impl = cfg.decode_impl
    if impl in ("auto", "cuda"):
        return cuda_kernels.soft_argmax_cuda(heatmaps, beta=beta,
                                             stride=cfg.stride)
    if impl == "torch":
        return decode_lib.soft_argmax(heatmaps, beta=beta, stride=cfg.stride)
    raise ValueError(f"unknown decode_impl {impl!r}: 'auto' | 'cuda' | "
                     f"'torch'")


def estimate_person_centers(stage1_beliefs: torch.Tensor,
                            cfg: CPMConfig = CPMConfig()) -> torch.Tensor:
    """(B, h, h, P+1) stage-1 beliefs → (B, 2) person centers in input
    pixels: the spatial expectation of the foreground mass (max over the
    part channels) under softmax(50·(fg − max))."""
    fg = stage1_beliefs[..., :-1].amax(dim=-1)               # (B, h, w)
    b, h, w = fg.shape
    flat = fg.reshape(b, h * w)
    m = flat.amax(dim=-1, keepdim=True)
    p = torch.softmax(50.0 * (flat - m), dim=-1).reshape(b, h, w)
    ys = torch.arange(h, dtype=torch.float32, device=fg.device) * cfg.stride
    xs = torch.arange(w, dtype=torch.float32, device=fg.device) * cfg.stride
    cy = torch.einsum("bhw,h->b", p, ys)
    cx = torch.einsum("bhw,w->b", p, xs)
    return torch.stack([cx, cy], dim=-1)


def estimate_person_geometry(stage1_beliefs: torch.Tensor,
                             cfg: CPMConfig = CPMConfig(),
                             beta: float = 30.0):
    """Stage-1 beliefs (B, h, h, P+1) → per-image person center and
    scale in input pixels: a per-part soft-argmax at ``beta`` (through
    :func:`_decode`, so kernel B1 on the card), then
    :func:`person_geometry_from_joints`. Returns (centers (B, 2) px,
    extent_px (B,))."""
    joints, conf = _decode(stage1_beliefs, cfg, beta)
    return person_geometry_from_joints(joints, conf)


def person_geometry_from_joints(joints: torch.Tensor, conf: torch.Tensor):
    """Decoded joints (..., P, 2) + conf (..., P) → (centers (..., 2),
    extent_px (...,)): the confidence-weighted center and the
    confidence-weighted L∞ extent around it. Conf is the raw per-part max
    belief, which can be negative, so it is clamped to 1e-6 first."""
    conf = torch.clamp_min(conf, 1e-6)
    w = conf / (conf.sum(dim=-1, keepdim=True) + 1e-8)
    centers = (w[..., None] * joints).sum(dim=-2)
    d = (joints - centers[..., None, :]).abs().amax(dim=-1)         # L∞
    wmax = conf / (conf.amax(dim=-1, keepdim=True) + 1e-8)
    extent = (d * torch.sqrt(wmax)).amax(dim=-1)
    return centers, extent


def crop_index_translation(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The true index-space translation of :func:`_crop_zoom`: its ``t``
    is in the half-pixel-center convention, so content maps as
    ``crop_idx = net_idx · s + (t + 0.5·(s − 1))``. Every joint ↔ crop
    conversion uses this; the raw ``t`` would bias mapped-back joints by
    0.5·(s − 1) px."""
    return t + 0.5 * (s[..., None] - 1.0)


def crop_affine_from_geometry(centers: torch.Tensor,
                              extent_px: torch.Tensor,
                              cfg: CPMConfig = CPMConfig(),
                              target_frac: float = 0.6,
                              max_zoom: float = 3.0,
                              min_zoom: float = 0.5):
    """(centers, extent) → per-image crop affine (s (B,), t (B, 2)) for
    :func:`_crop_zoom`: the zoom that maps the extent to ``target_frac``
    of the half-frame, clamped to [min_zoom, max_zoom], and the
    translation that maps the center to the frame center (S−1)/2 under
    the true index mapping, t = S/2 − (c + 0.5)·s."""
    half = cfg.input_size / 2.0
    s = target_frac * half / torch.clamp_min(extent_px, 1e-3)
    s = torch.clamp(s, min_zoom, max_zoom)
    t = half - (centers + 0.5) * s[..., None]
    return s, t


_F32_EPS = float(np.finfo(np.float32).eps)


def _zoom_weights(n: int, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, n_out, n_in) resampling matrices of one axis of
    ``jax.image.scale_and_translate(method="linear")`` (its
    ``compute_weight_mat``) for per-image scale ``s`` (B,) and translation
    ``t`` (B,): sample coordinate (i + 0.5)/s − t/s − 0.5, triangle kernel
    widened by max(1/s, 1) (antialiasing), each output's weights
    normalized where their sum exceeds 1000·eps, and outputs whose sample
    falls outside [−0.5, n − 0.5] zeroed. Computed on the device."""
    grid = torch.arange(n, dtype=torch.float32, device=s.device)
    inv = 1.0 / s
    kernel_scale = torch.clamp_min(inv, 1.0)
    sample = ((grid[None, :] + 0.5) * inv[:, None] - t[:, None] * inv[:, None]
              - 0.5)                                          # (B, n_out)
    x = ((sample[:, :, None] - grid[None, None, :]).abs()
         / kernel_scale[:, None, None])
    w = torch.clamp_min(1.0 - x, 0.0)
    total = w.sum(dim=-1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n - 0.5)
    return torch.where(inside[..., None], w, 0.0)


def _crop_zoom(images_net: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
               fill: float = 0.0) -> torch.Tensor:
    """Per-image crop affines (s (B,), t (B, 2) as (tx, ty)) applied to
    the preprocessed (B, S, S, C) batch, as ``jax.image.scale_and_translate``
    does it: one weight matrix per axis and image, then two batched
    products in full float32 (TF32 off, JAX's ``Precision.HIGHEST``).
    Out-of-window regions fill with ``fill`` (0 = mid-gray in the
    normalized space), through the weights' row sums. Returns NHWC
    memory, the layout the CPM's convs keep."""
    size = images_net.shape[1]
    wy = _zoom_weights(size, s, t[:, 1])
    wx = _zoom_weights(size, s, t[:, 0])
    with full_f32_matmul():
        out = torch.einsum("boh,bhwc->bowc", wy, images_net)
        out = torch.einsum("bpw,bowc->bopc", wx, out)
    if fill != 0.0:
        cov = wy.sum(-1)[:, :, None, None] * wx.sum(-1)[:, None, :, None]
        out = out + (1.0 - cov) * fill
    return out.contiguous()


def joints_from_crop_frame(joints_crop: torch.Tensor, s: torch.Tensor,
                           t: torch.Tensor) -> torch.Tensor:
    """Map (B, P, 2) crop-frame joints back to the network frame through
    the inverse of :func:`_crop_zoom`'s true index affine
    (:func:`crop_index_translation`, not the raw ``t``)."""
    t_idx = crop_index_translation(s, t)
    return (joints_crop - t_idx[..., None, :]) / s[..., None, None]


def estimate_2d_from_images(cpm, images: torch.Tensor,
                            cfg: CPMConfig = CPMConfig(),
                            beta: float = 100.0,
                            refine_center: bool = False,
                            refine_scale: bool = False,
                            letterbox: bool = False,
                            source_frame: bool = True,
                            scale_target_frac: float = 0.6,
                            max_zoom: float = 3.0,
                            scale_from_refined: bool = False,
                            scale_iters: int = 1,
                            flip_tta: bool = False,
                            scale_tta: tuple = ()):
    """Raw (uint8 or float) images (B, H₀, W₀, 3) → heatmaps (B, 46, 46,
    P+1), joints_px (B, P, 2), conf (B, P): resize (or ``letterbox``),
    normalize, the CPM, the decode — with the accuracy front end:

    - ``refine_center``: the refinement stages' hint is a per-image
      Gaussian at the person center estimated from the stage-1 beliefs
      (:func:`estimate_person_geometry`), not the frame center.
    - ``refine_scale``: ``scale_iters`` rounds of stage-1 geometry → crop
      affine (:func:`crop_affine_from_geometry`, zoom clamped to
      ``max_zoom``) → :func:`_crop_zoom` of the net frame → stage 1
      again; the full network then runs on the crop and its joints map
      back. Each round recomputes the total affine, so resampling happens
      once. ``scale_from_refined`` takes round 1's geometry from the full
      refined decode instead. Heatmaps are then in the crop frame.
    - ``flip_tta``: the whole pipeline again on the mirrored frame, joints
      mapped back (x → S−1−x, left ↔ right per ``CPM_FLIP_PERM``).
    - ``scale_tta``: the whole pipeline on centered zooms of the net frame
      (t = (S/2)(1 − s)), s == 1 skipped, each joint set mapped back; with
      ``refine_scale`` the view's affine composes into the crop.
    - All passes merge by confidence-weighted joint averaging, conf = the
      passes' mean; the heatmaps returned are the base pass's.
    - ``letterbox`` with ``source_frame``: joints in source pixels;
      otherwise in the network frame.

    Every soft-argmax (the β = 30 geometry decodes and the final decodes)
    goes through :func:`_decode`, so through kernel B1 on the card."""
    x = pre.preprocess(images, cfg.input_size, letterbox=letterbox)
    conv, dtype = _make_conv(cpm, cfg)
    size = cfg.input_size

    def centered_cmap(n):
        cm = pre.gaussian_center_map(size, cfg.center_sigma, device=x.device)
        return cm.expand(n, *cm.shape)

    def stage1(xn):
        trunk1, b1 = _stage1_forward(conv, xn.permute(0, 3, 1, 2))
        return trunk1, b1, b1.permute(0, 2, 3, 1)

    def run_net(xn, base=None, view_affine=None):
        """Stage 1 → (refine_scale crop) → refinement stages → decode on
        one preprocessed net-frame batch. ``base``/``view_affine``: ``xn``
        is the zoom of ``base`` under ``view_affine = (s, t)``; with
        ``refine_scale`` the affine composes into the crop and the joints
        come back in ``base``'s frame, otherwise in ``xn``'s."""
        trunk1, b1, b1_nhwc = stage1(xn)
        rc = refine_center
        crop_s = crop_t = None
        if refine_scale:
            x0 = xn if base is None else base
            b = xn.shape[0]
            if view_affine is None:
                crop_s = torch.ones(b, device=xn.device)
                crop_t = torch.zeros(b, 2, device=xn.device)
            else:
                crop_s, crop_t = view_affine
            for it in range(max(1, scale_iters)):
                if it == 0 and scale_from_refined and cfg.num_stages > 1:
                    cmap0 = (centered_cmap(b) if cfg.use_center_map
                             else None)
                    hm1 = _refine_forward(conv, dtype, xn.permute(0, 3, 1, 2),
                                          trunk1, b1, cmap0, cfg,
                                          cfg.num_stages)[-1]
                    j1, c1 = _decode(hm1.permute(0, 2, 3, 1), cfg, beta)
                    centers, extent = person_geometry_from_joints(j1, c1)
                else:
                    centers, extent = estimate_person_geometry(b1_nhwc, cfg)
                # Crop-frame geometry → net frame → the new total affine.
                centers_net = (centers - crop_index_translation(
                    crop_s, crop_t)) / crop_s[..., None]
                extent_net = extent / crop_s
                crop_s, crop_t = crop_affine_from_geometry(
                    centers_net, extent_net, cfg,
                    target_frac=scale_target_frac, max_zoom=max_zoom)
                xn = _crop_zoom(x0, crop_s, crop_t)
                trunk1, b1, b1_nhwc = stage1(xn)
            rc = False      # the crop is person-centered
        cmap = None
        if cfg.use_center_map:
            if rc:
                centers, _ = estimate_person_geometry(b1_nhwc, cfg)
                cmap = pre.gaussian_center_maps(size, cfg.center_sigma,
                                                centers)
            else:
                cmap = centered_cmap(xn.shape[0])
        if cfg.num_stages == 1:
            heatmaps = b1_nhwc
        else:
            heatmaps = _refine_forward(conv, dtype, xn.permute(0, 3, 1, 2),
                                       trunk1, b1, cmap, cfg,
                                       cfg.num_stages)[-1].permute(0, 2, 3, 1)
        joints, conf = _decode(heatmaps, cfg, beta)
        if crop_s is not None:
            joints = joints_from_crop_frame(joints, crop_s, crop_t)
        return heatmaps, joints, conf

    heatmaps, joints, conf = run_net(x)
    scales = [float(s) for s in scale_tta if float(s) != 1.0]
    if flip_tta or scales:
        perm = joints_lib.cpm_flip_index(x.device)

        def mirror_back(j, c):
            # Pixel p ↔ (S−1)−p under the flip (pixel centers at
            # integers), then left ↔ right channels.
            j = torch.stack([(size - 1.0) - j[..., 0], j[..., 1]], dim=-1)
            return j.index_select(1, perm), c.index_select(1, perm)

        b = x.shape[0]
        # t = (S/2)(1−s) puts the zoom's fixed point at (S−1)/2, the
        # mirror's, so the centered zoom and the flip commute exactly.
        half = size / 2.0
        views = [(x, None, None)]
        for s in scales:
            sv = torch.full((b,), s, device=x.device)
            tv = torch.full((b, 2), half * (1.0 - s), device=x.device)
            views.append((_crop_zoom(x, sv, tv), sv, tv))
        xm = x.flip(2) if flip_tta else None
        passes = [(joints, conf)]
        for i, (xv, sv, tv) in enumerate(views):
            aff = None if sv is None else (sv, tv)
            # With refine_scale run_net returns base-frame joints itself.
            unscale = aff is not None and not refine_scale
            if i > 0:
                _, j_s, c_s = run_net(xv, base=x, view_affine=aff)
                if unscale:
                    j_s = joints_from_crop_frame(j_s, sv, tv)
                passes.append((j_s, c_s))
            if flip_tta:
                _, j_f, c_f = run_net(xv.flip(2), base=xm, view_affine=aff)
                j_f, c_f = mirror_back(j_f, c_f)
                if unscale:
                    j_f = joints_from_crop_frame(j_f, sv, tv)
                passes.append((j_f, c_f))
        js = torch.stack([j for j, _ in passes])        # (N, B, P, 2)
        cs = torch.stack([c for _, c in passes])        # (N, B, P)
        joints = ((js * cs[..., None]).sum(0)
                  / (cs.sum(0) + 1e-8)[..., None])
        conf = cs.mean(0)
    if letterbox and source_frame:
        joints = pre.joints_to_source_frame(joints, pre.letterbox_affine(
            images.shape[1], images.shape[2], size))
    return heatmaps, joints, conf


def estimate_2d_microbatched(cpm, images: torch.Tensor,
                             cfg: CPMConfig = CPMConfig(),
                             chunk: int = 0, **kw):
    """:func:`estimate_2d_from_images` in sequential micro-chunks of
    ``chunk`` frames, one after another, so that peak activation memory is
    per chunk. The whole batch at once when ``chunk`` ≤ 0 or ≥ the batch.
    An uneven batch is padded up to a chunk multiple by repeating its last
    image, and the results are sliced back."""
    b = images.shape[0]
    if chunk <= 0 or chunk >= b:
        return estimate_2d_from_images(cpm, images, cfg, **kw)
    b_pad = -(-b // chunk) * chunk
    if b_pad != b:
        images = torch.cat(
            [images, images[-1:].expand(b_pad - b, *images.shape[1:])])
    outs = [estimate_2d_from_images(cpm, images[i:i + chunk], cfg, **kw)
            for i in range(0, b_pad, chunk)]
    return tuple(torch.cat(parts)[:b] for parts in zip(*outs))


# ---------------------------------------------------------------------------
# Multi-person frames
# ---------------------------------------------------------------------------

def person_evidence(stage1_beliefs: torch.Tensor,
                    cfg: CPMConfig = CPMConfig(),
                    person_sigma_px: float = 64.0) -> torch.Tensor:
    """Person-scale foreground evidence, stage-1 beliefs (B, h, h, P+1) →
    (B, h, h): the part channels clipped at 0 and summed, then a separable
    Gaussian of σ = ``person_sigma_px``/stride cells (radius 3σ, the kernel
    normalized to sum 1) as two SAME convs with zero padding. A cluster of
    joints integrates into one mode at the body center, a lone limb blob
    stays weak. The convs run in full float32 (TF32 off): the peaks are
    argmaxes over this map."""
    fg = torch.clamp_min(stage1_beliefs[..., :-1], 0.0).sum(-1)
    sigma = person_sigma_px / cfg.stride
    r = max(1, int(3.0 * sigma))
    xs = torch.arange(-r, r + 1, dtype=torch.float32, device=fg.device)
    k1 = torch.exp(-0.5 * (xs / sigma) ** 2)
    k1 = k1 / k1.sum()
    x = fg[:, None]
    with full_f32_conv():
        x = F.conv2d(x, k1.view(1, 1, -1, 1), padding=(r, 0))
        x = F.conv2d(x, k1.view(1, 1, 1, -1), padding=(0, r))
    return x[:, 0]


def find_person_peaks(fg: torch.Tensor, k: int, stride: int,
                      nms_radius_px: float):
    """Top-k peaks of a foreground map (B, h, w) with non-maximum
    suppression: k rounds of argmax (the first maximum, as ``jnp.argmax``),
    record, then set a disc of ``nms_radius_px`` around it to −inf.
    Returns (centers_px (B, k, 2) as (x, y) = cell·stride, scores (B, k)),
    all on the device."""
    b, h, w = fg.shape
    ys = torch.arange(h, dtype=torch.float32, device=fg.device)
    xs = torch.arange(w, dtype=torch.float32, device=fg.device)
    r_cells2 = (nms_radius_px / stride) ** 2
    m = fg
    centers, scores = [], []
    for _ in range(k):
        flat = m.reshape(b, h * w)
        idx = flat.argmax(dim=-1)
        scores.append(flat.gather(-1, idx[:, None])[:, 0])
        cy = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
        cx = (idx % w).to(torch.float32)
        centers.append(torch.stack([cx * stride, cy * stride], -1))
        d2 = ((ys[None, :, None] - cy[:, None, None]) ** 2
              + (xs[None, None, :] - cx[:, None, None]) ** 2)
        m = torch.where(d2 <= r_cells2, -math.inf, m)
    return torch.stack(centers, dim=1), torch.stack(scores, dim=1)


def select_people(scores: torch.Tensor, min_score: float = 0.05,
                  score_frac: float = 0.4,
                  joints: torch.Tensor | None = None,
                  dup_px: float = 30.0,
                  allow_empty: bool = False,
                  order_by_score: bool = False,
                  dup_joint_frac: float = 0.0) -> torch.Tensor:
    """Which of the k hypotheses per frame are people, scores (..., k) →
    a (..., k) bool mask:

    1. thresholds: a hypothesis clears ``min_score`` and ``score_frac`` of
       the frame's best score; the top one is always kept unless
       ``allow_empty``;
    2. with ``joints`` (..., k, P, 2): a greedy pass in slot order drops j
       when a kept i < j decodes within ``dup_px`` mean joint distance, or,
       with ``dup_joint_frac`` > 0, when at least that fraction of j's
       joints lie within ``dup_px`` of some joint of i.

    ``order_by_score`` runs the greedy pass in per-frame descending score
    order (a stable sort, as ``jnp.argsort``) and scatters the mask back
    to the input slots."""
    if order_by_score:
        ordr = torch.argsort(-scores, dim=-1, stable=True)
        inv = torch.argsort(ordr, dim=-1, stable=True)
        s_s = scores.gather(-1, ordr)
        j_s = None
        if joints is not None:
            idx = ordr[..., None, None].expand(*ordr.shape,
                                               *joints.shape[-2:])
            j_s = joints.gather(-3, idx)
        m = select_people(s_s, min_score, score_frac, j_s, dup_px,
                          allow_empty, dup_joint_frac=dup_joint_frac)
        return m.gather(-1, inv)
    top = scores.amax(dim=-1, keepdim=True)
    keep = (scores >= min_score) & (scores >= score_frac * top)
    if not allow_empty:
        keep = keep | (scores >= top)
    if joints is None:
        return keep
    k = scores.shape[-1]
    # d[..., j, i]: mean distance between hypotheses j and i's joints.
    d = torch.linalg.norm(joints[..., :, None, :, :]
                          - joints[..., None, :, :, :], dim=-1).mean(-1)
    is_dup = d < dup_px
    if dup_joint_frac > 0:
        # overlap[..., j, i]: share of j's joints within dup_px of some
        # joint of i (nearest joint, not part-aligned).
        d2 = torch.linalg.norm(joints[..., :, None, :, None, :]
                               - joints[..., None, :, None, :, :], dim=-1)
        overlap = (d2.amin(dim=-1) < dup_px).to(torch.float32).mean(-1)
        is_dup = is_dup | (overlap >= dup_joint_frac)
    kept_cols = [keep[..., 0:1]]
    for j in range(1, k):
        kept_sofar = torch.cat(kept_cols, dim=-1)
        dup = (kept_sofar & is_dup[..., j, :j]).any(dim=-1)
        kept_cols.append((keep[..., j] & ~dup)[..., None])
    return torch.cat(kept_cols, dim=-1)


def _fold(t: torch.Tensor, k: int) -> torch.Tensor:
    """(B, C, H, W) → (B·k, C, H, W), each image repeated k times in a row
    (``jnp.repeat(t, k, 0)``), as an NCHW view of NHWC memory: the int8
    gather reads conv inputs in that layout only."""
    return (t.permute(0, 2, 3, 1).repeat_interleave(k, dim=0).contiguous()
            .permute(0, 3, 1, 2))


def estimate_2d_multi(cpm, images: torch.Tensor,
                      cfg: CPMConfig = CPMConfig(),
                      max_people: int = 2,
                      beta: float = 100.0,
                      nms_radius_px: float = 96.0,
                      person_sigma_px: float = 64.0,
                      letterbox: bool = False,
                      refine_scale: bool = False,
                      scale_target_frac: float = 0.6,
                      max_zoom: float = 3.0,
                      flip_tta: bool = False,
                      center_hints: torch.Tensor | None = None,
                      hint_crop: bool | str = False,
                      hint_crop_dup_px: float = 30.0,
                      hint_crop_min_conf: float = 0.0):
    """Multi-person 2D estimation. Raw images (B, H₀, W₀, 3) → heatmaps
    (B, k, h, h, P+1), joints_px (B, k, P, 2) in the network frame, conf
    (B, k, P), person_scores (B, k), with k = ``max_people``:

    - stage 1 and the refinement trunk once per image; k person centers
      from :func:`find_person_peaks` on :func:`person_evidence`, their
      scores the peak values;
    - ``center_hints`` (B, k, 2) network-frame (x, y) replace the peaks:
      slot i decodes the person at hint i, scored by the evidence there
      (bilinear, clamped at the edges, cell corners at x = col·stride);
    - the refinement stages on the B·k fold, each hypothesis with a
      Gaussian hint at its center, then one decode (kernel B1 on the
      card);
    - ``refine_scale``, or ``hint_crop`` with hints: geometry from each
      hypothesis's decode (centered on its hint with ``hint_crop``), a
      crop per hypothesis (:func:`_crop_zoom`) and the whole network again
      on the crops, joints mapped back. ``hint_crop`` True or "dup" takes
      the crop decode only for slots whose plain decode lies within
      ``hint_crop_dup_px`` mean distance of a stronger slot's (and, with
      ``hint_crop_min_conf`` > 0, whose crop decode's mean conf clears
      that share of the frame's best plain slot); those slots' heatmaps
      are then crop-frame maps among network-frame ones, as in the JAX
      package. "all" takes every crop decode;
    - ``flip_tta``: the whole pass again on the mirrored frame with the
      mirrored centers in the same slots, merged slot by slot (conf-
      weighted joints, mean conf); the heatmaps are the first pass's.

    Raises ``ValueError`` unless ``cfg.use_center_map`` (the hint is what
    tells the people apart)."""
    if not cfg.use_center_map:
        raise ValueError("estimate_2d_multi needs cfg.use_center_map=True "
                         "(the center hint is what separates people)")
    b, k, size = images.shape[0], max_people, cfg.input_size
    x = pre.preprocess(images, size, letterbox=letterbox)
    conv, dtype = _make_conv(cpm, cfg)
    trunk1, b1 = _stage1_forward(conv, x.permute(0, 3, 1, 2))
    fg = person_evidence(b1.permute(0, 2, 3, 1), cfg, person_sigma_px)
    if center_hints is None:
        centers, person_scores = find_person_peaks(fg, k, cfg.stride,
                                                   nms_radius_px)
    else:
        centers = torch.as_tensor(center_hints, dtype=torch.float32,
                                  device=x.device)
        cells = centers / cfg.stride
        person_scores = pre.map_coordinates_linear(
            fg[..., None], cells[..., 1], cells[..., 0])[..., 0]

    def centered_cmap_lo(n, device):
        cm = pre.gaussian_center_map(size, cfg.center_sigma, device=device)
        return pre.downsample_center_map(
            cm.expand(n, *cm.shape), cfg.stride).permute(0, 3, 1, 2).to(dtype)

    def run_multi(xn, centers_n, trunk1_n=None, b1_n=None):
        """The per-hypothesis stages (and the crop pass) on one network-
        frame NHWC batch with (B, k, 2) centers; joints (B·k) in xn's
        frame."""
        xc = xn.permute(0, 3, 1, 2)
        if b1_n is None:
            trunk1_n, b1_n = _stage1_forward(conv, xc)
        f = _refine_trunk(conv, xc, trunk1_n, cfg)
        cmaps = pre.gaussian_center_maps(size, cfg.center_sigma,
                                         centers_n.reshape(b * k, 2))
        cmap_lo = pre.downsample_center_map(cmaps, cfg.stride).permute(
            0, 3, 1, 2).to(dtype)
        b1_k = _fold(b1_n, k)
        beliefs = _refine_stages(conv, dtype, _fold(f, k), b1_k, cmap_lo,
                                 cfg.num_stages)
        hm = (beliefs[-1] if beliefs else b1_k).permute(0, 2, 3, 1)
        joints, conf = _decode(hm, cfg, beta)

        do_hc = bool(hint_crop) and center_hints is not None
        if not (refine_scale or do_hc):
            return hm, joints, conf
        g_centers, g_extent = person_geometry_from_joints(joints, conf)
        if do_hc:
            g_centers = centers_n.reshape(b * k, 2)
        s, t = crop_affine_from_geometry(g_centers, g_extent, cfg,
                                         target_frac=scale_target_frac,
                                         max_zoom=max_zoom)
        xz = _crop_zoom(xn.repeat_interleave(k, dim=0), s, t)
        xzc = xz.permute(0, 3, 1, 2)
        trunk1c, b1c = _stage1_forward(conv, xzc)
        fc = _refine_trunk(conv, xzc, trunk1c, cfg)
        beliefs2 = _refine_stages(conv, dtype, fc, b1c,
                                  centered_cmap_lo(b * k, xn.device),
                                  cfg.num_stages)
        hm2 = (beliefs2[-1] if beliefs2 else b1c).permute(0, 2, 3, 1)
        joints2, conf2 = _decode(hm2, cfg, beta)
        joints2 = joints_from_crop_frame(joints2, s, t)
        if not do_hc or hint_crop == "all":
            return hm2, joints2, conf2
        # Selective substitution: only slots whose plain decode duplicates
        # a stronger slot's (ties to the lower index) take the crop decode.
        jb = joints.reshape(b, k, -1, 2)
        d = torch.linalg.norm(jb[:, :, None] - jb[:, None, :],
                              dim=-1).mean(-1)                  # (B, k, k)
        sc = person_scores
        idx = torch.arange(k, device=sc.device)
        stronger = ((sc[:, None, :] > sc[:, :, None])
                    | ((sc[:, None, :] == sc[:, :, None])
                       & (idx[None, None, :] < idx[None, :, None])))
        dup = (stronger & (d < hint_crop_dup_px)).any(dim=-1)     # (B, k)
        if hint_crop_min_conf > 0:
            cm = conf2.reshape(b, k, -1).mean(-1)
            pm = conf.reshape(b, k, -1).mean(-1)
            ref = pm.amax(dim=-1, keepdim=True)
            dup = dup & (cm >= hint_crop_min_conf * ref)
        m = dup.reshape(b * k)
        return (torch.where(m[:, None, None, None], hm2, hm),
                torch.where(m[:, None, None], joints2, joints),
                torch.where(m[:, None], conf2, conf))

    hm, joints, conf = run_multi(x, centers, trunk1, b1)
    if flip_tta:
        centers_f = torch.stack([(size - 1.0) - centers[..., 0],
                                 centers[..., 1]], dim=-1)
        _, j_f, c_f = run_multi(x.flip(2), centers_f)
        perm = joints_lib.cpm_flip_index(x.device)
        j_f = torch.stack([(size - 1.0) - j_f[..., 0], j_f[..., 1]], dim=-1)
        j_f, c_f = j_f.index_select(1, perm), c_f.index_select(1, perm)
        w = conf + c_f + 1e-8
        joints = (joints * conf[..., None] + j_f * c_f[..., None]) \
            / w[..., None]
        conf = 0.5 * (conf + c_f)
    return (hm.reshape(b, k, *hm.shape[1:]),
            joints.reshape(b, k, *joints.shape[1:]),
            conf.reshape(b, k, *conf.shape[1:]), person_scores)
