"""Hand-written CUDA kernels: build, load and launch.

Each kernel is a ``.cu`` file under ``tpu_pose_torch/csrc/`` with a plain
C entry point. At first use it is compiled by ``nvcc`` for ``sm_90a``
into a shared library named by a hash of the source and flags (so an edit
rebuilds) and loaded with ``ctypes``. In a source checkout the library
goes to ``build/tpu_pose_torch/`` at the repository root; an installed
package builds into the user's cache directory. Nothing is built or
imported when this module is imported: the CPU tests import it on
machines with no ``nvcc``.

Each kernel is also a ``torch.library`` custom op (``tpu_pose_torch::
soft_argmax``, ``::act_scale``, ``::quantize_act``, ``::quantize_im2col``
and its functional form ``::quantize_im2col_tile``) with a fake
implementation that gives only shapes and dtypes, so
``torch.export`` records one node per call and an exported program
launches the same kernels (``export.py``). Every wrapper calls its op,
and the op owns the device route: for a CPU tensor it runs the plain
PyTorch version; for a CUDA tensor it launches its kernel or raises — it
never falls back. Each wrapper keeps a launch count
(``wrapper.launches``) that only its kernel launch increments.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from tpu_pose_torch.ops import quantize as quantize_lib
from tpu_pose_torch.ops import softargmax as softargmax_lib

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("soft_argmax", "quantize_act")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def build_dir() -> Path:
    """``build/tpu_pose_torch/`` in a source checkout (the package's parent
    holds ``pyproject.toml``), else ``$XDG_CACHE_HOME/tpu_pose_torch``
    (default ``~/.cache``) for an installed package."""
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").exists():
        return root / "build" / "tpu_pose_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "tpu_pose_torch"


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build(*names: str) -> list:
    """Compile ``csrc/<name>.cu`` for each name (default: every source)
    unless already built, one ``nvcc`` per source, all started together;
    return the libraries' paths. Raises with the compiler's output if an
    nvcc fails."""
    names = names or SOURCES
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    outs = [_library_path(name) for name in names]
    running = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")  # concurrent builds
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {name}.cu (exit "
                          f"{proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(name)[0]))
    getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    if name == "soft_argmax":
        lib.soft_argmax_f32.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 8
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.soft_argmax_f32.restype = ctypes.c_int
    else:
        lib.quantize_act_scale.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.quantize_act_q.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.quantize_act_im2col.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int64] * 12
            + [ctypes.c_void_p] * 3)
        for fn in ("scale", "q", "im2col"):
            getattr(lib, f"quantize_act_{fn}").restype = ctypes.c_int
    return lib


def _check_launch(lib, name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{getattr(lib, f'{name}_error_string')(rc).decode()} "
            f"(cudaError {rc})")




# -- B1: soft-argmax decode ---------------------------------------------------

def _soft_argmax_launch(heatmaps: torch.Tensor, beta: float,
                        stride: float):
    """Launch ``csrc/soft_argmax.cu`` on a CUDA tensor (the op's CUDA
    kernel), counted in ``soft_argmax_cuda.launches``."""
    if heatmaps.dtype != torch.float32:
        raise TypeError(f"soft_argmax_cuda takes float32 heatmaps, got "
                        f"{heatmaps.dtype}")
    if heatmaps.dim() != 4 or heatmaps.shape[-1] < 2:
        raise ValueError(f"soft_argmax_cuda takes (B, H, W, P+1) heatmaps "
                         f"with P >= 1, got {tuple(heatmaps.shape)}")
    b, h, w, c = heatmaps.shape
    if not 0 < b * (c - 1) < 2 ** 31 or not 0 < h * w < 2 ** 31:
        raise ValueError(f"soft_argmax_cuda: shape {tuple(heatmaps.shape)} "
                         f"is empty or exceeds the kernel's 32-bit "
                         f"row/map indexing")
    joints = torch.empty((b, c - 1, 2), dtype=torch.float32,
                         device=heatmaps.device)
    conf = torch.empty((b, c - 1), dtype=torch.float32,
                       device=heatmaps.device)
    lib = _library("soft_argmax")
    with torch.cuda.device(heatmaps.device):
        stream = torch.cuda.current_stream(heatmaps.device).cuda_stream
        rc = lib.soft_argmax_f32(
            heatmaps.data_ptr(), joints.data_ptr(), conf.data_ptr(),
            b, c - 1, h, w, *heatmaps.stride(), float(beta), float(stride),
            stream)
    _check_launch(lib, "soft_argmax", rc)
    soft_argmax_cuda.launches += 1
    return joints, conf


@torch.library.custom_op("tpu_pose_torch::soft_argmax", mutates_args=())
def _soft_argmax_op(heatmaps: torch.Tensor, beta: float, stride: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    return softargmax_lib.soft_argmax(heatmaps, beta=beta, stride=stride)


_soft_argmax_op.register_kernel("cuda")(_soft_argmax_launch)


@_soft_argmax_op.register_fake
def _(heatmaps, beta, stride):
    b, _, _, c = heatmaps.shape
    return (heatmaps.new_empty((b, c - 1, 2)),
            heatmaps.new_empty((b, c - 1)))


def soft_argmax_cuda(heatmaps: torch.Tensor, beta: float = 100.0,
                     stride: int = 8):
    """Soft-argmax decode, ``(B, H, W, P+1)`` float32 → joints
    ``(B, P, 2)``, conf ``(B, P)``; the same function as
    ``ops/softargmax.soft_argmax``, through the op
    ``tpu_pose_torch::soft_argmax``. On a CUDA tensor the op launches
    ``csrc/soft_argmax.cu`` on the current stream (no synchronize); any
    strides are taken, so the CPM's NHWC heatmaps (or an NHWC view of
    NCHW memory) are read without a copy. On a CPU tensor it runs the
    plain version."""
    _device("soft_argmax_cuda", heatmaps)
    return _soft_argmax_op(heatmaps, float(beta), float(stride))


soft_argmax_cuda.launches = 0


# -- B2: int8 activation quantization ----------------------------------------

def _device(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _float_activation(name: str, x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty tensor")


def _dense(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned (the kernels' vector loads)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _act_scale_launch(x: torch.Tensor) -> torch.Tensor:
    """B2's abs-max pass on a CUDA tensor (the op's CUDA kernel), counted
    in ``act_scale_cuda.launches``."""
    _float_activation("act_scale_cuda", x)
    x = _dense(x)
    scale = torch.zeros((), dtype=torch.float32, device=x.device)
    lib = _library("quantize_act")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.quantize_act_scale(x.data_ptr(),
                                    int(x.dtype == torch.bfloat16),
                                    x.numel(), scale.data_ptr(), stream)
    _check_launch(lib, "quantize_act", rc)
    act_scale_cuda.launches += 1
    return scale


@torch.library.custom_op("tpu_pose_torch::act_scale", mutates_args=())
def _act_scale_op(x: torch.Tensor) -> torch.Tensor:
    return quantize_lib.act_scale(x)


_act_scale_op.register_kernel("cuda")(_act_scale_launch)


@_act_scale_op.register_fake
def _(x):
    return x.new_empty((), dtype=torch.float32)


def act_scale_cuda(x: torch.Tensor, a_scale=None) -> torch.Tensor:
    """The 0-d float32 per-tensor scale of ``x``; the same function as
    ``ops/quantize.act_scale``, bit for bit: ``a_scale`` when given (no
    launch), else ``max(max|x| / 127, 1e-12)`` over the whole tensor,
    through the op ``tpu_pose_torch::act_scale``. On a CUDA tensor
    (float32 or bf16) the dynamic scale is kernel B2's abs-max pass
    (``csrc/quantize_act.cu``, counted in ``.launches``), on the current
    stream, with no host sync; a non-contiguous input is read through a
    contiguous copy. On a CPU tensor it runs the plain version."""
    _device("act_scale_cuda", x)
    return _scale(x, a_scale)


act_scale_cuda.launches = 0


def _scale(x: torch.Tensor, a_scale) -> torch.Tensor:
    if a_scale is not None:
        scale = torch.as_tensor(a_scale, dtype=torch.float32, device=x.device)
        if scale.dim() != 0:
            raise ValueError(f"act_scale_cuda: the scale must be a scalar, "
                             f"got shape {tuple(scale.shape)}")
        return scale
    return _act_scale_op(x)


def _quantize_launch(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """B2's quantize pass on a CUDA tensor (the op's CUDA kernel), counted
    in ``quantize_act_cuda.launches``."""
    _float_activation("quantize_act_cuda", x)
    _check_scale("quantize_act_cuda", scale, x)
    x = _dense(x)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib = _library("quantize_act")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.quantize_act_q(x.data_ptr(), int(x.dtype == torch.bfloat16),
                                x.numel(), scale.data_ptr(), q.data_ptr(),
                                stream)
    _check_launch(lib, "quantize_act", rc)
    quantize_act_cuda.launches += 1
    return q


@torch.library.custom_op("tpu_pose_torch::quantize_act", mutates_args=())
def _quantize_op(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return quantize_lib._quantize(x, scale)


_quantize_op.register_kernel("cuda")(_quantize_launch)


@_quantize_op.register_fake
def _(x, scale):
    return torch.empty_like(x, dtype=torch.int8,
                            memory_format=torch.contiguous_format)


def quantize_act_cuda(x: torch.Tensor, a_scale=None):
    """Symmetric per-tensor int8 quantization, ``(int8 values in x's
    shape, 0-d float32 scale)``; the same function as
    ``ops/quantize.quantize_act``, bit for bit. ``a_scale``: a calibrated
    static scale (0-d float32 tensor), or None for the dynamic abs-max
    scale (:func:`act_scale_cuda`). The values come from the op
    ``tpu_pose_torch::quantize_act``: on a CUDA tensor (float32 or bf16)
    kernel B2's quantize pass (``csrc/quantize_act.cu``, counted in
    ``.launches``) on the current stream, no host sync, a non-contiguous
    input made contiguous first; on a CPU tensor the plain version."""
    _device("quantize_act_cuda", x)
    scale = _scale(x, a_scale)
    return _quantize_op(x, scale), scale


quantize_act_cuda.launches = 0

_IM2COL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _check_scale(name: str, scale: torch.Tensor, x: torch.Tensor) -> None:
    if (scale.device != x.device or scale.dim() != 0
            or scale.dtype != torch.float32):
        raise ValueError(f"{name}: the scale must be a 0-d float32 tensor "
                         f"on x's device")


def _im2col_launch(x: torch.Tensor, scale, k: int, tile,
                   out: torch.Tensor) -> None:
    """The fused quantize-and-gather on CUDA tensors (the op's CUDA
    kernel), counted in ``quantize_im2col_cuda.launches``."""
    if x.dtype not in _IM2COL_DTYPES:
        raise TypeError(f"quantize_im2col_cuda takes float32, bfloat16 or "
                        f"int8, got {x.dtype}")
    if x.dim() != 4 or x.numel() == 0 or x.stride(3) != 1:
        raise ValueError(f"quantize_im2col_cuda takes a non-empty (B, H, W, "
                         f"C) tensor with unit channel stride, got shape "
                         f"{tuple(x.shape)}, strides {x.stride()}")
    if (x.dtype == torch.int8) != (scale is None):
        raise ValueError("quantize_im2col_cuda: a scale goes with float "
                         "input, none with int8 input")
    if scale is not None:
        _check_scale("quantize_im2col_cuda", scale, x)
    b, h, w, c = x.shape
    b0, b1, h0, h1 = tile
    m = (b1 - b0) * (h1 - h0) * w
    if not (0 <= b0 < b1 <= b and 0 <= h0 < h1 <= h and k % 2 == 1):
        raise ValueError(f"quantize_im2col_cuda: tile {tuple(tile)} of a "
                         f"{k}x{k} conv does not fit {tuple(x.shape)}")
    if (out.device != x.device or out.dtype != torch.int8 or out.dim() != 2
            or out.shape[0] != m or not 0 <= out.shape[1] - k * k * c < 8
            or out.shape[1] % 8 or not out.is_contiguous()
            or out.data_ptr() % 16):
        raise ValueError(f"quantize_im2col_cuda: out must be a contiguous, "
                         f"16-byte aligned ({m}, K_pad) int8 tensor with "
                         f"K_pad the multiple of 8 at or above {k * k * c}; "
                         f"got {out.dtype} {tuple(out.shape)}")
    lib = _library("quantize_act")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.quantize_act_im2col(
            x.data_ptr(), _IM2COL_DTYPES[x.dtype], h, w, c, *x.stride()[:3],
            k, b0, b1, h0, h1, out.shape[1],
            None if scale is None else scale.data_ptr(), out.data_ptr(),
            stream)
    _check_launch(lib, "quantize_act", rc)
    quantize_im2col_cuda.launches += 1


@torch.library.custom_op("tpu_pose_torch::quantize_im2col",
                         mutates_args=("out",))
def _im2col_op(x: torch.Tensor, scale: Optional[torch.Tensor], k: int,
               tile: list[int], out: torch.Tensor) -> None:
    quantize_lib.quantize_im2col(x, scale, k, tuple(tile), out)


_im2col_op.register_kernel("cuda")(_im2col_launch)


@_im2col_op.register_fake
def _(x, scale, k, tile, out):
    return None


def quantize_im2col_cuda(x: torch.Tensor, scale, k: int, tile,
                         out: torch.Tensor) -> torch.Tensor:
    """Kernel B2 fused with the im2col gather: fill ``out`` (m, K_pad)
    int8 with the quantized im2col rows of the tile ``(b0, b1, h0, h1)``
    of a SAME, stride-1 ``k×k`` conv over ``x`` (B, H, W, C), and return
    it; the same function as ``ops/quantize.quantize_im2col``, bit for
    bit, through the op ``tpu_pose_torch::quantize_im2col``, which writes
    ``out`` in place (the caller's buffer is reused from tile to tile).
    ``x`` is float32 or bf16 with the 0-d float32 ``scale`` of the whole
    tensor, or int8 values with ``scale`` None. On a CUDA tensor the op
    launches ``csrc/quantize_act.cu``'s gather on the current stream
    (counted in ``.launches``), reading ``x`` through its strides, which
    must give the channels a unit stride: the int8 path's NHWC views are
    read without a copy, and anything else raises. On a CPU tensor it runs
    the plain version."""
    _device("quantize_im2col_cuda", x)
    _im2col_op(x, scale, int(k), [int(t) for t in tile], out)
    return out


quantize_im2col_cuda.launches = 0


def _im2col_tile_launch(x: torch.Tensor, scale, k: int, tile: list,
                        k_pad: int) -> torch.Tensor:
    """The functional form's CUDA kernel: a new buffer filled by
    :func:`_im2col_launch` (counted in ``quantize_im2col_cuda.launches``
    too)."""
    b0, b1, h0, h1 = tile
    out = torch.empty(((b1 - b0) * (h1 - h0) * x.shape[2], k_pad),
                      dtype=torch.int8, device=x.device)
    _im2col_launch(x, scale, k, tile, out)
    return out


@torch.library.custom_op("tpu_pose_torch::quantize_im2col_tile",
                         mutates_args=())
def _im2col_tile_op(x: torch.Tensor, scale: Optional[torch.Tensor], k: int,
                    tile: list[int], k_pad: int) -> torch.Tensor:
    b0, b1, h0, h1 = tile
    out = torch.empty(((b1 - b0) * (h1 - h0) * x.shape[2], k_pad),
                      dtype=torch.int8)
    return quantize_lib.quantize_im2col(x, scale, k, tuple(tile), out)


_im2col_tile_op.register_kernel("cuda")(_im2col_tile_launch)


@_im2col_tile_op.register_fake
def _(x, scale, k, tile, k_pad):
    b0, b1, h0, h1 = tile
    return x.new_empty(((b1 - b0) * (h1 - h0) * x.shape[2], k_pad),
                       dtype=torch.int8)


def quantize_im2col_tile_cuda(x: torch.Tensor, scale, k: int, tile,
                              k_pad: int) -> torch.Tensor:
    """:func:`quantize_im2col_cuda` returning a new (m, ``k_pad``) int8
    buffer instead of filling the caller's, through the op
    ``tpu_pose_torch::quantize_im2col_tile``, which mutates nothing: the
    form a loop body of an exported program can call (a ``scan`` body
    writes into no buffer of its caller; ``ops/quantize.
    _int8_conv_grouped``). The same kernel (``csrc/quantize_act.cu``'s
    gather, counted in ``quantize_im2col_cuda.launches``) on a CUDA
    tensor, the same plain version on a CPU tensor, the same bits."""
    _device("quantize_im2col_tile_cuda", x)
    return _im2col_tile_op(x, scale, int(k), [int(t) for t in tile],
                           int(k_pad))
