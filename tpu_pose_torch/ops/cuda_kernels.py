"""Hand-written CUDA kernels: build, load and launch.

Each kernel is a ``.cu`` file under ``tpu_pose_torch/csrc/`` with a plain
C entry point. At first use it is compiled by ``nvcc`` for ``sm_90a``
into a shared library named by a hash of the source and flags (so an edit
rebuilds) and loaded with ``ctypes``. In a source checkout the library
goes to ``build/tpu_pose_torch/`` at the repository root; an installed
package builds into the user's cache directory. Nothing is built or
imported when this module is imported: the CPU tests import it on
machines with no ``nvcc``.

Every wrapper owns its device route: for a CPU tensor it runs the plain
PyTorch version; for a CUDA tensor it launches its kernel or raises — it
never falls back. Each keeps a launch count (``wrapper.launches``) that
only its kernel launch increments.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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


def soft_argmax_cuda(heatmaps: torch.Tensor, beta: float = 100.0,
                     stride: int = 8):
    """Soft-argmax decode, ``(B, H, W, P+1)`` float32 → joints
    ``(B, P, 2)``, conf ``(B, P)``; the same function as
    ``ops/softargmax.soft_argmax``. On a CUDA tensor it launches
    ``csrc/soft_argmax.cu`` on the current stream (no synchronize); any
    strides are taken, so the CPM's NHWC heatmaps (or an NHWC view of
    NCHW memory) are read without a copy. On a CPU tensor it runs the
    plain version."""
    if heatmaps.device.type == "cpu":
        return softargmax_lib.soft_argmax(heatmaps, beta=beta, stride=stride)
    if heatmaps.device.type != "cuda":
        raise ValueError(f"soft_argmax_cuda: unsupported device "
                         f"{heatmaps.device}")
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


soft_argmax_cuda.launches = 0


def _float_activation(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty tensor")


def _dense(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned (the kernels' vector loads)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _static_scale(name: str, a_scale, device) -> torch.Tensor:
    scale = torch.as_tensor(a_scale, dtype=torch.float32, device=device)
    if scale.dim() != 0:
        raise ValueError(f"{name}: the scale must be a scalar, got shape "
                         f"{tuple(scale.shape)}")
    return scale


def act_scale_cuda(x: torch.Tensor, a_scale=None) -> torch.Tensor:
    """The 0-d float32 per-tensor scale of ``x``; the same function as
    ``ops/quantize.act_scale``, bit for bit: ``a_scale`` when given (no
    launch), else ``max(max|x| / 127, 1e-12)`` over the whole tensor. On a
    CUDA tensor (float32 or bf16) the dynamic scale is kernel B2's abs-max
    pass (``csrc/quantize_act.cu``, counted in ``.launches``), on the
    current stream, with no host sync; a non-contiguous input is read
    through a contiguous copy. On a CPU tensor it runs the plain
    version."""
    if x.device.type == "cpu":
        return quantize_lib.act_scale(x, a_scale)
    _float_activation("act_scale_cuda", x)
    if a_scale is not None:
        return _static_scale("act_scale_cuda", a_scale, x.device)
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


act_scale_cuda.launches = 0


def quantize_act_cuda(x: torch.Tensor, a_scale=None):
    """Symmetric per-tensor int8 quantization, ``(int8 values in x's
    shape, 0-d float32 scale)``; the same function as
    ``ops/quantize.quantize_act``, bit for bit. ``a_scale``: a calibrated
    static scale (0-d float32 tensor), or None for the dynamic abs-max
    scale (:func:`act_scale_cuda`). On a CUDA tensor (float32 or bf16) it
    launches kernel B2's quantize pass (``csrc/quantize_act.cu``, counted
    in ``.launches``) on the current stream, no host sync. A
    non-contiguous input is made contiguous first. On a CPU tensor it runs
    the plain version."""
    if x.device.type == "cpu":
        return quantize_lib.quantize_act(x, a_scale)
    _float_activation("quantize_act_cuda", x)
    x = _dense(x)
    scale = act_scale_cuda(x, a_scale)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib = _library("quantize_act")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.quantize_act_q(x.data_ptr(), int(x.dtype == torch.bfloat16),
                                x.numel(), scale.data_ptr(), q.data_ptr(),
                                stream)
    _check_launch(lib, "quantize_act", rc)
    quantize_act_cuda.launches += 1
    return q, scale


quantize_act_cuda.launches = 0

_IM2COL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def quantize_im2col_cuda(x: torch.Tensor, scale, k: int, tile,
                         out: torch.Tensor) -> torch.Tensor:
    """Kernel B2 fused with the im2col gather: fill ``out`` (m, K_pad)
    int8 with the quantized im2col rows of the tile ``(b0, b1, h0, h1)``
    of a SAME, stride-1 ``k×k`` conv over ``x`` (B, H, W, C), and return
    it; the same function as ``ops/quantize.quantize_im2col``, bit for
    bit. ``x`` is float32 or bf16 with the 0-d float32 ``scale`` of the
    whole tensor, or int8 values with ``scale`` None. On a CUDA tensor it
    launches ``csrc/quantize_act.cu``'s gather on the current stream
    (counted in ``.launches``), reading ``x`` through its strides, which
    must give the channels a unit stride: the int8 path's NHWC views are
    read without a copy, and anything else raises. On a CPU tensor it runs
    the plain version."""
    if x.device.type == "cpu":
        return quantize_lib.quantize_im2col(x, scale, k, tile, out)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_im2col_cuda: unsupported device "
                         f"{x.device}")
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
    if scale is not None and (scale.device != x.device or scale.dim() != 0
                              or scale.dtype != torch.float32):
        raise ValueError("quantize_im2col_cuda: the scale must be a 0-d "
                         "float32 tensor on x's device")
    b, h, w, c = x.shape
    b0, b1, h0, h1 = tile
    m = (b1 - b0) * (h1 - h0) * w
    if not (0 <= b0 < b1 <= b and 0 <= h0 < h1 <= h and k % 2 == 1):
        raise ValueError(f"quantize_im2col_cuda: tile {tile} of a {k}x{k} "
                         f"conv does not fit {tuple(x.shape)}")
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
    return out


quantize_im2col_cuda.launches = 0
