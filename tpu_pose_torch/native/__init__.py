"""Host-side native (C++) code for the serving front end: the letterbox
(port of ``tpu_pose/native``).

``letterbox.cpp`` is compiled on first use by ``g++`` into a shared
library named by a hash of the source, the compiler flags and the host's
CPU (``-march=native`` makes the binary host-specific), in the same build
directory as the CUDA kernels (``ops/cuda_kernels.build_dir``: ``build/
tpu_pose_torch/`` in a source checkout, never inside the package). It is
loaded with ctypes, which releases the GIL for the call, so concurrent
``BatchingServer.submit`` threads letterbox in parallel.

It is host code, not a device kernel, and optional: :func:`letterbox_u8`
returns None when the compiler or the library is missing, and the caller
(``ops/preprocess.letterbox_image_np``) takes its numpy path, which this
matches within 1 uint8 LSB. :func:`available` says which path runs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

from tpu_pose_torch.ops import preprocess as pre
from tpu_pose_torch.ops.cuda_kernels import build_dir

SRC = Path(__file__).resolve().parent / "letterbox.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB = None
_LIB_FAILED = False


def _host_cpu() -> bytes:
    """This host's CPU model and feature flags (Linux), which
    ``-march=native`` compiles for: a build directory copied to another
    machine then never loads a binary made for this one."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.processor().encode()
    keys = (b"model name", b"flags")
    return b"\n".join(sorted({ln for ln in lines if ln.startswith(keys)}))


def library_path() -> Path:
    """Where the library for this source, these flags and this host's CPU
    goes."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()
                            + _host_cpu()).hexdigest()
    return build_dir() / f"libletterbox-{digest[:16]}.so"


def _build_and_load() -> ctypes.CDLL:
    """Compile (unless built) and load the library. Raises on any
    failure; the caller treats that as 'native unavailable'."""
    so = library_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")  # concurrent builds
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.letterbox_resample_u8
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint8,
    ]
    return lib


def _lib():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is None and not _LIB_FAILED:
            try:
                _LIB = _build_and_load()
            except (OSError, subprocess.SubprocessError):
                _LIB_FAILED = True  # no g++ or no library: numpy path
    return _LIB


def available() -> bool:
    """True if the native letterbox compiled and loaded on this host."""
    return _lib() is not None


@functools.lru_cache(maxsize=64)
def _plan(n_in: int, n_out: int):
    """C-contiguous resample plan (idx int64, w float32) from the one
    source of the convention, ``ops/preprocess._resample_weights_np``."""
    idx, w = pre._resample_weights_np(n_in, n_out)
    return (np.ascontiguousarray(idx, np.int64),
            np.ascontiguousarray(w, np.float32))


def letterbox_u8(img: np.ndarray, size: int, fill: int = 128):
    """Native letterbox of one (H, W, C) uint8 frame to a (size, size, C)
    uint8 network frame (aspect-preserving resample + centered pad).

    Returns the output, or None where the native path does not apply
    (non-uint8 input, identity geometry, or no compiled library); the
    caller then takes ``ops/preprocess.letterbox_image_np``'s numpy path.
    """
    lib = _lib()
    if lib is None or img.dtype != np.uint8 or img.ndim != 3:
        return None
    h0, w0, c = img.shape
    nh, nw, off_y, off_x = pre._letterbox_geometry(h0, w0, size)
    if (nh, nw) == (h0, w0):
        return None  # pad only: the numpy path has no resample to do
    iy, wy = _plan(h0, nh)
    ix, wx = _plan(w0, nw)
    img = np.ascontiguousarray(img)
    out = np.empty((size, size, c), np.uint8)
    rc = lib.letterbox_resample_u8(
        img.ctypes.data, h0, w0, c,
        iy.ctypes.data, wy.ctypes.data, nh, iy.shape[1],
        ix.ctypes.data, wx.ctypes.data, nw, ix.shape[1],
        out.ctypes.data, size, off_y, off_x, int(fill) & 0xFF)
    if rc != 0:
        raise ValueError(f"letterbox_resample_u8 rejected its arguments "
                         f"(rc {rc}) for a {img.shape} frame to {size}")
    return out
