"""Device resolution shared by every constructor that creates tensors."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Without CUDA that is an error, never a
    silent move to the CPU: pass ``device="cpu"`` to run there."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_pose_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return torch.device("cuda")


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matmuls in full precision (TF32 off) on the GPU for the
    duration, restoring the previous setting after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@contextlib.contextmanager
def full_f32_conv():
    """Float32 convolutions in full precision (cuDNN's TF32 off) for the
    duration, restoring the previous setting after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
