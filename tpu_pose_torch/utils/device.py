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
    duration, restoring the previous setting after. Each entry counts in
    ``full_f32_matmul.entries``: a traced program does not record the
    flag, so an export reads the count to run the program exact
    (``export.py``)."""
    full_f32_matmul.entries += 1
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


full_f32_matmul.entries = 0


@contextlib.contextmanager
def full_f32_conv():
    """Float32 convolutions in full precision (cuDNN's TF32 off) for the
    duration, restoring the previous setting after; entries count in
    ``full_f32_conv.entries``, as for :func:`full_f32_matmul`."""
    full_f32_conv.entries += 1
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


full_f32_conv.entries = 0


def no_grad():
    """``torch.no_grad()``, or nothing when grad mode is already off (the
    same effect): an export traces under ``no_grad``, and each toggle,
    even one that changes nothing, becomes a grad-mode region of the
    exported graph that ``torch.export`` splits out and merges back
    (seconds per export)."""
    return (torch.no_grad() if torch.is_grad_enabled()
            else contextlib.nullcontext())
