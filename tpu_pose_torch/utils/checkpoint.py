"""Fitted results and CPM weights as npz files (port of the npz half of
``tpu_pose/utils/checkpoint.py``), in the JAX package's formats, so a
file written by either package loads in the other.

The JAX module's train-state checkpoints (``save_train_state``,
``restore_train_state``, ``latest_step``) store a training state the port
has only once training is ported (ROADMAP A.19).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from tpu_pose_torch.utils import tf_converter


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_fit_results(path: str, theta: Any, beta: Any, cam: Any,
                     energy: Any = None, extra: Optional[Dict] = None
                     ) -> None:
    """Save fitted (θ, β, cam[, energy]) arrays or tensors, batched or
    single, as a compressed npz (``extra``: more named arrays). The write
    goes to a temporary file that replaces ``path`` at once."""
    arrays = {"theta": _host(theta), "beta": _host(beta), "cam": _host(cam)}
    if energy is not None:
        arrays["energy"] = _host(energy)
    for k, v in (extra or {}).items():
        arrays[k] = _host(v)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def load_fit_results(path: str) -> Dict[str, np.ndarray]:
    """Every array of a :func:`save_fit_results` file, as numpy."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def save_cpm_params(path: str, params) -> None:
    """CPM weights in the flat npz format of
    ``tf_converter.save_params_npz`` (the JAX package's), from a
    ``{layer: {kind: array}}`` dict or a CPM / QuantizedCPM module; load
    with ``tf_converter.load_params_npz``."""
    if isinstance(params, torch.nn.Module):
        from tpu_pose_torch.models import cpm as cpm_lib
        params = cpm_lib.cpm_params_to_numpy(params)
    tf_converter.save_params_npz(
        path, {layer: {k: _host(v) for k, v in wb.items()}
               for layer, wb in params.items()})
