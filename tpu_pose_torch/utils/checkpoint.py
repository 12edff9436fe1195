"""Checkpoints (port of ``tpu_pose/utils/checkpoint.py``):

- CPM train states (parameters, optimizer state, step), one directory
  per step, in the port's own format (``torch.save`` state dicts; the
  JAX package uses orbax). Trained weights reach the rest of the system,
  and the other package, through the CPM npz below;
- fitted results and CPM weights as npz files in the JAX package's
  formats, so a file written by either package loads in the other.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tpu_pose_torch.utils import tf_converter


# ---------------------------------------------------------------------------
# Train state: <ckpt_dir>/<step>/{params.pt, opt_state.pt}
# ---------------------------------------------------------------------------

def save_train_state(ckpt_dir: str, step: int, params: Any,
                     opt_state: Any) -> None:
    """Save a CPM train state under ``ckpt_dir/<step>``: ``params`` (a
    module or a state dict) and ``opt_state`` (any ``torch.save``-able
    tree, e.g. ``cpm_train.TrainOptimizer``'s state). The files are
    written into a temporary directory that then takes the step's name,
    so a crash never leaves a partial step behind; saving a step again
    replaces it."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, str(int(step)))
    tmp = f"{final}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(params, os.path.join(tmp, "params.pt"))
    torch.save(opt_state, os.path.join(tmp, "opt_state.pt"))
    old = None
    if os.path.exists(final):
        old = f"{final}.old-{os.getpid()}"
        os.replace(final, old)
    os.replace(tmp, final)
    if old is not None:
        shutil.rmtree(old)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest step saved under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir) if d.isdigit()
             and os.path.isdir(os.path.join(ckpt_dir, d))]
    return max(steps) if steps else None


def restore_train_state(ckpt_dir: str, cpm: torch.nn.Module,
                        step: Optional[int] = None) -> Tuple[int, Any, Any]:
    """Restore ``(step, cpm, opt_state)`` from ``ckpt_dir`` (the latest
    step unless ``step`` is given): the parameters are loaded into
    ``cpm`` in place, and the optimizer state's tensors are put on
    ``cpm``'s device. The JAX package's version also takes the optimizer
    state's structure; the saved state here carries its own."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(os.path.abspath(ckpt_dir), str(int(step)))
    device = next(cpm.parameters()).device
    cpm.load_state_dict(torch.load(os.path.join(path, "params.pt"),
                                   map_location=device, weights_only=True))
    opt_state = torch.load(os.path.join(path, "opt_state.pt"),
                           map_location=device, weights_only=True)
    return int(step), cpm, opt_state


# ---------------------------------------------------------------------------
# Fitted results and CPM weights (npz, the JAX package's formats)
# ---------------------------------------------------------------------------

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
