"""CPM weight interchange in the JAX package's npz format (port of
``tpu_pose/utils/tf_converter.py:save_params_npz/load_params_npz``).

The format is a flat npz of ``layer.kind`` arrays — ``w`` HWIO and ``b``
for float weights; ``w_int8`` HWIO int8, ``w_scale``, ``b`` and an
optional 0-d ``a_scale`` for int8 weights. It is numpy only;
``models/cpm.cpm_params_from_numpy`` turns the loaded dict into a
:class:`~tpu_pose_torch.models.cpm.CPM` or
:class:`~tpu_pose_torch.models.cpm.QuantizedCPM`, and
``cpm_params_to_numpy`` goes the other way.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def save_params_npz(path: str, params: Dict[str, dict]) -> None:
    """Flat ``layer.kind`` npz of a ``{layer: {kind: array}}`` dict."""
    flat = {}
    for layer, wb in params.items():
        for kind, v in wb.items():
            flat[f"{layer}.{kind}"] = np.asarray(v)
    np.savez(path, **flat)


def load_params_npz(path: str) -> Dict[str, dict]:
    """``{layer: {kind: numpy array}}`` from a :func:`save_params_npz`
    file (the JAX package writes the same format)."""
    params: Dict[str, dict] = {}
    with np.load(path) as z:
        for key in z.files:
            layer, kind = key.rsplit(".", 1)
            params.setdefault(layer, {})[kind] = z[key]
    return params
