"""CPM weight interchange: the TF1-checkpoint converter and the JAX
package's npz format (port of ``tpu_pose/utils/tf_converter.py``).

The reference restores a pretrained Caffe→TF CPM checkpoint with
``tf.train.Saver``. The CPM's params are keyed by the same Caffe layer
names (``models/cpm._layer_defs``), so :func:`convert_tf_checkpoint` is
a name-mapping walk over the checkpoint's variable list; it imports
TensorFlow inside the function, and nothing else in the port needs it.

The npz format is a flat npz of ``layer.kind`` arrays — ``w`` HWIO and
``b`` for float weights; ``w_int8`` HWIO int8, ``w_scale``, ``b`` and an
optional 0-d ``a_scale`` for int8 weights. It is numpy only;
``models/cpm.cpm_params_from_numpy`` turns the loaded dict into a
:class:`~tpu_pose_torch.models.cpm.CPM` or
:class:`~tpu_pose_torch.models.cpm.QuantizedCPM`, and
``cpm_params_to_numpy`` goes the other way.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# Candidate TF variable-name templates per lineage; the converter tries each
# until the checkpoint matches (the exact reference naming is unverified).
_NAME_TEMPLATES = (
    "{layer}/weights",            # tf-slim style
    "{layer}/biases",
    "{layer}/kernel",             # tf.layers style
    "{layer}/bias",
    "CPM/{layer}/weights",
    "CPM/{layer}/biases",
    "{layer}_W",                  # plain-variable ports
    "{layer}_b",
)


def convert_tf_checkpoint(ckpt_path: str, layer_names) -> Dict[str, dict]:
    """Read a TF1 CPM checkpoint and return ``{layer: {"w", "b"}}``:
    float32 numpy, ``w`` HWIO (TF's own conv layout), the format
    ``models/cpm.cpm_params_from_numpy`` and :func:`save_params_npz` take.

    Args:
      ckpt_path: path/prefix of the ``.ckpt``.
      layer_names: iterable of Caffe layer names (e.g. from
        ``cpm._layer_defs(cfg)``).
    Raises KeyError if any layer cannot be located under any known naming
    scheme, ValueError for a kernel that is not 4-D.
    """
    import tensorflow as tf  # local import: only the converter needs it

    reader = tf.train.load_checkpoint(ckpt_path)
    available = set(reader.get_variable_to_shape_map())

    def find(layer: str, kind: str) -> np.ndarray:
        wanted = [t for t in _NAME_TEMPLATES
                  if ("weight" in t or "kernel" in t or t.endswith("_W"))
                  == (kind == "w")]
        for t in wanted:
            name = t.format(layer=layer)
            if name in available:
                return reader.get_tensor(name)
        raise KeyError(
            f"no checkpoint variable for layer {layer!r} ({kind}); "
            f"available sample: {sorted(available)[:8]}")

    params = {}
    for layer in layer_names:
        w = np.asarray(find(layer, "w"), np.float32)
        b = np.asarray(find(layer, "b"), np.float32)
        if w.ndim != 4:
            raise ValueError(f"{layer}: expected 4D kernel, got {w.shape}")
        params[layer] = {"w": w, "b": b}
    return params


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
