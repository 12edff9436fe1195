"""Numerical checks (port of ``tpu_pose/utils/debug.py``): NaN and Inf
escaping a fit or a decode.

- :func:`enable_nan_checks` — ``torch.autograd.set_detect_anomaly``;
- :func:`checked` — run a function and report the first non-finite
  output as an error value with ``.throw()``, as ``checkify`` does;
- :func:`assert_all_finite` — a guard at a subsystem boundary.

Each check reads a flag on the host, so it waits for the device: use them
in tests and debugging runs, not on the serving path.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch


def enable_nan_checks(enable: bool = True) -> None:
    """Raise where a backward pass produces NaN
    (``torch.autograd.set_detect_anomaly``). This covers the backward of
    every op under autograd (the fit's gradients), not every op's forward
    output as ``jax_debug_nans`` does; :func:`checked` covers outputs."""
    torch.autograd.set_detect_anomaly(enable)


class CheckError:
    """The outcome of a :func:`checked` call: :meth:`get` gives None or
    the ``FloatingPointError`` naming the first non-finite output (or the
    one :func:`assert_all_finite` raised); :meth:`throw` raises it."""

    def __init__(self, error: Optional[FloatingPointError] = None):
        self._error = error

    def get(self) -> Optional[FloatingPointError]:
        return self._error

    def throw(self) -> None:
        if self._error is not None:
            raise self._error


def _first_nonfinite(tree: Any, path: str = "output") -> Optional[str]:
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point() and not bool(torch.isfinite(tree).all()):
            return path
        return None
    if hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return None
    for key, value in items:
        found = _first_nonfinite(value, f"{path}.{key}" if isinstance(
            key, str) else f"{path}[{key}]")
        if found is not None:
            return found
    return None


def checked(fn: Callable) -> Callable:
    """``fn`` → a function returning ``(error, result)``: ``error`` is a
    :class:`CheckError`, set when a floating output of ``fn`` (a tensor,
    or one nested in tuples, NamedTuples, lists or dicts) holds NaN or
    Inf, or when :func:`assert_all_finite` raised inside ``fn`` (the
    result is then None). Call ``error.throw()`` to raise it."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            out = fn(*args, **kwargs)
        except FloatingPointError as e:
            return CheckError(e), None
        bad = _first_nonfinite(out)
        if bad is None:
            return CheckError(), out
        return CheckError(FloatingPointError(
            f"{bad} contains NaN/Inf")), out

    return wrapped


def assert_all_finite(x, name: str = "value"):
    """Raise ``FloatingPointError`` if ``x`` holds NaN or Inf; return it
    unchanged otherwise (inside :func:`checked`, the error is reported
    instead of raised)."""
    if not bool(torch.isfinite(torch.as_tensor(x)).all()):
        raise FloatingPointError(f"{name} contains NaN/Inf")
    return x
