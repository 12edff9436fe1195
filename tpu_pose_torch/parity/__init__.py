"""Parity harness (port of ``tpu_pose/parity``): makes the "MPJPE within
1 mm of the reference" target certifiable by one command.

- :mod:`oracle`  — reference-style decode + SMPL + projection + staged
  fit: a float64 host graph with a scipy L-BFGS loop, the reference
  lineage's idioms, independent of the port's compute modules.
- :mod:`harness` — stagewise parity report + end-to-end fit gap (MPJPE).
- :mod:`sweep`   — auto-sweep of FitConfig to minimize the gap; JSON out.
- :mod:`day_one` — the unattended chain from a reference directory:
  discovery, conversion, loading, certification, sweep, smoke eval.

CLIs: ``python -m tpu_pose_torch.tools.parity_sweep`` (certify or sweep
modes) and ``python -m tpu_pose_torch.tools.reference_day_one``.
"""

from tpu_pose_torch.parity import harness, oracle, sweep  # noqa: F401
