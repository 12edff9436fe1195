"""The video fits with L-BFGS stages and a symbolic T, exported, on the
CPU: each mode's artifact against the port's live call on the same
frames, bit for bit. The estimator and the depth cut are
tests/test_torch_export_lbfgs.py's (one 3-step L-BFGS stage, two yaw
hypotheses per frame, so that the smooth fit runs its Viterbi selection
over L-BFGS hypothesis fits).
"""

import numpy as np
import pytest

from test_torch_export import _frames, _np
from test_torch_export_lbfgs import FIELDS, lbfgs_estimator
from tpu_pose_torch import export as pexport
from torch_threads import one_thread

one_thread()


@pytest.fixture(scope="module")
def est():
    return lbfgs_estimator()


def _equal(out: dict, live: dict) -> None:
    for k in FIELDS:
        np.testing.assert_array_equal(out[k], live[k], err_msg=k)


@pytest.mark.parametrize("mode", ["temporal", "smooth", "independent"])
def test_lbfgs_video_artifact_symbolic_t(est, tmp_path, mode):
    """estimate_and_fit_video with L-BFGS stages and a symbolic T: the
    temporal mode's warm starts (a scan over frames whose body is an
    L-BFGS stage: a scan with a while_loop inside), the smooth mode's
    hypothesis fits, the independent mode's batch of frames, each equal
    to the live call at T = 2 and T = 3."""
    path = str(tmp_path / mode)
    meta = pexport.export_estimator(est, path, fn="estimate_and_fit_video",
                                    mode=mode)
    assert meta["input"]["shape"][0] == "b"
    prog = pexport.load(path)
    for t in (2, 3):
        frames = _frames(t, seed=7)
        _equal(prog(frames), _np(est.estimate_and_fit_video(frames,
                                                            mode=mode)))
