"""The exports that take an L-BFGS fit beyond tests/test_torch_export.py's
two (a symbolic-batch estimate_and_fit and fit_smpl), on the CPU: the
multi-person fit and both streaming exports here, the video fits with a
symbolic T in tests/test_torch_export_lbfgs_video.py (a file of their
own, so that the two share the suite's workers). Each artifact against
the port's live call on the same frames, bit for bit: an artifact
replays the live path's ATen ops, each L-BFGS stage a scan over its
steps with a while_loop linesearch, nested a frame scan deep in the
temporal warm starts.

Depth cut: one L-BFGS stage (the last of tests/test_torch_export.py's
SMALL_FIT) of 3 steps. Each stage is one gradient graph to trace, and the
nesting, not the number of steps, is what these exports add. Two yaw
hypotheses per frame, so the smooth and streaming fits run their Viterbi
selection over L-BFGS hypothesis fits.
"""

import dataclasses

import numpy as np
import pytest

from test_torch_export import _carry, _cfgs, _frames
from tpu_pose.api import PoseEstimator as JaxEstimator
from tpu_pose.utils import config as jc
from tpu_pose_torch import api
from tpu_pose_torch import export as pexport
from tpu_pose_torch.utils import config as tc
from torch_threads import one_thread

one_thread()

FIELDS = ("joints2d", "theta", "beta", "cam", "joints3d")


def lbfgs_estimator():
    """The port's estimator with one 3-step L-BFGS stage and two
    hypotheses per frame, on the JAX package's synthetic weights."""
    _, fit = _cfgs(tc)
    fit = dataclasses.replace(
        fit, optimizer="lbfgs",
        stages=(dataclasses.replace(fit.stages[-1], iters=3),))
    return _carry(JaxEstimator.create_synthetic(0, *_cfgs(jc)), fit,
                  fit_restarts=2)


@pytest.fixture(scope="module")
def est():
    return lbfgs_estimator()


def _equal(out: dict, live: dict) -> None:
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(out[k]),
                                      np.asarray(live[k]), err_msg=k)


def test_lbfgs_multi_artifact(est, tmp_path):
    """estimate_and_fit_multi with L-BFGS stages (batch 1, two people):
    every fitted field equal to the live call."""
    path = str(tmp_path / "multi")
    pexport.export_estimator(est, path, fn="estimate_and_fit_multi",
                             batch=1, max_people=2)
    frames = _frames(1, seed=6)
    out = pexport.load(path)(frames)
    live = est.estimate_and_fit_multi(frames, max_people=2)
    _equal(out, {k: getattr(live, k).numpy() for k in FIELDS})


def test_lbfgs_video_stream_artifact(est, tmp_path):
    """export_video_stream with L-BFGS hypothesis fits (chunk 2): the
    artifact session equals the live VideoSession over 3 frames, the
    second window anchored to the first."""
    path = str(tmp_path / "vs")
    pexport.export_video_stream(est, path, chunk=2)
    frames = _frames(3, seed=8)
    live_sess = api.VideoSession(est, chunk=2)
    live = [r for r in (live_sess.push(frames), live_sess.flush())
            if r is not None]
    art = pexport.ArtifactVideoSession(path)
    outs = [r for r in (art.push(frames), art.flush()) if r is not None]
    assert len(outs) == len(live) == 2
    for k in FIELDS:
        np.testing.assert_array_equal(
            np.concatenate([o[k] for o in outs]),
            np.concatenate([getattr(o, k).numpy() for o in live]),
            err_msg=k)


def test_lbfgs_video_multi_stream_artifact(est, tmp_path):
    """export_video_multi_stream with L-BFGS hypothesis fits (chunk 2, two
    tracks): the artifact session equals the live tracked stream over 3
    frames, identities and fits."""
    path = str(tmp_path / "vms")
    pexport.export_video_multi_stream(est, path, chunk=2, max_people=2)
    frames = _frames(3, seed=9)
    live = est.estimate_and_fit_video_multi_stream(frames, max_people=2,
                                                   chunk=2)
    sess = pexport.ArtifactVideoSession(path)
    outs = [r for r in (sess.push(frames),) if r is not None]
    outs.append(sess.flush())
    np.testing.assert_array_equal(
        np.concatenate([o["perm"] for o in outs]), live.perm.numpy())
    for k, axis in (("theta", 1), ("joints3d", 1), ("joints2d", 0)):
        np.testing.assert_array_equal(
            np.concatenate([o[k] for o in outs], axis=axis),
            getattr(live, k).numpy(), err_msg=k)
