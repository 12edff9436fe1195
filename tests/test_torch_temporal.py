"""The port's video fitting against the JAX package: the Viterbi
hypothesis selection, the three video fits and the chunked stream form
(fitting/temporal.py) under short stage schedules, and the video entry
points of PoseEstimator, including VideoSession against the stream form.

Bounds: Viterbi selections exactly equal; θ (but the leaf joints'
rotations, see ``LEAF``), β and cam within 1e-3, joints3d MPJPE and mean
vertex error ≤ 1 mm (BASELINE.json's budget) and energy rtol 1e-3 after
the fits (float32 sums in another order, as tests/test_torch_fit.py)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pose.api import PoseEstimator as JaxEstimator
from tpu_pose.fitting import priors as jax_priors, temporal as jax_temporal
from tpu_pose.models import joints as jax_joints, smpl as jax_smpl
from tpu_pose.models import smpl_data as jax_data
from tpu_pose.utils import config as jc
from tpu_pose_torch.api import PoseEstimator, VideoSession
from tpu_pose_torch.fitting import priors as torch_priors
from tpu_pose_torch.fitting import temporal
from tpu_pose_torch.models import smpl_data as torch_data
from tpu_pose_torch.utils import config as tc
from torch_threads import one_thread

one_thread()

END_TOL = dict(rtol=0, atol=1e-3)


def _fit_cfg(cfg_mod, **kw):
    """A short two-stage schedule (camera, then everything)."""
    return cfg_mod.FitConfig(
        stages=(cfg_mod.StageConfig(iters=15, lr=0.05, opt_pose=False,
                                    opt_shape=False, w_pose_prior=0,
                                    w_shape_prior=0, w_angle_prior=0),
                cfg_mod.StageConfig(iters=25, lr=0.02, w_pose_prior=0.5,
                                    w_shape_prior=1.0)),
        img_size=64, **kw)


@pytest.fixture(scope="module")
def assets():
    return (jax_data.synthetic_smpl(seed=0),
            torch_data.synthetic_smpl(seed=0, device="cpu"),
            jax_priors.synthetic_gmm_prior(0),
            torch_priors.synthetic_gmm_prior(0, device="cpu"))


def _sequence(jm, t=4, seed=5):
    """2D joints (pixels, 64² frame) of one body moving slowly, 1 px
    noise, and per-joint confidences."""
    rng = np.random.RandomState(seed)
    theta0 = 0.2 * rng.randn(72)
    theta0[1] += 2.0
    theta = (theta0 + 0.05 * np.cumsum(rng.randn(t, 72), 0)).astype(
        np.float32)
    beta = np.broadcast_to(rng.randn(10), (t, 10)).astype(np.float32)
    out = jax_smpl.smpl_forward_batch(jm, jnp.asarray(beta),
                                      jnp.asarray(theta))
    j14 = np.asarray(jax_joints.select_smpl_joints(out.joints))
    norm = 0.9 * j14[..., :2] * np.array([1.0, -1.0])
    px = (norm * 32 + 32 + rng.randn(t, 14, 2)).astype(np.float32)
    conf = rng.uniform(0.3, 1.0, (t, 14)).astype(np.float32)
    return px, conf


# θ entries of the four leaf joints (feet 10, 11; hands 22, 23): no SMPL
# joint depends on them, so only the pose prior moves them. Where a fit
# has already brought one to the prior's stationary point, its gradient
# is float32 rounding noise, and Adam, which steps by the gradient's sign
# at that scale, walks it ±lr per step in either package. They are held
# through the mesh instead (mean vertex error ≤ 1 mm).
LEAF = [3 * j + a for j in (10, 11, 22, 23) for a in range(3)]
DRIVEN = np.setdiff1d(np.arange(72), LEAF)


def _mesh_errors_mm(jm, a, b):
    """(joints3d MPJPE, mean vertex error) in mm between two fits."""
    fwd = [jax_smpl.smpl_forward_batch(jm, jnp.asarray(np.asarray(r.beta)),
                                       jnp.asarray(np.asarray(r.theta)))
           for r in (a, b)]
    return tuple(1000.0 * float(jnp.linalg.norm(
        getattr(fwd[0], k) - getattr(fwd[1], k), axis=-1).mean())
        for k in ("joints", "vertices"))


def _compare(jm, got, want):
    for k in ("theta", "beta", "cam"):
        g, w = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        assert g.shape == w.shape, k
        if k == "theta":
            g, w = g[..., DRIVEN], w[..., DRIVEN]
        np.testing.assert_allclose(g, w, **END_TOL, err_msg=k)
    np.testing.assert_allclose(np.asarray(got.energy),
                               np.asarray(want.energy), rtol=1e-3)
    assert max(_mesh_errors_mm(jm, got, want)) <= 1.0


# -- Viterbi ------------------------------------------------------------------

VITERBI = ["plain", "nan_energy", "frame_mask", "anchor",
           "mask_anchor_nan", "ties", "two_frames"]


@pytest.mark.parametrize("tracks", [None, 2])
@pytest.mark.parametrize("case", VITERBI)
def test_viterbi_select_matches_jax(case, tracks):
    """NaN energies count as inf; masked frames add no cost even where a
    pad's energy is inf; the anchor adds a transition from frame −1;
    exact ties (equal energies and orientations) go to the first index;
    T = 2 has one transition. With ``tracks`` the port selects over a
    leading track axis in one call, held against JAX track by track."""
    rng = np.random.RandomState(VITERBI.index(case)
                                + (0 if tracks is None else 20))
    k = tracks or 1
    t, r = (2 if case == "two_frames" else 7), 4
    energy = rng.rand(k, t, r).astype(np.float32) * 5
    glob = rng.randn(k, t, r, 3).astype(np.float32)
    mask = anchor = None
    if "nan" in case:
        energy[0, 2, 1] = energy[-1, 4, 0] = np.nan
    if "mask" in case:
        mask = np.float32([[1, 1, 1, 1, 1, 0, 0],
                           [1, 1, 1, 1, 1, 1, 0]][:k])
        energy[:, 6] = np.inf
    if "anchor" in case:
        anchor = rng.randn(k, 3).astype(np.float32)
    if case == "ties":
        energy[:, :, 1:3] = energy[:, :, 1:2]
        glob[:, :, 2] = glob[:, :, 1]
        energy[-1] = 0.0
        glob[-1] = 0.0
    want = []
    for i in range(k):
        kw = {}
        if mask is not None:
            kw["frame_mask"] = jnp.asarray(mask[i])
        if anchor is not None:
            kw["anchor_glob"] = jnp.asarray(anchor[i])
        want.append(np.asarray(jax_temporal._viterbi_select(
            jnp.asarray(energy[i]), jnp.asarray(glob[i]), 0.7, **kw)))
    want = np.stack(want)
    kw = {}
    if mask is not None:
        kw["frame_mask"] = torch.from_numpy(mask)
    if anchor is not None:
        kw["anchor_glob"] = torch.from_numpy(anchor)
    if tracks is None:
        energy, glob, want = energy[0], glob[0], want[0]
        kw = {key: v[0] for key, v in kw.items()}
    got = temporal._viterbi_select(torch.from_numpy(energy),
                                   torch.from_numpy(glob), 0.7, **kw)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "ties":
        assert (got[..., -1, :] == 0).all() if tracks else \
            (got == 0).all()
        assert not (got == 2).any()


def test_viterbi_select_prefers_a_consistent_path():
    """A flip costs more than the small unary gain it buys, and ties go to
    the first index, as jnp.argmin."""
    energy = torch.tensor([[0.0, 0.2], [0.1, 0.0], [0.0, 0.2]])
    glob = torch.tensor([[[0.0, 0, 0], [3.0, 0, 0]]] * 3)
    assert temporal._viterbi_select(energy, glob, 1.0).tolist() == [0, 0, 0]
    assert temporal._viterbi_select(energy, glob, 0.001).tolist() == \
        [0, 1, 0]
    assert temporal._viterbi_select(torch.zeros(3, 2), torch.zeros(3, 2, 3),
                                    1.0).tolist() == [0, 0, 0]


# -- the video fits ------------------------------------------------------------

def test_warmstart_schedule():
    cfg = _fit_cfg(tc)
    warm = temporal.warmstart_schedule(cfg, 7)
    assert len(warm.stages) == 1 and warm.stages[0].iters == 7
    assert warm.stages[0].lr == cfg.stages[-1].lr


def test_fit_video_matches_jax(assets):
    jm, tm, jp, tp = assets
    px, conf = _sequence(jm)
    want = jax.jit(functools.partial(
        jax_temporal.fit_video, cfg=_fit_cfg(jc), prior=jp, warm_iters=8,
        anchor_restarts=3))(jm, jnp.asarray(px), jnp.asarray(conf))
    got = temporal.fit_video(tm, torch.from_numpy(px), torch.from_numpy(conf),
                             _fit_cfg(tc), tp, warm_iters=8,
                             anchor_restarts=3)
    _compare(jm, got, want)


def test_fit_video_independent_matches_jax(assets):
    jm, tm, jp, tp = assets
    px, conf = _sequence(jm, seed=6)
    want = jax.jit(functools.partial(
        jax_temporal.fit_video_independent, cfg=_fit_cfg(jc), prior=jp))(
        jm, jnp.asarray(px), jnp.asarray(conf))
    got = temporal.fit_video_independent(
        tm, torch.from_numpy(px), torch.from_numpy(conf), _fit_cfg(tc), tp)
    _compare(jm, got, want)


SMOOTH = {
    "restarts1": dict(restarts=1),
    "restarts4": dict(restarts=4),
    "per_frame_beta": dict(restarts=2, shared_beta=False),
    "mask": dict(restarts=2, mask=True),
    "anchor_mask": dict(restarts=2, mask=True, anchor=True),
}


@pytest.mark.parametrize("case", sorted(SMOOTH))
def test_fit_video_smooth_matches_jax(assets, case):
    jm, tm, jp, tp = assets
    kw = dict(SMOOTH[case])
    px, conf = _sequence(jm, seed=7)
    kw_j, kw_t = {}, {}
    if kw.pop("mask", False):
        mask = np.array([1, 1, 1, 0], np.float32)
        conf[3] = 0.0
        kw_j["frame_mask"] = jnp.asarray(mask)
        kw_t["frame_mask"] = torch.from_numpy(mask)
    if kw.pop("anchor", False):
        rng = np.random.RandomState(8)
        anchor = {"theta": (0.1 * rng.randn(72)).astype(np.float32),
                  "beta": rng.randn(10).astype(np.float32),
                  "cam": np.array([0.9, 0.0, 0.0], np.float32)}
        anchor["theta"][1] += 2.0
        kw_j["anchor"] = {k: jnp.asarray(v) for k, v in anchor.items()}
        kw_t["anchor"] = {k: torch.from_numpy(v) for k, v in anchor.items()}
    want = jax.jit(functools.partial(
        jax_temporal.fit_video_smooth, cfg=_fit_cfg(jc), prior=jp, iters=40,
        **kw))(jm, jnp.asarray(px), jnp.asarray(conf), **kw_j)
    got = temporal.fit_video_smooth(
        tm, torch.from_numpy(px), torch.from_numpy(conf), _fit_cfg(tc), tp,
        iters=40, **kw, **kw_t)
    assert got.energy_history.shape == (0,)
    _compare(jm, got, want)
    if kw.get("shared_beta", True):
        assert torch.equal(got.beta, got.beta[:1].expand_as(got.beta))


def test_fit_video_stream_matches_jax(assets):
    """T = 5 in chunks of 2: two anchored chunks and a padded one."""
    jm, tm, jp, tp = assets
    px, conf = _sequence(jm, t=5, seed=9)
    want = jax_temporal.fit_video_stream(
        jm, jnp.asarray(px), jnp.asarray(conf), cfg=_fit_cfg(jc), prior=jp,
        chunk=2, restarts=2, iters=30)
    got = temporal.fit_video_stream(
        tm, torch.from_numpy(px), torch.from_numpy(conf), _fit_cfg(tc), tp,
        chunk=2, restarts=2, iters=30)
    assert got.theta.shape == (5, 72)
    _compare(jm, got, want)


def test_interpenetration_raises(assets):
    """The interpenetration term, which raised before it was ported, in
    the four video fits against JAX, on a one-stage schedule (the full
    stage, w = 1e3, which the joint refine takes too); the stream form on
    one chunk (its anchored chunks are
    test_fit_video_stream_matches_jax's, and the term is per frame)."""
    jm, tm, jp, tp = assets
    px, conf = _sequence(jm, t=2)

    def cfg(m):
        c = _fit_cfg(m)
        last = dataclasses.replace(c.stages[-1], w_interpenetration=1e3)
        return dataclasses.replace(c, stages=(last,))

    fits = {"fit_video": dict(warm_iters=5, anchor_restarts=2),
            "fit_video_smooth": dict(restarts=2, iters=20),
            "fit_video_independent": {},
            "fit_video_stream": dict(chunk=2, restarts=2, iters=10)}
    for name, kw in fits.items():
        want = jax.jit(functools.partial(
            getattr(jax_temporal, name), cfg=cfg(jc), prior=jp, **kw))(
                jm, jnp.asarray(px), jnp.asarray(conf))
        got = getattr(temporal, name)(tm, torch.from_numpy(px),
                                      torch.from_numpy(conf), cfg(tc), tp,
                                      **kw)
        _compare(jm, got, want)


# -- PoseEstimator's video entry points ----------------------------------------

SMALL_CPM = dict(input_size=64, features=16, stage1_head_width=32,
                 refine_width=16, num_stages=2, compute_dtype="float32")


@pytest.fixture(scope="module")
def estimators():
    """The JAX estimator and the port holding its weights (float32)."""
    jest = JaxEstimator.create_synthetic(0, jc.CPMConfig(**SMALL_CPM),
                                         _fit_cfg(jc), fit_restarts=2)
    params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in jest.cpm_params.items()}
    smpl = {k: np.asarray(v) for k, v in jest.smpl_model._asdict().items()}
    prior = {k: np.asarray(getattr(jest.prior, k))
             for k in ("means", "precisions", "log_consts")}
    test = PoseEstimator.from_numpy(params, smpl, prior,
                                    tc.CPMConfig(**SMALL_CPM), _fit_cfg(tc),
                                    device="cpu", fit_restarts=2)
    return jest, test


def _frames(t, seed):
    return np.random.RandomState(seed).randint(
        0, 256, (t, 64, 64, 3)).astype(np.uint8)


def _compare_results(jm, got, want):
    """An EstimateAndFitResult against JAX's: joints2d 1e-2 px, then the
    fit as :func:`_compare`."""
    np.testing.assert_allclose(got.joints2d.numpy(),
                               np.asarray(want.joints2d), rtol=0, atol=1e-2)
    assert got.vertices.shape == want.vertices.shape
    _compare(jm, got, want)


@pytest.mark.parametrize("mode", ["smooth", "temporal", "independent"])
def test_estimate_and_fit_video_matches_jax(assets, estimators, mode):
    jest, test = estimators
    frames = _frames(3, seed=3)
    want = jest.estimate_and_fit_video(jnp.asarray(frames), mode=mode)
    got = test.estimate_and_fit_video(frames, mode=mode)
    _compare_results(assets[0], got, want)


def test_estimate_and_fit_video_stream_and_session(assets, estimators):
    """The stream form against JAX's (T = 5, chunk 2), and VideoSession fed
    the same frames in irregular pushes against the stream form: the same
    windows and anchor carry; the last window pads with zero frames where
    the stream repeats the last frame's joints, both masked out."""
    jest, test = estimators
    frames = _frames(5, seed=5)
    want = jest.estimate_and_fit_video_stream(jnp.asarray(frames), chunk=2)
    ref = test.estimate_and_fit_video_stream(frames, chunk=2)
    _compare_results(assets[0], ref, want)
    sess = VideoSession(test, chunk=2)
    outs = [sess.push(frames[lo:hi]) for lo, hi in ((0, 1), (1, 4), (4, 5))]
    assert outs[0] is None and outs[1].theta.shape == (4, 72)
    assert outs[2] is None and sess.frames_buffered == 1
    outs = [outs[1], sess.flush()]
    theta = torch.cat([o.theta for o in outs])
    joints2d = torch.cat([o.joints2d for o in outs])
    torch.testing.assert_close(joints2d, ref.joints2d, rtol=0, atol=1e-4)
    torch.testing.assert_close(theta, ref.theta, rtol=0, atol=1e-3)
    with pytest.raises(RuntimeError, match="flushed"):
        sess.push(frames[:1])
    with pytest.raises(RuntimeError, match="flushed"):
        sess.flush()


def test_video_entry_points_reject_bad_input(estimators):
    _, test = estimators
    with pytest.raises(ValueError, match="unknown video mode"):
        test.estimate_and_fit_video(_frames(2, 0), mode="bogus")
    for call in (test.estimate_and_fit_video,
                 test.estimate_and_fit_video_stream):
        with pytest.raises(ValueError, match="frame stack"):
            call(np.zeros((64, 64, 3), np.uint8))
    assert VideoSession(test, chunk=2).flush() is None
