"""Tracked multi-person video in the port against the JAX package: every
function of fitting/tracking.py on constructed features (as
tests/test_tracking.py builds them, with the cost margins stated at each),
the track-batched smooth fit, and ``estimate_and_fit_video_multi``, its
stream form and ``MultiPersonVideoSession`` on tests/test_tracking.py's
small CPM and fit schedule, with the JAX weights carried across.

Bounds: perms, masks and liveness exactly; appearance features and the
Viterbi state 1e-5; smoothed centers 1e-3 px; joints2d 1e-2 px and person
scores 1e-5; the fits as tests/test_torch_temporal.py (θ without the leaf
joints' rotations, β and cam 1e-3, joints3d MPJPE ≤ 1 mm)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import two_people_frames
from tpu_pose.api import PoseEstimator as JaxEstimator
from tpu_pose.fitting import temporal as jax_temporal
from tpu_pose.fitting import tracking as jax_tracking
from tpu_pose.models import cpm as jax_cpm
from tpu_pose.utils import config as jc
from tpu_pose_torch.api import MultiPersonVideoSession, PoseEstimator
from tpu_pose_torch.fitting import temporal, tracking
from tpu_pose_torch.models import cpm as torch_cpm
from tpu_pose_torch.utils import config as tc
from torch_threads import one_thread

one_thread()

LEAF = [3 * j + a for j in (10, 11, 22, 23) for a in range(3)]
DRIVEN = np.setdiff1d(np.arange(72), LEAF)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _shuffle_slots(rng, tracks):
    """Ground-truth track features (T, k, D) → a per-frame slot-shuffled
    copy and the shuffles."""
    t, k, _ = tracks.shape
    perms = np.stack([rng.permutation(k) for _ in range(t)])
    slots = np.empty_like(tracks)
    for i in range(t):
        slots[i, perms[i]] = tracks[i]
    return slots, perms


def test_permutations_order():
    for k in (1, 2, 3, 4):
        np.testing.assert_array_equal(
            tracking._permutations(k, torch.device("cpu")).numpy(),
            np.asarray(jax_tracking._permutations(k)))


@pytest.mark.parametrize("patch", [3, 5])
def test_appearance_features_matches_jax(patch):
    """Bilinear patch means, joints inside, on and beyond the edges."""
    rng = np.random.RandomState(patch)
    img = (rng.rand(3, 32, 32, 3) - 0.5).astype(np.float32)
    joints = rng.uniform(-6, 38, (3, 2, 14, 2)).astype(np.float32)
    joints[0, 0, 0] = [0.0, 0.0]
    joints[0, 0, 1] = [31.0, 31.0]
    want = np.asarray(jax_tracking.appearance_features(
        jnp.asarray(img), jnp.asarray(joints), patch=patch))
    got = tracking.appearance_features(_t(img), _t(joints), patch=patch)
    assert got.shape == (3, 2, 42)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _greedy_inputs(case):
    """Three separated trajectories (tracks ≥ 0.4 apart per coordinate,
    steps ≤ 0.04), slots shuffled per frame; 'score_gate': one track's slot
    is garbage with score 0 for five frames."""
    rng = np.random.RandomState(0)
    t, k, d = 16, 3, 4
    base = np.array([[0, 0, 0, 0], [.8, .6, .4, .7], [1.6, 1.4, .9, .1]])
    tracks = (base[None] + rng.uniform(-.02, .02, (t, k, d)).cumsum(0)
              ).astype(np.float32)
    scores = rng.uniform(0.85, 1.0, (t, k)).astype(np.float32)
    if case == "score_gate":
        tracks[6:11, 1] = rng.uniform(0, 2, (5, d))
        scores[6:11, 1] = 0.0
    slots, perms = _shuffle_slots(rng, tracks)
    slot_scores = np.empty_like(scores)
    for i in range(t):
        slot_scores[i, perms[i]] = scores[i]
    return slots, slot_scores


@pytest.mark.parametrize("case", ["plain", "score_gate", "state_carry"])
def test_associate_tracks_matches_jax(case):
    slots, scores = _greedy_inputs(case)
    kw = dict(score_gate=0.5)
    if case != "state_carry":
        want = np.asarray(jax_tracking.associate_tracks(
            jnp.asarray(slots), jnp.asarray(scores), **kw))
        got = tracking.associate_tracks(_t(slots), _t(scores), **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        return
    p1_j, st_j = jax_tracking.associate_tracks(
        jnp.asarray(slots[:7]), jnp.asarray(scores[:7]), return_state=True,
        **kw)
    p2_j = jax_tracking.associate_tracks(
        jnp.asarray(slots[7:]), jnp.asarray(scores[7:]), init_state=st_j,
        **kw)
    p1_t, st_t = tracking.associate_tracks(_t(slots[:7]), _t(scores[:7]),
                                           return_state=True, **kw)
    p2_t = tracking.associate_tracks(_t(slots[7:]), _t(scores[7:]),
                                     init_state=st_t, **kw)
    np.testing.assert_array_equal(p1_t.numpy(), np.asarray(p1_j))
    np.testing.assert_array_equal(p2_t.numpy(), np.asarray(p2_j))
    for a, b in zip(st_t, st_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_gather_tracks_and_compose_perms_match_jax():
    rng = np.random.RandomState(3)
    t, k = 7, 4
    p1 = np.stack([rng.permutation(k) for _ in range(t)]).astype(np.int32)
    p2 = np.stack([rng.permutation(k) for _ in range(t)]).astype(np.int32)
    x = rng.rand(t, k, 5).astype(np.float32)
    want = np.asarray(jax_tracking.compose_perms(jnp.asarray(p1),
                                                 jnp.asarray(p2)))
    got = tracking.compose_perms(_t(p1), _t(p2))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tracking.gather_tracks(_t(x), _t(p1)).numpy(),
        np.asarray(jax_tracking.gather_tracks(jnp.asarray(x),
                                              jnp.asarray(p1))))
    np.testing.assert_array_equal(
        tracking.gather_tracks(tracking.gather_tracks(_t(x), _t(p1)),
                               _t(p2)).numpy(),
        tracking.gather_tracks(_t(x), got).numpy())


def test_presence_hysteresis_matches_jax():
    rng = np.random.RandomState(4)
    strong = rng.rand(12, 3) > 0.7
    weak = strong | (rng.rand(12, 3) > 0.3)
    init = np.array([False, True, True])
    want = np.asarray(jax_tracking.presence_hysteresis(
        jnp.asarray(strong), jnp.asarray(weak), jnp.asarray(init)))
    got = tracking.presence_hysteresis(_t(strong), _t(weak), _t(init))
    np.testing.assert_array_equal(got.numpy(), want)


def _center_case(case):
    t = 24 if case in ("outlier", "pad_frame") else 5
    x = np.linspace(10.0, 50.0, t, dtype=np.float32)
    obs = np.stack([np.stack([x, np.full(t, 32.0, np.float32)], -1),
                    np.stack([60 - x, 20 + 0.5 * x], -1)], 1)   # (T, 2, 2)
    w = np.ones((t, 2), np.float32)
    if case == "outlier":
        obs[10, 0] += (40.0, -25.0)
        w[:, 1] = np.linspace(0.2, 1.5, t)
    elif case == "pad_frame":
        obs[15, 0] = (0.0, 0.0)
        w[15] = 0.0
    elif case == "single_observation":
        w[1:] = 0.0
    elif case == "all_zero":
        w[:] = 0.0
    elif case == "two_frames":
        obs, w = obs[:2], w[:2]
    return obs.astype(np.float32), w


def _smooth_f64(obs, w, lam=8.0, sigma=30.0, iters=2):
    """smooth_track_centers' closed form and IRLS in float64 (numpy)."""
    obs = np.swapaxes(obs, 0, 1).astype(np.float64)
    w0 = np.maximum(np.swapaxes(w, 0, 1).astype(np.float64), 0.0)
    w0 = w0 / (w0.mean(-1, keepdims=True) + 1e-8) + 1e-3
    eye = np.eye(obs.shape[1])
    d2 = eye[:-2] - 2.0 * eye[1:-1] + eye[2:]
    reg = lam * d2.T @ d2 + 1e-6 * eye

    def solve(ws):
        return np.stack([np.linalg.solve(reg + np.diag(wi), wi[:, None] * o)
                         for wi, o in zip(ws, obs)])

    sm = solve(w0)
    for _ in range(iters):
        wr = w0 * np.exp(-((sm - obs) ** 2).sum(-1) / sigma ** 2)
        sm = solve(wr / (wr.mean(-1, keepdims=True) + 1e-8) + 1e-3)
    return np.swapaxes(sm, 0, 1)


@pytest.mark.parametrize("case", ["outlier", "pad_frame",
                                  "single_observation", "all_zero",
                                  "two_frames"])
def test_smooth_track_centers_matches_jax(case):
    """The IRLS smoother on an outlier, a zero-weight pad frame, a track
    with one observation (the 1e-3 weight floor keeps it finite), all
    weights zero, and T < 3 (returned as is): 1e-3 px. With one
    observation the system's condition number is ≈ 1e5 (the floor's 1e-3
    against λ‖D₂‖²), so float32 LU solves in two LAPACKs differ by
    ≈ 1e-2 px (JAX's own is 0.014 px from the float64 solution): that case
    is held to the float64 solution within 0.05 px, as is JAX's."""
    obs, w = _center_case(case)
    want = np.asarray(jax_tracking.smooth_track_centers(jnp.asarray(obs),
                                                        jnp.asarray(w)))
    got = tracking.smooth_track_centers(_t(obs), _t(w))
    assert bool(torch.isfinite(got).all())
    if case != "single_observation":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
        return
    exact = _smooth_f64(obs, w)
    for sm in (got.numpy(), want):
        np.testing.assert_allclose(sm, exact, rtol=0, atol=0.05)
    assert abs(got[0, 0, 0] - 10.0) < 0.1


def _viterbi_case(case):
    """(geom, app, scores, kwargs) with the cost margins of
    tests/test_tracking.py's constructions: same-person appearance within
    0.01, different people ≥ 0.6 apart per channel."""
    rng = np.random.RandomState(len(case))
    if case.startswith("random_k"):
        k = int(case[-1])
        return (rng.randn(10, k, 6).astype(np.float32),
                rng.randn(10, k, 9).astype(np.float32), None, {})
    if case == "crossing_gap":
        t, k = 20, 2
        x = np.linspace(0.0, 1.0, t, dtype=np.float32)
        geom = np.zeros((t, k, 2), np.float32)
        geom[:, 0, 0], geom[:, 1, 0] = x, 1.0 - x
        geom[:, :, 1] = 0.5
        app = np.zeros((t, k, 3), np.float32)
        app[:, 0], app[:, 1] = (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)
        order = np.argsort(geom[..., 0], axis=1)
        geom = np.take_along_axis(geom, order[..., None], 1)
        app = np.take_along_axis(app, order[..., None], 1)
        geom[8:12] = rng.rand(4, k, 2)
        app[8:12] = rng.rand(4, k, 3)
        return geom, app, None, {}
    t = 18
    app = np.zeros((t, 2, 3), np.float32)
    app[:, 0] = [0.9, 0.1, 0.1]
    geom = np.zeros((t, 2, 2), np.float32)
    geom[:, 0, 0], geom[:, 1, 0] = 0.3, 0.7
    scores = np.ones((t, 2), np.float32)
    kw = dict(score_gate=0.5)
    if case == "birth":                 # B enters at frame 6
        app[:, 1] = rng.rand(t, 3)
        app[6:, 1] = [0.1, 0.1, 0.9]
        scores[:6, 1] = 0.1
        app[9:12], geom[9:12] = app[9:12, ::-1], geom[9:12, ::-1]
    elif case in ("death", "no_death"):  # B leaves at 7, C enters at 12
        app[:7, 1] = [0.1, 0.9, 0.1]
        app[7:12, 1] = rng.rand(5, 3)
        app[12:, 1] = [0.1, 0.1, 0.9]
        scores[7:12, 1] = 0.1
        kw["death_frames"] = 3 if case == "death" else 0
    elif case == "refresh":             # appearances drift and swap slots
        u = np.linspace(0.0, 1.0, t, dtype=np.float32)[:, None]
        e = np.eye(3, dtype=np.float32)
        app[:, 0] = (1.0 - u) * e[0] + u * e[2]
        app[:, 1] = (1.0 - u) * e[1] + u * e[0]
        app[12:] = app[12:, ::-1]
        app[8:12] = rng.rand(4, 2, 3)
        geom[:] = 0.0
        kw = dict(anchor_refresh=0.5)
    elif case == "pad_frames":          # an all-non-live stretch
        app[:, 1] = [0.1, 0.1, 0.9]
        scores[5:9] = -1e9
        app[5:9] = 0.0
    app += rng.uniform(-0.01, 0.01, app.shape).astype(np.float32)
    return geom, app, scores, kw


VITERBI = ["random_k2", "random_k3", "crossing_gap", "birth", "death",
           "no_death", "refresh", "pad_frames"]


@pytest.mark.parametrize("case", VITERBI)
def test_associate_tracks_viterbi_matches_jax(case):
    """The perms exactly and the returned state within 1e-5, on the
    reference's own constructions: random features (k = 2, 3), a crossing
    with a garbage gap, a birth, a death with and without death_frames,
    anchor refresh through drifting appearances, and non-live frames."""
    geom, app, scores, kw = _viterbi_case(case)
    s_j = None if scores is None else jnp.asarray(scores)
    s_t = None if scores is None else _t(scores)
    p_j, st_j = jax_tracking.associate_tracks_viterbi(
        jnp.asarray(geom), jnp.asarray(app), s_j, return_state=True, **kw)
    p_t, st_t = tracking.associate_tracks_viterbi(
        _t(geom), _t(app), s_t, return_state=True, **kw)
    assert p_t.dtype == torch.int32
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    assert len(st_t) == 7
    for a, b in zip(st_t, st_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    if case == "death":
        # C re-anchored the slot B's death freed.
        assert st_t[4][1, 2] > 0.6
    if case == "refresh":
        assert not np.array_equal(
            p_t.numpy(), np.asarray(jax_tracking.associate_tracks_viterbi(
                jnp.asarray(geom), jnp.asarray(app))))


@pytest.mark.parametrize("case", ["birth", "death", "refresh"])
def test_associate_tracks_viterbi_state_carry_matches_jax(case):
    """Windows chained through init_state / return_state give the one-call
    perms, in both packages, and the same carried state (1e-5)."""
    geom, app, scores, kw = _viterbi_case(case)
    split = 5
    s = np.ones(geom.shape[:2], np.float32) if scores is None else scores
    p1_j, st_j = jax_tracking.associate_tracks_viterbi(
        jnp.asarray(geom[:split]), jnp.asarray(app[:split]),
        jnp.asarray(s[:split]), return_state=True, **kw)
    p2_j = jax_tracking.associate_tracks_viterbi(
        jnp.asarray(geom[split:]), jnp.asarray(app[split:]),
        jnp.asarray(s[split:]), init_state=st_j, **kw)
    p1_t, st_t = tracking.associate_tracks_viterbi(
        _t(geom[:split]), _t(app[:split]), _t(s[:split]),
        return_state=True, **kw)
    p2_t = tracking.associate_tracks_viterbi(
        _t(geom[split:]), _t(app[split:]), _t(s[split:]), init_state=st_t,
        **kw)
    for a, b in zip(st_t, st_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(p1_t.numpy(), np.asarray(p1_j))
    np.testing.assert_array_equal(p2_t.numpy(), np.asarray(p2_j))
    whole = tracking.associate_tracks_viterbi(_t(geom), _t(app), _t(s),
                                              **kw)
    np.testing.assert_array_equal(torch.cat([p1_t, p2_t]).numpy(),
                                  whole.numpy())


# -- the track-batched smooth fit ---------------------------------------------

def _fit_cfg(cfg_mod, img_size=64):
    """tests/test_tracking.py's schedule."""
    return cfg_mod.FitConfig(
        stages=(cfg_mod.StageConfig(iters=10, lr=0.05, opt_pose=False,
                                    opt_shape=False, w_pose_prior=0,
                                    w_shape_prior=0, w_angle_prior=0),
                cfg_mod.StageConfig(iters=15, lr=0.02, w_pose_prior=0.5,
                                    w_shape_prior=1.0)),
        img_size=img_size)


# tests/test_tracking.py's small CPM at a 192 px input: the stream form has
# no NMS radius knob, and its default 96 px covers a whole 64 px frame,
# which would leave the second slot without a proposal.
VIDEO_SIZE = 192
SMALL = dict(input_size=VIDEO_SIZE, features=16, stage1_head_width=32,
             refine_width=16, num_stages=3, compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def _estimators():
    """The JAX estimator (2 yaw hypotheses per frame) and the port holding
    its weights, model and prior."""
    jest = JaxEstimator.create_synthetic(0, jc.CPMConfig(**SMALL),
                                         _fit_cfg(jc, VIDEO_SIZE),
                                         fit_restarts=2)
    params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in jest.cpm_params.items()}
    smpl = {k: np.asarray(v) for k, v in jest.smpl_model._asdict().items()}
    prior = {k: np.asarray(getattr(jest.prior, k))
             for k in ("means", "precisions", "log_consts")}
    test = PoseEstimator.from_numpy(params, smpl, prior,
                                    tc.CPMConfig(**SMALL),
                                    _fit_cfg(tc, VIDEO_SIZE), device="cpu",
                                    fit_restarts=2)
    return jest, test


def _compare_fit(jest, got, want):
    """θ (driven entries), β, cam within 1e-3; joints3d MPJPE ≤ 1 mm
    through the JAX model."""
    for k in ("theta", "beta", "cam"):
        g = np.asarray(getattr(got, k))
        w = np.asarray(getattr(want, k))
        assert g.shape == w.shape, k
        if k == "theta":
            g, w = g[..., DRIVEN], w[..., DRIVEN]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3, err_msg=k)
    from tpu_pose.models import smpl as jax_smpl
    fwd = [jax_smpl.smpl_forward_batch(
        jest.smpl_model, jnp.asarray(np.asarray(r.beta).reshape(-1, 10)),
        jnp.asarray(np.asarray(r.theta).reshape(-1, 72))) for r in (got, want)]
    mpjpe = 1000.0 * float(jnp.linalg.norm(fwd[0].joints - fwd[1].joints,
                                           axis=-1).mean())
    assert mpjpe <= 1.0, mpjpe


def _bodies(jm, k, t, seed):
    """2D joints (pixels, 64² frame) of k bodies moving slowly, 1 px
    noise, and per-joint confidences: (k, t, 14, 2), (k, t, 14)."""
    from tpu_pose.models import joints as jax_joints, smpl as jax_smpl
    rng = np.random.RandomState(seed)
    theta0 = 0.2 * rng.randn(k, 1, 72)
    theta0[..., 1] += 2.0
    theta = (theta0 + 0.05 * np.cumsum(rng.randn(k, t, 72), 1)).astype(
        np.float32).reshape(k * t, 72)
    beta = np.repeat(rng.randn(k, 10), t, 0).astype(np.float32)
    out = jax_smpl.smpl_forward_batch(jm, jnp.asarray(beta),
                                      jnp.asarray(theta))
    j14 = np.asarray(jax_joints.select_smpl_joints(out.joints))
    norm = 0.9 * j14[..., :2] * np.array([1.0, -1.0])
    px = (norm * 32 + 32 + rng.randn(k * t, 14, 2)).astype(np.float32)
    conf = rng.uniform(0.3, 1.0, (k * t, 14)).astype(np.float32)
    return px.reshape(k, t, 14, 2), conf.reshape(k, t, 14)


def test_fit_video_smooth_tracks_matches_jax_vmap():
    """Two tracks at once with per-track frame masks and anchors against
    the JAX package's fit_video_smooth vmapped over tracks (what its
    multi-person video path does): one batch of K·T·R fits, the Viterbi
    selection batched over K, one Adam loop."""
    jest, test = _estimators()
    px, conf = _bodies(jest.smpl_model, k=2, t=4, seed=11)
    cfg_j, cfg_t = _fit_cfg(jc), _fit_cfg(tc)
    mask = np.array([[1, 1, 1, 0], [1, 0, 1, 1]], np.float32)
    rng = np.random.RandomState(8)
    anchor = {"theta": (0.1 * rng.randn(2, 72)).astype(np.float32),
              "beta": rng.randn(2, 10).astype(np.float32),
              "cam": np.array([[0.9, 0.0, 0.0], [0.8, 0.1, 0.0]],
                              np.float32)}
    want = jax.jit(jax.vmap(lambda j, c, m, a: jax_temporal.fit_video_smooth(
        jest.smpl_model, j, c, cfg=cfg_j, prior=jest.prior,
        restarts=2, iters=30, frame_mask=m, anchor=a)))(
        jnp.asarray(px), jnp.asarray(conf), jnp.asarray(mask),
        {k: jnp.asarray(v) for k, v in anchor.items()})
    got = temporal.fit_video_smooth_tracks(
        test.smpl_model, _t(px), _t(conf), cfg_t, test.prior,
        restarts=2, iters=30, frame_mask=_t(mask),
        anchor={k: _t(v) for k, v in anchor.items()})
    assert got.theta.shape == (2, 4, 72) and got.energy.shape == (2, 4)
    _compare_fit(jest, got, want)
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=1e-3)


# -- the entry points ---------------------------------------------------------

def _frames(t, seed):
    return two_people_frames(t, VIDEO_SIZE, VIDEO_SIZE, seed, spread=0.6)


def _compare_video(jest, got, want, frames=slice(None)):
    """A MultiPersonVideoResult against JAX's (``frames`` of it): perm,
    frame and track masks exactly, joints2d 1e-2 px, scores 1e-5, fits."""
    w = {k: np.asarray(v) for k, v in want._asdict().items()}
    for k in ("joints2d", "conf", "person_scores", "frame_mask", "perm"):
        w[k] = w[k][frames]
    for k in ("theta", "beta", "cam", "joints3d", "energy"):
        w[k] = w[k][:, frames]
    np.testing.assert_array_equal(got.perm.numpy(), w["perm"])
    np.testing.assert_array_equal(got.frame_mask.numpy(), w["frame_mask"])
    np.testing.assert_allclose(got.joints2d.numpy(), w["joints2d"], rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(got.person_scores.numpy(),
                               w["person_scores"], rtol=0, atol=1e-5)
    assert got.vertices.shape == tuple(w["joints3d"].shape[:2]) + (6890, 3)
    _compare_fit(jest, got, type(want)(**w))


def test_estimate_and_fit_video_multi_matches_jax():
    """The default knobs (temporal hints, one pass): NMS proposals,
    Viterbi identities, the hinted re-decode, presence and the per-track
    fits."""
    jest, test = _estimators()
    frames = _frames(4, seed=1)
    want = jest.estimate_and_fit_video_multi(jnp.asarray(frames))
    got = test.estimate_and_fit_video_multi(frames)
    assert got.track_mask.dtype == torch.bool
    np.testing.assert_array_equal(got.track_mask.numpy(),
                                  np.asarray(want.track_mask))
    _compare_video(jest, got, want)


# Every knob of the tracked path at once. dup_px 5 keeps both people
# present in every frame: a track with one weighted frame in a 3-frame
# window makes the smoother's float32 solve ill-conditioned (the two
# packages' LAPACKs then differ by 1e-2 px in the hints, ROADMAP §C).
KNOBS = dict(hint_passes=2, hint_crop=True, hint_crop_min_conf=0.5,
             track_reassociate=True, allow_empty=True,
             track_death_frames=2, track_anchor_refresh=0.1,
             presence_keep_frac=0.7, track_birth_cost=0.06,
             min_person_score=0.1, dup_px=5.0)


@functools.lru_cache(maxsize=None)
def _stream_runs():
    """T = 5 in windows of 3 (the second padded): JAX's stream form, the
    port's, and the port's one-shot call on the first window."""
    jest, test = _estimators()
    frames = _frames(5, seed=2)
    want = jest.estimate_and_fit_video_multi_stream(jnp.asarray(frames),
                                                    chunk=3, **KNOBS)
    got = test.estimate_and_fit_video_multi_stream(frames, chunk=3, **KNOBS)
    first = test.estimate_and_fit_video_multi(frames[:3], **KNOBS)
    return frames, want, got, first


def test_video_multi_all_knobs_matches_jax_window():
    """Every knob in one call: the port's one-shot call on three frames
    against the JAX stream form's first (full, unpadded) window, which is
    the one-shot program with an all-ones pad mask."""
    jest, _ = _estimators()
    _, want, _, first = _stream_runs()
    _compare_video(jest, first, want, frames=slice(0, 3))


def test_video_multi_stream_matches_jax():
    """The stream form with every knob, two windows (carried tracker state,
    presence and anchors; zero pad frames masked) against JAX's."""
    jest, _ = _estimators()
    _, want, got, _ = _stream_runs()
    assert got.perm.shape == (5, 2) and got.theta.shape == (2, 5, 72)
    np.testing.assert_array_equal(got.track_mask.numpy(),
                                  np.asarray(want.track_mask))
    _compare_video(jest, got, want)


def test_video_multi_session_matches_stream():
    """MultiPersonVideoSession fed the frames in irregular pushes gives the
    stream form's windows exactly; a closed session refuses input."""
    _, test = _estimators()
    frames, _, ref, _ = _stream_runs()
    sess = MultiPersonVideoSession(test, chunk=3, **KNOBS)
    outs = [sess.push(frames[lo:hi]) for lo, hi in ((0, 1), (1, 4), (4, 5))]
    assert outs[0] is None and outs[2] is None
    assert sess.frames_buffered == 2
    outs = [outs[1], sess.flush()]
    for f in ("perm", "frame_mask", "joints2d", "person_scores"):
        assert torch.equal(torch.cat([getattr(o, f) for o in outs]),
                           getattr(ref, f)), f
    for f in ("theta", "beta", "cam", "joints3d"):
        assert torch.equal(torch.cat([getattr(o, f) for o in outs], 1),
                           getattr(ref, f)), f
    with pytest.raises(RuntimeError, match="flushed"):
        sess.push(frames[:1])
    with pytest.raises(RuntimeError, match="flushed"):
        sess.flush()


def test_video_paths_pin_hint_crop_dup_px(monkeypatch):
    """A reference quirk, reproduced: the tracked video paths never pass
    hint_crop_dup_px to the hinted decodes (tpu_pose/api.py, the
    estimate_2d_multi call with center_hints), so the selective crop uses
    its default 30 px. Traced in JAX (eval_shape, no compile) and run in
    the port, recording every estimate_2d_multi call."""
    jest, test = _estimators()
    frames = _frames(3, seed=3)
    calls = {"jax": [], "torch": []}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name].append(kw)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(jax_cpm, "estimate_2d_multi",
                        spy("jax", jax_cpm.estimate_2d_multi))
    monkeypatch.setattr(torch_cpm, "estimate_2d_multi",
                        spy("torch", torch_cpm.estimate_2d_multi))
    knobs = dict(max_people=2, min_person_score=0.05, person_score_frac=0.4,
                 dup_px=30.0, hint_passes=2, hint_crop=True)
    jax.eval_shape(functools.partial(
        jest._estimate_and_fit_video_multi_impl, restarts=2, **knobs),
        jest.cpm_params, jest.smpl_model, jnp.asarray(frames))
    test.estimate_and_fit_video_multi(frames, **knobs)
    for name in ("jax", "torch"):
        hinted = [kw for kw in calls[name] if "center_hints" in kw]
        assert len(hinted) == 2 and len(calls[name]) == 3, name
        assert all(kw["hint_crop"] is True
                   and "hint_crop_dup_px" not in kw for kw in hinted), name


def test_video_multi_all_absent_tracks_fall_back_to_all_frames():
    """With no presence anywhere (allow_empty, an unreachable score floor)
    every track's fit falls back to an all-ones frame mask: finite fits,
    all-False masks."""
    _, test = _estimators()
    res = test.estimate_and_fit_video_multi(_frames(3, seed=4),
                                            allow_empty=True,
                                            min_person_score=1e9)
    assert not bool(res.frame_mask.any()) and not bool(res.track_mask.any())
    assert bool(torch.isfinite(res.theta).all())
    assert bool(torch.isfinite(res.energy).all())


def test_video_multi_entry_points_reject_bad_input():
    _, test = _estimators()
    for call in (test.estimate_and_fit_video_multi,
                 test.estimate_and_fit_video_multi_stream):
        with pytest.raises(ValueError, match="frame stack"):
            call(np.zeros((64, 64, 3), np.uint8))
    assert MultiPersonVideoSession(test, chunk=2).flush() is None


def _params_of(fn):
    import inspect
    return [(p.name, p.default)
            for p in inspect.signature(fn).parameters.values()
            if p.name not in ("cfg", "params", "cpm")]


@pytest.mark.parametrize("name", [
    "PoseEstimator.estimate_and_fit_multi",
    "PoseEstimator.estimate_and_fit_video_multi",
    "PoseEstimator.estimate_and_fit_video_multi_stream",
    "MultiPersonVideoSession.__init__",
    "tracking.appearance_features", "tracking.associate_tracks",
    "tracking.gather_tracks", "tracking.compose_perms",
    "tracking.presence_hysteresis", "tracking.smooth_track_centers",
    "tracking.associate_tracks_viterbi",
    "cpm.person_evidence", "cpm.find_person_peaks", "cpm.select_people",
    "cpm.estimate_2d_multi"])
def test_signatures_and_defaults_match_jax(name):
    """The ported entry points take the JAX package's arguments, in its
    order, with its defaults (the config argument aside: each package has
    its own config classes; the CPM is a module in the port, a parameter
    tree in JAX)."""
    import tpu_pose.api as jax_api
    import tpu_pose_torch.api as torch_api
    mods = {"PoseEstimator": (jax_api.PoseEstimator, PoseEstimator),
            "MultiPersonVideoSession": (jax_api.MultiPersonVideoSession,
                                        MultiPersonVideoSession),
            "tracking": (jax_tracking, tracking),
            "cpm": (jax_cpm, torch_cpm)}
    owner, attr = name.split(".")
    j_fn, t_fn = (getattr(m, attr) for m in mods[owner])
    assert _params_of(t_fn) == _params_of(j_fn)
    assert torch_api.MultiPersonVideoResult._fields == \
        jax_api.MultiPersonVideoResult._fields
    assert torch_api.MultiPersonResult._fields == \
        jax_api.MultiPersonResult._fields
