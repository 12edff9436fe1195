"""Multi-person frames in the port against the JAX package: the person
evidence, the NMS'd peaks, the person-count selection, the bilinear
evidence sampler, ``estimate_2d_multi`` with every knob (center hints and
the hint-centered crop included), and ``PoseEstimator.
estimate_and_fit_multi``, on tests/test_multiperson.py's small CPM with
the JAX weights carried across.

The frames show two people as smooth images (``chip_smoke.
two_people_frames``): on per-pixel noise the random-weight network's peak
and slot decisions are ill-conditioned. Bounds: evidence 1e-5·max;
peaks' centers exact and scores 1e-6; masks equal; float32 joints
1e-2 px, conf 1e-4, person_scores 1e-5, heatmaps 1e-4·max|b|; bf16
joints within one 8 px cell; the fits as tests/test_torch_temporal.py
(θ without the leaf joints' rotations, β and cam 1e-3, joints3d MPJPE
≤ 1 mm)."""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import two_people_frames
from tpu_pose.api import PoseEstimator as JaxEstimator
from tpu_pose.fitting import priors as jax_priors
from tpu_pose.models import cpm as jax_cpm
from tpu_pose.models import smpl_data as jax_data
from tpu_pose.utils import config as jc
from tpu_pose_torch.api import PoseEstimator
from tpu_pose_torch.models import cpm as torch_cpm
from tpu_pose_torch.ops import preprocess as torch_pre
from tpu_pose_torch.utils import config as tc
from torch_threads import one_thread

one_thread()

SMALL = dict(input_size=64, features=16, stage1_head_width=32,
             refine_width=16, num_stages=3)
HM_TOL = 1e-4          # × max|b|
JOINT_TOL = 1e-2       # px
CONF_TOL = 1e-4
SCORE_TOL = 1e-5


def _cfgs(compute_dtype="float32", **kw):
    return (jc.CPMConfig(**SMALL, compute_dtype=compute_dtype, **kw),
            tc.CPMConfig(**SMALL, compute_dtype=compute_dtype, **kw))


@functools.lru_cache(maxsize=None)
def _params():
    """The JAX weights and their numpy copy."""
    params = jax_cpm.init_cpm_params(jax.random.PRNGKey(0), _cfgs()[0])
    return params, {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                    for k, v in params.items()}


def _port_cpm(tcfg):
    return torch_cpm.cpm_params_from_numpy(_params()[1], tcfg, "cpu")


# -- evidence, peaks, selection -----------------------------------------------

def _beliefs(shape, seed):
    """Stage-1-like beliefs (B, h, h, 15): a smooth positive field with
    some negative cells (which the clip removes)."""
    rng = np.random.RandomState(seed)
    b = rng.rand(*shape).astype(np.float32) - 0.2
    b[:, shape[1] // 4, shape[2] // 3, :] += 3.0
    return b


@pytest.mark.parametrize("shape,sigma", [((2, 46, 46, 15), 64.0),
                                         ((3, 8, 8, 15), 64.0),
                                         ((1, 12, 16, 15), 24.0)])
def test_person_evidence_matches_jax(shape, sigma):
    """The full-size 46² map (49-tap kernel, padding beyond half the map),
    the small model's 8² and a non-square map at another σ."""
    b = _beliefs(shape, shape[1])
    want = np.asarray(jax_cpm.person_evidence(jnp.asarray(b), _cfgs()[0],
                                              sigma))
    got = torch_cpm.person_evidence(torch.from_numpy(b), _cfgs()[1], sigma)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("k,radius", [(1, 96.0), (2, 96.0), (3, 24.0),
                                      (4, 1000.0)])
def test_find_person_peaks_matches_jax(k, radius):
    """Centers exactly, scores 1e-6; with a radius over the whole map the
    later rounds see only −inf and take cell 0, as jnp.argmax."""
    fg = np.array(jax_cpm.person_evidence(
        jnp.asarray(_beliefs((3, 46, 46, 15), 7)), _cfgs()[0], 24.0))
    c_j, s_j = jax_cpm.find_person_peaks(jnp.asarray(fg), k, 8, radius)
    c_t, s_t = torch_cpm.find_person_peaks(torch.from_numpy(fg), k, 8,
                                           radius)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0,
                               atol=1e-6)


def _selection_inputs(seed):
    """(8, 3) scores with a below-floor frame and tied scores, and joints
    with exact and near duplicates, a shuffled (partial-overlap) copy and
    a far person."""
    rng = np.random.RandomState(seed)
    scores = rng.uniform(0.0, 1.0, (8, 3)).astype(np.float32)
    scores[0] = [0.01, 0.02, 0.03]
    scores[1] = [0.5, 0.5, 0.2]
    person = rng.uniform(40, 200, (8, 14, 2)).astype(np.float32)
    joints = np.stack([person, person + 300.0, person + 300.0], 1)
    joints[2, 1] = person[2] + 4.0                  # near duplicate
    joints[3, 2] = person[3][::-1]                  # partial overlap
    joints[4, 0] = joints[4, 2] + 5.0               # duplicate, slot order
    joints[5, 1] = person[5] + 29.0                 # just under dup_px
    return scores, joints


SELECT = {
    "scores_only": dict(),
    "allow_empty": dict(allow_empty=True),
    "joints": dict(joints=True),
    "joints_allow_empty": dict(joints=True, allow_empty=True),
    "order_by_score": dict(joints=True, order_by_score=True),
    "dup_joint_frac": dict(joints=True, dup_joint_frac=0.5),
    "everything": dict(joints=True, order_by_score=True, allow_empty=True,
                       dup_joint_frac=0.5, dup_px=45.0),
}


@pytest.mark.parametrize("case", sorted(SELECT))
def test_select_people_matches_jax(case):
    kw = dict(SELECT[case])
    scores, joints = _selection_inputs(sorted(SELECT).index(case))
    use_joints = kw.pop("joints", False)
    want = np.asarray(jax_cpm.select_people(
        jnp.asarray(scores), 0.05, 0.4,
        joints=jnp.asarray(joints) if use_joints else None, **kw))
    got = torch_cpm.select_people(
        torch.from_numpy(scores), 0.05, 0.4,
        joints=torch.from_numpy(joints) if use_joints else None, **kw)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_select_people_is_not_vacuous():
    """The selection inputs reach every rule: the dedupe, the partial
    overlap and the score order each change some mask."""
    scores, joints = _selection_inputs(0)
    s, j = torch.from_numpy(scores), torch.from_numpy(joints)
    base = torch_cpm.select_people(s, joints=j)
    assert not torch.equal(base, torch_cpm.select_people(s))
    assert not torch.equal(base, torch_cpm.select_people(
        s, joints=j, dup_joint_frac=0.5))
    assert not torch.equal(base, torch_cpm.select_people(
        s, joints=j, order_by_score=True))


def test_map_coordinates_linear_matches_jax():
    """jax.scipy.ndimage.map_coordinates(order=1, mode="nearest") per
    channel: inside, on integer cells and beyond every edge (clamped)."""
    rng = np.random.RandomState(0)
    img = rng.randn(2, 9, 11, 3).astype(np.float32)
    ys = rng.uniform(-3, 12, (2, 4, 5)).astype(np.float32)
    xs = rng.uniform(-3, 14, (2, 4, 5)).astype(np.float32)
    ys[0, 0, :3] = [0.0, 8.0, 4.0]
    xs[0, 0, :3] = [0.0, 10.0, 3.0]
    want = np.stack([np.stack([np.asarray(
        jax.scipy.ndimage.map_coordinates(
            jnp.asarray(img[n, ..., c]), [jnp.asarray(ys[n]),
                                          jnp.asarray(xs[n])],
            order=1, mode="nearest")) for c in range(3)], -1)
        for n in range(2)])
    got = torch_pre.map_coordinates_linear(
        torch.from_numpy(img), torch.from_numpy(ys), torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# -- estimate_2d_multi --------------------------------------------------------

def _frames(t=2, h=72, w=96, seed=1):
    return two_people_frames(t, h, w, seed)


def _compare_multi(got, want, joint_tol=JOINT_TOL):
    hm_j = np.asarray(want[0])
    np.testing.assert_allclose(got[0].numpy(), hm_j, rtol=0,
                               atol=HM_TOL * np.abs(hm_j).max())
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=joint_tol)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=CONF_TOL)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0,
                               atol=SCORE_TOL)


def _run_multi(imgs, hints=None, **kw):
    """estimate_2d_multi of both packages on the same frames."""
    jcfg, tcfg = _cfgs()
    j_kw, t_kw = dict(kw), dict(kw)
    if hints is not None:
        j_kw["center_hints"] = jnp.asarray(hints)
        t_kw["center_hints"] = torch.from_numpy(hints)
    want = jax_cpm.estimate_2d_multi(_params()[0], jnp.asarray(imgs), jcfg,
                                     **j_kw)
    with torch.no_grad():
        got = torch_cpm.estimate_2d_multi(_port_cpm(tcfg),
                                          torch.from_numpy(imgs), tcfg,
                                          **t_kw)
    return got, want


MULTI = {
    "plain": dict(),
    "max_people3": dict(max_people=3, nms_radius_px=24.0),
    "letterbox": dict(letterbox=True),
    "refine_scale": dict(refine_scale=True),
    "refine_scale_target_zoom": dict(refine_scale=True,
                                     scale_target_frac=0.7, max_zoom=2.0),
    "flip_tta": dict(flip_tta=True),
    "person_sigma": dict(person_sigma_px=32.0, beta=50.0),
    "everything": dict(letterbox=True, refine_scale=True, flip_tta=True,
                       max_people=3, nms_radius_px=24.0),
}


@pytest.mark.parametrize("case", sorted(MULTI))
def test_estimate_2d_multi_knobs_match_jax(case):
    kw = dict(dict(max_people=2, nms_radius_px=32.0), **MULTI[case])
    got, want = _run_multi(_frames(), **kw)
    k = kw["max_people"]
    assert got[0].shape == (2, k, 8, 8, 15) and got[1].shape == (2, k, 14, 2)
    _compare_multi(got, want)


def test_estimate_2d_multi_bf16():
    """bf16 convs round elsewhere in the two frameworks: joints within one
    8 px cell, the same peaks."""
    jcfg, tcfg = _cfgs("bfloat16")
    imgs = _frames(seed=2)
    want = jax_cpm.estimate_2d_multi(_params()[0], jnp.asarray(imgs), jcfg,
                                     nms_radius_px=32.0, flip_tta=True)
    with torch.no_grad():
        got = torch_cpm.estimate_2d_multi(_port_cpm(tcfg),
                                          torch.from_numpy(imgs), tcfg,
                                          nms_radius_px=32.0, flip_tta=True)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=8)


# Network-frame hints (x, y) per frame and slot: near the two people, and
# both slots on one person (a guaranteed duplicate, which the selective
# crop substitutes in slot 1).
HINTS = np.array([[[18.0, 32.0], [46.0, 33.0]],
                  [[30.0, 30.0], [30.0, 30.0]]], np.float32)

HINT_CASES = {
    "hints": dict(),
    "hints_flip": dict(flip_tta=True),
    "hint_crop_dup": dict(hint_crop=True),
    "hint_crop_dup_str": dict(hint_crop="dup", hint_crop_dup_px=20.0),
    "hint_crop_all": dict(hint_crop="all"),
    "hint_crop_min_conf": dict(hint_crop=True, hint_crop_min_conf=0.9),
    "hint_crop_flip_refine": dict(hint_crop=True, flip_tta=True,
                                  refine_scale=True),
}


@pytest.mark.parametrize("case", sorted(HINT_CASES))
def test_estimate_2d_multi_center_hints_match_jax(case):
    """Slot i decodes at hint i, scored by the bilinear evidence there;
    the hint-centered crop in its selective and "all" forms, the ghost
    gate, and with flip TTA and refine_scale."""
    got, want = _run_multi(_frames(), hints=HINTS, max_people=2,
                           **HINT_CASES[case])
    _compare_multi(got, want)


def test_hint_crop_substitution_and_gate_are_exercised():
    """The selective crop takes, slot by slot, either the plain hinted
    decode or the "all" crop decode: the duplicated slot (frame 1, slot 1,
    the same hint as slot 0) the crop's, the slot it duplicates the plain
    one; the ghost gate at conf share 10 (unreachable) keeps every plain
    decode."""
    imgs = _frames()
    _, tcfg = _cfgs()
    cpm = _port_cpm(tcfg)

    def run(**kw):
        with torch.no_grad():
            return torch_cpm.estimate_2d_multi(
                cpm, torch.from_numpy(imgs), tcfg,
                center_hints=torch.from_numpy(HINTS), **kw)[1]

    plain, sel, every = run(), run(hint_crop=True), run(hint_crop="all")
    gated = run(hint_crop=True, hint_crop_min_conf=10.0)
    for i in range(2):
        for j in range(2):
            assert (torch.equal(sel[i, j], plain[i, j])
                    or torch.equal(sel[i, j], every[i, j])), (i, j)
    assert torch.equal(sel[1, 0], plain[1, 0])
    assert torch.equal(sel[1, 1], every[1, 1])
    assert not torch.equal(every[1, 1], plain[1, 1])
    assert torch.equal(gated, plain)


def test_selective_hint_crop_mixes_heatmap_frames():
    """A reference quirk, reproduced: under selective hint_crop the
    returned heatmaps of a substituted slot are its crop-frame maps
    (models/cpm.py estimate_2d_multi in the JAX package, the
    ``jnp.where(m, hm2, hm)``), while the other slots keep network-frame
    maps, in both packages."""
    got, want = _run_multi(_frames(), hints=HINTS, max_people=2,
                           hint_crop=True)
    every_got, every_want = _run_multi(_frames(), hints=HINTS, max_people=2,
                                       hint_crop="all")
    plain_got, _ = _run_multi(_frames(), hints=HINTS, max_people=2)
    for g, e in ((got, every_got), (want, every_want)):
        np.testing.assert_array_equal(np.asarray(g[0][1, 1]),
                                      np.asarray(e[0][1, 1]))
    assert torch.equal(got[0][1, 0], plain_got[0][1, 0])
    assert not torch.allclose(got[0][1, 1], plain_got[0][1, 1], atol=1e-3)


def test_estimate_2d_multi_requires_center_map():
    _, tcfg = _cfgs(use_center_map=False)
    cpm = torch_cpm.init_cpm_params(0, tcfg, device="cpu")
    with pytest.raises(ValueError, match="use_center_map"):
        torch_cpm.estimate_2d_multi(cpm, torch.zeros(1, 64, 64, 3), tcfg)


def test_int8_multi_conv_inputs_stay_nhwc(monkeypatch):
    """The B·k fold (trunk features, stage-1 beliefs, per-hypothesis
    hints), the crop pass and the resized image keep every int8 conv input
    NHWC memory, the layout kernel B2's passes read in place on the
    card."""
    _, tcfg = _cfgs()
    q = torch_cpm.quantize_params(_port_cpm(tcfg))
    names = {id(m): n for n, m in q.named_children()}
    seen, bad = set(), []
    conv_q = torch_cpm._conv_q

    def tap(x, layer, relu, act_dtype):
        seen.add(names[id(layer)])
        if not x.permute(0, 2, 3, 1).is_contiguous():
            bad.append(names[id(layer)])
        return conv_q(x, layer, relu, act_dtype)

    monkeypatch.setattr(torch_cpm, "_conv_q", tap)
    with torch.no_grad():
        torch_cpm.estimate_2d_multi(q, torch.from_numpy(_frames()), tcfg,
                                    refine_scale=True, flip_tta=True)
    assert bad == [] and len(seen) == len(names)


# -- PoseEstimator.estimate_and_fit_multi -------------------------------------

def _fit_cfg(cfg_mod):
    return cfg_mod.FitConfig(
        stages=(cfg_mod.StageConfig(iters=15, lr=0.05, opt_pose=False,
                                    opt_shape=False, w_pose_prior=0,
                                    w_shape_prior=0, w_angle_prior=0),
                cfg_mod.StageConfig(iters=25, lr=0.02, w_pose_prior=0.5,
                                    w_shape_prior=1.0)), img_size=64)


@functools.lru_cache(maxsize=None)
def _estimators(**knobs):
    jcfg, tcfg = _cfgs()
    jest = JaxEstimator(_params()[0], jax_data.synthetic_smpl(seed=0),
                        jax_priors.synthetic_gmm_prior(0), jcfg,
                        _fit_cfg(jc), **knobs)
    smpl = {k: np.asarray(v) for k, v in jest.smpl_model._asdict().items()}
    prior = {k: np.asarray(getattr(jest.prior, k))
             for k in ("means", "precisions", "log_consts")}
    test = PoseEstimator.from_numpy(_params()[1], smpl, prior, tcfg,
                                    _fit_cfg(tc), device="cpu", **knobs)
    return jest, test


# θ entries of the leaf joints (feet, hands): only the prior moves them,
# so they are held through the mesh (tests/test_torch_temporal.py).
LEAF = [3 * j + a for j in (10, 11, 22, 23) for a in range(3)]
DRIVEN = np.setdiff1d(np.arange(72), LEAF)


def compare_fits(got: dict, want: dict) -> None:
    """θ (driven entries), β and cam within 1e-3, joints3d MPJPE ≤ 1 mm."""
    for k in ("theta", "beta", "cam"):
        g, w = got[k], want[k]
        assert g.shape == w.shape, k
        if k == "theta":
            g, w = g[..., DRIVEN], w[..., DRIVEN]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3, err_msg=k)
    mpjpe = 1000.0 * np.linalg.norm(got["joints3d"] - want["joints3d"],
                                    axis=-1).mean()
    assert mpjpe <= 1.0, mpjpe


FIT_MULTI = {
    "defaults": (dict(), dict(nms_radius_px=32.0)),
    "everything": (dict(letterbox=True, refine_scale=True, flip_tta=True,
                        fit_restarts=2),
                   dict(max_people=3, nms_radius_px=24.0, allow_empty=True,
                        min_person_score=0.3, person_score_frac=0.9,
                        dup_px=40.0, dup_joint_frac=0.5)),
}


@pytest.mark.parametrize("case", sorted(FIT_MULTI))
def test_estimate_and_fit_multi_matches_jax(case):
    """The default path and every knob (the front end, yaw multistart,
    the selection's options): source-pixel joints 1e-2 px, scores and
    masks, and the B·k fits."""
    knobs, kw = FIT_MULTI[case]
    jest, test = _estimators(**knobs)
    imgs = _frames(seed=3)
    want = {k: np.asarray(v) for k, v in
            jest.estimate_and_fit_multi(jnp.asarray(imgs), **kw)
            ._asdict().items()}
    got = {k: v.detach().numpy() for k, v in
           test.estimate_and_fit_multi(imgs, **kw)._asdict().items()}
    np.testing.assert_allclose(got["joints2d"], want["joints2d"], rtol=0,
                               atol=JOINT_TOL)
    np.testing.assert_allclose(got["person_scores"], want["person_scores"],
                               rtol=0, atol=SCORE_TOL)
    np.testing.assert_array_equal(got["person_mask"], want["person_mask"])
    assert got["vertices"].shape == want["vertices"].shape
    compare_fits(got, want)


def test_multi_warns_once_when_scale_tta_ignored():
    """scale_tta applies to the single-person front end only; the multi
    paths say so once per estimator."""
    _, test = _estimators()
    est = PoseEstimator(test.cpm, test.smpl_model, test.prior, test.cpm_cfg,
                        test.fit_cfg, device="cpu", scale_tta=(0.8,))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in range(2):
            est._warn_multi_ignores_scale_tta()
    assert len([x for x in w if "scale_tta" in str(x.message)]) == 1


def test_multi_rejects_bad_frames():
    _, test = _estimators()
    with pytest.raises(ValueError, match="frame stack"):
        test.estimate_and_fit_multi(np.zeros((64, 64, 3), np.uint8))
