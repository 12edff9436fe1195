"""The port's hard synthetic set (tpu_pose_torch/data/synthetic_hard.py)
against the JAX package's on the same seeds, the ground-truth contracts of
tests/test_synthetic_hard.py on the port's generator, and the union
stage-1 targets through the port's stage_supervision_loss against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pose.data import synthetic_hard as jax_sh
from tpu_pose.models import cpm_train as jax_cpm_train
from tpu_pose.models import smpl_data as jax_smpl_data
from tpu_pose.utils.config import CPMConfig as JaxCPMConfig
from tpu_pose_torch.data import synthetic_hard as sh
from tpu_pose_torch.models import cpm as cpm_lib
from tpu_pose_torch.models import cpm_train
from tpu_pose_torch.models import joints as joints_lib
from tpu_pose_torch.models import smpl_data
from tpu_pose_torch.utils.config import CPMConfig
from torch_threads import one_thread

one_thread()

CFG = CPMConfig(input_size=128)     # small frames keep the suite fast
JAX_CFG = JaxCPMConfig(input_size=128)
# The port's SMPL runs in eager float32 on the CPU, JAX's in a jitted
# forward: labels within tests/test_torch_data.py's tolerances, the draws
# (θ, β, centers, scales, flags) bit for bit, and the rendered frames
# identical on at least PIXEL_SHARE of their values (a splat whose rounded
# pixel or depth order sits on an edge may land one pixel over; measured:
# every value identical at this size, 99.995 % at 368² with the
# 6890-vertex model).
JOINT_TOL = dict(rtol=0, atol=1e-4)     # px and metres
HEATMAP_TOL = dict(rtol=0, atol=1e-5)
CMAP_TOL = dict(rtol=0, atol=1e-6)
PIXEL_SHARE = 0.99
EXACT = ("theta", "beta", "centers", "scales", "visibility", "present",
         "has_distractor", "num_distractors", "distractor_centers")


@pytest.fixture(scope="module")
def models():
    return (jax_smpl_data.synthetic_smpl(seed=0, num_verts=300),
            smpl_data.synthetic_smpl(seed=0, num_verts=300, device="cpu"))


@pytest.fixture(scope="module")
def model(models):
    return models[1]


def _assert_same_set(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k == "images":
            assert (g == w).mean() >= PIXEL_SHARE
        elif k in EXACT or w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k.startswith("heatmaps"):
            np.testing.assert_allclose(g, w, err_msg=k, **HEATMAP_TOL)
        elif k == "center_maps":
            np.testing.assert_allclose(g, w, err_msg=k, **CMAP_TOL)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **JOINT_TOL)


_THETA = np.random.RandomState(8).randn(3, 72).astype(np.float32) * 0.2
_BETA = np.random.RandomState(9).randn(3, 10).astype(np.float32)
# Every generator and batch iterator, with every option somewhere.
CASES = {
    "examples": ("make_hard_examples", (4,),
                 dict(seed=3, scale_range=(0.4, 1.0), occlusion_prob=0.5)),
    "examples_every_option": (
        "make_hard_examples", (6,),
        dict(seed=2, occlusion_prob=0.5, flip_prob=0.5, truncation=0.3,
             distractor_prob=0.7, max_distractors=2, union_stage1=True,
             clutter=3, heatmap_sigma=2.0)),
    "examples_given_pose": ("make_hard_examples", (3,),
                            dict(seed=5, theta=_THETA, beta=_BETA,
                                 distractor_prob=1.0)),
    "multi_k2": ("make_hard_multi_examples", (3,), dict(seed=5)),
    "multi_k3": ("make_hard_multi_examples", (3,),
                 dict(seed=1, num_people=3, clutter=2)),
    "video_crossing": ("make_hard_multi_video", (6,),
                       dict(seed=7, keyframe_every=4)),
    "video_k4_span": ("make_hard_multi_video", (4,),
                      dict(seed=2, num_people=4, x_span=0.8,
                           crossing=False)),
    "enterleave": ("make_hard_enterleave_video", (10,),
                   dict(seed=0, leave_at=0.4, enter_at=0.5)),
}
BATCHES = {
    "train_union": ("hard_train_batches", (3, 2),
                    dict(seed=1, raw_images=True, distractor_prob=0.8,
                         max_distractors=2, union_stage1=True)),
    "train_f32": ("hard_train_batches", (2, 1),
                  dict(seed=0, flip_prob=0.0, occlusion_prob=1.0)),
    "eval": ("hard_eval_batches", (2, 2), dict(seed=4, truncation=0.2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generators_match_jax(models, case):
    jm, tm = models
    name, args, kw = CASES[case]
    _assert_same_set(getattr(sh, name)(tm, *args, CFG, **kw),
                     getattr(jax_sh, name)(jm, *args, JAX_CFG, **kw))


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_batches_match_jax(models, case):
    jm, tm = models
    name, args, kw = BATCHES[case]
    got = list(getattr(sh, name)(tm, *args, CFG, **kw))
    want = list(getattr(jax_sh, name)(jm, *args, JAX_CFG, **kw))
    assert len(got) == len(want) == args[1]
    for g, w in zip(got, want):
        if g["images"].dtype == np.float32:     # x/256 − 0.5
            g, w = dict(g), dict(w)
            for d in (g, w):
                d["images"] = np.round((d["images"] + 0.5) * 256).astype(
                    np.uint8)
        _assert_same_set(g, w)


def test_empty_examples_match_jax():
    want = jax_sh.make_empty_examples(4, JAX_CFG, seed=3, clutter=4,
                                      occluder_prob=0.7)
    got = sh.make_empty_examples(4, CFG, seed=3, clutter=4,
                                 occluder_prob=0.7)
    np.testing.assert_array_equal(got["images"], want["images"])


def test_vertex_regions_and_body_cache_match_jax(models):
    jm, tm = models
    np.testing.assert_array_equal(sh._vertex_regions(tm),
                                  jax_sh._vertex_regions(jm))
    a, b = sh._BodyCache(tm), jax_sh._BodyCache(jm)
    for k in ("regions", "weights", "texture"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


# -- the ground-truth contracts (tests/test_synthetic_hard.py) ---------------

@pytest.fixture(scope="module")
def ex(model):
    return sh.make_hard_examples(model, 6, CFG, seed=3,
                                 scale_range=(0.4, 1.0), occlusion_prob=0.5)


def test_schema_and_shapes(ex):
    assert ex["images"].shape == (6, 128, 128, 3)
    assert ex["images"].dtype == np.uint8
    assert ex["heatmaps"].shape == (6, 16, 16, 15)
    assert ex["joints2d"].shape == (6, 14, 2)
    assert ex["centers"].shape == (6, 2)
    assert ex["scales"].shape == (6,)
    assert ex["visibility"].shape == (6, 14)


def test_determinism(model):
    a = sh.make_hard_examples(model, 2, CFG, seed=7)
    b = sh.make_hard_examples(model, 2, CFG, seed=7)
    np.testing.assert_array_equal(a["images"], b["images"])
    np.testing.assert_array_equal(a["joints2d"], b["joints2d"])


def test_gt_geometry_convention(ex):
    """joints2d is the scale/offset map of the SMPL joints: the centered
    14-joint extent → scales·(size/2) px around centers."""
    j3d14 = ex["gt_joints3d"][:, joints_lib.CPM_TO_SMPL]
    for i in range(len(j3d14)):
        c3d = j3d14[i].mean(0)
        extent = np.abs(j3d14[i] - c3d).max()
        px_extent = np.abs(ex["joints2d"][i] - ex["centers"][i]).max()
        bound = ex["scales"][i] * (CFG.input_size / 2.0)
        assert 0.3 * bound <= px_extent <= bound + 1e-3
        want = ((j3d14[i] - c3d)[:, :2] * (bound / extent)
                + ex["centers"][i])
        np.testing.assert_allclose(ex["joints2d"][i], want, atol=1e-3)


def test_heatmaps_peak_at_joints(ex):
    hm = ex["heatmaps"][0]
    for j in range(14):
        iy, ix = np.unravel_index(np.argmax(hm[..., j]), hm.shape[:2])
        px = ex["joints2d"][0, j]
        assert abs(ix * CFG.stride - px[0]) <= CFG.stride
        assert abs(iy * CFG.stride - px[1]) <= CFG.stride


def test_person_is_rendered_near_joints(ex):
    for i in range(3):
        lo = np.clip(ex["joints2d"][i].min(0).astype(int) - 4, 0, 127)
        hi = np.clip(ex["joints2d"][i].max(0).astype(int) + 4, 1, 128)
        patch = ex["images"][i, lo[1]:hi[1], lo[0]:hi[0]]
        assert patch.size > 0 and patch.std() > 10.0


def test_occlusion_marks_visibility(model):
    e = sh.make_hard_examples(model, 12, CFG, seed=11, occlusion_prob=1.0)
    assert (e["visibility"] == 0).any()
    assert e["visibility"].mean() > 0.5


def test_multi_person_schema_and_separation(model):
    m = sh.make_hard_multi_examples(model, 4, CFG, seed=5)
    assert m["images"].shape == (4, 128, 128, 3)
    assert m["joints2d"].shape == (4, 2, 14, 2)
    assert m["gt_joints3d"].shape == (4, 2, 24, 3)
    assert (m["centers"][:, 0, 0] < m["centers"][:, 1, 0]).all()


def test_train_batches_center_maps_follow_the_person(model):
    """Center maps peak at each frame's person center; a mirrored frame's
    at (size − 1) − x."""
    b = next(sh.hard_train_batches(model, 3, 1, CFG, seed=0,
                                   raw_images=True, flip_prob=0.0))
    assert b["images"].dtype == np.uint8
    assert b["center_maps"].shape == (3, 128, 128, 1)
    assert b["heatmaps"].shape == (3, 16, 16, 15)
    e = sh.make_hard_examples(model, 3, CFG, seed=0)
    for i in range(3):
        iy, ix = np.unravel_index(np.argmax(b["center_maps"][i, ..., 0]),
                                  (128, 128))
        np.testing.assert_allclose([ix, iy], e["centers"][i], atol=1.0)
    bf = next(sh.hard_train_batches(model, 3, 1, CFG, seed=0,
                                    raw_images=True, flip_prob=1.0))
    iy, ix = np.unravel_index(np.argmax(bf["center_maps"][0, ..., 0]),
                              (128, 128))
    np.testing.assert_allclose([127 - ix, iy], e["centers"][0], atol=1.0)


def test_truncation_marks_out_of_frame_joints(model):
    size = CFG.input_size
    base = sh.make_hard_examples(model, 8, CFG, seed=9,
                                 scale_range=(0.5, 0.9))
    again = sh.make_hard_examples(model, 8, CFG, seed=9,
                                  scale_range=(0.5, 0.9), truncation=0.0)
    np.testing.assert_array_equal(base["images"], again["images"])
    tr = sh.make_hard_examples(model, 8, CFG, seed=9,
                               scale_range=(0.5, 0.9), truncation=0.6)
    out = ((tr["joints2d"] < 0.0) | (tr["joints2d"] > size - 1.0)).any(-1)
    assert out.any()
    assert (tr["visibility"][out] == 0.0).all()
    assert np.isfinite(tr["heatmaps"]).all()


def test_distractor_keeps_target_gt_and_changes_pixels(model):
    base = sh.make_hard_examples(model, 8, CFG, seed=2, occlusion_prob=0.0)
    d = sh.make_hard_examples(model, 8, CFG, seed=2, occlusion_prob=0.0,
                              distractor_prob=0.7)
    for k in ("joints2d", "centers", "scales", "heatmaps", "gt_joints3d"):
        np.testing.assert_array_equal(base[k], d[k])
    has = d["has_distractor"]
    assert 2 <= has.sum() < 8
    for i in range(8):
        same = np.array_equal(base["images"][i], d["images"][i])
        assert same == (has[i] == 0)
        assert np.isfinite(d["distractor_centers"][i]).all() == bool(has[i])
    assert (d["visibility"] <= base["visibility"]).all()


def test_multi_examples_k3_schema_and_separation(model):
    m = sh.make_hard_multi_examples(model, 4, CFG, seed=1, num_people=3)
    assert m["joints2d"].shape == (4, 3, 14, 2)
    assert m["centers"].shape == (4, 3, 2)
    c = m["centers"]
    for i in range(4):
        assert np.linalg.norm(c[i, 0] - c[i, 1]) > 20
        assert np.linalg.norm(c[i, 1] - c[i, 2]) > 20
    assert np.linalg.norm(m["joints2d"].mean(2) - c, axis=-1).max() < 24.0


def test_multi_video_k3_everyone_crosses(model):
    v = sh.make_hard_multi_video(model, 10, CFG, seed=1, crossing=True,
                                 num_people=3)
    assert v["joints2d"].shape == (10, 3, 14, 2)
    cx = v["centers"][..., 0]
    assert cx[0, 0] < cx[0, 1] < cx[0, 2]
    assert cx[-1, 0] > cx[-1, 1] > cx[-1, 2]


def test_empty_examples_have_no_person():
    e = sh.make_empty_examples(6, CFG, seed=0)
    assert e["images"].shape == (6, 128, 128, 3) and set(e) == {"images"}
    np.testing.assert_array_equal(
        e["images"], sh.make_empty_examples(6, CFG, seed=0)["images"])
    assert not np.array_equal(
        e["images"], sh.make_empty_examples(6, CFG, seed=1)["images"])


def test_enterleave_presence_semantics(model):
    el = sh.make_hard_enterleave_video(model, 16, CFG, seed=0)
    p = el["present"]
    assert p.shape == (16, 3)
    assert p[:, 0].all()
    assert p[0, 1] == 1 and p[-1, 1] == 0
    gone = np.nonzero(p[:, 1] == 0)[0]
    assert (p[gone[0]:, 1] == 0).all()
    assert p[0, 2] == 0 and p[-1, 2] == 1
    came = np.nonzero(p[:, 2] == 1)[0]
    assert (p[came[0]:, 2] == 1).all()
    assert (p[:, 1] + p[:, 2] <= 1).all()
    for i in range(16):
        for q in range(3):
            if p[i, q]:
                assert np.linalg.norm(el["joints2d"][i, q].mean(0)
                                      - el["centers"][i, q]) < 24.0


def test_union_stage1_targets(model):
    d = sh.make_hard_examples(model, 8, CFG, seed=2, occlusion_prob=0.0,
                              distractor_prob=0.7)
    u = sh.make_hard_examples(model, 8, CFG, seed=2, occlusion_prob=0.0,
                              distractor_prob=0.7, union_stage1=True)
    for k in d:
        np.testing.assert_array_equal(d[k], u[k])
    hs1 = u["heatmaps_stage1"]
    assert hs1.shape == u["heatmaps"].shape
    for i in range(8):
        if u["has_distractor"][i]:
            assert (hs1[i, ..., :-1] >= u["heatmaps"][i, ..., :-1]
                    - 1e-6).all()
            assert (hs1[i, ..., -1] <= u["heatmaps"][i, ..., -1]
                    + 1e-6).all()
            extra = (hs1[i, ..., :-1] - u["heatmaps"][i, ..., :-1]).max(-1)
            yx = np.unravel_index(np.argmax(extra), extra.shape)
            peak_px = np.array([yx[1], yx[0]], np.float32) * CFG.stride
            assert extra.max() > 0.5
            assert np.linalg.norm(peak_px - u["distractor_centers"][i]) \
                < 0.75 * CFG.input_size
        else:
            np.testing.assert_array_equal(hs1[i], u["heatmaps"][i])
    np.testing.assert_allclose(hs1[..., -1], 1.0 - hs1[..., :-1].max(-1),
                               atol=1e-6)


def test_union_stage1_flip_mirrors_distractor_mass(model):
    kw = dict(occlusion_prob=0.0, distractor_prob=1.0, union_stage1=True)
    u0 = sh.make_hard_examples(model, 6, CFG, seed=5, flip_prob=1e-12, **kw)
    u1 = sh.make_hard_examples(model, 6, CFG, seed=5, flip_prob=1.0, **kw)
    size = CFG.input_size
    ys, xs = np.mgrid[0:16, 0:16]
    for i in range(6):
        np.testing.assert_allclose(
            u1["distractor_centers"][i, 0],
            size - 1.0 - u0["distractor_centers"][i, 0], atol=1e-5)
        np.testing.assert_allclose(u1["distractor_centers"][i, 1],
                                   u0["distractor_centers"][i, 1])
        e0, e1 = ((u["heatmaps_stage1"][i, ..., :-1]
                   - u["heatmaps"][i, ..., :-1]).max(-1) for u in (u0, u1))
        cx0 = np.sum(e0 * xs) / e0.sum() * CFG.stride
        cy0 = np.sum(e0 * ys) / e0.sum() * CFG.stride
        cx1 = np.sum(e1 * xs) / e1.sum() * CFG.stride
        cy1 = np.sum(e1 * ys) / e1.sum() * CFG.stride
        assert abs(cx1 - (size - 1.0 - cx0)) <= CFG.stride
        assert abs(cy1 - cy0) <= CFG.stride


def test_max_distractors_two(model):
    base = sh.make_hard_examples(model, 10, CFG, seed=2, occlusion_prob=0.0)
    d1 = sh.make_hard_examples(model, 10, CFG, seed=2, occlusion_prob=0.0,
                               distractor_prob=0.9)
    d2 = sh.make_hard_examples(model, 10, CFG, seed=2, occlusion_prob=0.0,
                               distractor_prob=0.9, max_distractors=2)
    for k in ("joints2d", "centers", "scales", "heatmaps"):
        np.testing.assert_array_equal(base[k], d2[k])
    nd = d2["num_distractors"]
    assert set(np.unique(nd[nd > 0])) <= {1, 2}
    assert (nd == 2).any() and (nd == 1).any()
    np.testing.assert_array_equal(nd > 0, d2["has_distractor"] > 0)
    assert d1["num_distractors"].max() == 1


def test_train_batches_union_schema(model):
    b = next(sh.hard_train_batches(model, 4, 1, CFG, seed=0,
                                   raw_images=True, distractor_prob=1.0,
                                   union_stage1=True, max_distractors=2))
    assert b["heatmaps_stage1"].shape == b["heatmaps"].shape
    assert (b["heatmaps_stage1"][..., :-1]
            >= b["heatmaps"][..., :-1] - 1e-6).all()


def test_multi_video_x_span_controls_start_spread(model):
    v0 = sh.make_hard_multi_video(model, 4, CFG, seed=2, num_people=4)
    v0b = sh.make_hard_multi_video(model, 4, CFG, seed=2, num_people=4,
                                   x_span=0.0)
    np.testing.assert_array_equal(v0["images"], v0b["images"])
    vw = sh.make_hard_multi_video(model, 4, CFG, seed=2, num_people=4,
                                  x_span=0.8)
    gap0 = np.diff(np.sort(v0["centers"][0, :, 0])).min() / 128.0
    gapw = np.diff(np.sort(vw["centers"][0, :, 0])).min() / 128.0
    assert abs(gap0 - 0.56 / 3) < 0.02
    assert abs(gapw - 0.8 / 3) < 0.02
    cx = vw["centers"][..., 0]
    assert cx[0, 0] < cx[0, -1] and cx[-1, 0] > cx[-1, -1]


def test_generator_runs_on_a_model_on_another_device(model):
    """The generator copies the model to the CPU for its SMPL forward:
    a model handed over elsewhere gives the same frames (here the
    meta device stands in for the GPU: only .device is read before the
    copy)."""
    class Elsewhere:
        device = torch.device("meta")

        def __init__(self, m):
            self.m = m

        def to(self, dev):
            assert str(dev) == "cpu"
            return self.m

        def __getattr__(self, k):
            return getattr(self.m, k)

    a = sh.make_hard_examples(model, 2, CFG, seed=4)
    b = sh.make_hard_examples(Elsewhere(model), 2, CFG, seed=4)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# -- union stage-1 targets in training ----------------------------------------

SMALL_KW = dict(input_size=64, features=16, stage1_head_width=32,
                refine_width=16, num_stages=2, compute_dtype="float32")


def test_stage_supervision_loss_union_targets_match_jax(model):
    """hard_train_batches(union_stage1=True)'s heatmaps_stage1 reach stage
    1 only, through the port's loss as through JAX's (flipped frames
    included), within 1e-5; the train step feeds the key to the loss."""
    cfg = CPMConfig(**SMALL_KW)
    b = next(sh.hard_train_batches(model, 4, 1, cfg, seed=3,
                                   raw_images=True, distractor_prob=1.0,
                                   max_distractors=2, union_stage1=True,
                                   flip_prob=0.5))
    assert (np.abs(b["heatmaps_stage1"] - b["heatmaps"]).max((1, 2, 3))
            > 0.1).all()
    cpm = cpm_lib.init_cpm_params(0, cfg, device="cpu")
    params = jax.tree.map(jnp.asarray, cpm_lib.cpm_params_to_numpy(cpm))
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    for stage1 in (None, "heatmaps_stage1"):
        want = float(jax_cpm_train.stage_supervision_loss(
            params, jnp.asarray(b["images"]), jnp.asarray(b["center_maps"]),
            jnp.asarray(b["heatmaps"]), JaxCPMConfig(**SMALL_KW),
            stage1_heatmaps=None if stage1 is None
            else jnp.asarray(b[stage1])))
        with torch.no_grad():
            got = float(cpm_train.stage_supervision_loss(
                cpm, t["images"], t["center_maps"], t["heatmaps"], cfg,
                stage1_heatmaps=None if stage1 is None else t[stage1]))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        if stage1 is None:
            target_only = got
    assert got != target_only
    opt = cpm_train.TrainOptimizer(1e-3)
    _, _, loss = cpm_train.make_train_step(cfg, opt)(
        cpm, opt.init(dict(cpm.named_parameters())), b)
    np.testing.assert_allclose(float(loss), got, rtol=1e-6)
