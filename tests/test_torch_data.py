"""The port's data layer (tpu_pose_torch/data/) against the JAX package's:
the synthetic sets and batch schemas, the npz-shard pipeline both ways
(shuffled order held against JAX's numpy branch), select_h36m_joints, and
the dataset readers and converters on small files the tests write."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_datasets import (_coco_json, _fabricate_3dpw, _lsp_mat,
                           _mpii_mat, _write_lsp_images)
from tpu_pose.data import datasets as jax_ds
from tpu_pose.data import pipeline as jax_pipe
from tpu_pose.data import synthetic as jax_syn
from tpu_pose.models import joints as jax_joints
from tpu_pose.models import smpl_data as jax_smpl_data
from tpu_pose.utils.config import CPMConfig as JaxCPMConfig
from tpu_pose_torch.data import datasets, pipeline, synthetic
from tpu_pose_torch.models import joints, smpl_data
from tpu_pose_torch.utils.config import CPMConfig
from torch_threads import one_thread

one_thread()

CFG_KW = dict(input_size=64, features=16, stage1_head_width=32,
              refine_width=16, num_stages=2)
SMALL = CPMConfig(**CFG_KW)
JAX_SMALL = JaxCPMConfig(**CFG_KW)
# The port's SMPL joints run in eager float32 on the CPU, JAX's in a
# jitted forward: joints agree to float32 rounding, a rendered pixel
# within one unit (a value on a rounding edge of the uint8 cast).
JOINT_TOL = dict(rtol=0, atol=1e-4)     # px and metres
HEATMAP_TOL = dict(rtol=0, atol=1e-5)
CMAP_TOL = dict(rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    return (jax_smpl_data.synthetic_smpl(seed=0, num_verts=300),
            smpl_data.synthetic_smpl(seed=0, num_verts=300, device="cpu"))


def _assert_pixels_close(a, b):
    """uint8 images within one unit, and at most 1 % of values off."""
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.01


def test_sample_poses_bit_identical():
    a = jax_syn.sample_poses(np.random.RandomState(3), 5)
    b = synthetic.sample_poses(np.random.RandomState(3), 5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("video", [False, True])
def test_examples_match_jax(models, video):
    jm, tm = models
    if video:
        want = jax_syn.make_video_examples(jm, 6, JAX_SMALL, seed=4,
                                           keyframe_every=4)
        got = synthetic.make_video_examples(tm, 6, SMALL, seed=4,
                                            keyframe_every=4)
    else:
        want = jax_syn.make_examples(jm, 4, JAX_SMALL, seed=2)
        got = synthetic.make_examples(tm, 4, SMALL, seed=2)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == \
            want[k].dtype, k
    np.testing.assert_array_equal(got["theta"], want["theta"])
    np.testing.assert_array_equal(got["beta"], want["beta"])
    np.testing.assert_allclose(got["gt_joints3d"], want["gt_joints3d"],
                               **JOINT_TOL)
    np.testing.assert_allclose(got["joints2d"], want["joints2d"],
                               **JOINT_TOL)
    np.testing.assert_allclose(got["heatmaps"], want["heatmaps"],
                               **HEATMAP_TOL)
    _assert_pixels_close(got["images"], want["images"])


@pytest.mark.parametrize("kind", ["train_f32", "train_raw", "eval"])
def test_batch_schemas_match_jax(models, kind):
    jm, tm = models
    if kind == "eval":
        want = list(jax_syn.eval_batches(jm, 2, 2, JAX_SMALL, seed=7))
        got = list(synthetic.eval_batches(tm, 2, 2, SMALL, seed=7))
    else:
        raw = kind == "train_raw"
        want = list(jax_syn.cpm_train_batches(jm, 2, 2, JAX_SMALL, seed=1,
                                              raw_images=raw))
        got = list(synthetic.cpm_train_batches(tm, 2, 2, SMALL, seed=1,
                                               raw_images=raw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
            if k == "images" and w[k].dtype == np.uint8:
                _assert_pixels_close(g[k], w[k])
            elif k == "images":
                # x/256 − 0.5 of images within one unit.
                np.testing.assert_allclose(g[k], w[k], rtol=0,
                                           atol=1 / 256 + 1e-6)
            elif k == "center_maps":
                np.testing.assert_allclose(g[k], w[k], **CMAP_TOL)
            elif k == "heatmaps":
                np.testing.assert_allclose(g[k], w[k], **HEATMAP_TOL)
            else:
                np.testing.assert_allclose(g[k], w[k], **JOINT_TOL)


# ---------------------------------------------------------------------------
# npz-shard pipeline
# ---------------------------------------------------------------------------

def _arrays(n=10, seed=0):
    rng = np.random.RandomState(seed)
    return {"images": rng.randint(0, 255, (n, 8, 8, 3)).astype(np.uint8),
            "gt_joints3d": rng.randn(n, 24, 3).astype(np.float32),
            "idx": np.arange(n)}


@pytest.fixture
def no_grain(monkeypatch):
    """Sends the JAX reader down its numpy branch (grain fails to
    import), the ordering the port implements."""
    monkeypatch.setitem(sys.modules, "grain", None)
    monkeypatch.setitem(sys.modules, "grain.python", None)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shards_read_across_packages(tmp_path, writer):
    arrays = _arrays(10)
    write = (pipeline if writer == "port" else jax_pipe).write_npz_shards
    paths = write(str(tmp_path), arrays, shard_size=4)
    assert [p.rsplit("/", 1)[1] for p in paths] == [
        "shard-00000.npz", "shard-00001.npz", "shard-00002.npz"]
    for src in (pipeline.NpzShardSource(str(tmp_path)),
                jax_pipe.NpzShardSource(str(tmp_path))):
        assert len(src) == 10
        for i in (0, 3, 4, 9, 13):          # 13 wraps to 3
            for k, v in arrays.items():
                np.testing.assert_array_equal(src[i][k], v[i % 10])
    keyed = pipeline.NpzShardSource(str(tmp_path), keys=("idx",))
    assert set(keyed[5]) == {"idx"}


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_unshuffled_batches_equal_jax_with_grain(tmp_path, drop_remainder):
    pipeline.write_npz_shards(str(tmp_path), _arrays(10), shard_size=4)
    got = list(pipeline.batches(str(tmp_path), 3,
                                drop_remainder=drop_remainder))
    want = list(jax_pipe.batches(str(tmp_path), 3,
                                 drop_remainder=drop_remainder,
                                 shard_by_process=False))
    assert len(got) == len(want) == (3 if drop_remainder else 4)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))


@pytest.mark.parametrize("epochs", [1, 2])
def test_shuffled_batches_equal_jax_numpy_order(tmp_path, no_grain, epochs):
    pipeline.write_npz_shards(str(tmp_path), _arrays(10), shard_size=4)
    got = [b["idx"] for b in pipeline.batches(
        str(tmp_path), 3, shuffle=True, seed=5, num_epochs=epochs)]
    want = [b["idx"] for b in jax_pipe.batches(
        str(tmp_path), 3, shuffle=True, seed=5, num_epochs=epochs,
        shard_by_process=False)]
    assert len(got) == 3 * epochs
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # Each epoch covers distinct records; the order is not the identity.
    first = np.concatenate(got[:3])
    assert len(set(first.tolist())) == 9
    assert not np.array_equal(first, np.arange(9))


def test_batches_split_across_ranks(tmp_path, monkeypatch):
    """shard_by_process reads torch.distributed's rank and world size when
    a process group is initialized: rank 1 of 2 reads every other
    record from the second."""
    import torch.distributed as dist
    pipeline.write_npz_shards(str(tmp_path), _arrays(8), shard_size=4)
    assert pipeline.process_shard() == (0, 1)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    assert pipeline.process_shard() == (1, 2)
    got = [b["idx"].tolist() for b in pipeline.batches(str(tmp_path), 2)]
    assert got == [[1, 3], [5, 7]]
    alone = [b["idx"].tolist() for b in pipeline.batches(
        str(tmp_path), 4, shard_by_process=False)]
    assert alone == [[0, 1, 2, 3], [4, 5, 6, 7]]


def test_select_h36m_joints_matches_jax():
    x = np.random.RandomState(0).randn(2, 3, 24, 3).astype(np.float32)
    want = np.asarray(jax_joints.select_h36m_joints(jnp.asarray(x)))
    np.testing.assert_array_equal(joints.select_h36m_joints(x), want)
    np.testing.assert_array_equal(
        joints.select_h36m_joints(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(joints.H36M_TO_SMPL,
                                  jax_joints.H36M_TO_SMPL)
    assert joints.H36M_JOINT_NAMES == jax_joints.H36M_JOINT_NAMES


# ---------------------------------------------------------------------------
# Dataset readers and converters
# ---------------------------------------------------------------------------

def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


def _assert_shards_equal(a: str, b: str):
    sa, sb = pipeline.NpzShardSource(a), pipeline.NpzShardSource(b)
    assert len(sa) == len(sb) and len(sa) > 0
    assert sa.paths[-1].rsplit("/", 1)[1] == sb.paths[-1].rsplit("/", 1)[1]
    for i in range(len(sa)):
        ra, rb = sa[i], sb[i]
        assert set(ra) == set(rb)
        for k in rb:
            assert ra[k].dtype == rb[k].dtype, k
            np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)


@pytest.mark.parametrize("layout", ["lsp", "lspet"])
def test_load_lsp_matches_jax(tmp_path, layout):
    path, _, _ = _lsp_mat(tmp_path, layout)
    for vis in ("auto", "visible_flag"):
        for g, w in zip(datasets.load_lsp(path, vis),
                        jax_ds.load_lsp(path, vis)):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="visibility"):
        datasets.load_lsp(path, visibility="nope")


def test_load_mpii_coco_h36m_match_jax(tmp_path):
    mpii = _mpii_mat(tmp_path)
    for train_only in (True, False):
        _assert_records_equal(datasets.load_mpii(mpii, train_only),
                              jax_ds.load_mpii(mpii, train_only))
    coco, _ = _coco_json(tmp_path)
    _assert_records_equal(datasets.load_coco(coco), jax_ds.load_coco(coco))
    rng = np.random.RandomState(0)
    h36m = str(tmp_path / "data_3d_h36m.npz")
    np.savez_compressed(h36m, positions_3d=np.array(
        {"S1": {"Walking": rng.randn(5, 32, 3).astype(np.float32)},
         "S9": {"Sitting": rng.randn(4, 17, 3).astype(np.float32)}},
        dtype=object))
    got, want = datasets.load_h36m_3d_npz(h36m), jax_ds.load_h36m_3d_npz(h36m)
    assert got.keys() == want.keys()
    for subj in want:
        for act in want[subj]:
            np.testing.assert_array_equal(got[subj][act], want[subj][act])
    np.testing.assert_array_equal(datasets.LSP_TO_CPM, jax_ds.LSP_TO_CPM)
    np.testing.assert_array_equal(datasets.MPII_TO_CPM, jax_ds.MPII_TO_CPM)
    np.testing.assert_array_equal(datasets.H36M_32_TO_17,
                                  jax_ds.H36M_32_TO_17)


def test_load_3dpw_matches_jax(tmp_path):
    pkl, _, _ = _fabricate_3dpw(tmp_path)
    got, want = datasets.load_3dpw(pkl), jax_ds.load_3dpw(pkl)
    for k in ("sequence", "cam_poses", "cam_intrinsics", "img_frame_ids"):
        np.testing.assert_array_equal(got[k], want[k])
    _assert_records_equal(got["actors"], want["actors"])


@pytest.mark.parametrize("center,side,out", [((90, 60), 64.0, 128),
                                             ((0, 0), 40.0, 40),
                                             ((70.3, 41.7), 151.4, 64)])
def test_crop_person_matches_jax(center, side, out):
    img = np.random.RandomState(1).randint(0, 255, (120, 160, 3)) \
        .astype(np.uint8)
    crop, origin, zoom = datasets.crop_person(img, center, side, out)
    w_crop, w_origin, w_zoom = jax_ds.crop_person(img, center, side, out)
    np.testing.assert_array_equal(crop, w_crop)
    np.testing.assert_array_equal(origin, w_origin)
    assert zoom == w_zoom
    pts = np.random.RandomState(2).uniform(0, 150, (14, 2))
    np.testing.assert_array_equal(
        datasets.crop_point_map(pts, origin, zoom),
        jax_ds.crop_point_map(pts, w_origin, w_zoom))


@pytest.mark.parametrize("dataset", ["lsp", "mpii", "coco", "3dpw"])
def test_converters_match_jax(tmp_path, dataset):
    from PIL import Image
    if dataset == "lsp":
        mat, xy, _ = _lsp_mat(tmp_path, "lsp", n=3)
        args = (mat, _write_lsp_images(tmp_path, xy))
        convert, jax_convert = datasets.lsp_to_shards, jax_ds.lsp_to_shards
    elif dataset == "mpii":
        d = tmp_path / "mpii_images"
        d.mkdir()
        Image.fromarray(np.full((300, 400, 3), 90, np.uint8)).save(
            d / "037454012.jpg")
        args = (_mpii_mat(tmp_path), str(d))
        convert, jax_convert = datasets.mpii_to_shards, jax_ds.mpii_to_shards
    elif dataset == "coco":
        d = tmp_path / "coco_images"
        d.mkdir()
        Image.fromarray(np.full((200, 120, 3), 50, np.uint8)).save(
            d / "000000000003.jpg")
        args = (_coco_json(tmp_path)[0], str(d))
        convert, jax_convert = datasets.coco_to_shards, jax_ds.coco_to_shards
    else:
        pkl, img_dir, _ = _fabricate_3dpw(tmp_path)
        args = (pkl, img_dir)
        convert = datasets.threedpw_to_shards
        jax_convert = jax_ds.threedpw_to_shards
    convert(*args, str(tmp_path / "port"), out_size=64, shard_size=2)
    jax_convert(*args, str(tmp_path / "jax"), out_size=64, shard_size=2)
    _assert_shards_equal(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_sequences_to_shards_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    images = rng.randint(0, 255, (5, 8, 8, 3)).astype(np.uint8)
    j3d = rng.randn(5, 17, 3)
    extra = dict(gt_joints2d=rng.randn(5, 14, 2),
                 gt_theta=rng.randn(5, 72), gt_beta=rng.randn(5, 10))
    datasets.sequences_to_shards(images, j3d, str(tmp_path / "port"),
                                 shard_size=2, **extra)
    jax_ds.sequences_to_shards(images, j3d, str(tmp_path / "jax"),
                               shard_size=2, **extra)
    _assert_shards_equal(str(tmp_path / "port"), str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="align"):
        datasets.sequences_to_shards(images, j3d[:2], str(tmp_path / "x"))
    with pytest.raises(ValueError, match="together"):
        datasets.sequences_to_shards(images, j3d, str(tmp_path / "y"),
                                     gt_theta=extra["gt_theta"])
