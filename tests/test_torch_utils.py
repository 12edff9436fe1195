"""The port's host utilities (tpu_pose_torch/utils/): metrics against the
JAX package's on seeded inputs, npz files across the two packages, viz
arrays, video IO, the numerical checks and profiling."""

import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pose.utils import checkpoint as jax_ckpt
from tpu_pose.utils import metrics as jax_metrics
from tpu_pose.utils import tf_converter as jax_conv
from tpu_pose.utils import viz as jax_viz
from tpu_pose_torch.models import cpm as cpm_lib
from tpu_pose_torch.utils import checkpoint, debug, metrics, profiling, viz
from tpu_pose_torch.utils import tf_converter
from tpu_pose_torch.utils.config import CPMConfig
from torch_threads import one_thread

one_thread()

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(seed, shape, reflect=False):
    """(pred, gt): gt random, pred a scaled, rotated, shifted and noisy
    copy; ``reflect`` mirrors it (det < 0) for Procrustes' fix."""
    rng = np.random.RandomState(seed)
    gt = rng.randn(*shape).astype(np.float32)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    q *= np.sign(np.linalg.det(q))
    if reflect:
        q = q @ np.diag([1.0, 1.0, -1.0])
    pred = 1.3 * gt @ q.T + rng.randn(3) + 0.05 * rng.randn(*shape)
    return pred.astype(np.float32), gt


@pytest.mark.parametrize("reflect", [False, True])
def test_metrics_match_jax(reflect):
    pred, gt = _pair(0, (4, 14, 3), reflect)
    t = torch.from_numpy
    for fn in ("mpjpe", "scaled_mpjpe"):
        np.testing.assert_allclose(
            getattr(metrics, fn)(t(pred), t(gt)).numpy(),
            np.asarray(getattr(jax_metrics, fn)(jnp.asarray(pred),
                                                jnp.asarray(gt))),
            err_msg=fn, **TOL)
    np.testing.assert_allclose(
        metrics.mpjpe(t(pred), t(gt), align_root=False).numpy(),
        np.asarray(jax_metrics.mpjpe(jnp.asarray(pred), jnp.asarray(gt),
                                     align_root=False)), **TOL)
    # The JAX functions take one (J, 3) pair; the port's batch.
    for fn in ("procrustes_align", "pa_mpjpe"):
        want = np.stack([np.asarray(getattr(jax_metrics, fn)(
            jnp.asarray(p), jnp.asarray(g))) for p, g in zip(pred, gt)])
        np.testing.assert_allclose(getattr(metrics, fn)(t(pred), t(gt))
                                   .numpy(), want, err_msg=fn, **TOL)
    # A reflected pred cannot be rotated onto gt: the aligned error stays
    # well above the noise, as in JAX.
    pa = metrics.pa_mpjpe(t(pred), t(gt)).numpy()
    assert (pa > 0.3).all() if reflect else (pa < 0.1).all()
    np.testing.assert_allclose(pa, metrics.pa_mpjpe_np(pred, gt), **TOL)


def test_2d_metrics_match_jax():
    rng = np.random.RandomState(1)
    gt = (rng.rand(5, 14, 2) * 100).astype(np.float32)
    pred = gt + (rng.randn(5, 14, 2) * 6).astype(np.float32)
    mask = rng.rand(5, 14) > 0.3
    headsize = rng.uniform(10, 30, 5).astype(np.float32)
    t, j = torch.from_numpy, jnp.asarray
    np.testing.assert_allclose(metrics.pck(t(pred), t(gt), 8.0).numpy(),
                               np.asarray(jax_metrics.pck(j(pred), j(gt),
                                                          8.0)), **TOL)
    for kw in ({}, {"mask": mask}, {"headsize": headsize, "mask": mask}):
        tkw = {k: t(v) for k, v in kw.items()}
        jkw = {k: j(v) for k, v in kw.items()}
        np.testing.assert_allclose(
            metrics.pckh(t(pred), t(gt), **tkw).numpy(),
            np.asarray(jax_metrics.pckh(j(pred), j(gt), **jkw)), **TOL)


def test_numpy_twins_match_jax():
    """The float64 host twins are copies: equal to JAX's."""
    pred, gt = _pair(2, (3, 14, 3))
    verts, gverts = _pair(3, (2, 50, 3), reflect=True)
    rng = np.random.RandomState(4)
    p2, g2 = rng.rand(3, 14, 2) * 80, rng.rand(3, 14, 2) * 80
    mask = rng.rand(3, 14) > 0.2
    area = metrics.keypoint_bbox_area_np(g2, mask)
    cases = [("pa_mpjpe_np", (pred, gt), {}), ("mpjpe_np", (pred, gt), {}),
             ("scaled_mpjpe_np", (pred, gt), {}),
             ("oks_np", (p2, g2, area), {"mask": mask}),
             ("keypoint_bbox_area_np", (g2,), {"mask": mask}),
             ("pve_np", (verts, gverts), {}),
             ("pve_np", (verts, gverts), {"align": "none"}),
             ("pa_pve_np", (verts, gverts), {}),
             ("pckh_np", (p2, g2), {"mask": mask})]
    for fn, args, kw in cases:
        np.testing.assert_array_equal(
            getattr(metrics, fn)(*args, **kw),
            getattr(jax_metrics, fn)(*args, **kw), err_msg=fn)
    with pytest.raises(ValueError, match="align"):
        metrics.pve_np(verts, gverts, align="procrustes")


def test_fit_results_npz_across_packages(tmp_path):
    rng = np.random.RandomState(5)
    theta, beta, cam = (rng.randn(3, n).astype(np.float32)
                        for n in (72, 10, 3))
    port_file, jax_file = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    checkpoint.save_fit_results(port_file, torch.from_numpy(theta), beta,
                                cam, energy=torch.ones(3),
                                extra={"frame": np.arange(3)})
    jax_ckpt.save_fit_results(jax_file, theta, beta, cam,
                              energy=np.ones(3, np.float32),
                              extra={"frame": np.arange(3)})
    for a, b in ((jax_ckpt.load_fit_results(port_file),
                  checkpoint.load_fit_results(jax_file)),
                 (checkpoint.load_fit_results(port_file),
                  jax_ckpt.load_fit_results(jax_file))):
        assert set(a) == {"theta", "beta", "cam", "energy", "frame"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cpm_params_npz_across_packages(tmp_path):
    """The port's CPM saved by the port loads in JAX's loader with the
    same arrays, and JAX's file loads back into an equal port CPM."""
    cfg = CPMConfig(input_size=64, features=8, stage1_head_width=16,
                    refine_width=8, num_stages=2)
    cpm = cpm_lib.init_cpm_params(3, cfg, device="cpu")
    port_file, jax_file = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    checkpoint.save_cpm_params(port_file, cpm)
    params = cpm_lib.cpm_params_to_numpy(cpm)
    loaded = jax_conv.load_params_npz(port_file)
    assert set(loaded) == set(params)
    for layer, wb in params.items():
        for k, v in wb.items():
            np.testing.assert_array_equal(np.asarray(loaded[layer][k]), v)
    jax_ckpt.save_cpm_params(jax_file, loaded)
    back = cpm_lib.cpm_params_from_numpy(tf_converter.load_params_npz(
        jax_file), cfg, "cpu")
    for (n, a), (_, b) in zip(cpm.state_dict().items(),
                              back.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)


def test_viz_matches_jax(tmp_path):
    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (64, 80, 3)).astype(np.uint8)
    joints = rng.rand(14, 2) * [80, 64]
    conf = rng.rand(14)
    np.testing.assert_array_equal(
        viz.draw_skeleton(img, joints, conf),
        jax_viz.draw_skeleton(img, joints, conf))
    verts = rng.randn(40, 3) * 0.3
    faces = rng.randint(0, 40, (30, 3))
    cam = np.array([0.9, 0.05, -0.1])
    px = viz.project_vertices_weak_perspective(verts, cam, 64)
    np.testing.assert_array_equal(
        px, jax_viz.project_vertices_weak_perspective(verts, cam, 64))
    np.testing.assert_array_equal(
        viz.draw_mesh_overlay(img, px), jax_viz.draw_mesh_overlay(img, px))
    np.testing.assert_array_equal(
        viz.rasterize_mesh(img, px, verts[:, 2], faces, vertices3d=verts),
        jax_viz.rasterize_mesh(img, px, verts[:, 2], faces,
                               vertices3d=verts))
    hm = rng.rand(8, 8, 15).astype(np.float32)
    np.testing.assert_array_equal(viz.tile_heatmaps(hm),
                                  jax_viz.tile_heatmaps(hm))
    viz.export_obj(str(tmp_path / "p.obj"), verts, faces)
    jax_viz.export_obj(str(tmp_path / "j.obj"), verts, faces)
    assert (tmp_path / "p.obj").read_text() == \
        (tmp_path / "j.obj").read_text()


def test_videoio_roundtrip(tmp_path):
    if importlib.util.find_spec("cv2") is None:
        pytest.skip("cv2 not installed")
    from tpu_pose_torch.utils import videoio
    frames = np.zeros((5, 32, 48, 3), np.uint8)
    frames[:, :, :16] = (200, 30, 30)      # red band: RGB order kept
    path = str(tmp_path / "v.avi")
    videoio.write_video(path, frames, fps=10.0)
    info = videoio.video_info(path)
    assert (info["width"], info["height"]) == (48, 32)
    back = videoio.read_video(path)
    assert back.shape == (5, 32, 48, 3)
    assert back[:, 8, 8, 0].min() > 150 and back[:, 8, 8, 2].max() < 90
    chunks = list(videoio.iter_video(path, chunk=2, stride=2))
    assert [len(c) for c in chunks] == [2, 1]
    assert videoio.is_video_path(path) and not videoio.is_video_path("a.npy")


def test_checked_reports_nan_and_inf():
    err, out = debug.checked(lambda x: x * 2.0)(torch.ones(3))
    err.throw()
    assert err.get() is None
    torch.testing.assert_close(out, torch.full((3,), 2.0))
    err, _ = debug.checked(torch.log)(torch.tensor(-1.0))
    assert isinstance(err.get(), FloatingPointError)
    with pytest.raises(FloatingPointError, match="output"):
        err.throw()
    err, _ = debug.checked(lambda x: {"a": x, "b": (x, x / 0.0)})(
        torch.ones(2))
    with pytest.raises(FloatingPointError, match=r"output\.b\[1\]"):
        err.throw()


def test_assert_all_finite_guard():
    def guarded(x):
        return debug.assert_all_finite(x / x.sum(), "normed")

    err, out = debug.checked(guarded)(torch.zeros(4))  # 0/0 → NaN
    assert out is None
    with pytest.raises(FloatingPointError, match="normed"):
        err.throw()
    debug.checked(guarded)(torch.ones(4))[0].throw()
    debug.enable_nan_checks(True)
    assert torch.is_anomaly_enabled()
    debug.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


def test_profiling_timer_and_cost_analysis(tmp_path):
    m, k, n = 128, 64, 32
    a, b = torch.ones(m, k), torch.ones(k, n)
    cost = profiling.cost_analysis(torch.matmul, a, b)
    assert cost == {"flops": 2.0 * m * n * k}
    sec = profiling.Timer(torch.matmul, a, b, warmup=1, iters=2).run()
    assert sec > 0
    assert profiling.sync({"x": a[:1], "y": (b[:1], torch.empty(0))}) == 2.0
    util = profiling.utilization(1e-3, cost)
    assert util["mfu"] == pytest.approx(2.0 * m * n * k / 1e-3 / 67e12)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.matmul(a, b)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
