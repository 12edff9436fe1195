"""The port's data-parallel layer (tpu_pose_torch/parallel/mesh.py, the
sharded evaluators, the data-parallel train step, sharded artifacts, the
frame-sharded video fits and their artifacts, and the CLIs under a
launcher) on the CPU over gloo.

One world of two ranks per module (this file run as a script, joined
through a FileStore under the module's tmp dir) runs every scenario once
and writes its numpy results; the JAX side runs in the parent meanwhile,
single-device and over tests/conftest.py's 8 fake devices, on the same
weights (the port's numpy He-init, carried with ``from_numpy``) and
inputs. Tolerances are the JAX package's own (tests/test_parallel.py)."""

import contextlib
import copy
import functools
import io
import os
import pickle
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from tpu_pose_torch.models import cpm as cpm_lib
from tpu_pose_torch.parallel import mesh as mesh_lib
from tpu_pose_torch.utils import config as tc
from torch_threads import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
KINDS = ("plain", "mask", "stage1")
EVALUATORS = ("h36m", "pckh", "oks")
# Float64 metric sums over the same per-frame values in another order.
METRIC_RTOL = 1e-9


def _cfgs(cfg_mod):
    """tests/test_parallel.py's SMALL_CPM and SMALL_FIT."""
    cpm = cfg_mod.CPMConfig(input_size=64, features=8, stage1_head_width=16,
                            refine_width=8, num_stages=2,
                            compute_dtype="float32")
    fit = cfg_mod.FitConfig(
        stages=(cfg_mod.StageConfig(iters=15, lr=0.05, opt_pose=False,
                                    opt_shape=False, w_pose_prior=0,
                                    w_shape_prior=0, w_angle_prior=0),
                cfg_mod.StageConfig(iters=25, lr=0.02, w_pose_prior=0.5,
                                    w_shape_prior=1.0)),
        img_size=64)
    return cpm, fit


def _inputs():
    """Every input of the scenarios, drawn from seeds with numpy."""
    rng = np.random.RandomState(0)
    imgs8 = rng.randint(0, 255, (8, 64, 64, 3)).astype(np.uint8)
    rng = np.random.RandomState(7)
    j2d = (rng.rand(8, 14, 2) * 64).astype(np.float32)
    conf = (rng.rand(8, 14) * 0.5 + 0.5).astype(np.float32)
    rng = np.random.RandomState(1)
    train = {
        "images": rng.rand(8, 64, 64, 3).astype(np.float32) - 0.5,
        "center_maps": rng.rand(8, 64, 64, 1).astype(np.float32),
        "heatmaps": rng.rand(8, 8, 8, 15).astype(np.float32),
    }
    mask = np.ones((8, 15), np.float32)
    mask[:, 2] = 0.0
    hm_u = train["heatmaps"] + 0.3 * rng.rand(8, 8, 8, 15).astype(np.float32)
    batches = {"plain": train, "mask": dict(train, joint_mask=mask),
               "stage1": dict(train, heatmaps_stage1=hm_u)}
    rng = np.random.RandomState(4)
    evals = []
    for n in (4, 3):     # the last batch uneven over the two ranks
        evals.append({
            "images": rng.randint(0, 255, (n, 64, 64, 3)).astype(np.uint8),
            "gt_joints3d": rng.rand(n, 24, 3).astype(np.float32),
            "gt_joints2d": (rng.rand(n, 14, 2) * 64).astype(np.float32),
            "conf": (rng.rand(n, 14) > 0.2).astype(np.float32),
            "headsize": (rng.rand(n) * 10 + 5).astype(np.float32),
            "area": (rng.rand(n) * 2000 + 500).astype(np.float32)})
    return {"imgs8": imgs8, "imgs3": imgs8[:3], "j2d": j2d, "conf": conf,
            "train": batches, "evals": evals, **_video_inputs()}


# tests/test_parallel.py's sharded smooth video fit: T = 16 frames of a
# body whose pose moves from θ_A to θ_B, SMALL_FIT, 2 hypotheses, 30
# refine steps, no prior, the full-size synthetic SMPL of seed 0 in both
# packages, as that test's estimator has. (On the 400-vertex synthetic
# model the fit is ill-conditioned: JAX's own sharded fit ends 6.0e-3
# from its single-device one in θ, against its 2e-4 bound; 1.4e-5 on the
# full-size model.)
VIDEO_T = 16
VIDEO_KW = dict(restarts=2, iters=30)
# The sharded video artifacts: each of the world's two ranks two frames.
ARTIFACT_T = 4
VIDEO_MODES = ("smooth", "temporal", "independent")
# Sharded against single-device, both in one package: JAX's own bounds
# (tests/test_parallel.py); against JAX: tests/test_torch_temporal.py's.
SHARD_TOL = dict(rtol=0, atol=2e-4)
SHARD_ENERGY_TOL = dict(rtol=0, atol=1e-5)
END_TOL = dict(rtol=0, atol=1e-3)


def _video_inputs():
    """The video sequence's 2D joints (pixels, a 64² frame) from the
    port's SMPL, as tests/test_parallel.py draws them; the mask, anchor
    and frames of the edge cases and artifacts."""
    from tpu_pose_torch.models import camera, joints, smpl, smpl_data
    model = smpl_data.synthetic_smpl(seed=0, device="cpu")
    rng = np.random.RandomState(4)
    th_a, th_b = rng.randn(72) * 0.2, rng.randn(72) * 0.2
    w = np.arange(VIDEO_T)[:, None] / (VIDEO_T - 1.0)
    theta = torch.tensor((1 - w) * th_a + w * th_b, dtype=torch.float32)
    with torch.no_grad():
        out = smpl.smpl_forward(model, torch.zeros(VIDEO_T, 10), theta)
        j3d = joints.select_smpl_joints(out.joints)
        j2d = (camera.weak_perspective_project(
            j3d, torch.tensor([0.9, 0.0, 0.0])) + 1.0) * 32.0
    mask = np.ones(VIDEO_T, np.float32)
    mask[VIDEO_T // 2 - 1:VIDEO_T // 2 + 1] = 0.0   # across the ranks
    rng = np.random.RandomState(6)
    anchor = {"theta": (0.2 * rng.randn(72)).astype(np.float32),
              "beta": (0.5 * rng.randn(10)).astype(np.float32),
              "cam": np.array([0.9, 0.0, 0.0], np.float32)}
    frames = np.random.RandomState(8).randint(
        0, 255, (ARTIFACT_T, 64, 64, 3)).astype(np.uint8)
    return {"video_j2d": j2d.numpy(), "video_conf": np.ones(
        (VIDEO_T, 14), np.float32), "video_mask": mask,
        "video_anchor": anchor, "video_frames": frames}


def _train_params():
    return cpm_lib.cpm_params_to_numpy(
        cpm_lib.init_cpm_params(3, _cfgs(tc)[0], device="cpu"))


def _np(res) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in res._asdict().items()}


# -- one rank of the world ---------------------------------------------------

def _rowwise(est):
    """A copy of ``est`` whose entry points run one frame per call, so a
    frame's prediction does not depend on the batch it came in (on the CPU
    a batch of 4 and one of 2 round the decode 3.8e-6 px and the fit's θ
    3e-8 apart)."""
    def rows(fn):
        def run(images, **kw):
            outs = [fn(images[i:i + 1], **kw) for i in range(len(images))]
            cat = [torch.cat(f) for f in zip(*outs)]
            return (type(outs[0])(*cat) if hasattr(outs[0], "_fields")
                    else tuple(cat))
        return run

    out = copy.copy(est)
    out.estimate_and_fit = rows(est.estimate_and_fit)
    out._front_end = rows(est._front_end)
    return out


def _video_rank(rank, mesh, est, inp, workdir) -> dict:
    """The frame-sharded video fits and artifacts on this rank: sharded
    against the port's single-device call, each Viterbi selection
    recorded; the halo exchange and psum's values."""
    import dataclasses

    from tpu_pose_torch import export as pexport
    from tpu_pose_torch.api import PoseEstimator
    from tpu_pose_torch.fitting import temporal
    out = {}
    shard = mesh_lib.frame_shard(mesh, "cpu")
    first, last = (torch.full((2, 3), 10.0 * rank + k) for k in (1, 2))
    out["halo"] = [t.numpy() for t in mesh_lib.halo_exchange(first, last,
                                                             shard)]
    out["psum"] = mesh_lib.psum(torch.tensor([rank + 1.0, 2.0]),
                                mesh).numpy()
    out["edges"] = {k: float(v) for k, v in shard.edges().items()}

    model = est.smpl_model
    fit_cfg = _cfgs(tc)[1]
    j, c = (torch.from_numpy(inp[k]) for k in ("video_j2d", "video_conf"))
    anchor = {k: torch.from_numpy(v) for k, v in inp["video_anchor"].items()}
    real = temporal._viterbi_select
    cases = {
        "smooth": (j, c, {}),
        "t2": (j[:2], c[:2], {}),
        "mask": (j, c, {"frame_mask": torch.from_numpy(inp["video_mask"])}),
        "anchor": (j, c, {"anchor": anchor}),
        "restarts1": (j, c, {"restarts": 1}),
        "unshared": (j, c, {"shared_beta": False})}
    out["fits"] = {}
    for name, (jj, cc, kw) in cases.items():
        kw = dict(VIDEO_KW, **kw)
        got = {}
        for label, m in (("sharded", mesh), ("single", None)):
            sels = []
            with mock.patch.object(temporal, "_viterbi_select",
                                   lambda *a, **k: sels.append(
                                       real(*a, **k)) or sels[-1]):
                mesh_lib.COLLECTIVES.clear()
                res = temporal.fit_video_smooth(model, jj, cc, fit_cfg, None,
                                                mesh=m, **kw)
            got[label] = (_np(res), [s.numpy() for s in sels],
                          dict(mesh_lib.COLLECTIVES))
        out["fits"][name] = got
    for name, fn in (("temporal", temporal.fit_video),
                     ("independent", temporal.fit_video_independent)):
        out["fits"][name] = {
            label: (_np(fn(model, j, c, fit_cfg, None, mesh=m)), [], {})
            for label, m in (("sharded", mesh), ("single", None))}

    est_v = PoseEstimator(est.cpm, model, None, est.cpm_cfg,
                          dataclasses.replace(fit_cfg,
                                              stages=fit_cfg.stages[-1:]),
                          fit_restarts=2, device="cpu")
    frames = inp["video_frames"]
    out["artifacts"] = {}
    for mode, n in [(m, WORLD) for m in VIDEO_MODES] + [("smooth", 1)]:
        path = os.path.join(workdir, f"video_{mode}_dp{n}")
        meta = pexport.export_estimator(est_v, path,
                                        fn="estimate_and_fit_video",
                                        batch=ARTIFACT_T, n_devices=n,
                                        mode=mode)
        live = est_v.estimate_and_fit_video(
            frames, mode, mesh=mesh if n == WORLD else None)
        out["artifacts"][mode, n] = (meta, pexport.load(path)(frames),
                                     _np(live))

    # The CPM's precision follows the global T: an int8 estimator whose
    # int8_min_batch is T, each rank T/2 frames.
    est_q = PoseEstimator.create_synthetic(
        seed=0, cpm_cfg=est.cpm_cfg, fit_cfg=est_v.fit_cfg, quantize=True,
        calibration_images=frames, int8_min_batch=ARTIFACT_T, device="cpu")
    asked = {}
    for label, m in (("sharded", mesh), ("single", None)):
        asked[label] = []
        with mock.patch.object(
                est_q, "_params_for_batch",
                lambda b, _f=est_q._params_for_batch, _a=asked[label]:
                _a.append(b) or _f(b)):
            res = est_q.estimate_and_fit_video(frames, "independent",
                                               mesh=m)
        out[f"int8_{label}"] = _np(res)
    out["int8_asked"] = asked
    return out


def _evaluate(eval_lib, est, name, batches, **kw):
    fn = {"h36m": eval_lib.evaluate_h36m_style,
          "pckh": eval_lib.evaluate_pckh, "oks": eval_lib.evaluate_oks}[name]
    return fn(est, iter(batches), **kw)


def _rank(rank: int, workdir: str) -> None:
    import torch.distributed as dist

    from tpu_pose_torch import export as pexport
    from tpu_pose_torch.api import PoseEstimator
    from tpu_pose_torch.data import pipeline
    from tpu_pose_torch.models import cpm_train
    from tpu_pose_torch.parallel import eval as eval_lib
    from tpu_pose_torch.tools import eval_2d, train_cpm

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=WORLD)
    out = {}
    try:   # as on a host without CUDA, whatever this one has
        with mock.patch.object(torch.cuda, "is_available",
                               return_value=False):
            mesh_lib.make_mesh(device="cuda")
    except RuntimeError as e:
        out["cuda_mesh_error"] = str(e)
    mesh = mesh_lib.make_mesh(device="cpu")
    out["mesh"] = (mesh.size(), mesh.mesh_dim_names, mesh.get_local_rank())
    inp = _inputs()
    cpm_cfg, fit_cfg = _cfgs(tc)
    est = PoseEstimator.create_synthetic(seed=0, cpm_cfg=cpm_cfg,
                                         fit_cfg=fit_cfg, device="cpu")

    fused = eval_lib.sharded_fused_fn(est, mesh)
    out["fused8"] = _np(fused(inp["imgs8"]))
    padded, n = mesh_lib.pad_to_multiple(inp["imgs3"], WORLD)
    out["fused3"] = {k: v[:n] for k, v in _np(fused(padded)).items()}
    rows = mesh_lib.shard_rows(8, mesh)
    out["fit"] = _np(mesh_lib.gather_batch(
        est.fit_smpl(inp["j2d"][rows], inp["conf"][rows]), mesh))
    two_d = eval_lib.sharded_2d_fn(est, mesh)
    out["2d"] = _np(two_d(inp["imgs8"]))

    params = _train_params()
    out["train"] = {}
    for kind in KINDS:
        res = {}
        for label, m in (("dp", mesh), ("single", None)):
            cpm = cpm_lib.cpm_params_from_numpy(params, cpm_cfg, "cpu")
            opt = cpm_train.TrainOptimizer(lr=1e-3)
            step = cpm_train.make_train_step(cpm_cfg, opt, mesh=m)
            cpm, _, loss = step(cpm, opt.init(dict(cpm.named_parameters())),
                                inp["train"][kind])
            res[label] = (float(loss), cpm_lib.cpm_params_to_numpy(cpm))
        out["train"][kind] = res

    out["eval"] = {}
    est_rows = _rowwise(est)
    for name in EVALUATORS:
        ckpt = os.path.join(workdir, f"{name}.json")
        res = {"single": _evaluate(eval_lib, est, name, inp["evals"]),
               "sharded": _evaluate(eval_lib, est, name, inp["evals"],
                                    mesh=mesh),
               "rows_single": _evaluate(eval_lib, est_rows, name,
                                        inp["evals"]),
               "rows_sharded": _evaluate(eval_lib, est_rows, name,
                                         inp["evals"], mesh=mesh)}
        _evaluate(eval_lib, est, name, inp["evals"][:1], mesh=mesh,
                  checkpoint_path=ckpt)
        res["resumed"] = _evaluate(eval_lib, est, name, inp["evals"],
                                   mesh=mesh, checkpoint_path=ckpt)
        out["eval"][name] = res

    art = os.path.join(workdir, "e2d_dp2")
    meta = pexport.export_estimator(est, art, fn="estimate_2d", batch=4,
                                    n_devices=WORLD)
    prog = pexport.load(art)
    out["artifact"] = (meta, prog(inp["imgs8"][:4]),
                       _np(two_d(inp["imgs8"][:4])))
    out["refusals"] = {}
    for case, kw in (("indivisible", dict(batch=3, n_devices=2)),
                     ("symbolic", dict(batch=None, n_devices=2)),
                     ("world", dict(batch=8, n_devices=4))):
        try:
            pexport.export_estimator(est, os.path.join(workdir, case),
                                     fn="estimate_2d", **kw)
        except ValueError as e:
            out["refusals"][case] = str(e)

    out["video"] = _video_rank(rank, mesh, est, inp, workdir)

    shards = os.path.join(workdir, f"shards{rank}")
    pipeline.write_npz_shards(shards, {"x": np.arange(16)}, shard_size=5)
    out["pipeline"] = {
        flag: [b["x"] for b in pipeline.batches(shards, 4,
                                                shard_by_process=flag)]
        for flag in (True, False)}

    small = functools.partial(tc.CPMConfig, features=8, stage1_head_width=16,
                              refine_width=8, num_stages=2)
    real = tc.CPMConfig
    tc.CPMConfig = small
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            train_cpm.main(["--synthetic", "--steps", "2", "--batch", "4",
                            "--input_size", "32", "--log_every", "1",
                            "--device", "cpu", "--lr", "1e-3", "--export",
                            os.path.join(workdir, "cli_weights.npz")])
    finally:
        tc.CPMConfig = real
    out["train_cli"] = text.getvalue()
    text = io.StringIO()
    real_create = PoseEstimator.create_synthetic.__func__
    PoseEstimator.create_synthetic = classmethod(
        lambda cls, seed=0, **kw: real_create(
            cls, seed, cpm_cfg=cpm_cfg, fit_cfg=fit_cfg, **kw))
    try:
        with contextlib.redirect_stdout(text):
            out["eval_cli"] = eval_2d.main(
                ["--synthetic_batches", "1", "--batch", "3", "--device",
                 "cpu", "--protocol", "oks"])
    finally:
        PoseEstimator.create_synthetic = classmethod(real_create)
    out["eval_cli_text"] = text.getvalue()

    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


# -- the parent: the world and the JAX side ----------------------------------

def _jax_video(inp, params, mesh, workdir) -> dict:
    """JAX's frame-sharded smooth video fit over the 8 devices
    (tests/test_parallel.py's), and its smooth video artifact exported
    with n_devices=2, loaded and run on the artifacts' frames."""
    import dataclasses

    import jax

    from tpu_pose import export as jax_export
    from tpu_pose.api import PoseEstimator as JaxEstimator
    from tpu_pose.fitting import temporal as jax_temporal
    from tpu_pose.models import smpl_data as jax_smpl_data
    from tpu_pose.parallel import mesh as jax_mesh
    from tpu_pose.utils import config as jc

    cpm_cfg, fit_cfg = _cfgs(jc)
    model = jax_smpl_data.synthetic_smpl(seed=0)
    bs = jax_mesh.batch_sharding(mesh)
    fit = jax.jit(lambda m, j, c: jax_temporal.fit_video_smooth(
        m, j, c, cfg=fit_cfg, **VIDEO_KW),
        in_shardings=(jax_mesh.replicated(mesh), bs, bs), out_shardings=bs)
    res = fit(jax_mesh.replicate(model, mesh),
              jax.device_put(inp["video_j2d"], bs),
              jax.device_put(inp["video_conf"], bs))
    est_v = JaxEstimator(
        jax.tree.map(jax.numpy.asarray, params), model, None, cpm_cfg,
        dataclasses.replace(fit_cfg, stages=fit_cfg.stages[-1:]),
        fit_restarts=2)
    path = os.path.join(workdir, "jax_video_dp2")
    jax_export.export_estimator(est_v, path, fn="estimate_and_fit_video",
                                batch=ARTIFACT_T, n_devices=WORLD)
    return {"sharded_fit": {k: np.asarray(v)
                            for k, v in res._asdict().items()},
            "artifact": jax_export.load(path)(inp["video_frames"])}


def _jax_side(inp, workdir):
    """JAX's single-device and 8-device sharded results on the same
    weights and inputs."""
    import jax
    import jax.numpy as jnp

    from tpu_pose.api import PoseEstimator as JaxEstimator
    from tpu_pose.fitting import fit as jax_fit
    from tpu_pose.fitting import priors as jax_priors
    from tpu_pose.models import cpm_train as jax_train
    from tpu_pose.models import smpl_data as jax_smpl_data
    from tpu_pose.parallel import eval as jax_eval
    from tpu_pose.parallel import mesh as jax_mesh
    from tpu_pose.utils import config as jc

    def host(res):
        return {k: np.asarray(v) for k, v in res._asdict().items()}

    cpm_cfg, fit_cfg = _cfgs(jc)
    params = cpm_lib.cpm_params_to_numpy(
        cpm_lib.init_cpm_params(0, _cfgs(tc)[0], device="cpu"))
    est = JaxEstimator(jax.tree.map(jnp.asarray, params),
                       jax_smpl_data.synthetic_smpl(seed=0),
                       jax_priors.synthetic_gmm_prior(0), cpm_cfg, fit_cfg)
    mesh = jax_mesh.make_mesh()
    bs = jax_mesh.batch_sharding(mesh)
    repl = jax_mesh.replicated(mesh)
    out = {"fused8": host(est.estimate_and_fit(inp["imgs8"]))}
    fused = jax_eval.sharded_fused_fn(est, mesh)
    out["sharded_fused8"] = host(fused(jax.device_put(inp["imgs8"], bs)))
    padded, n = jax_mesh.pad_to_multiple(inp["imgs3"], 8)
    out["sharded_fused3"] = {k: v[:n] for k, v in host(
        fused(jax.device_put(padded, bs))).items()}

    fn = functools.partial(jax_fit.fit_smpl_batch, cfg=fit_cfg,
                           prior=est.prior)
    out["fit"] = host(jax.jit(fn)(est.smpl_model, inp["j2d"], inp["conf"]))
    out["sharded_fit"] = host(jax.jit(
        fn, in_shardings=(repl, bs, bs), out_shardings=bs)(
        jax_mesh.replicate(est.smpl_model, mesh),
        jax.device_put(inp["j2d"], bs), jax.device_put(inp["conf"], bs)))

    out["2d"] = host(est.estimate_2d(inp["imgs8"]))
    two_d = jax_eval.sharded_2d_fn(est, mesh)(
        jax.device_put(inp["imgs8"], bs))
    out["sharded_2d"] = dict(zip(("heatmaps", "joints2d", "conf"),
                                 (np.asarray(x) for x in two_d)))

    import optax
    tparams = jax.tree.map(jnp.asarray, _train_params())
    opt = optax.adam(1e-3)
    step = jax_train.make_train_step(cpm_cfg, opt, mesh=mesh)
    out["train"] = {}
    for kind in KINDS:
        p, _, loss = step(jax_mesh.replicate(tparams, mesh),
                          jax_mesh.replicate(opt.init(tparams), mesh),
                          jax_mesh.shard_batch(inp["train"][kind], mesh))
        out["train"][kind] = (float(loss), jax.tree.map(np.asarray, p))
    _, _, loss = jax_train.make_train_step(cpm_cfg, opt)(
        tparams, opt.init(tparams), inp["train"]["plain"])
    out["train_single_plain_loss"] = float(loss)
    out["video"] = _jax_video(inp, params, mesh, workdir)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX results, [rank 0's results, rank 1's]): the world's two ranks
    run while the parent computes the JAX side."""
    workdir = str(tmp_path_factory.mktemp("world"))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), workdir],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    try:
        jax_out = _jax_side(_inputs(), workdir)
    finally:
        logs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-4000:]
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return jax_out, ranks, workdir


# -- the tests ---------------------------------------------------------------

def test_pad_to_multiple():
    """tests/test_parallel.py's case, and a tensor padded on its device
    by repeating its last row."""
    padded, n = mesh_lib.pad_to_multiple(np.ones((5, 3)), 8)
    assert padded.shape == (8, 3) and n == 5
    same, n2 = mesh_lib.pad_to_multiple(np.ones((8, 3)), 8)
    assert same.shape == (8, 3) and n2 == 8
    t, n3 = mesh_lib.pad_to_multiple(torch.arange(3.0)[:, None], 2)
    assert n3 == 3 and t[:, 0].tolist() == [0.0, 1.0, 2.0, 2.0]
    want = np.pad(np.arange(3.0)[:, None], [(0, 1), (0, 0)], mode="edge")
    np.testing.assert_array_equal(t.numpy(), want)


def test_make_mesh_refuses_cuda_without_a_gpu(world, monkeypatch):
    """Without CUDA, make_mesh() raises before touching any process
    group (no silent gloo or CPU mesh), here and inside the world."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_lib.make_mesh()
    assert not torch.distributed.is_initialized()
    for r in world[1]:
        assert "CUDA is not available" in r["cuda_mesh_error"]


def test_mesh_is_one_data_axis_over_the_world(world):
    assert [r["mesh"] for r in world[1]] == [(2, ("data",), 0),
                                            (2, ("data",), 1)]
    from torch.distributed.tensor import Replicate, Shard
    assert mesh_lib.batch_sharding() == [Shard(0)]
    assert mesh_lib.replicated() == [Replicate()]
    assert mesh_lib.DATA_AXIS == "data"


def test_smpl_joint_names_equal_jax():
    from tpu_pose.models import joints as jax_joints
    from tpu_pose_torch.models import joints
    assert joints.SMPL_JOINT_NAMES == jax_joints.SMPL_JOINT_NAMES
    assert len(joints.SMPL_JOINT_NAMES) == 24


def _check_fused(got, want):
    np.testing.assert_allclose(got["joints2d"], want["joints2d"], atol=5e-3)
    np.testing.assert_allclose(got["theta"], want["theta"], atol=3e-2)
    np.testing.assert_allclose(got["vertices"], want["vertices"], atol=3e-2)


@pytest.mark.parametrize("ref", ["fused8", "sharded_fused8"])
def test_sharded_fused_matches_jax(world, ref):
    """sharded_fused_fn at batch 8 over 2 ranks against JAX's single-device
    call and JAX's sharded_fused_fn over 8 devices: joints2d 5e-3 px, θ
    and vertices 3e-2 (tests/test_parallel.py's bounds); both ranks
    return the whole batch."""
    jax_out, ranks, _ = world
    for r in ranks:
        assert r["fused8"]["theta"].shape == (8, 72)
        _check_fused(r["fused8"], jax_out[ref])
    for k, v in ranks[0]["fused8"].items():
        np.testing.assert_array_equal(v, ranks[1]["fused8"][k], err_msg=k)


def test_sharded_fused_uneven_batch_matches_jax(world):
    """An uneven batch of 3 edge-padded to the world (2 ranks) and sliced
    back, against JAX's padded to its 8 devices."""
    jax_out, ranks, _ = world
    for r in ranks:
        assert r["fused3"]["joints2d"].shape == (3, 14, 2)
        _check_fused(r["fused3"], jax_out["sharded_fused3"])


@pytest.mark.parametrize("ref", ["fit", "sharded_fit"])
def test_sharded_fit_on_identical_joints(world, ref):
    """The fit alone on identical joints, rows split over the ranks and
    gathered: θ, β 1e-3, energy 1e-4 against JAX single and sharded."""
    jax_out, ranks, _ = world
    got, want = ranks[0]["fit"], jax_out[ref]
    np.testing.assert_allclose(got["theta"], want["theta"], atol=1e-3)
    np.testing.assert_allclose(got["beta"], want["beta"], atol=1e-3)
    np.testing.assert_allclose(got["energy"], want["energy"], atol=1e-4)


@pytest.mark.parametrize("ref", ["2d", "sharded_2d"])
def test_sharded_2d_matches_jax(world, ref):
    """sharded_2d_fn against JAX's estimate_2d and sharded_2d_fn:
    joints2d 5e-3 px (the fused bound), heatmaps 1e-4 · max, conf 1e-4."""
    jax_out, ranks, _ = world
    got, want = ranks[0]["2d"], jax_out[ref]
    np.testing.assert_allclose(got["joints2d"], want["joints2d"], atol=5e-3)
    np.testing.assert_allclose(got["heatmaps"], want["heatmaps"],
                               atol=1e-4 * np.abs(want["heatmaps"]).max())
    np.testing.assert_allclose(got["conf"], want["conf"], atol=1e-4)


def _param_pairs(port: dict, jax_params: dict):
    for layer, p in port.items():
        for k in ("w", "b"):
            yield f"{layer}.{k}", p[k], np.asarray(jax_params[layer][k])


@pytest.mark.parametrize("kind", KINDS)
def test_dp_train_step_matches_jax(world, kind):
    """make_train_step(mesh=) over 2 ranks against JAX's over 8 devices on
    the same global batch and initial parameters, plain, with a joint
    mask and with stage-1 union targets: loss rtol 1e-5, parameters 5e-4
    after the step (tests/test_parallel.py); and against the port's own
    single-device step."""
    jax_out, ranks, _ = world
    want_loss, want_params = jax_out["train"][kind]
    loss, params = ranks[0]["train"][kind]["dp"]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for name, a, b in _param_pairs(params, want_params):
        np.testing.assert_allclose(a, b, atol=5e-4, err_msg=name)
    s_loss, s_params = ranks[0]["train"][kind]["single"]
    np.testing.assert_allclose(loss, s_loss, rtol=1e-5)
    for layer, p in params.items():
        for k in ("w", "b"):
            np.testing.assert_allclose(p[k], s_params[layer][k], atol=5e-4)
    if kind == "plain":
        np.testing.assert_allclose(loss, jax_out["train_single_plain_loss"],
                                   rtol=1e-5)


def test_dp_train_step_keeps_the_ranks_replicated(world):
    """Every rank applies the same averaged update: identical parameters
    and loss on both ranks after each step."""
    _, ranks, _ = world
    for kind in KINDS:
        l0, p0 = ranks[0]["train"][kind]["dp"]
        l1, p1 = ranks[1]["train"][kind]["dp"]
        assert l0 == l1
        for layer in p0:
            for k in ("w", "b"):
                np.testing.assert_array_equal(p0[layer][k], p1[layer][k])


def _metric_items(d: dict, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _metric_items(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _check_metrics(got: dict, want: dict, rtol: float) -> None:
    want, got = dict(_metric_items(want)), dict(_metric_items(got))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("name", EVALUATORS)
def test_sharded_evaluator_equals_single_device(world, name):
    """Each evaluator with the mesh, over batches of 4 and 3 frames (the
    last edge-padded to the world), gives the single-device metrics within
    1e-9 relative (float64 sums in another order), on both ranks. The
    estimator runs a frame per call here, so each frame's prediction is
    the same in both runs (test_sharded_evaluator_batched bounds the
    batched one)."""
    _, ranks, _ = world
    for r in ranks:
        res = r["eval"][name]
        assert res["rows_sharded"]["num_frames"] == 7
        _check_metrics(res["rows_sharded"], res["rows_single"], METRIC_RTOL)


@pytest.mark.parametrize("name", EVALUATORS)
def test_sharded_evaluator_batched(world, name):
    """The same with the batched estimator: a rank's rows run at batch 2,
    not 4, and float32 rounds their predictions differently (decode
    ≤ 3.8e-6 px, θ ≤ 3e-8 on the CPU), so the metrics agree within
    1e-6 relative; equal on both ranks."""
    _, ranks, _ = world
    for r in ranks:
        res = r["eval"][name]
        assert res["sharded"]["num_frames"] == res["single"]["num_frames"]
        _check_metrics(res["sharded"], res["single"], 1e-6)
    _check_metrics(ranks[1]["eval"][name]["sharded"],
                   ranks[0]["eval"][name]["sharded"], 0.0)


@pytest.mark.parametrize("name", EVALUATORS)
def test_sharded_evaluator_resumes_from_its_cursor(world, name):
    """A run over the mesh stopped after one batch (cursor written by rank
    0) and resumed over both batches gives the uninterrupted run's
    metrics on both ranks."""
    _, ranks, workdir = world
    for r in ranks:
        res = r["eval"][name]
        _check_metrics(res["resumed"], res["sharded"], METRIC_RTOL)
    assert os.path.exists(os.path.join(workdir, f"{name}.json"))


def test_sharded_artifact_matches_the_live_sharded_call(world):
    """export_estimator(n_devices=2): rank 0 writes the per-rank program
    at batch 4 / 2; loaded on both ranks, it runs each rank's rows and
    gathers the batch, equal to the live sharded_2d_fn on the same rows
    within 1e-5 (the same graph, traced), and meta records the sharding
    as JAX's does."""
    _, ranks, _ = world
    for r in ranks:
        meta, got, live = r["artifact"]
        assert meta["sharding"] == {"n_devices": 2, "axis": "data"}
        assert meta["inputs"][0]["shape"] == [4, 64, 64, 3]
        assert meta["outputs"]["joints2d"]["shape"] == ["4", "14", "2"]
        for k in ("heatmaps", "joints2d", "conf"):
            assert got[k].shape[0] == 4
            np.testing.assert_allclose(got[k], live[k], atol=1e-5,
                                       err_msg=k)


def test_sharded_artifact_refusals(world):
    """ValueError on every rank for a batch not divisible by n_devices, a
    symbolic batch, and a world smaller than n_devices."""
    _, ranks, _ = world
    for r in ranks:
        ref = r["refusals"]
        assert set(ref) == {"indivisible", "symbolic", "world"}
        assert "not divisible" in ref["indivisible"]
        assert "static batch" in ref["symbolic"]
        assert "need 4 ranks" in ref["world"]


def test_clis_read_one_global_batch_on_every_rank(world):
    """The process-strided reader would give each rank other records than
    the single process's batch k (their union is not batch k), so the CLIs
    read with shard_by_process=False: every rank sees batch k itself."""
    _, ranks, _ = world
    single = [np.arange(16)[i:i + 4] for i in range(0, 16, 4)]
    for r in ranks:
        got = r["pipeline"][False]
        assert len(got) == len(single)
        for a, b in zip(got, single):
            np.testing.assert_array_equal(a, b)
    union0 = np.concatenate([r["pipeline"][True][0] for r in ranks])
    assert sorted(union0.tolist()) != single[0].tolist()


def test_train_cli_in_the_world(world):
    """train_cpm over the mesh: rank 0 alone prints, and the exported
    weights are the replicated parameters."""
    _, ranks, workdir = world
    assert "done: 2 steps" in ranks[0]["train_cli"]
    assert "step 2: loss" in ranks[0]["train_cli"]
    assert ranks[1]["train_cli"] == ""
    assert os.path.exists(os.path.join(workdir, "cli_weights.npz"))


def test_eval_cli_in_the_world(world):
    """eval_2d over the mesh with an uneven batch of 3: the same metrics on
    both ranks, printed by rank 0 alone."""
    _, ranks, _ = world
    assert ranks[0]["eval_cli"] == ranks[1]["eval_cli"]
    assert ranks[0]["eval_cli"]["num_frames"] == 3
    assert "meanOKS=" in ranks[0]["eval_cli_text"]
    assert ranks[1]["eval_cli_text"] == ""


def test_halo_exchange_and_psum(world):
    """mesh.halo_exchange on each rank: the left neighbour's last row and
    the right neighbour's first row, a missing neighbour's row this
    rank's own edge row, and the flags at both ends; psum's sum over the
    ranks; FrameShard.edges."""
    _, ranks, _ = world
    r0, r1 = (r["video"] for r in ranks)
    for got, want in ((r0["halo"], (1.0, 11.0, 0.0, 1.0)),
                      (r1["halo"], (2.0, 12.0, 1.0, 0.0))):
        left, right, has_left, has_right = got
        np.testing.assert_array_equal(left, np.full((2, 3), want[0]))
        np.testing.assert_array_equal(right, np.full((2, 3), want[1]))
        assert (float(has_left), float(has_right)) == want[2:]
    for r in (r0, r1):
        np.testing.assert_array_equal(r["psum"], [3.0, 4.0])
    assert r0["edges"] == {"has_left": 0.0, "has_right": 1.0, "first": 1.0}
    assert r1["edges"] == {"has_left": 1.0, "has_right": 0.0, "first": 0.0}


def _joints3d(res: dict) -> np.ndarray:
    from tpu_pose_torch.models import smpl, smpl_data
    model = smpl_data.synthetic_smpl(seed=0, device="cpu")
    with torch.no_grad():
        return smpl.smpl_joints(model, torch.as_tensor(res["beta"]),
                                torch.as_tensor(res["theta"])).numpy()


def test_sharded_video_fit_matches_jax(world):
    """fit_video_smooth(mesh=) over the two ranks against JAX's same fit
    jitted with T in P("data") over its 8 devices (tests/test_parallel.py:
    T = 16, SMALL_FIT, 2 hypotheses, 30 steps): θ, β, cam within 1e-3,
    joints within 1 mm, energy rtol 1e-3; both ranks return all T
    frames, equal."""
    jax_out, ranks, _ = world
    want = jax_out["video"]["sharded_fit"]
    for r in ranks:
        got = r["video"]["fits"]["smooth"]["sharded"][0]
        assert got["theta"].shape == (VIDEO_T, 72)
        for k in ("theta", "beta", "cam"):
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **END_TOL)
        np.testing.assert_allclose(_joints3d(got), _joints3d(want),
                                   **END_TOL)
        np.testing.assert_allclose(got["energy"], want["energy"], rtol=1e-3)
        for k, v in got.items():
            np.testing.assert_array_equal(
                v, ranks[0]["video"]["fits"]["smooth"]["sharded"][0][k])


@pytest.mark.parametrize("case", ["smooth", "t2", "mask", "anchor",
                                  "restarts1", "unshared", "temporal",
                                  "independent"])
def test_sharded_video_fit_matches_single(world, case):
    """Each video fit with the mesh against the port's single-device call
    on the same rank: θ and β within 2e-4, energy within 1e-5 (JAX's
    sharded-against-single bounds), the same Viterbi selections, and the
    collectives chip_smoke.video_collectives counts. The cases: the JAX
    test's smooth fit; T = 2 (one frame per rank, both halos one row); a
    frame mask whose zeros straddle the ranks; an anchor; one hypothesis
    (no selection); a β per frame; fit_video and fit_video_independent."""
    import chip_smoke
    _, ranks, _ = world
    kw = {"t2": {}, "mask": {"masked": True}, "anchor": {"anchored": True},
          "restarts1": {"restarts": 1}, "unshared": {"shared_beta": False}}
    for r in ranks:
        got, got_sels, counts = r["video"]["fits"][case]["sharded"]
        want, want_sels, _ = r["video"]["fits"][case]["single"]
        for k in ("theta", "beta"):
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **SHARD_TOL)
        np.testing.assert_allclose(got["energy"], want["energy"],
                                   **SHARD_ENERGY_TOL)
        assert len(got_sels) == len(want_sels)
        for a, b in zip(got_sels, want_sels):
            np.testing.assert_array_equal(a, b)
        if case in ("temporal", "independent"):
            continue
        mode_kw = dict(VIDEO_KW, **kw.get(case, {}))
        want_counts = chip_smoke.video_collectives("smooth", outputs=5,
                                                   **mode_kw)
        assert counts == {k: v for k, v in want_counts.items() if v}
    if case in ("smooth", "mask"):
        assert len(ranks[0]["video"]["fits"][case]["sharded"][1]) == 1


@pytest.mark.parametrize("mode", VIDEO_MODES)
def test_sharded_video_artifact_matches_the_live_sharded_call(world, mode):
    """export_estimator(fn="estimate_and_fit_video", batch=4,
    n_devices=2) in each mode: the per-rank program at 2 frames, its
    collectives inside (the smooth refine's halo exchange and β sum in
    its scan body), loaded on both ranks, equals the live call with the
    mesh within 1e-6 (the same ops, replayed) and returns all T frames;
    meta records JAX's sharding."""
    _, ranks, _ = world
    for r in ranks:
        meta, got, live = r["video"]["artifacts"][mode, WORLD]
        assert meta["sharding"] == {"n_devices": WORLD, "axis": "data"}
        assert meta["inputs"][0]["shape"] == [ARTIFACT_T, 64, 64, 3]
        for k, v in live.items():
            assert got[k].shape == v.shape, k
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6,
                                       err_msg=k)


def test_sharded_video_artifact_matches_jax_artifact(world):
    """The smooth artifact over the two ranks against JAX's
    export_estimator(fn="estimate_and_fit_video", batch=4, n_devices=2)
    run over its fake devices, on the same weights and frames: θ, β, cam
    within 1e-3, joints3d within 1 mm, energy rtol 1e-3."""
    jax_out, ranks, _ = world
    want = jax_out["video"]["artifact"]
    for r in ranks:
        _, got, _ = r["video"]["artifacts"]["smooth", WORLD]
        for k in ("theta", "beta", "cam", "joints3d"):
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **END_TOL)
        np.testing.assert_allclose(got["energy"], want["energy"], rtol=1e-3)


def test_sharded_video_takes_the_precision_of_the_global_t(world):
    """An int8 estimator whose int8_min_batch is the sequence's T: each
    rank decodes T/2 frames but asks the precision policy for T, so it
    runs the int8 CPM as the single-device call does (T/2 would pick the
    float one); the 2D joints and the fit agree with that call."""
    _, ranks, _ = world
    for r in ranks:
        v = r["video"]
        assert v["int8_asked"] == {"sharded": [ARTIFACT_T],
                                   "single": [ARTIFACT_T]}
        got, want = v["int8_sharded"], v["int8_single"]
        np.testing.assert_allclose(got["joints2d"], want["joints2d"],
                                   rtol=0, atol=1e-4)
        for k in ("theta", "beta"):
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **SHARD_TOL)


def test_video_artifact_replica_groups(world):
    """n_devices=1 in the world of two: each rank is a replica of its
    own, its program's collectives over a group of its own
    (utils/world.replica_group), and each equals the single-device live
    call within 1e-6."""
    _, ranks, _ = world
    for r in ranks:
        meta, got, live = r["video"]["artifacts"]["smooth", 1]
        assert meta["sharding"] == {"n_devices": 1, "axis": "data"}
        for k, v in live.items():
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6,
                                       err_msg=k)


def test_multiprocess_smoke_tool():
    """tools/multiprocess_smoke.py as a user runs it: two gloo ranks from
    the launcher's environment report the single-process step's loss."""
    res = subprocess.run(
        [sys.executable, "-m", "tpu_pose_torch.tools.multiprocess_smoke",
         "--device", "cpu", "--nproc", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "multiprocess_smoke: OK" in res.stdout


if __name__ == "__main__":
    _rank(int(sys.argv[1]), sys.argv[2])
