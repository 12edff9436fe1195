"""Deployment artifacts of the port (tpu_pose_torch/export.py), the port of
tests/test_export.py, on the CPU.

The artifact contract: export writes a self-contained directory (a
torch.export program with the weights, the SMPL model and the prior in
it, plus meta.json); `load` runs it with NO estimator in scope; outputs
match the live path. The estimator is the JAX test file's SMALL_CPM /
SMALL_FIT, carried into the port with from_numpy, so one artifact is
also held against the JAX package's own artifact. Each artifact is built
once per module: an export traces the entry point twice and takes tens of
seconds on the CPU.

Tolerances: an artifact runs the live path's ATen ops in the same order,
so on the CPU its outputs equal the live call's (measured: 0.0 on every
field). The bounds below are 1e-5 on pre-fit and fit fields alike, room
for a CPU reduction split over threads in another way, and far below
the JAX file's 1e-4 / 2e-2.
"""

import copy
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pose import export as jax_export
from tpu_pose.api import PoseEstimator as JaxEstimator
from tpu_pose.models import camera as jax_camera
from tpu_pose.models import joints as jax_joints
from tpu_pose.models import smpl as jax_smpl
from tpu_pose.utils import config as jc
from tpu_pose_torch import api
from tpu_pose_torch import export as pexport
from tpu_pose_torch.api import PoseEstimator
from tpu_pose_torch.fitting import fit as fit_lib
from tpu_pose_torch.ops import cuda_kernels
from tpu_pose_torch.utils import config as tc
from torch_threads import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=0, atol=1e-5)


def _cfgs(cfg_mod):
    """tests/test_export.py's SMALL_CPM and SMALL_FIT in either package."""
    cpm = cfg_mod.CPMConfig(input_size=64, features=16, stage1_head_width=32,
                            refine_width=16, num_stages=2,
                            compute_dtype="float32")
    fit = cfg_mod.FitConfig(
        stages=(cfg_mod.StageConfig(iters=10, lr=0.05, opt_pose=False,
                                    opt_shape=False, w_pose_prior=0,
                                    w_shape_prior=0, w_angle_prior=0),
                cfg_mod.StageConfig(iters=15, lr=0.02, w_pose_prior=0.5,
                                    w_shape_prior=1.0)),
        img_size=64)
    return cpm, fit


def _lbfgs_cfgs(cfg_mod):
    """The same model with 10 + 10 L-BFGS steps: short enough that the
    reference reproduces itself (tests/test_torch_lbfgs.py)."""
    cpm, fit = _cfgs(cfg_mod)
    return cpm, dataclasses.replace(
        fit, optimizer="lbfgs",
        stages=tuple(dataclasses.replace(st, iters=10) for st in fit.stages))


def _carry(jest, fit_cfg=None, **kw):
    cpm_cfg, default_fit = _cfgs(tc)
    fit_cfg = fit_cfg or default_fit
    params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in jest.cpm_params.items()}
    smpl = {k: np.asarray(v) for k, v in jest.smpl_model._asdict().items()}
    prior = {k: np.asarray(getattr(jest.prior, k))
             for k in ("means", "precisions", "log_consts")}
    return PoseEstimator.from_numpy(params, smpl, prior, cpm_cfg, fit_cfg,
                                    device="cpu", **kw)


@pytest.fixture(scope="module")
def pair():
    jest = JaxEstimator.create_synthetic(0, *_cfgs(jc))
    return jest, _carry(jest)


@pytest.fixture(scope="module")
def est(pair):
    return pair[1]


def _jax_twin(jest, fit_cfg, **kw):
    """A JAX estimator on ``jest``'s weights, model and prior."""
    return JaxEstimator(jest.cpm_params, jest.smpl_model, jest.prior,
                        _cfgs(jc)[0], fit_cfg, **kw)


@pytest.fixture(scope="module")
def lbfgs_pair(pair):
    """The JAX and port estimators with the 10 + 10-step L-BFGS fit."""
    return (_jax_twin(pair[0], _lbfgs_cfgs(jc)[1]),
            _carry(pair[0], _lbfgs_cfgs(tc)[1]))


@pytest.fixture(scope="module")
def est1(pair):
    """The estimator with the last stage alone: fewer stages to trace
    where a test holds an export form rather than a schedule."""
    return _carry(pair[0], _last_stage(_cfgs(tc)[1]))


def _last_stage(fit):
    return dataclasses.replace(fit, stages=fit.stages[-1:])


@pytest.fixture(scope="module")
def video_pair(pair):
    """Estimators with two yaw hypotheses per frame, so that the smooth
    video fit runs its Viterbi selection; the last stage alone (depth
    cut: each stage is a graph to trace)."""
    return (_jax_twin(pair[0], _last_stage(_cfgs(jc)[1]), fit_restarts=2),
            _carry(pair[0], _last_stage(_cfgs(tc)[1]), fit_restarts=2))


@pytest.fixture(scope="module")
def est8(pair):
    """The int8 CPM (dynamic activation scales) at batches of 4 and up."""
    return _carry(pair[0], quantize=True, int8_min_batch=4)


def _frames(b, seed=0, h=64, w=64):
    return np.random.RandomState(seed).randint(
        0, 255, (b, h, w, 3)).astype(np.uint8)


def _np(res) -> dict:
    return {k: v.detach().numpy() for k, v in res._asdict().items()}


@pytest.fixture(scope="module")
def artifacts(est, lbfgs_pair, video_pair, est8, est1, tmp_path_factory):
    """Artifacts by name, each exported on first use: name → (path,
    meta)."""
    root = tmp_path_factory.mktemp("artifacts")
    est_l, est_v = lbfgs_pair[1], video_pair[1]
    specs = {
        "fused": lambda p: pexport.export_estimator(
            est, p, fn="estimate_and_fit"),
        "e2d": lambda p: pexport.export_estimator(
            est, p, fn="estimate_2d", batch=2),
        "e2d_sym": lambda p: pexport.export_estimator(
            est, p, fn="estimate_2d"),
        "multi": lambda p: pexport.export_estimator(
            est, p, fn="estimate_and_fit_multi", batch=1, max_people=2),
        "video": lambda p: pexport.export_estimator(
            est_v, p, fn="estimate_and_fit_video", mode="smooth"),
        "video_temporal": lambda p: pexport.export_estimator(
            est1, p, fn="estimate_and_fit_video", mode="temporal"),
        "lbfgs": lambda p: pexport.export_estimator(
            est_l, p, fn="estimate_and_fit"),
        "lbfgs_fit": lambda p: pexport.export_estimator(
            est_l, p, fn="fit_smpl", batch=2),
        "i8_sym": lambda p: pexport.export_estimator(
            est8, p, fn="estimate_2d", params_batch_hint=8),
        "fit": lambda p: pexport.export_estimator(est, p, fn="fit_smpl"),
        "vs": lambda p: pexport.export_video_stream(est, p, chunk=3),
        "vms": lambda p: pexport.export_video_multi_stream(
            est, p, chunk=3, max_people=2),
    }
    built = {}

    def get(name):
        if name not in built:
            path = str(root / name)
            built[name] = (path, specs[name](path))
        return built[name]
    return get


@pytest.fixture(scope="module")
def loaded(artifacts):
    """Loaded artifacts by name, each loaded once (a load deserializes the
    program: seconds on the CPU)."""
    progs = {}

    def get(name):
        if name not in progs:
            progs[name] = pexport.load(artifacts(name)[0])
        return progs[name]
    return get


def _copy(src: str, tmp_path) -> str:
    dst = str(tmp_path / os.path.basename(src))
    shutil.copytree(src, dst)
    return dst


def _flip_byte(path: str, at=None) -> None:
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2 if at is None else at] ^= 0xFF
    open(path, "wb").write(bytes(blob))


# -- the custom ops ---------------------------------------------------------

def _op_cases():
    rng = np.random.RandomState(0)
    hm = torch.from_numpy(rng.randn(2, 9, 7, 5).astype(np.float32))
    x = torch.from_numpy(rng.randn(2, 6, 5, 4).astype(np.float32))
    scale = cuda_kernels.act_scale_cuda(x)
    out = torch.empty(2 * 6 * 5, 40, dtype=torch.int8)
    return {
        "soft_argmax": (cuda_kernels._soft_argmax_op, (hm, 100.0, 8.0)),
        "act_scale": (cuda_kernels._act_scale_op, (x,)),
        "quantize_act": (cuda_kernels._quantize_op, (x, scale)),
        "quantize_im2col": (cuda_kernels._im2col_op,
                            (x, scale, 3, [0, 2, 0, 6], out)),
        "quantize_im2col_tile": (cuda_kernels._im2col_tile_op,
                                 (x, scale, 3, [1, 2, 2, 5], 40)),
    }


@pytest.mark.parametrize("name", ["soft_argmax", "act_scale", "quantize_act",
                                  "quantize_im2col", "quantize_im2col_tile"])
def test_custom_op_opcheck(name):
    """Each kernel's torch.library op passes opcheck on the CPU: schema,
    autograd registration, the fake implementation (symbolic shapes
    included) against the CPU one."""
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)


# -- the export form of the Adam loop ----------------------------------------

class _AdamModule(torch.nn.Module):
    def __init__(self, iters):
        super().__init__()
        self.iters = iters

    def forward(self, x, target, w, mask):
        def energy(x, target, w):
            return (w * torch.sin(x - target) ** 2).sum(-1) + (x * x).sum(-1)
        y, hist = fit_lib._run_adam(energy, x, self.iters, 0.1, mask,
                                    keep_history=True, args=(target, w))
        return y, torch.stack(hist, -1)


def _adam_inputs(b, seed):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(b, 5).astype(np.float32)),
            torch.from_numpy(rng.randn(b, 5).astype(np.float32)),
            torch.from_numpy(rng.rand(5).astype(np.float32)),
            torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0]))


def test_adam_export_matches_eager_loop():
    """The scan form of _run_adam (a symbolic batch, a mask, the energy
    history as the scan's per-step output) equals the eager loop bit for
    bit on the CPU, at the traced batch and at another one: the same
    gradient ops, and the bias corrections divide as the eager loop
    does. 40 steps make one scan node, not 40 unrolled steps."""
    module = _AdamModule(40)
    args = _adam_inputs(3, 0)
    adam = fit_lib.FitExport()
    with adam.recording():
        want = module(*args)
    b = torch.export.Dim("b")
    with adam.replaying_calls():
        prog = torch.export.export(
            module, args, dynamic_shapes=({0: b}, {0: b}, None, None),
            strict=False)
    adam.finish()
    scans = [n for n in prog.graph.nodes if n.op == "call_function"
             and "scan" in str(n.target)]
    assert len(scans) == 1
    got = prog.module()(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    other = _adam_inputs(5, 1)
    for g, w in zip(prog.module()(*other), module(*other)):
        assert torch.equal(g, w)


def test_adam_export_refuses_a_foreign_graph():
    """A graph recorded for one call and replayed by a call of another
    kind raises, as does an export that replays fewer loops than were
    recorded."""
    args = _adam_inputs(3, 0)
    adam = fit_lib.FitExport()
    with adam.recording():
        _AdamModule(40)(*args)
    with adam.replaying_calls(), pytest.raises(RuntimeError,
                                               match="recorded for"):
        torch.export.export(_AdamModule(41), args, strict=False)
    with pytest.raises(RuntimeError, match="replayed 0 of the 1"):
        adam.finish()


def test_stage_groups():
    """Inside an export, consecutive Adam stages with the same mask and
    the same energy terms on run as one loop; the live path and L-BFGS
    fit stage by stage."""
    stages = tc.FitConfig().stages
    cfg = tc.FitConfig()
    assert fit_lib._stage_groups(cfg, object(), None) == [[s] for s in stages]
    with fit_lib.FitExport().recording():
        assert fit_lib._stage_groups(cfg, object(), None) == [
            [stages[0]], [stages[1], stages[2]]]
        # Without a prior the pose-prior weight turns no term on.
        assert fit_lib._stage_groups(cfg, None, None) == [
            [stages[0]], [stages[1], stages[2]]]
        capsule = dataclasses.replace(stages[2], w_interpenetration=1.0)
        split = dataclasses.replace(cfg, stages=(*stages[:2], capsule))
        assert fit_lib._stage_groups(split, object(), object()) == [
            [s] for s in split.stages]
        lbfgs = dataclasses.replace(cfg, optimizer="lbfgs")
        assert fit_lib._stage_groups(lbfgs, object(), None) == [
            [s] for s in stages]


def test_export_runs_consecutive_stages_as_one_scan(est, tmp_path):
    """Two consecutive stages that differ only in steps, rate and weights
    export as one scan over both (the moments restart at the second
    stage's first step), and the artifact equals the live fit_smpl bit
    for bit on the CPU at two batch sizes."""
    _, fit = _cfgs(tc)
    third = dataclasses.replace(fit.stages[1], iters=7, lr=0.011,
                                w_pose_prior=2.0, w_shape_prior=0.25,
                                w_angle_prior=3.0)
    fit3 = dataclasses.replace(fit, stages=(*fit.stages, third),
                               keep_history=True)
    est3 = PoseEstimator(est.cpm, est.smpl_model, est.prior, est.cpm_cfg,
                         fit3, device="cpu")
    path = str(tmp_path / "fit3")
    pexport.export_estimator(est3, path, fn="fit_smpl")
    prog = pexport.load(path)
    scans = [n for n in prog._module.graph.nodes
             if n.op == "call_function" and "scan" in str(n.target)]
    assert len(scans) == 2
    rng = np.random.RandomState(6)
    for b in (1, 3):
        j2d = rng.uniform(8, 56, (b, 14, 2)).astype(np.float32)
        conf = rng.uniform(0.5, 1.0, (b, 14)).astype(np.float32)
        out = prog(j2d, conf)
        live = est3.fit_smpl(j2d, conf)
        for k in ("theta", "beta", "cam", "energy"):
            np.testing.assert_array_equal(out[k], getattr(live, k).numpy(),
                                          err_msg=f"{k} at batch {b}")


# -- export / load: the JAX file's tests --------------------------------------

def test_export_fused_roundtrip(est, artifacts, loaded):
    """Artifact output == live fused path (symbolic batch, run at 2)."""
    path, meta = artifacts("fused")
    assert meta["fn"] == "estimate_and_fit"
    assert meta["decode_impl"] == "cuda"   # B1's op: plain on the CPU
    assert set(meta["outputs"]) == {"joints2d", "conf", "theta", "beta",
                                    "cam", "vertices", "joints3d",
                                    "energy"}
    assert meta["precision"] == {"matmul_allow_tf32": False,
                                 "cudnn_allow_tf32": True}
    frames = _frames(2)
    out = loaded("fused")(frames)
    live = _np(est.estimate_and_fit(frames))
    for k in live:
        np.testing.assert_allclose(out[k], live[k], **TOL, err_msg=k)
    assert out["vertices"].shape == (2, 6890, 3)


def test_export_symbolic_batch(est, artifacts, loaded):
    """batch=None → one artifact, any batch."""
    path, meta = artifacts("e2d_sym")
    assert meta["input"]["shape"][0] == "b"
    assert meta["outputs"]["joints2d"]["shape"] == ["b", "14", "2"]
    prog = loaded("e2d_sym")
    for b in (1, 3):
        out = prog(_frames(b, seed=b))
        assert out["joints2d"].shape == (b, 14, 2)
        assert out["conf"].shape == (b, 14)
    # 3-D single frame promotes to batch 1.
    out = prog(_frames(1)[0])
    assert out["joints2d"].shape == (1, 14, 2)


def test_export_estimate_2d_matches_live(est, loaded):
    frames = _frames(2, seed=7)
    out = loaded("e2d")(frames)
    live = _np(est.estimate_2d(frames))
    np.testing.assert_allclose(out["heatmaps"], live["heatmaps"], **TOL)
    np.testing.assert_allclose(out["joints2d"], live["joints2d"], **TOL)


def test_export_multi_person(est, artifacts):
    path, meta = artifacts("multi")
    assert meta["fn_kwargs"]["max_people"] == 2
    frames = _frames(1, seed=3)
    out = pexport.load(path)(frames)
    assert out["joints2d"].shape == (1, 2, 14, 2)
    assert out["theta"].shape == (1, 2, 72)
    assert out["person_mask"].shape == (1, 2)
    live = _np(est.estimate_and_fit_multi(frames, max_people=2))
    np.testing.assert_array_equal(out["person_mask"], live["person_mask"])
    for k in ("joints2d", "theta", "cam", "joints3d"):
        np.testing.assert_allclose(out[k], live[k], **TOL, err_msg=k)


def test_export_input_validation(loaded):
    prog = loaded("e2d")
    with pytest.raises(ValueError, match="static batch"):
        prog(_frames(3))
    with pytest.raises(ValueError, match="expected frames"):
        prog(np.zeros((2, 32, 64, 3), np.uint8))
    # float input is clipped+cast, not rejected.
    out = prog(_frames(2).astype(np.float32))
    assert out["joints2d"].shape == (2, 14, 2)


def test_export_video(video_pair, artifacts, loaded, tmp_path):
    """Video-path artifact: T is the leading dim, symbolic (the Viterbi
    selection and the joint refine run as scans); the smooth whole-
    sequence fit (shared-β coupling included) matches the live fused
    video call at T = 3 and T = 2, bit for bit on the CPU. T = 1 raises
    a clear error."""
    est_v = video_pair[1]
    path, meta = artifacts("video")
    assert meta["fn_kwargs"]["mode"] == "smooth"
    assert meta["input"]["shape"][0] == "b"
    prog = loaded("video")
    for t in (3, 2):
        frames = _frames(t, seed=21)
        out = prog(frames)
        live = _np(est_v.estimate_and_fit_video(frames, mode="smooth"))
        assert out["beta"].shape == (t, 10)
        for k in ("joints2d", "theta", "beta", "cam", "joints3d"):
            np.testing.assert_array_equal(out[k], live[k], err_msg=k)
        # Shared-beta coupling survived the round trip.
        assert np.ptp(out["beta"], axis=0).max() < 1e-5
    with pytest.raises(ValueError, match="T >= 2"):
        prog(_frames(1))
    with pytest.raises(ValueError, match="video mode"):
        pexport.export_estimator(est_v, str(tmp_path / "vbad"),
                                 fn="estimate_and_fit_video", batch=2,
                                 mode="nope")


def test_export_video_temporal_symbolic_t(est1, loaded):
    """The temporal mode with a symbolic T (its warm starts a scan over
    the frames, each step a nested Adam scan): the artifact equals the
    live call at T = 4 and T = 2, bit for bit on the CPU. (The
    independent mode is fit_smpl_batch, which the symbolic "fused"
    artifact runs.)"""
    prog = loaded("video_temporal")
    for t in (4, 2):
        frames = _frames(t, seed=22)
        out = prog(frames)
        live = _np(est1.estimate_and_fit_video(frames, mode="temporal"))
        for k in ("joints2d", "theta", "beta", "cam", "joints3d"):
            np.testing.assert_array_equal(out[k], live[k], err_msg=k)


def test_video_artifact_matches_jax(video_pair, loaded):
    """The symbolic-T smooth video artifact (two yaw hypotheses per frame)
    against the JAX package's smooth video fit of the same frames at
    T = 3: joints3d within 1 mm MPJPE, β shared in both. JAX's live call,
    not a JAX artifact: JAX's export with a symbolic T and more than one
    hypothesis stops in its Viterbi selection ("'b - 1' >= '1' is
    inconclusive", ROADMAP §C)."""
    jest_v, _ = video_pair
    frames = _frames(3, seed=23)
    got = loaded("video")(frames)
    want = {k: np.asarray(v) for k, v in jest_v.estimate_and_fit_video(
        jnp.asarray(frames), mode="smooth")._asdict().items()}
    assert _mpjpe_mm(got["joints3d"], want["joints3d"]) <= 1.0
    for out in (got, want):
        assert np.ptp(out["beta"], axis=0).max() < 1e-5


def test_export_fit_smpl(est, artifacts):
    """Joints-only artifact: (joints2d, conf) → fit + mesh, matching the
    live fit_smpl path; symbolic batch; two-input validation."""
    path, meta = artifacts("fit")
    assert [i["name"] for i in meta["inputs"]] == ["joints2d", "conf"]
    prog = pexport.load(path)
    rng = np.random.RandomState(4)
    j2d = rng.uniform(8, 56, (2, 14, 2)).astype(np.float32)
    conf = np.ones((2, 14), np.float32)
    out = prog(j2d, conf)
    live = est.fit_smpl(j2d, conf)
    np.testing.assert_allclose(out["theta"], live.theta.numpy(), **TOL)
    np.testing.assert_allclose(out["cam"], live.cam.numpy(), **TOL)
    assert out["vertices"].shape == (2, 6890, 3)
    # Single-sample promotion + arg-count validation.
    one = prog(j2d[0], conf[0])
    assert one["theta"].shape == (1, 72)
    with pytest.raises(ValueError, match="2 input"):
        prog(j2d)
    with pytest.raises(ValueError, match="inconsistent batch"):
        prog(j2d, np.ones((3, 14), np.float32))


def test_serving_from_artifact(est, loaded):
    """Deployment end-to-end: BatchingServer over the loaded artifact, no
    estimator on the serving host. Mixed-resolution requests letterbox
    at submit time against the artifact's recorded network frame, and
    fields= validates against the artifact's output spec."""
    from tpu_pose_torch import serving
    servable = pexport.ServableProgram(loaded("fused"))
    assert servable.symbolic_batch
    assert "theta" in servable.result_fields

    rng = np.random.RandomState(0)
    frames = rng.randint(0, 255, (3, 64, 64, 3)).astype(np.uint8)
    direct = est.estimate_and_fit(frames)
    with serving.BatchingServer(servable, max_batch=4, max_wait_ms=200.0,
                                fields=("theta", "joints2d")) as srv:
        big = rng.randint(0, 255, (96, 80, 3)).astype(np.uint8)
        futs = srv.submit_many(frames) + [srv.submit(big)]
        results = [f.result(timeout=300) for f in futs]
    for i in range(3):
        assert set(results[i]) == {"theta", "joints2d"}
        np.testing.assert_allclose(results[i]["theta"],
                                   direct.theta[i].numpy(), atol=2e-2)
    # The mixed-res request resolves in ITS source pixels.
    assert results[3]["joints2d"].shape == (14, 2)
    assert np.all(np.isfinite(results[3]["joints2d"]))

    with pytest.raises(ValueError, match="unknown result fields"):
        serving.BatchingServer(servable, max_batch=2, fields=("nope",))
    with pytest.raises(ValueError, match="fn='estimate_2d'"):
        pexport.ServableProgram(loaded("e2d"))


def test_export_sharded_multichip_raises(est, tmp_path):
    """A sharded artifact in one process: n_devices=1 records the sharding
    and its loaded program equals the live estimate_2d; n_devices=8 needs a
    world of 8 ranks and raises without writing, as do a symbolic batch
    and a batch not divisible by n_devices (the two-rank artifact is held
    against the live sharded call in tests/test_torch_parallel.py)."""
    path = str(tmp_path / "dp1")
    meta = pexport.export_estimator(est, path, fn="estimate_2d", batch=2,
                                    n_devices=1)
    assert meta["sharding"] == {"n_devices": 1, "axis": "data"}
    assert pexport.inspect_artifact(path)["sharding"] == meta["sharding"]
    frames = _frames(2, seed=13)
    got = pexport.load(path)(frames)
    live = _np(est.estimate_2d(frames))
    for k in ("heatmaps", "joints2d", "conf"):
        np.testing.assert_allclose(got[k], live[k], atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="need 8 ranks"):
        pexport.export_estimator(est, str(tmp_path / "dp8"),
                                 fn="estimate_2d", batch=8, n_devices=8)
    assert not os.path.exists(tmp_path / "dp8")
    with pytest.raises(ValueError, match="static batch"):
        pexport.export_estimator(est, str(tmp_path / "x1"),
                                 fn="estimate_2d", n_devices=1)
    with pytest.raises(ValueError, match="not divisible"):
        pexport.export_estimator(est, str(tmp_path / "x2"),
                                 fn="estimate_2d", batch=3, n_devices=2)


def test_serving_from_sharded_artifact_raises(est, tmp_path):
    """The JAX file serves an 8-device artifact from one controller; the
    port's needs a world of 8 ranks, so in one process the fused path with
    n_devices=8 raises before exporting."""
    with pytest.raises(ValueError, match="need 8 ranks"):
        pexport.export_estimator(est, str(tmp_path / "dp_srv"),
                                 fn="estimate_and_fit", batch=8,
                                 n_devices=8)
    assert not os.path.exists(tmp_path / "dp_srv")


def test_video_multi_stream_artifact_matches_live(est, artifacts):
    """The tracked-streaming artifact (two window programs + carried
    state) reproduces the live streaming path: same windows, same
    identity assignment, same fits — run via ArtifactVideoSession with
    no estimator in scope."""
    path, meta = artifacts("vms")
    assert meta["fn"] == "video_multi_stream"
    assert meta["carry"]["carry_theta"]["shape"] == [2, 72]

    frames = _frames(7, seed=9)
    live = est.estimate_and_fit_video_multi_stream(frames, max_people=2,
                                                   chunk=3)
    sess = pexport.ArtifactVideoSession(path)
    outs = []
    for lo, hi in ((0, 5), (5, 7)):
        r = sess.push(frames[lo:hi])
        if r is not None:
            outs.append(r)
    outs.append(sess.flush())
    theta = np.concatenate([o["theta"] for o in outs], axis=1)
    j2d = np.concatenate([o["joints2d"] for o in outs], axis=0)
    perm = np.concatenate([o["perm"] for o in outs], axis=0)
    fmask = np.concatenate([o["frame_mask"] for o in outs], axis=0)
    np.testing.assert_array_equal(perm, live.perm.numpy())
    np.testing.assert_array_equal(fmask, live.frame_mask.numpy())
    np.testing.assert_allclose(j2d, live.joints2d.numpy(), **TOL)
    np.testing.assert_allclose(theta, live.theta.numpy(), **TOL)
    with pytest.raises(RuntimeError):
        sess.push(frames[:1])
    # Loading it as a plain single-program artifact fails clearly.
    with pytest.raises(FileNotFoundError):
        pexport.load(path)
    with pytest.raises(ValueError, match="video_multi_stream"):
        pexport.ArtifactVideoSession(artifacts("e2d")[0])


def test_video_stream_artifact_matches_live_session(est, artifacts):
    """Single-person streaming artifact == live VideoSession: same
    window programs, same anchor carry; frames pushed as a non-contiguous
    view (the live session makes them contiguous, and so must the
    artifact session: the convs follow the input's layout)."""
    path, meta = artifacts("vs")
    assert meta["fn"] == "video_stream"
    assert meta["carry_keys"] == ["carry_theta", "carry_beta", "carry_cam"]
    frames = np.ascontiguousarray(
        _frames(7, seed=8).transpose(0, 2, 1, 3)).transpose(0, 2, 1, 3)
    assert not frames.flags["C_CONTIGUOUS"]
    live_sess = api.VideoSession(est, chunk=3)
    live_outs = [r for r in (live_sess.push(frames), live_sess.flush())
                 if r is not None]
    art = pexport.ArtifactVideoSession(path)
    outs = [r for r in (art.push(frames), art.flush()) if r is not None]
    theta = np.concatenate([o["theta"] for o in outs], axis=0)
    j2d = np.concatenate([o["joints2d"] for o in outs], axis=0)
    assert theta.shape == (7, 72) and j2d.shape == (7, 14, 2)
    np.testing.assert_allclose(
        theta, np.concatenate([o.theta.numpy() for o in live_outs]), **TOL)
    np.testing.assert_allclose(
        j2d, np.concatenate([o.joints2d.numpy() for o in live_outs]), **TOL)


def test_stream_artifact_verifies_sha256(artifacts, tmp_path):
    """Both streaming-session programs are hash-verified on open."""
    src, meta = artifacts("vs")
    assert set(meta["program_sha256"]) == {"program_first.pt2",
                                           "program_anchored.pt2"}
    path = _copy(src, tmp_path)
    pexport.ArtifactVideoSession(path)  # intact → opens
    _flip_byte(os.path.join(path, "program_anchored.pt2"), at=0)
    with pytest.raises(ValueError, match="integrity"):
        pexport.ArtifactVideoSession(path)


def test_inspect_artifact_streaming_layout(tmp_path):
    """Streaming artifacts record a {file: sha} dict over their two window
    programs; inspection is pure file I/O, so a fabricated layout
    exercises it without paying for a stream export."""
    sp = tmp_path / "stream_like"
    sp.mkdir()
    blobs = {"program_first.pt2": b"first-program",
             "program_anchored.pt2": b"anchored-program"}
    for k, v in blobs.items():
        (sp / k).write_bytes(v)
    meta = {"format_version": pexport.FORMAT_VERSION,
            "fn": "video_stream",
            "program_sha256": {k: hashlib.sha256(v).hexdigest()
                               for k, v in blobs.items()},
            "outputs": {}}
    (sp / "meta.json").write_text(json.dumps(meta))
    info = pexport.inspect_artifact(str(sp))
    assert info["ok"] and set(info["programs"]) == set(blobs)
    assert all(p["sha256_ok"] for p in info["programs"].values())


def test_video_field_split_mirrors_api():
    """export.py duplicates api's result-field axis split so deployment
    hosts don't import the model stack — this pins them together."""
    assert pexport._VIDEO_T_FIRST == api._VIDEO_MULTI_T_FIRST
    assert pexport._VIDEO_K_FIRST == api._VIDEO_MULTI_K_FIRST
    assert (set(api.MultiPersonVideoResult._fields)
            == set(pexport._VIDEO_T_FIRST + pexport._VIDEO_K_FIRST)
            | {"track_mask"})


def test_load_rejects_non_artifact(tmp_path):
    with pytest.raises(FileNotFoundError):
        pexport.load(str(tmp_path / "nope"))
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "meta.json").write_text('{"format_version": 99}')
    (bad / "program.pt2").write_bytes(b"")
    with pytest.raises(ValueError, match="format"):
        pexport.load(str(bad))


def test_load_verifies_program_sha256(artifacts, tmp_path):
    """meta.json records the program's sha256; a corrupted program.pt2
    fails the integrity check at load, not as an opaque load error or
    silently wrong numerics."""
    src, meta = artifacts("e2d")
    assert len(meta["program_sha256"]) == 64
    path = _copy(src, tmp_path)
    on_disk = json.loads(open(os.path.join(path, "meta.json")).read())
    assert on_disk["program_sha256"] == meta["program_sha256"]
    pexport.load(path)  # intact artifact verifies fine
    _flip_byte(os.path.join(path, "program.pt2"))
    with pytest.raises(ValueError, match="integrity"):
        pexport.load(path)


def test_export_unknown_fn(est, tmp_path):
    with pytest.raises(ValueError, match="unknown fn"):
        pexport.export_estimator(est, str(tmp_path / "x"), fn="nope")


def test_export_letterbox_nonsquare_input(pair, tmp_path):
    """input_shape + letterbox: the artifact takes non-square source
    frames and returns joints in SOURCE pixels, matching the live
    letterboxed estimator."""
    est_lb = _carry(pair[0], letterbox=True)
    path = str(tmp_path / "lb")
    meta = pexport.export_estimator(est_lb, path, fn="estimate_2d",
                                    batch=2, input_shape=(96, 60))
    assert meta["input"]["shape"] == [2, 96, 60, 3]
    assert meta["estimator"]["letterbox"]
    frames = _frames(2, seed=2, h=96, w=60)
    out = pexport.load(path)(frames)
    live = est_lb.estimate_2d(frames)
    np.testing.assert_allclose(out["joints2d"], live.joints2d.numpy(),
                               **TOL)


def test_export_quantized_params(est8, artifacts, loaded, tmp_path):
    """quantize=True estimators bake the batch-policy-selected weight
    set: int8 at/above int8_min_batch, float below. Both artifacts run
    and the int8 one matches the live int8 path; the int8 CPM with a
    symbolic batch equals the live int8 call at batches 1, 2, 4, 5 and
    9."""
    p8 = str(tmp_path / "int8")
    meta8 = pexport.export_estimator(est8, p8, fn="estimate_2d", batch=4)
    assert meta8["estimator"]["quantized_params"]
    frames = _frames(4, seed=11)
    out = pexport.load(p8)(frames)
    live = est8.estimate_2d(frames)
    np.testing.assert_allclose(out["joints2d"], live.joints2d.numpy(),
                               **TOL)
    # Symbolic batch uses the params_batch_hint side of the policy.
    pb = str(tmp_path / "bf16")
    metab = pexport.export_estimator(est8, pb, fn="estimate_2d",
                                     params_batch_hint=1)
    assert not metab["estimator"]["quantized_params"]
    out1 = pexport.load(pb)(_frames(1))
    assert out1["joints2d"].shape == (1, 14, 2)
    # A symbolic batch on the int8 side of the policy: its convs tile by
    # groups of images; the integer GEMM is exact whatever the tiles. It
    # serves every bucket with the int8 weights it baked, so below
    # int8_min_batch it is held against a live call on those weights.
    # Batches 1 and 2 are the sizes a size-oblivious trace could get
    # wrong; 9 is two groups of 8 images.
    meta_sym = artifacts("i8_sym")[1]
    assert meta_sym["input"]["shape"][0] == "b"
    assert meta_sym["estimator"]["quantized_params"]
    prog = loaded("i8_sym")
    live8 = copy.copy(est8)
    live8.int8_min_batch = 1
    for b in (1, 2, 4, 5, 9):
        frames = _frames(b, seed=12)
        out = prog(frames)
        live = _np(live8.estimate_2d(frames))
        for k in ("heatmaps", "joints2d", "conf"):
            np.testing.assert_array_equal(out[k], live[k], err_msg=k)


def test_int8_symbolic_artifact_matches_jax_artifact(pair, loaded,
                                                     tmp_path):
    """The symbolic-batch int8 estimate_2d artifact against the JAX
    package's (export_estimator(..., params_batch_hint=8), symbolic) at a
    batch of 5, both quantizing the same float weights with dynamic
    activation scales: joints2d within 0.5 px and conf within 1e-2
    (ROADMAP §C: a dynamic activation scale may be one ulp from the
    jitted forward's, tests/test_torch_quantize.py's bound)."""
    jest8 = JaxEstimator.create_synthetic(0, *_cfgs(jc), quantize=True,
                                          int8_min_batch=4)
    jpath = str(tmp_path / "jax_i8")
    meta = jax_export.export_estimator(jest8, jpath, fn="estimate_2d",
                                       params_batch_hint=8,
                                       platforms=("cpu",))
    assert meta["estimator"]["quantized_params"]
    frames = _frames(5, seed=14)
    want = jax_export.load(jpath)(frames)
    got = loaded("i8_sym")(frames)
    np.testing.assert_allclose(got["joints2d"], want["joints2d"], rtol=0,
                               atol=0.5)
    np.testing.assert_allclose(got["conf"], want["conf"], rtol=0, atol=1e-2)


def test_export_remaining_refusals(est, tmp_path):
    """What the port still refuses, as the JAX package does: a sharded
    video whose T the ranks do not divide, a sharded symbolic T, and a
    symbolic batch with cpm_microbatch chunking; cross-lowering is
    test_cross_lowering_raises. Each refuses before any collective, so
    without a process group."""
    with pytest.raises(ValueError, match="not divisible by n_devices"):
        pexport.export_estimator(est, str(tmp_path / "v1"),
                                 fn="estimate_and_fit_video", batch=3,
                                 n_devices=2)
    with pytest.raises(ValueError, match="needs a static batch"):
        pexport.export_estimator(est, str(tmp_path / "v1"),
                                 fn="estimate_and_fit_video", n_devices=1)
    chunked = copy.copy(est)
    chunked.cpm_microbatch = 2
    with pytest.raises(ValueError, match="cpm_microbatch"):
        pexport.export_estimator(chunked, str(tmp_path / "mb"),
                                 fn="estimate_2d")
    assert not os.path.exists(tmp_path / "v1")


def test_cross_lowering_raises(est, tmp_path):
    """A torch.export program runs on the device it was traced on: a
    foreign platform, or two, raise with that reason (the JAX package's
    cross-lowering is listed in ROADMAP §C)."""
    for platforms in (("cuda",), ("cuda", "cpu"), ("tpu",)):
        with pytest.raises(ValueError, match="traced on one device"):
            pexport.export_estimator(est, str(tmp_path / "x"),
                                     fn="estimate_and_fit", batch=2,
                                     platforms=platforms)


def _mpjpe_mm(a, b) -> float:
    return 1000.0 * float(np.linalg.norm(a - b, axis=-1).mean())


def _within_jax_lbfgs(jest_l, joints2d, conf, joints3d) -> None:
    """Each sample's joints3d within 1 mm MPJPE of the JAX package's live
    L-BFGS fit of the same joints (network-frame pixels; compiled once
    for the module's batch of 2). On a miss the message also reports how
    far a one-ulp change of the joints moves JAX's own fit, a measure of
    how well posed the fit is."""
    def fit(j2d):
        want = jest_l.fit_smpl(jnp.asarray(j2d), jnp.asarray(conf))
        return np.asarray(jax_smpl.smpl_forward_batch(
            jest_l.smpl_model, want.beta, want.theta).joints)

    def spread():
        moved = fit(np.nextafter(joints2d, np.float32(np.inf)))
        return [_mpjpe_mm(m, w) for m, w in zip(moved, want)]
    want = fit(joints2d)
    got = [_mpjpe_mm(j, w) for j, w in zip(joints3d, want)]
    assert max(got) <= 1.0, (
        f"mm from JAX per sample {got}; JAX's own one-ulp spread "
        f"{spread()}")


def _body_joints(jest, seeds, img=64):
    """Pixel joints of known bodies (θ, β from each seed, as
    tests/test_torch_lbfgs.py's clean observations) under a known
    weak-perspective camera, confidence 1: a fit that is well posed."""
    px = []
    for seed in seeds:
        rng = np.random.RandomState(seed)
        theta = jnp.asarray(rng.randn(72) * 0.25, jnp.float32)
        beta = jnp.asarray(rng.randn(10) * 0.3, jnp.float32)
        j3d = jax_joints.select_smpl_joints(
            jax_smpl.smpl_forward(jest.smpl_model, beta, theta).joints)
        cam = jnp.asarray([0.9, 0.05, -0.1], jnp.float32)
        px.append((jax_camera.weak_perspective_project(j3d, cam) + 1.0)
                  * (img / 2.0))
    px = np.array(jnp.stack(px), np.float32)
    return px, np.ones(px.shape[:2], np.float32)


def test_lbfgs_estimate_and_fit_artifact(lbfgs_pair, artifacts, loaded):
    """FitConfig(optimizer="lbfgs") exports: each stage a scan over its
    steps whose linesearch is a while_loop, with a symbolic batch. The
    artifact equals the live L-BFGS call bit for bit on the CPU at
    batches 1 and 2; its 2D joints and confidences are the JAX package's
    within test_artifacts_match_jax_artifacts' bounds. Its fit is the
    fit_smpl program's, held against JAX at 1 mm on well-posed joints in
    test_lbfgs_fit_smpl_artifact: the random CPM's joints are no body's
    projection, and on them a ±2-ulp change of the joints moves JAX's
    own 10 + 10-step fit by up to 1.39 mm (ROADMAP §C)."""
    jest_l, est_l = lbfgs_pair
    path, meta = artifacts("lbfgs")
    assert meta["input"]["shape"][0] == "b"
    for b in (1, 2):
        frames = _frames(b, seed=42)
        out = loaded("lbfgs")(frames)
        live = _np(est_l.estimate_and_fit(frames))
        for k in ("joints2d", "conf", "theta", "beta", "cam", "joints3d"):
            np.testing.assert_array_equal(out[k], live[k], err_msg=k)
    want = jest_l.estimate_2d(jnp.asarray(frames))
    np.testing.assert_allclose(out["joints2d"], np.asarray(want.joints2d),
                               rtol=0, atol=1e-2)
    np.testing.assert_allclose(out["conf"], np.asarray(want.conf),
                               rtol=1e-4, atol=1e-5)


def test_lbfgs_fit_smpl_artifact(lbfgs_pair, loaded):
    """The joints-only artifact with L-BFGS stages (batch 2) on the joints
    of two known bodies: the live fit_smpl bit for bit on the CPU; the
    JAX package's live L-BFGS fit of the same joints within 1 mm
    (_within_jax_lbfgs)."""
    jest_l, est_l = lbfgs_pair
    j2d, conf = _body_joints(jest_l, [4, 5])
    out = loaded("lbfgs_fit")(j2d, conf)
    live = est_l.fit_smpl(j2d, conf)
    for k in ("theta", "beta", "cam"):
        np.testing.assert_array_equal(out[k], getattr(live, k).numpy(),
                                      err_msg=k)
    _within_jax_lbfgs(jest_l, j2d, conf, out["joints3d"])


def test_inspect_artifact(artifacts, tmp_path):
    """inspect_artifact summarizes without loading: ok=True on an intact
    artifact, per-program sizes + sha status; corruption and a missing
    file flip ok to False."""
    path = _copy(artifacts("e2d")[0], tmp_path)
    info = pexport.inspect_artifact(path)
    assert info["ok"] and info["fn"] == "estimate_2d"
    assert info["programs"]["program.pt2"]["bytes"] > 0
    assert info["programs"]["program.pt2"]["sha256_ok"]
    assert info["estimator"]["scale_tta"] == []
    assert "joints2d" in info["outputs"]

    p = os.path.join(path, "program.pt2")
    _flip_byte(p)
    info2 = pexport.inspect_artifact(path)
    assert not info2["ok"]
    assert not info2["programs"]["program.pt2"]["sha256_ok"]

    os.remove(p)
    info3 = pexport.inspect_artifact(path)
    assert not info3["ok"]
    assert info3["programs"]["program.pt2"]["bytes"] is None

    with pytest.raises(FileNotFoundError):
        pexport.inspect_artifact(str(tmp_path / "nope"))


def test_export_deploy_cli(artifacts, tmp_path, capsys):
    """tools/export_deploy: --inspect prints the summary and exits 1 on a
    bad artifact; a CPU export smoke-runs the reloaded program."""
    from tpu_pose_torch.tools import export_deploy
    export_deploy.main(["--inspect", artifacts("e2d")[0]])
    assert json.loads(capsys.readouterr().out)["ok"]
    bad = _copy(artifacts("e2d")[0], tmp_path)
    _flip_byte(os.path.join(bad, "program.pt2"))
    with pytest.raises(SystemExit) as exc:
        export_deploy.main(["--inspect", bad])
    assert exc.value.code == 1
    capsys.readouterr()
    out = str(tmp_path / "cli")
    export_deploy.main(["--out", out, "--fn", "estimate_2d",
                        "--platforms", "cpu", "--batch", "1"])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["fn"] == "estimate_2d" and record["batch"] == 1
    assert record["smoke_outputs"]["joints2d"] == [1, 14, 2]


# -- added for the port -----------------------------------------------------

def test_load_imports_no_model_code(artifacts):
    """A serving host needs only export.load: loading and running an
    artifact imports torch, the custom ops and their plain versions —
    no model, fitting or API module, and nothing of JAX (checked in a
    fresh interpreter through sys.modules)."""
    path, _ = artifacts("e2d")
    code = (
        "import sys, numpy as np\n"
        "from tpu_pose_torch import export\n"
        f"out = export.load({path!r})(np.zeros((2, 64, 64, 3), np.uint8))\n"
        "assert out['joints2d'].shape == (2, 14, 2)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'tpu_pose.'))\n"
        "             or m.startswith(('tpu_pose_torch.models',\n"
        "                              'tpu_pose_torch.fitting',\n"
        "                              'tpu_pose_torch.api')))\n"
        "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_artifacts_match_jax_artifacts(pair, loaded, tmp_path):
    """One JAX-parity case: estimate_2d and estimate_and_fit from the
    port's artifacts against the JAX package's artifacts of the same
    weights (tpu_pose.export, platforms=("cpu",)), within
    tests/test_torch_api.py's float32 bounds: joints2d 1e-2 px, conf
    1e-4 relative, θ/β/cam 1e-3, energy rtol 1e-3, joints3d and
    vertices ≤ 1 mm."""
    jest, _ = pair
    frames = _frames(2, seed=31)
    got = {
        "estimate_2d": loaded("e2d_sym")(frames),
        "estimate_and_fit": loaded("fused")(frames)}
    for fn, out in got.items():
        jpath = str(tmp_path / fn)
        jax_export.export_estimator(jest, jpath, fn=fn, batch=2,
                                    platforms=("cpu",))
        want = jax_export.load(jpath)(frames)
        np.testing.assert_allclose(out["joints2d"], want["joints2d"],
                                   rtol=0, atol=1e-2, err_msg=fn)
        np.testing.assert_allclose(out["conf"], want["conf"], rtol=0,
                                   atol=1e-4 * np.abs(want["conf"]).max(),
                                   err_msg=fn)
    out, want = got["estimate_and_fit"], want
    for k in ("theta", "beta", "cam"):
        np.testing.assert_allclose(out[k], want[k], rtol=0, atol=1e-3,
                                   err_msg=k)
    np.testing.assert_allclose(out["energy"], want["energy"], rtol=1e-3)
    for k in ("joints3d", "vertices"):
        mm = 1000.0 * np.linalg.norm(out[k] - want[k], axis=-1).mean()
        assert mm <= 1.0, (k, mm)
    # The same frames through the live JAX estimator: the JAX artifact is
    # its own reference.
    live = jest.estimate_and_fit(jnp.asarray(frames))
    np.testing.assert_allclose(want["joints2d"], np.asarray(live.joints2d),
                               atol=1e-4)


def test_serve_cli_serves_an_artifact(est, artifacts):
    """`tools/serve --artifact` serves the artifact over HTTP with no
    model code: one /predict request through PoseClient, in a child
    process, equals the live estimator's call on the same frame."""
    from tpu_pose_torch.client import PoseClient
    path, _ = artifacts("fused")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_pose_torch.tools.serve", "--artifact",
         path, "--port", "0", "--host", "127.0.0.1", "--fields", "theta"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("listening on "):
                break
        assert lines and lines[-1].startswith("listening on "), lines
        url = lines[-1].split()[2]
        frame = _frames(1, seed=41)[0]
        with PoseClient(url) as client:
            out = client.predict(frame)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    live = est.estimate_and_fit(frame[None])
    np.testing.assert_allclose(out["theta"], live.theta[0].numpy(), **TOL)
