"""The port's BatchingServer (tpu_pose_torch/serving.py): the cases of
tests/test_serving.py on the port's server (stub estimators for the
lifecycle and backpressure cases), parity with the JAX package's server
on the same requests over carried weights, padding, the precision policy
under serving and the pipeline policy."""

import concurrent.futures
import threading

import numpy as np
import pytest
import torch

from chip_smoke import two_people_frames
from tpu_pose import native as jax_native
from tpu_pose import serving as jax_serving
from tpu_pose.api import PoseEstimator as JaxEstimator
from tpu_pose.utils import config as jc
from tpu_pose_torch import native, serving
from tpu_pose_torch.api import EstimateAndFitResult, PoseEstimator
from tpu_pose_torch.models import joints as joints_lib
from tpu_pose_torch.ops import preprocess as pre
from tpu_pose_torch.utils import config as tc
from torch_threads import one_thread

one_thread()

TIMEOUT = 120
SIZES = ((64, 64), (48, 80), (100, 60))   # network-sized, wide, tall
FIELDS = EstimateAndFitResult._fields + ("letterbox_affine",)


def _cfgs(cfg_mod):
    """tests/test_torch_api.py's small float32 configs."""
    cpm = cfg_mod.CPMConfig(input_size=64, features=16, stage1_head_width=32,
                            refine_width=16, num_stages=2,
                            compute_dtype="float32")
    fit = cfg_mod.FitConfig(
        stages=(cfg_mod.StageConfig(iters=20, lr=0.05, opt_pose=False,
                                    opt_shape=False, w_pose_prior=0,
                                    w_shape_prior=0, w_angle_prior=0),
                cfg_mod.StageConfig(iters=40, lr=0.02, w_pose_prior=0.5,
                                    w_shape_prior=1.0)),
        img_size=64)
    return cpm, fit


def _carry(jax_est, **kw):
    cpm_cfg, fit_cfg = _cfgs(tc)
    params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in jax_est.cpm_params.items()}
    smpl = {k: np.asarray(v) for k, v in jax_est.smpl_model._asdict().items()}
    prior = {k: np.asarray(getattr(jax_est.prior, k))
             for k in ("means", "precisions", "log_consts")}
    return PoseEstimator.from_numpy(params, smpl, prior, cpm_cfg, fit_cfg,
                                    device="cpu", **kw)


@pytest.fixture(scope="module")
def pair():
    """(JAX estimator, port estimator over the same weights). Both
    packages' native letterboxes are built here, before any server
    starts: built at first use, g++ would run inside ``submit`` of the
    first frame that needs a resample, after an earlier request has
    opened the dispatcher's ``max_wait_ms`` window, and split the batch
    that the batch-count assertions expect."""
    jax_native.available()
    native.available()
    jest = JaxEstimator.create_synthetic(0, *_cfgs(jc))
    return jest, _carry(jest)


@pytest.fixture(scope="module")
def est(pair):
    return pair[1]


def _frames(seed, sizes=SIZES):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in sizes]


def _serve(server_cls, estimator, submit, **kw):
    """Results of ``submit(server)``'s futures, the server shut down."""
    with server_cls(estimator, max_batch=4, buckets=(4,),
                    max_wait_ms=300.0, **kw) as srv:
        futs = submit(srv)
        return [f.result(timeout=TIMEOUT) for f in futs], srv


def _mpjpe_mm(a, b):
    return 1000.0 * float(np.linalg.norm(a - b, axis=-1).mean())


def _assert_fit_close(got, want, what):
    """tests/test_torch_api.py's float32 bounds: θ/β/cam 1e-3, energy
    rtol 1e-3, joints3d and vertices ≤ 1 mm."""
    for k in ("theta", "beta", "cam"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3,
                                   err_msg=f"{what} {k}")
    np.testing.assert_allclose(got["energy"], want["energy"], rtol=1e-3,
                               err_msg=f"{what} energy")
    for k in ("joints3d", "vertices"):
        if k in want:
            assert _mpjpe_mm(got[k], want[k]) <= 1.0, (what, k)


# -- parity with the JAX package's server -----------------------------------

def test_server_matches_jax_mixed_resolution(pair):
    """Mixed-resolution uint8 requests through submit: every field within
    the float32 bounds of JAX's server on the same requests, joints2d in
    source pixels, letterbox_affine bit-equal, one batch each."""
    jest, test = pair
    frames = _frames(0)

    def submit(srv):
        return [srv.submit(f) for f in frames]

    want, jsrv = _serve(jax_serving.BatchingServer, jest, submit,
                        fields=FIELDS)
    got, tsrv = _serve(serving.BatchingServer, test, submit, fields=FIELDS)
    counts = ("requests", "batches", "mean_batch", "occupancy", "shed")
    assert jsrv.stats.snapshot()["batches"] == 1
    assert ({k: tsrv.stats.snapshot()[k] for k in counts}
            == {k: jsrv.stats.snapshot()[k] for k in counts})
    for (h, w), g, j in zip(SIZES, got, want):
        j = {k: np.asarray(v) for k, v in j.items()}
        assert set(g) == set(j) and all(
            isinstance(v, (np.ndarray, np.generic)) for v in g.values())
        np.testing.assert_array_equal(g["letterbox_affine"],
                                      j["letterbox_affine"])
        np.testing.assert_array_equal(g["letterbox_affine"],
                                      pre.letterbox_affine(h, w, 64)
                                      if (h, w) != (64, 64)
                                      else [1, 1, 0, 0])
        np.testing.assert_allclose(g["joints2d"], j["joints2d"], rtol=0,
                                   atol=1e-2, err_msg=str((h, w)))
        np.testing.assert_allclose(g["conf"], j["conf"], rtol=0,
                                   atol=1e-4 * np.abs(j["conf"]).max())
        _assert_fit_close(g, j, (h, w))


def test_server_multi_matches_jax(pair):
    """fn="estimate_and_fit_multi" with fn_kwargs: the same person masks,
    every other field within the float32 bounds, on frames of people
    (on pixel noise the peak decisions are ill-conditioned)."""
    jest, test = pair
    frames = [two_people_frames(1, h, w, seed=i)[0]
              for i, (h, w) in enumerate(SIZES)]

    def submit(srv):
        return [srv.submit(f) for f in frames]

    kw = dict(fn="estimate_and_fit_multi", fn_kwargs={"max_people": 2})
    want, _ = _serve(jax_serving.BatchingServer, jest, submit, **kw)
    got, _ = _serve(serving.BatchingServer, test, submit, **kw)
    for g, j in zip(got, want):
        g, j = g._asdict(), {k: np.asarray(v) for k, v in j._asdict().items()}
        np.testing.assert_array_equal(g["person_mask"], j["person_mask"])
        assert g["joints2d"].shape == (2, 14, 2)
        np.testing.assert_allclose(g["joints2d"], j["joints2d"], rtol=0,
                                   atol=1e-2)
        np.testing.assert_allclose(g["person_scores"], j["person_scores"],
                                   rtol=1e-4, atol=1e-5)
        _assert_fit_close(g, j, "multi")


def test_server_fit_matches_jax(pair):
    """submit_fit with COCO-17 detector joints mapped by coco_to_cpm: the
    fit within the float32 bounds of JAX's server."""
    jest, test = pair
    rng = np.random.RandomState(5)
    coco = (16 + 32 * rng.rand(3, 17, 2)).astype(np.float32)
    conf = rng.uniform(0.5, 1.0, (3, 17)).astype(np.float32)
    j14, c14 = joints_lib.coco_to_cpm(coco, conf)

    def submit(srv):
        return [srv.submit_fit(j, c) for j, c in zip(j14, c14)]

    kw = dict(fn="fit_smpl")
    want, _ = _serve(jax_serving.BatchingServer, jest, submit, **kw)
    got, _ = _serve(serving.BatchingServer, test, submit, **kw)
    for g, j in zip(got, want):
        _assert_fit_close(g._asdict(), {k: np.asarray(v) for k, v in
                                        j._asdict().items()}, "fit")


def test_padded_bucket_equals_direct_call(est):
    """Three requests padded to bucket 4 by repeating the last: each
    result is bit-equal to a direct estimate_and_fit on the padded
    bucket."""
    frames = _frames(1, [(64, 64)] * 3)
    got, srv = _serve(serving.BatchingServer, est,
                      lambda s: s.submit_many(np.stack(frames)))
    assert srv.stats.snapshot()["occupancy"] == pytest.approx(3 / 4)
    direct = est.estimate_and_fit(np.stack(frames + frames[-1:]))
    for i, r in enumerate(got):
        for k, v in r._asdict().items():
            np.testing.assert_array_equal(
                v, getattr(direct, k)[i].numpy(), err_msg=k)


def test_precision_policy_under_serving(est):
    """quantize=True with calibrated static scales (so batch neighbours
    cannot move a scale) and int8_min_batch=4: a bucket of 4 takes the
    int8 CPM, a bucket of 1 the float one."""
    calib = np.stack(_frames(2, [(64, 64)] * 4))
    q = PoseEstimator(est.cpm, est.smpl_model, est.prior, est.cpm_cfg,
                      est.fit_cfg, quantize=True, calibration_images=calib,
                      int8_min_batch=4, device="cpu")
    picked = []
    orig = q._params_for_batch

    def record(batch_size):
        cpm = orig(batch_size)
        picked.append((batch_size, cpm is q.cpm))
        return cpm

    q._params_for_batch = record
    frames = _frames(3, [(64, 64)] * 4)
    with serving.BatchingServer(q, max_batch=4, max_wait_ms=300.0) as srv:
        full = [f.result(timeout=TIMEOUT) for f in srv.submit_many(
            np.stack(frames))]
        lone = srv.submit(frames[0]).result(timeout=TIMEOUT)
    assert picked == [(4, True), (1, False)]
    assert q.cpm is not q.cpm_bf16
    assert np.isfinite(full[0].theta).all() and np.isfinite(lone.theta).all()


class _OrderEstimator:
    """Stub that records launches and blocks its first call until
    released, so a second request queues behind the first."""

    def __init__(self):
        self.events = []
        self.entered = threading.Event()
        self.release = threading.Event()

    def estimate_and_fit(self, images):
        v = int(np.asarray(images)[0, 0, 0, 0])
        self.events.append(("launch", v))
        self.entered.set()
        assert self.release.wait(timeout=60)
        return {"first_px": np.asarray(images)[:, 0, 0, 0]}


@pytest.mark.parametrize("finish_ready_first,order", [
    (True, [("launch", 1), ("done", 1), ("launch", 2), ("done", 2)]),
    (False, [("launch", 1), ("launch", 2), ("done", 1), ("done", 2)])])
def test_pipeline_policy(finish_ready_first, order):
    """On the CPU a pending batch's work is done when its call returns, so
    it is finished before the next launch; with the check off (the
    reference's order) the next batch launches first. Either way the
    futures of consecutive batches resolve in order."""
    stub = _OrderEstimator()
    srv = serving.BatchingServer(stub, max_batch=1, max_wait_ms=0.0)
    srv.finish_ready_first = finish_ready_first
    with srv:
        f1 = srv.submit(np.full((2, 2, 3), 1, np.uint8))
        assert stub.entered.wait(timeout=60)
        f2 = srv.submit(np.full((2, 2, 3), 2, np.uint8))
        for v, f in ((1, f1), (2, f2)):
            f.add_done_callback(
                lambda _, v=v: stub.events.append(("done", v)))
        stub.release.set()
        assert f2.result(timeout=60)["first_px"] == 2
        assert f1.result(timeout=60)["first_px"] == 1
    assert stub.events == order


class _RecordingEstimator(_OrderEstimator):
    def estimate_and_fit(self, images):
        self.events.append(("batch", len(images)))
        return super().estimate_and_fit(images)


def test_finished_callers_join_the_next_batch():
    """A pending batch finished before the next launch lets its callers'
    next requests join that launch (within max_wait_ms) instead of
    leaving them for the one after."""
    stub = _RecordingEstimator()
    with serving.BatchingServer(stub, max_batch=4, buckets=(4,),
                                max_wait_ms=300.0) as srv:
        f1 = srv.submit(np.full((2, 2, 3), 1, np.uint8))
        assert stub.entered.wait(timeout=60)
        f2 = srv.submit(np.full((2, 2, 3), 2, np.uint8))
        again = []
        f1.add_done_callback(lambda _: again.append(
            srv.submit(np.full((2, 2, 3), 3, np.uint8))))
        stub.release.set()
        assert f2.result(timeout=60)["first_px"] == 2
        assert again[0].result(timeout=60)["first_px"] == 3
    assert srv.stats.snapshot()["batches"] == 2
    assert srv.stats.snapshot()["requests"] == 3


def test_dispatcher_grad_mode_is_its_own(est):
    """A caller under no_grad / inference_mode gets the same fit: grad
    mode is thread-local and the dispatcher runs with it on."""
    frame = _frames(4, [(64, 64)])[0]
    with serving.BatchingServer(est, max_batch=1) as srv:
        with torch.inference_mode():
            a = srv.submit(frame).result(timeout=TIMEOUT)
        b = srv.submit(frame).result(timeout=TIMEOUT)
    np.testing.assert_array_equal(a.theta, b.theta)


# -- tests/test_serving.py's cases on the port's server ----------------------

def test_default_buckets():
    assert serving.default_buckets(1) == (1,)
    assert serving.default_buckets(8) == (1, 2, 4, 8)
    assert serving.default_buckets(12) == (1, 2, 4, 8, 12)


def test_batching_server_end_to_end(est):
    """Concurrent submits resolve to a direct batched call's numbers, as
    numpy, and the telemetry shows the aggregation."""
    frames = np.stack(_frames(0, [(64, 64)] * 3))
    direct = est.estimate_and_fit(frames)
    with serving.BatchingServer(est, max_batch=4, max_wait_ms=200.0) as srv:
        results = [f.result(timeout=TIMEOUT) for f in srv.submit_many(frames)]
    for i, r in enumerate(results):
        assert isinstance(r.theta, np.ndarray) and r.theta.shape == (72,)
        np.testing.assert_allclose(r.theta, direct.theta[i].numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(r.joints2d, direct.joints2d[i].numpy(),
                                   atol=1e-3)
    snap = srv.stats.snapshot()
    assert snap["requests"] == 3 and snap["batches"] == 1
    assert snap["occupancy"] == pytest.approx(3 / 4)
    assert snap["latency_ms_p99"] >= snap["latency_ms_p50"] > 0


def test_server_validates_and_closes(est):
    srv = serving.BatchingServer(est, max_batch=2, max_wait_ms=0.0)
    with pytest.raises(ValueError):
        srv.submit(np.zeros((2, 64, 64, 3), np.uint8))  # a batch
    srv.shutdown()
    with pytest.raises(RuntimeError):
        srv.submit(np.zeros((64, 64, 3), np.uint8))
    srv.shutdown()  # idempotent
    with pytest.raises(ValueError):
        serving.BatchingServer(est, max_batch=4, buckets=(1, 2))


class _BoomEstimator:
    def estimate_and_fit(self, images):
        raise RuntimeError("boom")


def test_server_propagates_estimator_errors():
    """A failing call fails its batch's futures with the exception (no
    retry on another route), and the dispatcher keeps serving."""
    with serving.BatchingServer(_BoomEstimator(), max_batch=2,
                                max_wait_ms=0.0) as srv:
        for _ in range(2):
            fut = srv.submit(np.zeros((8, 8, 3), np.uint8))
            with pytest.raises(RuntimeError, match="boom"):
                fut.result(timeout=60)


class _EchoEstimator:
    def estimate_and_fit(self, images):
        return {"first_px": np.asarray(images)[:, 0, 0, 0]}


def test_cancelled_future_does_not_kill_dispatcher():
    with serving.BatchingServer(_EchoEstimator(), max_batch=4,
                                max_wait_ms=300.0) as srv:
        f1 = srv.submit(np.full((2, 2, 3), 7, np.uint8))
        f1.cancel()
        f2 = srv.submit(np.full((2, 2, 3), 9, np.uint8))
        assert f2.result(timeout=60)["first_px"] == 9
        f3 = srv.submit(np.full((2, 2, 3), 5, np.uint8))
        assert f3.result(timeout=60)["first_px"] == 5


def test_shutdown_fails_stragglers_instead_of_hanging():
    srv = serving.BatchingServer(_EchoEstimator(), max_batch=2,
                                 max_wait_ms=0.0)
    straggler = concurrent.futures.Future()
    srv._queue.put(None)
    srv._queue.put((np.zeros((2, 2, 3), np.uint8), straggler, 0.0, None))
    srv.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        straggler.result(timeout=60)


class _GatedEstimator:
    """Blocks inside the call until released: a deterministic backlog
    behind one batch in flight."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def estimate_and_fit(self, images):
        self.entered.set()
        assert self.release.wait(timeout=60)
        return {"first_px": np.asarray(images)[:, 0, 0, 0]}


def test_backpressure_sheds_at_max_queue():
    stub = _GatedEstimator()
    with serving.BatchingServer(stub, max_batch=2, max_wait_ms=0.0,
                                max_queue=3) as srv:
        f0 = srv.submit(np.full((2, 2, 3), 1, np.uint8))
        assert stub.entered.wait(timeout=60)
        fq = [srv.submit(np.full((2, 2, 3), 2 + i, np.uint8))
              for i in range(3)]
        assert srv.queue_depth() == 3
        with pytest.raises(serving.ServerOverloaded) as ei:
            srv.submit(np.full((2, 2, 3), 9, np.uint8))
        assert ei.value.queued == 3 and ei.value.max_queue == 3
        assert 0.1 <= ei.value.retry_after_s <= 30.0
        tel = srv.telemetry()
        assert tel["shed"] == 1 and tel["queue_depth"] == 3
        assert tel["max_queue"] == 3
        stub.release.set()
        assert f0.result(timeout=60)["first_px"] == 1
        for i, f in enumerate(fq):
            assert f.result(timeout=60)["first_px"] == 2 + i
    assert srv.stats.snapshot()["shed"] == 1


def test_backpressure_default_and_disable():
    stub = _GatedEstimator()
    stub.release.set()
    srv = serving.BatchingServer(stub, max_batch=4)
    assert srv.max_queue == 32
    srv.shutdown()
    srv0 = serving.BatchingServer(stub, max_batch=1, max_queue=0)
    assert srv0.max_queue == 0
    srv0.shutdown()
    with pytest.raises(ValueError, match="max_queue"):
        serving.BatchingServer(stub, max_batch=1, max_queue=-1)


def test_fields_selection_trims_response(est):
    frame = _frames(1, [(64, 64)])[0]
    with serving.BatchingServer(est, max_batch=2, max_wait_ms=0.0,
                                fields=("theta", "joints2d")) as srv:
        out = srv.submit(frame).result(timeout=TIMEOUT)
    assert set(out) == {"theta", "joints2d"}
    assert out["theta"].shape == (72,) and out["joints2d"].shape == (14, 2)


def test_fields_validated_at_construction(est):
    with pytest.raises(ValueError, match="unknown result fields"):
        serving.BatchingServer(est, max_batch=2, fields=("thetas",))


def test_mixed_resolution_requests_batch_together(est):
    """Requests of different (H, W) ride one batch and come back in their
    source pixels: the oracle letterboxes each frame, runs the direct
    batched call and maps joints back through each affine."""
    frames = _frames(3, [(80, 60), (48, 96), (64, 64)])
    results, srv = _serve(serving.BatchingServer, est,
                          lambda s: [s.submit(f) for f in frames])
    assert srv.stats.snapshot()["batches"] == 1
    nets, affs = zip(*[pre.letterbox_image_np(f, 64) for f in frames])
    direct = est.estimate_and_fit(np.stack(nets + nets[-1:]))
    for i, (r, a) in enumerate(zip(results, affs)):
        np.testing.assert_allclose(r.theta, direct.theta[i].numpy(),
                                   atol=1e-4)
        expect = (direct.joints2d[i].numpy() - a[2:4]) / a[0:2]
        np.testing.assert_allclose(r.joints2d, expect, atol=1e-3)


def test_letterbox_affine_field(est):
    rng = np.random.RandomState(4)
    with serving.BatchingServer(
            est, max_batch=2, max_wait_ms=0.0,
            fields=("joints2d", "letterbox_affine")) as srv:
        small = srv.submit(rng.randint(0, 255, (32, 64, 3)).astype(
            np.uint8)).result(TIMEOUT)
        exact = srv.submit(rng.randint(0, 255, (64, 64, 3)).astype(
            np.uint8)).result(TIMEOUT)
    assert set(small) == {"joints2d", "letterbox_affine"}
    np.testing.assert_allclose(exact["letterbox_affine"], [1, 1, 0, 0])
    np.testing.assert_allclose(small["letterbox_affine"],
                               pre.letterbox_affine(32, 64, 64))


def test_pipelined_dispatch_many_batches():
    with serving.BatchingServer(_EchoEstimator(), max_batch=2,
                                max_wait_ms=0.0, max_queue=0) as srv:
        futs = [srv.submit(np.full((2, 2, 3), v, np.uint8))
                for v in range(20)]
        for v, f in enumerate(futs):
            assert f.result(timeout=60)["first_px"] == v
    assert srv.stats.snapshot()["requests"] == 20


def test_server_multi_person_fn(est):
    with serving.BatchingServer(
            est, max_batch=4, max_wait_ms=5.0, fn="estimate_and_fit_multi",
            fn_kwargs={"max_people": 3},
            fields=("joints2d", "person_mask", "theta")) as srv:
        frames = np.stack(_frames(0, [(64, 64)] * 3))
        outs = [f.result(timeout=TIMEOUT) for f in srv.submit_many(frames)]
    for out in outs:
        assert set(out) == {"joints2d", "person_mask", "theta"}
        assert out["joints2d"].shape == (3, 14, 2)
        assert out["person_mask"].shape == (3,) and out["person_mask"].any()
        assert out["theta"].shape == (3, 72)


def test_server_multi_fn_validation(est):
    with pytest.raises(ValueError, match="fn must be"):
        serving.BatchingServer(est, fn="estimate_2d")
    with pytest.raises(ValueError, match="fn_kwargs only"):
        serving.BatchingServer(est, fn_kwargs={"max_people": 2})
    with pytest.raises(ValueError, match="unknown result fields"):
        serving.BatchingServer(est, fields=("person_mask",))
    serving.BatchingServer(est, fn="estimate_and_fit_multi",
                           fields=("person_mask",)).shutdown()


class _ArtifactStub(_EchoEstimator):
    """An artifact-backed estimator names the entry point it serves."""
    fn = "estimate_and_fit_multi"
    result_fields = ("first_px",)


def test_server_fn_must_match_artifact(est, tmp_path):
    """An estimate_and_fit_multi artifact behind the default fn (or the
    reverse) is a contract mismatch and must fail at construction; with
    the matching fn it serves (the knobs baked at export)."""
    from tpu_pose_torch import export as pexport
    est2 = PoseEstimator(est.cpm, est.smpl_model, None, est.cpm_cfg,
                         est.fit_cfg, device="cpu")
    path = str(tmp_path / "multi_art")
    pexport.export_estimator(est2, path, fn="estimate_and_fit_multi",
                             batch=2, platforms=("cpu",), max_people=2)
    sp = pexport.ServableProgram(path)
    with pytest.raises(ValueError, match="construct the server"):
        serving.BatchingServer(sp)   # default fn mismatches
    with pytest.raises(ValueError, match="artifact-backed"):
        serving.BatchingServer(sp, fn="estimate_and_fit_multi",
                               fn_kwargs={"max_people": 2})
    with serving.BatchingServer(sp, fn="estimate_and_fit_multi",
                                buckets=(2,), max_batch=2,
                                fields=("joints2d", "person_mask")) as s:
        frames = np.zeros((2, 64, 64, 3), np.uint8)
        out = [f.result(timeout=TIMEOUT) for f in s.submit_many(frames)]
    assert np.asarray(out[0]["joints2d"]).shape == (2, 14, 2)
    assert np.asarray(out[0]["person_mask"]).shape == (2,)


def test_server_fit_smpl_from_artifact(est, tmp_path):
    """A fit_smpl artifact serves joints-only deployments: the host has no
    model code, the response includes the posed mesh, and each result
    equals the live estimator's fit of the same joints."""
    from tpu_pose_torch import export as pexport
    path = str(tmp_path / "fit_art")
    pexport.export_estimator(est, path, fn="fit_smpl", batch=2,
                             platforms=("cpu",))
    sp = pexport.ServableProgram(path)
    rng = np.random.RandomState(1)
    joints = [rng.rand(14, 2).astype(np.float32) * 64 for _ in range(2)]
    with serving.BatchingServer(sp, fn="fit_smpl", buckets=(2,),
                                max_batch=2) as srv:
        futs = [srv.submit_fit(j, np.ones(14, np.float32)) for j in joints]
        outs = [f.result(timeout=TIMEOUT) for f in futs]
    assert np.asarray(outs[0]["vertices"]).shape == (6890, 3)
    assert np.asarray(outs[0]["theta"]).shape == (72,)
    live = est.fit_smpl(np.stack(joints), np.ones((2, 14), np.float32))
    for i in range(2):
        np.testing.assert_allclose(outs[i]["theta"], live.theta[i].numpy(),
                                   rtol=0, atol=1e-5)


def test_server_fn_must_match_estimator_fn():
    """The artifact check stays generic: an estimator naming its fn must
    be served with that fn and without fn_kwargs; its result_fields
    validate fields."""
    with pytest.raises(ValueError, match="construct the server"):
        serving.BatchingServer(_ArtifactStub())
    with pytest.raises(ValueError, match="artifact-backed"):
        serving.BatchingServer(_ArtifactStub(), fn="estimate_and_fit_multi",
                               fn_kwargs={"max_people": 2})
    with pytest.raises(ValueError, match="unknown result fields"):
        serving.BatchingServer(_ArtifactStub(), fn="estimate_and_fit_multi",
                               fields=("theta",))


def test_server_fit_smpl_fn(est):
    rng = np.random.RandomState(0)
    with serving.BatchingServer(est, max_batch=4, max_wait_ms=5.0,
                                fn="fit_smpl",
                                fields=("theta", "cam", "energy")) as srv:
        with pytest.raises(ValueError, match="submit_fit"):
            srv.submit(np.zeros((64, 64, 3), np.uint8))
        futs = [srv.submit_fit(rng.rand(14, 2).astype(np.float32) * 64,
                               np.ones(14, np.float32)) for _ in range(3)]
        outs = [f.result(timeout=TIMEOUT) for f in futs]
    for out in outs:
        assert set(out) == {"theta", "cam", "energy"}
        assert out["theta"].shape == (72,)
    with serving.BatchingServer(est) as srv2:
        with pytest.raises(ValueError, match="fit_smpl"):
            srv2.submit_fit(np.zeros((14, 2)), np.ones(14))
    with pytest.raises(ValueError, match="letterbox_affine"):
        serving.BatchingServer(est, fn="fit_smpl",
                               fields=("letterbox_affine",))


def test_submit_fit_wrong_joint_count_fails_alone(est):
    rng = np.random.RandomState(0)
    with serving.BatchingServer(est, max_batch=4, max_wait_ms=50.0,
                                fn="fit_smpl") as srv:
        with pytest.raises(ValueError, match="fits 14 joints"):
            srv.submit_fit(rng.rand(13, 2).astype(np.float32),
                           np.ones(13, np.float32))
        fut = srv.submit_fit(rng.rand(14, 2).astype(np.float32) * 64,
                             np.ones(14, np.float32))
        assert fut.result(timeout=TIMEOUT).theta.shape == (72,)
