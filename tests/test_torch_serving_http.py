"""The port's HTTP front end and client (tpu_pose_torch/serving_http.py,
tpu_pose_torch/client.py): tests/test_serving_http.py's cases on the
port's server, wire compatibility with the JAX package's server and
client in both directions, and the detector joint maps (models/joints.py
and the client's copies) against the JAX package's."""

import io
import json
import socket
import threading
import time
from http.client import HTTPConnection

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pose import client as jax_client
from tpu_pose import serving_http as jax_http
from tpu_pose.models import joints as jax_joints
from tpu_pose_torch import client as port_client
from tpu_pose_torch import serving_http
from tpu_pose_torch.api import PoseEstimator
from tpu_pose_torch.models import joints as joints_lib
from tpu_pose_torch.serving_http import PoseHTTPServer
from tpu_pose_torch.utils.config import CPMConfig, FitConfig, StageConfig
from torch_threads import one_thread

one_thread()

TIMEOUT = 120
SMALL_CPM = CPMConfig(input_size=64, features=16, stage1_head_width=32,
                      refine_width=16, num_stages=2, compute_dtype="float32")
SMALL_FIT = FitConfig(
    stages=(StageConfig(iters=10, lr=0.05, w_pose_prior=0,
                        w_shape_prior=0, w_angle_prior=0),),
    img_size=64)
FIELDS = ("joints2d", "conf", "theta", "energy", "letterbox_affine")


@pytest.fixture(scope="module")
def est():
    return PoseEstimator.create_synthetic(
        seed=0, cpm_cfg=SMALL_CPM, fit_cfg=SMALL_FIT, device="cpu")


@pytest.fixture(scope="module")
def srv(est):
    # max_queue=0 (unbounded): the 64-connection burst floods past the
    # default bound; backpressure has its own test.
    lb = PoseEstimator(est.cpm, est.smpl_model, est.prior, SMALL_CPM,
                       SMALL_FIT, device="cpu", letterbox=True)
    with PoseHTTPServer(lb, max_batch=4, max_wait_ms=10.0, max_queue=0,
                        fields=FIELDS) as s:
        yield s


@pytest.fixture(scope="module")
def fit_srv(est):
    with PoseHTTPServer(est, max_batch=4, max_wait_ms=5.0,
                        fn="fit_smpl") as s:
        yield s


def _npy_bytes(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _npz_body(j, c):
    buf = io.BytesIO()
    np.savez(buf, joints2d=j, conf=c)
    return buf.getvalue()


def _post(srv, body, ctype, path="/predict", accept=None):
    conn = HTTPConnection(srv.host, srv.port, timeout=TIMEOUT)
    headers = {"Content-Type": ctype}
    if accept:
        headers["Accept"] = accept
    conn.request("POST", path, body=body, headers=headers)
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, r.getheader("Content-Type"), data


def _get(s, path):
    conn = HTTPConnection(s.host, s.port, timeout=30)
    conn.request("GET", path)
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return data


def _frame(seed, h=64, w=64):
    return np.random.RandomState(seed).randint(
        0, 255, (h, w, 3)).astype(np.uint8)


# -- wire compatibility with the JAX package ---------------------------------

class _WireEstimator:
    """A deterministic stub that both packages' servers can serve: its
    outputs depend on the (letterboxed) frames and joints it is given."""
    cpm_cfg = SMALL_CPM
    grid = np.arange(28, dtype=np.float32).reshape(14, 2)

    def estimate_and_fit(self, images):
        corner = np.asarray(images, np.float32)[:, 0, 0, :]
        return {"joints2d": self.grid[None] + corner[:, None, :2] / 8.0,
                "conf": np.repeat(corner[:, :1] / 255.0, 14, axis=1),
                "theta": np.tile(corner, (1, 24))}

    def fit_smpl(self, joints2d, conf):
        j = np.asarray(joints2d)
        return {"theta": np.tile(j.reshape(len(j), -1)[:, :24], (1, 3)),
                "energy": (j.sum((1, 2)) * np.asarray(conf).mean(1))}


@pytest.fixture(scope="module")
def wire_servers():
    """The JAX package's server and the port's over the same stub, for
    frames and for joints."""
    with jax_http.PoseHTTPServer(_WireEstimator(), max_batch=4,
                                 max_wait_ms=5.0) as jf, \
            PoseHTTPServer(_WireEstimator(), max_batch=4,
                           max_wait_ms=5.0) as tf, \
            jax_http.PoseHTTPServer(_WireEstimator(), max_batch=4,
                                    max_wait_ms=5.0, fn="fit_smpl") as jj, \
            PoseHTTPServer(_WireEstimator(), max_batch=4, max_wait_ms=5.0,
                           fn="fit_smpl") as tj:
        yield {"jax": (jf, jj), "port": (tf, tj)}


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_wire_responses_equal_field_for_field(wire_servers):
    """/predict (JSON and .npz), /predict_batch and /fit answer the same
    bytes from the JAX package's server and the port's."""
    frame, wide = _frame(1), _frame(2, 48, 80)
    stack = np.stack([_frame(3), _frame(4)])
    rng = np.random.RandomState(0)
    j, c = (rng.rand(2, 14, 2) * 64).astype(np.float32), \
        rng.rand(2, 14).astype(np.float32)
    cases = [(0, _npy_bytes(frame), "application/x-npy", "/predict", None),
             (0, _npy_bytes(wide), "application/x-npy",
              "/predict?fields=joints2d", None),
             (0, _npy_bytes(frame), "application/x-npy", "/predict",
              "application/x-npz"),
             (0, _npy_bytes(stack), "application/x-npy", "/predict_batch",
              "application/x-npz"),
             (1, _npz_body(j[0], c[0]), "application/x-npz", "/fit", None),
             (1, _npz_body(j, c), "application/x-npz", "/fit",
              "application/x-npz")]
    for route, body, ctype, path, accept in cases:
        responses = [_post(wire_servers[pkg][route], body, ctype, path,
                           accept) for pkg in ("jax", "port")]
        (js, jt, jd), (ts, tt, td) = responses
        assert js == ts == 200 and jt == tt, (path, responses)
        if accept is None:
            assert json.loads(jd) == json.loads(td), path
        else:
            with np.load(io.BytesIO(jd)) as a, np.load(io.BytesIO(td)) as b:
                _assert_same(dict(a), dict(b))


def test_clients_interchange(wire_servers, srv, fit_srv):
    """The port's PoseClient against the JAX package's server and the JAX
    package's PoseClient against the port's server: predict,
    predict_batch and fit return what the other package's client gets."""
    frame, stack = _frame(5, 48, 80), np.stack([_frame(6), _frame(7)])
    rng = np.random.RandomState(1)
    j = (rng.rand(14, 2) * 64).astype(np.float32)
    c = np.ones(14, np.float32)
    jf, jj = wire_servers["jax"]
    for server, fserver in ((jf, jj), (srv, fit_srv)):
        url = f"http://{server.host}:{server.port}"
        furl = f"http://{fserver.host}:{fserver.port}"
        with port_client.PoseClient(url) as pc, \
                jax_client.PoseClient(url) as jc:
            _assert_same(pc.predict(frame), jc.predict(frame))
            _assert_same(pc.predict_batch(stack), jc.predict_batch(stack))
            assert pc.healthy() and jc.healthy()
        with port_client.PoseClient(furl) as pc, \
                jax_client.PoseClient(furl) as jc:
            _assert_same(pc.fit(j, c), jc.fit(j, c))
            _assert_same(pc.fit(np.stack([j, j]), np.stack([c, c])),
                         jc.fit(np.stack([j, j]), np.stack([c, c])))


def test_metrics_and_stats_names_match_jax(wire_servers):
    jf = wire_servers["jax"][0]
    tf = wire_servers["port"][0]
    for s in (jf, tf):
        _post(s, _npy_bytes(_frame(8)), "application/x-npy")
    assert (set(json.loads(_get(jf, "/stats")))
            == set(json.loads(_get(tf, "/stats"))))

    def names(s):
        return [line.split()[0] if not line.startswith("#") else line
                for line in _get(s, "/metrics").decode().splitlines()]

    assert names(jf) == names(tf)
    assert all(n.startswith(("tpu_pose_", "# TYPE tpu_pose_"))
               for n in names(tf))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_joint_maps_match_jax(as_tensor):
    """coco_to_cpm / mpii_to_cpm as numpy and as tensors against the JAX
    package's (numpy and jnp), with a leading batch shape; the client's
    copies of the tables against both."""
    rng = np.random.RandomState(2)
    coco, ccoco = rng.rand(2, 3, 17, 2).astype(np.float32), \
        rng.rand(2, 3, 17).astype(np.float32)
    mpii, cmpii = rng.rand(3, 16, 2).astype(np.float32), \
        rng.rand(3, 16).astype(np.float32)
    conv = torch.from_numpy if as_tensor else (lambda a: a)
    jconv = jnp.asarray if as_tensor else (lambda a: a)
    for fn, client_fn, j, c in (
            ("coco_to_cpm", port_client.PoseClient.coco_to_cpm, coco, ccoco),
            ("mpii_to_cpm", port_client.PoseClient.mpii_to_cpm, mpii,
             cmpii)):
        got = getattr(joints_lib, fn)(conv(j), conv(c))
        want = getattr(jax_joints, fn)(jconv(j), jconv(c))
        assert all(isinstance(g, torch.Tensor) == as_tensor for g in got)
        for g, w, cl in zip(got, want, client_fn(j, c)):
            g = g.numpy() if as_tensor else g
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=fn)
            np.testing.assert_array_equal(cl, g, err_msg=fn)
        with pytest.raises(ValueError, match=fn):
            getattr(joints_lib, fn)(conv(j[..., :5, :]), conv(c[..., :5]))
    assert joints_lib.COCO_KEYPOINT_NAMES == jax_joints.COCO_KEYPOINT_NAMES
    assert joints_lib.COCO_TO_CPM_DIRECT == jax_joints.COCO_TO_CPM_DIRECT
    np.testing.assert_array_equal(joints_lib.MPII16_TO_CPM,
                                  jax_joints.MPII16_TO_CPM)
    np.testing.assert_array_equal(joints_lib.CPM_OKS_SIGMA,
                                  jax_joints.CPM_OKS_SIGMA)


# -- tests/test_serving_http.py's cases on the port's server ----------------

def test_predict_npy_json_roundtrip(srv):
    status, ctype, data = _post(srv, _npy_bytes(_frame(0)),
                                "application/x-npy")
    assert status == 200 and ctype == "application/json"
    out = json.loads(data)
    assert set(out) == set(FIELDS)
    assert np.asarray(out["joints2d"]).shape == (14, 2)
    assert np.asarray(out["theta"]).shape == (72,)


def test_predict_png_mixed_resolution_source_pixels(srv):
    """A PNG of another resolution letterboxes at submit and returns
    joints in its source pixels."""
    from PIL import Image
    img = np.zeros((100, 40, 3), np.uint8)
    img[:] = (40, 90, 160)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    status, _, data = _post(srv, buf.getvalue(), "image/png")
    assert status == 200
    out = json.loads(data)
    j = np.asarray(out["joints2d"])
    aff = np.asarray(out["letterbox_affine"])
    assert aff.shape == (4,) and not np.allclose(aff, [1, 1, 0, 0])
    assert (j[:, 0] >= -40).all() and (j[:, 0] <= 80).all()


def test_field_selection_and_unknown_field(srv):
    frame = np.zeros((64, 64, 3), np.uint8)
    status, _, data = _post(srv, _npy_bytes(frame), "application/x-npy",
                            path="/predict?fields=theta,energy")
    assert status == 200 and set(json.loads(data)) == {"theta", "energy"}
    status, _, data = _post(srv, _npy_bytes(frame), "application/x-npy",
                            path="/predict?fields=nope")
    assert status == 400 and "unknown fields" in json.loads(data)["error"]


def test_npz_response(srv):
    status, ctype, data = _post(srv, _npy_bytes(np.zeros((64, 64, 3),
                                                         np.uint8)),
                                "application/x-npy",
                                accept="application/x-npz")
    assert status == 200 and ctype == "application/x-npz"
    with np.load(io.BytesIO(data)) as z:
        assert z["joints2d"].shape == (14, 2)


def test_error_codes(srv):
    assert _post(srv, b"not a png", "image/png")[0] == 400
    assert _post(srv, b"{}", "application/json")[0] == 400
    status, _, data = _post(srv, _npy_bytes(np.zeros((4, 4))),
                            "application/x-npy")
    assert status == 400 and "H, W, 3" in json.loads(data)["error"]
    assert _post(srv, b"", "application/x-npy", path="/nope")[0] in (400,
                                                                      404)


def test_health_stats_metrics(srv):
    conn = HTTPConnection(srv.host, srv.port, timeout=30)
    conn.request("GET", "/healthz")
    r = conn.getresponse()
    assert r.status == 200 and json.loads(r.read())["ok"] is True
    conn.request("GET", "/stats")
    snap = json.loads(conn.getresponse().read())
    assert {"requests", "batches", "mean_batch"} <= set(snap)
    conn.request("GET", "/metrics")
    text = conn.getresponse().read().decode()
    conn.close()
    assert "# TYPE tpu_pose_requests counter" in text
    assert "tpu_pose_latency_ms_p50" in text


def test_predict_batch(srv):
    stack = np.random.RandomState(3).randint(
        0, 255, (5, 64, 64, 3)).astype(np.uint8)
    status, _, data = _post(srv, _npy_bytes(stack), "application/x-npy",
                            path="/predict_batch?fields=joints2d,energy",
                            accept="application/x-npz")
    assert status == 200
    with np.load(io.BytesIO(data)) as z:
        assert z["joints2d"].shape == (5, 14, 2)
        assert z["energy"].shape == (5,)
    status, _, data = _post(srv, _npy_bytes(stack[0]), "application/x-npy",
                            path="/predict_batch")
    assert status == 400 and "N, H, W, 3" in json.loads(data)["error"]


def test_concurrent_clients_batch_together(srv):
    before = srv.server.stats.snapshot()["requests"]
    frames = [_frame(i) for i in range(8)]
    results = [None] * 8

    def go(i):
        results[i] = _post(srv, _npy_bytes(frames[i]), "application/x-npy")

    threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert all(r[0] == 200 for r in results)
    assert srv.server.stats.snapshot()["requests"] >= before + 8
    j0 = json.loads(results[0][2])["joints2d"]
    j1 = json.loads(results[1][2])["joints2d"]
    assert not np.allclose(j0, j1)


def test_http_multi_person_fn(est):
    with PoseHTTPServer(est, max_batch=2, max_wait_ms=5.0,
                        fn="estimate_and_fit_multi",
                        fn_kwargs={"max_people": 2},
                        fields=("joints2d", "person_mask")) as s:
        status, _, data = _post(s, _npy_bytes(_frame(5)),
                                "application/x-npy")
    assert status == 200
    out = json.loads(data)
    assert np.asarray(out["joints2d"]).shape == (2, 14, 2)
    assert np.asarray(out["person_mask"]).shape == (2,)


def test_http_fit_route(est, fit_srv):
    """/fit on a fit_smpl server: single and batched rows; a bad body and
    a frames server answer 400."""
    rng = np.random.RandomState(0)
    j = rng.rand(14, 2).astype(np.float32) * 64
    status, _, data = _post(fit_srv, _npz_body(j, np.ones(14, np.float32)),
                            "application/x-npz",
                            path="/fit?fields=theta,energy")
    assert status == 200
    assert np.asarray(json.loads(data)["theta"]).shape == (72,)
    jb = rng.rand(3, 14, 2).astype(np.float32) * 64
    status, _, data = _post(fit_srv, _npz_body(jb, np.ones((3, 14),
                                                           np.float32)),
                            "application/x-npz", path="/fit?fields=theta",
                            accept="application/x-npz")
    assert status == 200
    with np.load(io.BytesIO(data)) as z:
        assert z["theta"].shape == (3, 72)
    assert _post(fit_srv, b"junk", "application/x-npz", path="/fit")[0] == 400
    with PoseHTTPServer(est, max_batch=2, max_wait_ms=5.0) as s2:
        status, _, data = _post(s2, _npz_body(j, np.ones(14, np.float32)),
                                "application/x-npz", path="/fit")
    assert status == 400 and "submit_fit" in json.loads(data)["error"]


def test_pose_client_roundtrip(srv):
    c = port_client.PoseClient(f"http://{srv.host}:{srv.port}",
                               fields=("joints2d", "theta"))
    frame = _frame(7)
    out = c.predict(frame)
    assert set(out) == {"joints2d", "theta"}
    assert out["joints2d"].shape == (14, 2)
    outs = c.predict_batch(np.stack([frame, frame]))
    assert outs["theta"].shape == (2, 72)
    np.testing.assert_allclose(outs["theta"][0], outs["theta"][1])
    assert c.healthy() and c.stats()["requests"] >= 3
    bad = port_client.PoseClient(f"http://{srv.host}:{srv.port}",
                                 fields=("nope",))
    with pytest.raises(port_client.ServingError, match="unknown fields"):
        bad.predict(frame)
    with pytest.raises(ValueError, match="H, W, 3"):
        c.predict(np.zeros((4, 4)))
    assert not port_client.PoseClient("http://127.0.0.1:1").healthy()
    c.close()


def test_pose_client_keepalive_and_stale_socket_retry(srv):
    frame = _frame(3)
    with port_client.PoseClient(f"http://{srv.host}:{srv.port}",
                                fields=("theta",)) as c:
        c.predict(frame)
        conn1 = c._local.conn
        assert conn1 is not None
        c.predict(frame)
        assert c._local.conn is conn1
        conn1.sock.close()
        assert c.predict(frame)["theta"].shape == (72,)
        assert c._local.conn is not conn1
        seen = {}

        def from_thread():
            c.predict(frame)
            seen["conn"] = c._local.conn
            c.close()

        t = threading.Thread(target=from_thread)
        t.start()
        t.join(timeout=TIMEOUT)
        assert not t.is_alive() and seen["conn"] is not c._local.conn
    assert c._local.conn is None


def test_pose_client_fit(fit_srv):
    c = port_client.PoseClient(f"http://{fit_srv.host}:{fit_srv.port}")
    j = np.random.RandomState(0).rand(14, 2).astype(np.float32) * 64
    assert c.fit(j, np.ones(14, np.float32))["theta"].shape == (72,)
    outs = c.fit(np.stack([j, j]), np.ones((2, 14), np.float32))
    assert outs["theta"].shape == (2, 72)
    c.close()


def test_empty_batch_rejected(srv):
    status, _, data = _post(srv, _npy_bytes(
        np.zeros((0, 64, 64, 3), np.uint8)), "application/x-npy",
        path="/predict_batch")
    assert status == 400 and "N >= 1" in json.loads(data)["error"]


def test_client_predict_batch_chunks_large_stacks(est):
    with PoseHTTPServer(est, max_batch=4, max_wait_ms=5.0,
                        fields=("theta",)) as s:
        c = port_client.PoseClient(f"http://{s.host}:{s.port}",
                                   fields=("theta",))
        stack = np.random.RandomState(1).randint(
            0, 255, (5, 64, 64, 3)).astype(np.uint8)
        out = c.predict_batch(stack, max_request_bytes=stack[0].nbytes)
        assert out["theta"].shape == (5, 72)
        whole = c.predict_batch(stack)
        np.testing.assert_allclose(out["theta"], whole["theta"], atol=1e-5)
        c.close()


def test_error_paths_do_not_poison_keepalive(srv):
    body = _npy_bytes(np.zeros((64, 64, 3), np.uint8))
    conn = HTTPConnection(srv.host, srv.port, timeout=30)
    conn.request("POST", "/nope", body=body,
                 headers={"Content-Type": "application/x-npy"})
    r = conn.getresponse()
    r.read()
    assert r.status == 404 and r.will_close
    conn.close()
    with port_client.PoseClient(f"http://{srv.host}:{srv.port}",
                                fields=("theta",)) as c:
        with pytest.raises(port_client.ServingError, match="404"):
            c._result(*c._request("POST", "/nope", body))
        assert getattr(c._local, "conn", None) is None
        assert c.predict(np.zeros((64, 64, 3), np.uint8))["theta"].shape \
            == (72,)


def test_client_close_reaches_worker_thread_conns(srv):
    frame = _frame(11)
    c = port_client.PoseClient(f"http://{srv.host}:{srv.port}",
                               fields=("theta",))
    worker_conns = []

    def worker():
        c.predict(frame)
        worker_conns.append(c._local.conn)

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    c.predict(frame)
    assert len(c._conns) == 4
    c.close()
    assert not c._conns
    assert all(conn.sock is None for conn in worker_conns)


def test_client_timeout_is_not_retried(srv):
    calls = {"n": 0}

    class _SlowConn:
        sock = object()

        def request(self, *a, **kw):
            calls["n"] += 1

        def getresponse(self):
            raise socket.timeout("timed out")

        def close(self):
            pass

    c = port_client.PoseClient(f"http://{srv.host}:{srv.port}")
    c._local.conn = _SlowConn()
    with pytest.raises(OSError):
        c._request("GET", "/stats")
    assert calls["n"] == 1
    assert getattr(c._local, "conn", None) is None


class _GatedEstimator:
    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def estimate_and_fit(self, images):
        self.entered.set()
        assert self.release.wait(timeout=60)
        return {"first_px": np.asarray(images)[:, 0, 0, 0]}


def test_overload_returns_503_with_retry_after():
    stub = _GatedEstimator()
    with PoseHTTPServer(stub, max_batch=1, max_wait_ms=0.0,
                        max_queue=1) as s:
        body = _npy_bytes(np.zeros((8, 8, 3), np.uint8))
        results = []

        def go():
            results.append(_post(s, body, "application/x-npy"))

        t1 = threading.Thread(target=go)
        t1.start()
        assert stub.entered.wait(timeout=60)
        t2 = threading.Thread(target=go)
        t2.start()
        t0 = time.time()
        while s.server.queue_depth() < 1 and time.time() - t0 < 60:
            time.sleep(0.01)
        status, _, data = _post(s, body, "application/x-npy")
        conn = HTTPConnection(s.host, s.port, timeout=30)
        conn.request("POST", "/predict", body=body,
                     headers={"Content-Type": "application/x-npy"})
        r = conn.getresponse()
        retry_hdr = r.getheader("Retry-After")
        r.read()
        conn.close()
        assert status == 503
        err = json.loads(data)
        assert "overloaded" in err["error"] and err["retry_after_s"] >= 0.1
        assert retry_hdr is not None and int(retry_hdr) >= 1
        snap = json.loads(_get(s, "/stats"))
        assert snap["shed"] >= 2 and snap["max_queue"] == 1
        assert snap["queue_depth"] == 1
        metrics = _get(s, "/metrics").decode()
        assert "# TYPE tpu_pose_shed counter" in metrics
        assert "tpu_pose_queue_depth" in metrics
        stub.release.set()
        t1.join(timeout=60)
        t2.join(timeout=60)
        assert not t1.is_alive() and not t2.is_alive()
        assert sorted(r[0] for r in results) == [200, 200]


def test_backlog_survives_64_connection_burst(srv):
    """64 near-simultaneous connections are all served (the listen
    backlog is 128, not socketserver's 5)."""
    body = _npy_bytes(_frame(3))
    n = 64
    barrier = threading.Barrier(n)
    errs, oks = [], []

    def go():
        try:
            barrier.wait(timeout=60)
            status, _, data = _post(srv, body, "application/x-npy")
            assert status == 200, (status, data[:200])
            oks.append(1)
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errs.append(repr(e))

    threads = [threading.Thread(target=go) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not errs, errs[:5]
    assert len(oks) == n


def test_listener_backlog_default():
    assert serving_http._Listener.request_queue_size == 128


def test_serve_cli_flags_and_default_fields(est):
    """The serve CLI's flags are the JAX CLI's (argparse; --artifact
    serves a deployment artifact, tests/test_torch_export.py) plus
    --device, which defaults to the card; each fn's default fields are
    fields that fn's server accepts."""
    from tpu_pose_torch.tools import serve
    args = serve.parse_args([])
    assert (args.device, args.port, args.max_batch, args.fn,
            args.max_queue, args.max_wait_ms) == (
        "cuda", 8080, 64, "estimate_and_fit", -1, 5.0)
    assert args.artifact == ""
    assert serve.parse_args(["--artifact", "x"]).artifact == "x"
    args = serve.parse_args(["--fn", "fit_smpl", "--device", "cpu",
                             "--max_people", "3", "--allow_empty"])
    assert (args.fn, args.device, args.max_people, args.allow_empty) == (
        "fit_smpl", "cpu", 3, True)
    from tpu_pose_torch import serving
    for fn, fields in serve.DEFAULT_FIELDS.items():
        serving.BatchingServer(est, fn=fn, fields=fields).shutdown()
