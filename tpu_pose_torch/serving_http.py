"""HTTP front end for :class:`tpu_pose_torch.serving.BatchingServer`
(port of ``tpu_pose/serving_http.py``; the same routes, bodies, status
codes and metric names, so the two servers are interchangeable behind
one client or dashboard).

Standard library only: a ``ThreadingHTTPServer`` whose request threads
are the server's concurrency model. Each handler decodes and letterboxes
its frame on its own thread (the native letterbox releases the GIL) and
blocks on its request's ``Future``, while the one dispatch thread owns
the estimator. Handler threads touch numpy only.

Endpoints:

- ``POST /predict``: the body is one frame, PNG/JPEG (``Content-Type:
  image/*``, decoded with PIL, imported when such a body arrives) or a
  raw ``.npy`` array (``application/x-npy``, (H, W, 3) uint8, what a
  client should send). Any resolution; joints come back in this frame's
  pixels. The response is a JSON object of the requested fields
  (``?fields=a,b``; default every field the server returns), arrays as
  nested lists, or an ``.npz`` stream when the request sends ``Accept:
  application/x-npz`` (the compact form; use it for ``vertices``).
- ``POST /predict_batch``: an ``.npy`` (N, H, W, 3) stack, submitted as
  N independent requests (they fill buckets together); every field
  gains a leading N axis. Same ``?fields=`` and ``Accept`` contract.
- ``POST /fit``: for ``fn="fit_smpl"`` servers (external 2D
  detectors): an ``.npz`` body with ``joints2d`` (P, 2) or (N, P, 2) in
  network-frame pixels and ``conf`` (P,) or (N, P); rows are
  independent requests. Same response contract.
- ``GET /healthz``: 200 ``{"ok": true}`` while the dispatcher lives.
- ``GET /stats``: the server's telemetry snapshot as JSON (with
  ``queue_depth``, ``max_queue`` and ``shed``).
- ``GET /metrics``: the same snapshot in Prometheus text format, named
  ``tpu_pose_*`` (the wire contract a dashboard reads).

Overload: when the queue is at ``max_queue``, the POST routes answer at
once with ``503``, a ``Retry-After`` header and a JSON
``retry_after_s`` hint, instead of queueing into the request timeout.

Use::

    est = PoseEstimator.create_synthetic(seed=0, letterbox=True)
    with PoseHTTPServer(est, port=8080,
                        fields=("joints2d", "conf", "theta", "beta",
                                "cam", "energy")) as srv:
        srv.serve_forever()

TLS, authentication and load balancing belong to the deployment's
ingress, not here.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np

from tpu_pose_torch import serving as serving_lib

_MAX_BODY = 64 * 1024 * 1024        # one frame; 64 MB covers 8K RGB
_MAX_BODY_BATCH = 1024 * 1024 * 1024  # /predict_batch stacks


class _Listener(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog sized for bursts.

    A batching server coalesces simultaneous requests, so bursts of
    ``max_batch`` near-simultaneous connects are its normal arrival
    pattern; socketserver's default ``request_queue_size`` of 5 lets the
    kernel reset the tail of such a burst before ``accept()`` runs."""
    request_queue_size = 128


def _decode_body(body: bytes, ctype: str) -> np.ndarray:
    """Request body → (H, W, 3) uint8 frame. Raises ValueError with a
    client-appropriate message on malformed input."""
    ctype = (ctype or "").split(";")[0].strip().lower()
    if ctype == "application/x-npy":
        try:
            arr = np.load(io.BytesIO(body), allow_pickle=False)
        except Exception as e:
            raise ValueError(f"bad .npy body: {e}")
    elif ctype.startswith("image/"):
        try:
            from PIL import Image
            with Image.open(io.BytesIO(body)) as im:
                arr = np.asarray(im.convert("RGB"))
        except ValueError:
            raise
        except Exception as e:
            raise ValueError(f"undecodable {ctype} body: {e}")
    else:
        raise ValueError(
            f"unsupported Content-Type {ctype!r}: send image/png, "
            f"image/jpeg, or application/x-npy")
    arr = np.asarray(arr)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(
            f"frame must be (H, W, 3), got shape {tuple(arr.shape)}")
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr


def _to_plain(tree) -> dict:
    """A result (NamedTuple or dict of arrays) → {name: ndarray}."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    return {k: np.asarray(v) for k, v in dict(tree).items()}


class _Handler(BaseHTTPRequestHandler):
    # Set by PoseHTTPServer on the server instance (self.server.pose).
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        if self.server.pose.verbose:
            super().log_message(fmt, *args)

    # -- helpers ----------------------------------------------------------

    def _send(self, code: int, payload: bytes,
              ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        if self.close_connection:
            # Tell the client (don't just drop the socket): set on the
            # error paths that answer before reading the request body.
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(payload)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode())

    def _error(self, code: int, msg: str) -> None:
        self._send_json(code, {"error": msg})

    # -- routes -----------------------------------------------------------

    def do_GET(self):
        pose = self.server.pose
        path = self.path.split("?")[0]
        if path == "/healthz":
            alive = pose.server._thread.is_alive()
            self._send_json(200 if alive else 503, {"ok": alive})
        elif path == "/stats":
            self._send_json(200, pose.server.telemetry())
        elif path == "/metrics":
            snap = pose.server.telemetry()
            lines = []
            for k, v in snap.items():
                name = f"tpu_pose_{k}"
                kind = ("counter" if k in ("requests", "batches", "shed")
                        else "gauge")
                lines.append(f"# TYPE {name} {kind}")
                lines.append(f"{name} {float(v)}")
            self._send(200, ("\n".join(lines) + "\n").encode(),
                       "text/plain; version=0.0.4")
        else:
            self._error(404, f"no route {path!r}")

    def do_POST(self):
        pose = self.server.pose
        path, _, query = self.path.partition("?")
        if path not in ("/predict", "/predict_batch", "/fit"):
            # Answering before reading the body leaves the unread body on
            # a kept-alive connection, where it would be parsed as the
            # next request line (the next valid request would get a bogus
            # 501/414). Close instead of draining: the body may be up to
            # the cap.
            self.close_connection = True
            self._error(404, f"no route {path!r}")
            return
        max_body = (_MAX_BODY_BATCH if path == "/predict_batch"
                    else _MAX_BODY)
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = 0
        if not 0 < length <= max_body:
            self.close_connection = True  # body unread — see 404 above
            self._error(413 if length > max_body else 400,
                        f"Content-Length must be in (0, {max_body}]")
            return
        body = self.rfile.read(length)
        fields = None
        for part in query.split("&"):
            if part.startswith("fields="):
                fields = tuple(f for f in part[7:].split(",") if f)
        try:
            if path == "/fit":
                try:
                    with np.load(io.BytesIO(body),
                                 allow_pickle=False) as z:
                        joints = np.asarray(z["joints2d"], np.float32)
                        conf = np.asarray(z["conf"], np.float32)
                except Exception as e:
                    raise ValueError(
                        f"/fit takes an .npz body with joints2d + conf:"
                        f" {e}")
                single = joints.ndim == 2
                if single:
                    joints, conf = joints[None], conf[None]
                if (joints.ndim != 3 or joints.shape[-1] != 2
                        or conf.shape != joints.shape[:2]):
                    raise ValueError(
                        f"joints2d must be ([N,] P, 2) with matching "
                        f"conf, got shapes {joints.shape}, {conf.shape}")
                if joints.shape[0] == 0:
                    raise ValueError("empty request: N must be >= 1")
            elif path == "/predict_batch":
                ctype = (self.headers.get("Content-Type") or "").split(
                    ";")[0].strip().lower()
                if ctype != "application/x-npy":
                    raise ValueError(
                        "/predict_batch takes an application/x-npy "
                        "(N, H, W, 3) stack")
                try:
                    stack = np.load(io.BytesIO(body), allow_pickle=False)
                except Exception as e:
                    raise ValueError(f"bad .npy body: {e}")
                if (stack.ndim != 4 or stack.shape[-1] != 3
                        or stack.shape[0] == 0):
                    raise ValueError(
                        f"stack must be (N, H, W, 3) with N >= 1, got "
                        f"{tuple(stack.shape)}")
                if stack.dtype != np.uint8:
                    stack = np.clip(stack, 0, 255).astype(np.uint8)
            else:
                frame = _decode_body(body,
                                     self.headers.get("Content-Type"))
        except ValueError as e:
            self._error(400, str(e))
            return
        try:
            if path == "/fit":
                futs = [pose.server.submit_fit(j, c)
                        for j, c in zip(joints, conf)]
                outs = [_to_plain(f.result(
                    timeout=pose.request_timeout_s)) for f in futs]
                res = {k: np.stack([o[k] for o in outs])
                       for k in outs[0]}
                if single:
                    res = {k: v[0] for k, v in res.items()}
            elif path == "/predict_batch":
                futs = pose.server.submit_many(stack)
                outs = [_to_plain(f.result(
                    timeout=pose.request_timeout_s)) for f in futs]
                res = {k: np.stack([o[k] for o in outs])
                       for k in outs[0]}
            else:
                fut = pose.server.submit(frame)
                res = _to_plain(fut.result(
                    timeout=pose.request_timeout_s))
        except serving_lib.ServerOverloaded as e:
            # Backpressure: 503 + Retry-After at once instead of queueing
            # into a timeout (in a batched submit some earlier rows may
            # already be queued; they compute and are discarded, the
            # price of failing fast).
            self.send_response(503)
            payload = json.dumps({
                "error": str(e),
                "retry_after_s": round(e.retry_after_s, 2)}).encode()
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("Retry-After",
                             str(max(1, int(round(e.retry_after_s)))))
            self.end_headers()
            self.wfile.write(payload)
            return
        except ValueError as e:
            # e.g. /fit against a frames server, or a wrong joint count:
            # client errors, not server faults.
            self._error(400, str(e))
            return
        except Exception as e:
            self._error(500, f"{type(e).__name__}: {e}")
            return
        if fields is not None:
            unknown = set(fields) - set(res)
            if unknown:
                self._error(400, f"unknown fields {sorted(unknown)}; "
                                 f"have {sorted(res)}")
                return
            res = {k: res[k] for k in fields}
        if "application/x-npz" in (self.headers.get("Accept") or ""):
            buf = io.BytesIO()
            np.savez(buf, **res)
            self._send(200, buf.getvalue(), "application/x-npz")
        else:
            self._send_json(
                200, {k: np.asarray(v).tolist() for k, v in res.items()})


class PoseHTTPServer:
    """HTTP data plane over a :class:`serving.BatchingServer`.

    Args:
      estimator: an ``api.PoseEstimator`` (or any estimator
        ``BatchingServer`` takes).
      host/port: bind address; port 0 picks a free port (see ``.port``).
      request_timeout_s: per-request wait on the device result.
      verbose: log each request (BaseHTTPRequestHandler format).
      backlog: listen(2) queue depth. Size it ≥ the largest client
        burst (default 128; see ``_Listener``).
      **server_kw: forwarded to ``BatchingServer`` (``max_batch``,
        ``max_wait_ms``, ``buckets``, ``fields`` ...).

    ``serve_forever()`` blocks (Ctrl-C safe); the instance is also a
    context manager. Construction starts the listener thread, so callers
    can talk to ``.port`` at once.
    """

    def __init__(self, estimator, host: str = "127.0.0.1", port: int = 0,
                 request_timeout_s: float = 120.0, verbose: bool = False,
                 fields: Optional[Sequence[str]] = None,
                 backlog: int = 128, **server_kw):
        self.server = serving_lib.BatchingServer(estimator,
                                                 fields=fields,
                                                 **server_kw)
        self.request_timeout_s = request_timeout_s
        self.verbose = verbose
        listener_cls = type("_Listener", (_Listener,),
                            {"request_queue_size": int(backlog)})
        self._httpd = listener_cls((host, port), _Handler)
        self._httpd.pose = self
        self.host, self.port = self._httpd.server_address[:2]
        self._listener = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._listener.start()

    def serve_forever(self) -> None:
        """Block until :meth:`shutdown` (the listener thread is already
        serving; this parks the caller)."""
        try:
            self._listener.join()
        except KeyboardInterrupt:
            self.shutdown()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self.server.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
