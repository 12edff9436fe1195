"""Client for a :mod:`tpu_pose_torch.serving_http` endpoint (port of
``tpu_pose/client.py``). Standard library and numpy only: a camera host
or web backend talks to the pose service without torch. It speaks the
same wire format as the JAX package's server.

    from tpu_pose_torch.client import PoseClient
    client = PoseClient("http://pose-host:8080")
    out = client.predict(frame)               # (H, W, 3) any resolution
    out["joints2d"], out["theta"]             # numpy arrays
    outs = client.predict_batch(stack)        # (N, H, W, 3) → leading N
    fit = client.fit(joints2d, conf)          # fn=fit_smpl servers
    client.healthy(); client.stats()

Frames go as raw ``.npy`` and responses come back as ``.npz``: array
data never passes through JSON.
"""

from __future__ import annotations

import http.client
import io
import json
import threading
from http.client import HTTPConnection
from typing import Optional, Sequence
from urllib.parse import urlparse

import numpy as np

__all__ = ["PoseClient", "ServingError"]


class ServingError(RuntimeError):
    """Non-200 response from the serving endpoint."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class PoseClient:
    """Thin wire-format client for :class:`serving_http.PoseHTTPServer`.

    Args:
      url: endpoint base, e.g. ``"http://pose-host:8080"``.
      fields: default result-field selection for every request (None =
        whatever the server serves).
      timeout_s: socket timeout per request (the first request may
        include the server's warm-up).
    """

    def __init__(self, url: str, fields: Optional[Sequence[str]] = None,
                 timeout_s: float = 300.0):
        u = urlparse(url if "//" in url else f"http://{url}")
        if u.scheme != "http":
            raise ValueError(f"PoseClient speaks plain http (put TLS in "
                             f"the ingress), got {u.scheme!r}")
        self.host = u.hostname
        self.port = u.port or 80
        self.fields = tuple(fields) if fields else None
        self.timeout_s = timeout_s
        # One persistent keep-alive connection per calling thread (the
        # endpoint is HTTP/1.1): a TCP connect and a handler thread per
        # frame would otherwise dominate small-request latency. Thread-
        # local storage makes the instance safe to share across a client
        # thread pool without a lock on the socket; the registry below
        # exists only so close() can reach connections opened by other
        # (possibly finished) threads: each idle keep-alive socket pins a
        # server handler thread.
        self._local = threading.local()
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    # -- wire helpers ------------------------------------------------------

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            self._local.conn = None
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        """Close every connection this client opened: the calling
        thread's and those of other threads that used the shared instance
        (e.g. a client thread pool). Safe from any thread; also the
        context-manager exit. A thread mid-request sees its request
        fail."""
        self._drop_conn()
        with self._conns_lock:
            conns, self._conns = self._conns, set()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _request(self, method: str, path: str, body: bytes = b"",
                 ctype: str = "application/x-npy") -> tuple:
        headers = {"Accept": "application/x-npz"}
        if body:
            headers["Content-Type"] = ctype
        # One retry on a connection-level failure: a kept-alive socket the
        # server (or an idle timeout) closed between requests fails as
        # OSError/BadStatusLine on its next use. Every route is a pure
        # function of its body, so a resend is safe; a failure on a fresh
        # connection propagates. A response timeout is not retried
        # (socket.timeout is an OSError, but means the request is slow in
        # flight, not that the socket was stale; a resend would duplicate
        # device work and double the worst-case latency).
        for attempt in (0, 1):
            conn = getattr(self._local, "conn", None)
            fresh = conn is None
            if fresh:
                conn = HTTPConnection(self.host, self.port,
                                      timeout=self.timeout_s)
                self._local.conn = conn
                with self._conns_lock:
                    self._conns.add(conn)
            try:
                conn.request(method, path, body=body or None,
                             headers=headers)
                r = conn.getresponse()
                data = r.read()
            except (OSError, http.client.HTTPException) as e:
                self._drop_conn()
                if isinstance(e, TimeoutError) or fresh or attempt:
                    raise
                continue
            if r.will_close or r.status != 200:
                # Non-200 responses drop the connection even when the
                # server says keep-alive: error paths that answered before
                # reading the request body leave it on the wire, where it
                # would be parsed as the next request line.
                self._drop_conn()
            return r.status, r.getheader("Content-Type") or "", data

    def _result(self, status: int, ctype: str, data: bytes) -> dict:
        if status != 200:
            try:
                msg = json.loads(data).get("error", data[:200])
            except Exception:
                msg = repr(data[:200])
            raise ServingError(status, str(msg))
        if "application/x-npz" in ctype:
            with np.load(io.BytesIO(data)) as z:
                return {k: z[k] for k in z.files}
        return {k: np.asarray(v) for k, v in json.loads(data).items()}

    def _path(self, route: str) -> str:
        if self.fields:
            return f"{route}?fields={','.join(self.fields)}"
        return route

    @staticmethod
    def _npy(arr: np.ndarray) -> bytes:
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(arr))
        return buf.getvalue()

    # -- API ---------------------------------------------------------------

    def predict(self, frame: np.ndarray) -> dict:
        """One (H, W, 3) frame of any resolution → dict of numpy arrays
        (``joints2d`` in THIS frame's source pixels)."""
        frame = np.asarray(frame)
        if frame.ndim != 3 or frame.shape[-1] != 3:
            raise ValueError(f"frame must be (H, W, 3), got "
                             f"{frame.shape}")
        if frame.dtype != np.uint8:
            frame = np.clip(frame, 0, 255).astype(np.uint8)
        return self._result(*self._request(
            "POST", self._path("/predict"), self._npy(frame)))

    def predict_batch(self, frames: np.ndarray,
                      max_request_bytes: int = 48 * 1024 * 1024) -> dict:
        """(N, H, W, 3) stack → dict with a leading N axis per field.
        Stacks larger than ``max_request_bytes`` go as several requests
        (the results concatenate), below the endpoint's body cap."""
        frames = np.asarray(frames)
        if frames.ndim != 4 or frames.shape[-1] != 3 or not len(frames):
            raise ValueError(f"frames must be (N, H, W, 3) with N >= 1, "
                             f"got {frames.shape}")
        if frames.dtype != np.uint8:
            frames = np.clip(frames, 0, 255).astype(np.uint8)
        per = max(int(frames[0].nbytes), 1)
        chunk = max(max_request_bytes // per, 1)
        outs = []
        for start in range(0, len(frames), chunk):
            outs.append(self._result(*self._request(
                "POST", self._path("/predict_batch"),
                self._npy(frames[start:start + chunk]))))
        if len(outs) == 1:
            return outs[0]
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    @staticmethod
    def coco_to_cpm(joints17: np.ndarray, conf17: np.ndarray):
        """COCO-17 detector output → the CPM-14 convention ``fit``
        sends: direct slots per the standard correspondence, neck =
        shoulder midpoint (conf = min of the shoulders), head ≈ nose.
        The client's numpy copy of ``models.joints.coco_to_cpm`` (that
        module needs torch), held equal to it by
        tests/test_torch_serving_http.py."""
        joints17 = np.asarray(joints17)
        conf17 = np.asarray(conf17)
        if (joints17.shape[-2:] != (17, 2)
                or conf17.shape != joints17.shape[:-1]):
            raise ValueError(
                f"coco_to_cpm takes (..., 17, 2) joints with matching "
                f"(..., 17) conf; got {joints17.shape}, {conf17.shape}")
        # CPM slot → COCO id (slots 0/1 synthesized below).
        idx = np.array([0, 0, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15])
        j = joints17[..., idx, :].copy()
        c = conf17[..., idx].copy()
        j[..., 1, :] = (joints17[..., 5, :] + joints17[..., 6, :]) / 2.0
        c[..., 1] = np.minimum(conf17[..., 5], conf17[..., 6])
        return j, c

    @staticmethod
    def mpii_to_cpm(joints16: np.ndarray, conf16: np.ndarray):
        """MPII-16 detector output → the CPM-14 convention ``fit``
        sends: a pure permutation (MPII carries every CPM joint; pelvis
        and thorax dropped). The client's numpy copy of
        ``models.joints.mpii_to_cpm``, held equal to it by
        tests/test_torch_serving_http.py."""
        joints16 = np.asarray(joints16)
        conf16 = np.asarray(conf16)
        if (joints16.shape[-2:] != (16, 2)
                or conf16.shape != joints16.shape[:-1]):
            raise ValueError(
                f"mpii_to_cpm takes (..., 16, 2) joints with matching "
                f"(..., 16) conf; got {joints16.shape}, {conf16.shape}")
        idx = np.array([9, 8, 12, 11, 10, 13, 14, 15, 2, 1, 0, 3, 4, 5])
        return joints16[..., idx, :], conf16[..., idx]

    def fit(self, joints2d: np.ndarray, conf: np.ndarray) -> dict:
        """(P, 2)/(N, P, 2) network-frame joints + conf → fit result
        (``fn=fit_smpl`` servers). External COCO-17 detector output
        converts first via :meth:`coco_to_cpm`."""
        buf = io.BytesIO()
        np.savez(buf, joints2d=np.asarray(joints2d, np.float32),
                 conf=np.asarray(conf, np.float32))
        return self._result(*self._request(
            "POST", self._path("/fit"), buf.getvalue(),
            ctype="application/x-npz"))

    def healthy(self) -> bool:
        try:
            status, _, data = self._request("GET", "/healthz")
        except OSError:
            return False
        return status == 200 and json.loads(data).get("ok") is True

    def stats(self) -> dict:
        status, _, data = self._request("GET", "/stats")
        if status != 200:
            raise ServingError(status, repr(data[:200]))
        return json.loads(data)
