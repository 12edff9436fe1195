"""Micro-batching server for the fused entry points (port of
``tpu_pose/serving.py``).

Requests arrive one frame at a time; the estimator is throughput-optimal
at a batch. :class:`BatchingServer` collects concurrent single-frame
requests into device batches (up to ``max_batch``, waiting at most
``max_wait_ms`` after the first), pads each to a fixed bucket size, and
scatters per-frame results back to the callers' futures as numpy.

- Mixed resolutions: every request letterboxes to the network frame at
  submit time, on the caller's thread (``ops/preprocess.
  letterbox_image_np``, native for uint8), so requests of any (H, W)
  batch together under one device shape; ``joints2d`` comes back in each
  request's source pixels.
- The estimator's batch-size precision policy composes: small buckets
  take the float CPM, large ones the int8 one
  (``api.PoseEstimator._params_for_batch``), with no server logic.

Threading: callers enqueue from any thread; one dispatch thread owns the
estimator. The precision scopes of the fit (``utils/device.py``) flip
process-global flags, so the model never runs on two threads at once;
grad mode is thread-local, and the dispatcher's starts enabled whatever
the callers' threads run under (the fit needs ``torch.autograd.grad``).
A CUDA estimator's dispatcher runs under ``torch.cuda.device`` of its
device.

Pipeline: the dispatcher keeps at most one batch pending. JAX's dispatch
returns at once, so the reference launches batch i+1 before waiting on
batch i's results. The port's entry points spend about a whole call's
time on the host issuing launches, so finishing batch i only after
launching batch i+1 would hold batch i's responses behind all of batch
i+1's host time. So a CUDA event is recorded after each launch, and the
pending batch is finished before the next launch when its event fires
within the host time that launch took (on the CPU: always), and the next
batch is then topped up while requests keep arriving less than
``max_wait_ms`` apart (the finished callers' next requests join it);
only a pending batch whose device work outlasts its launch (a launch
that returns early, as a captured graph's does) overlaps the next
launch.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from tpu_pose_torch.ops import preprocess as pre


def default_buckets(max_batch: int) -> tuple:
    """Power-of-two batch buckets below ``max_batch``, plus ``max_batch``
    itself: a handful of batch shapes, at most ≈ 2× padding."""
    b, out = 1, []
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


class ServerOverloaded(RuntimeError):
    """``submit`` shed a request: the queue is at ``max_queue``. An
    unbounded queue under sustained overload grows without limit and
    pushes every latency past the request timeout; shedding at the door
    keeps accepted work on schedule. ``retry_after_s`` estimates when a
    retry would find room (queue depth ÷ throughput); ``serving_http``
    answers it with ``503 Retry-After``."""

    def __init__(self, queued: int, max_queue: int, retry_after_s: float):
        super().__init__(
            f"server overloaded: {queued} requests queued "
            f"(max_queue={max_queue}); retry in ~{retry_after_s:.1f}s")
        self.queued = queued
        self.max_queue = max_queue
        self.retry_after_s = retry_after_s


class ServerStats:
    """Running serving telemetry. Updates and snapshots hold the lock (an
    unlocked snapshot can race the dispatcher's ``deque.extend``)."""

    def __init__(self, window: int = 1024):
        self.requests = 0
        self.batches = 0
        self.padded_frames = 0
        self.shed = 0
        self.latencies_ms = collections.deque(maxlen=window)
        self._lock = threading.Lock()

    def record_batch(self, n: int, padded: int, latencies_ms) -> None:
        with self._lock:
            self.requests += n
            self.batches += 1
            self.padded_frames += padded
            self.latencies_ms.extend(latencies_ms)

    def record_shed(self) -> None:
        with self._lock:
            self.shed += 1

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self.latencies_ms)
            pick = (lambda q: lat[min(int(q * len(lat)), len(lat) - 1)]
                    if lat else 0.0)
            occupancy = (self.requests
                         / max(self.requests + self.padded_frames, 1))
            return {
                "requests": self.requests,
                "batches": self.batches,
                "mean_batch": self.requests / max(self.batches, 1),
                "occupancy": occupancy,
                "shed": self.shed,
                "latency_ms_p50": pick(0.50),
                "latency_ms_p99": pick(0.99),
            }


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _map(fn, res):
    """``fn`` over a result's fields: a NamedTuple stays one, anything
    else with ``items`` becomes a dict."""
    if hasattr(res, "_fields"):
        return type(res)(*(fn(v) for v in res))
    return {k: fn(v) for k, v in res.items()}


class BatchingServer:
    """Aggregate concurrent requests into batches for the estimator.

    Args:
      estimator: an ``api.PoseEstimator``, or any object with the entry
        point ``fn`` (an artifact-backed estimator names its own ``fn``
        and may list ``result_fields``).
      max_batch: largest device batch.
      max_wait_ms: how long the dispatcher waits to fill a batch after
        the first request arrives; 0 dispatches whatever is queued.
      buckets: the batch sizes to pad to; default power-of-two.
      fields: the result fields to return (e.g. ``("theta", "beta",
        "cam", "joints2d", "conf")``), or None for all. The mesh
        (``vertices``, ≈ 80 KB per frame) dominates a response; clients
        that rebuild it from (θ, β) should drop it. The extra field
        ``"letterbox_affine"`` returns each request's source → network
        affine (identity for network-sized frames); ``joints2d`` is
        always in the request's source pixels.
      fn: the entry point to serve: ``"estimate_and_fit"`` (default),
        ``"estimate_and_fit_multi"`` (results gain the ``max_people``
        axis and ``person_mask``) or ``"fit_smpl"`` (joints in, through
        :meth:`submit_fit`).
      fn_kwargs: keywords for ``estimate_and_fit_multi`` on a live
        estimator (``max_people``, ``min_person_score``, ...).
      max_queue: backpressure bound: ``submit``/``submit_fit`` raise
        :class:`ServerOverloaded` when this many requests are queued.
        Default ``8 × max_batch``; 0 disables shedding.

    Use as a context manager, or call :meth:`shutdown`.
    """

    # Finish the pending batch before the next launch when its device work
    # is done (module docstring). A measurement turns it off to compare.
    finish_ready_first = True

    def __init__(self, estimator, max_batch: int = 64,
                 max_wait_ms: float = 5.0,
                 buckets: Optional[Sequence[int]] = None,
                 fields: Optional[Sequence[str]] = None,
                 fn: str = "estimate_and_fit",
                 fn_kwargs: Optional[dict] = None,
                 max_queue: Optional[int] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if fn not in ("estimate_and_fit", "estimate_and_fit_multi",
                      "fit_smpl"):
            raise ValueError(
                f"fn must be estimate_and_fit, estimate_and_fit_multi, "
                f"or fit_smpl, got {fn!r}")
        self.estimator = estimator
        self.fn = fn
        self.fn_kwargs = dict(fn_kwargs or {})
        if self.fn_kwargs and fn != "estimate_and_fit_multi":
            raise ValueError("fn_kwargs only apply to "
                             "estimate_and_fit_multi")
        est_fn = getattr(estimator, "fn", None)
        if est_fn is not None and est_fn != fn:
            # An artifact exported for one entry point behind another would
            # silently serve the wrong contract.
            raise ValueError(
                f"estimator serves fn={est_fn!r}; construct the server "
                f"with fn={est_fn!r}")
        if self.fn_kwargs and est_fn is not None:
            raise ValueError(
                "artifact-backed estimators bake the multi-person knobs "
                "at export time; fn_kwargs only apply to live "
                "PoseEstimators")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.fields = None if fields is None else tuple(fields)
        if self.fields is not None:
            self._check_fields(estimator, fn)
        # The network frame for submit-time letterboxing; None (a stub
        # estimator without a cpm_cfg) batches frames as they come.
        cpm_cfg = getattr(estimator, "cpm_cfg", None)
        self._net_size = getattr(cpm_cfg, "input_size", None)
        # Joint count for submit_fit's check (None: unknown, accept any).
        self._num_joints = (getattr(estimator, "num_joints", None)
                            or getattr(cpm_cfg, "num_joints", None))
        self.buckets = tuple(sorted(set(
            buckets if buckets is not None else default_buckets(max_batch))))
        if self.buckets[-1] != max_batch:
            raise ValueError("largest bucket must equal max_batch")
        self.max_queue = (8 * max_batch if max_queue is None
                          else int(max_queue))
        if self.max_queue < 0:
            raise ValueError("max_queue must be >= 0 (0 = unbounded)")
        self.stats = ServerStats()
        # How often a pending batch met a collected one: finished before
        # the launch, or overlapped by it (dispatcher thread only).
        self.pipeline_counts = {"finished_first": 0, "overlapped": 0}
        # The queue itself is unbounded; submit sheds by its depth. A
        # bounded queue.Queue would let the dispatcher's sentinel re-post
        # in _collect block on its own full queue, and shutdown's sentinel
        # stall behind a full backlog.
        self._queue: "queue.Queue" = queue.Queue()
        # EWMA of a batch's service time, for the Retry-After hint.
        self._service_ema_s: Optional[float] = None
        self._closed = False
        self._submit_lock = threading.Lock()
        device = getattr(estimator, "device", None)
        self._cuda = (torch.device(device)
                      if isinstance(device, (str, torch.device))
                      and torch.device(device).type == "cuda" else None)
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True)
        self._thread.start()

    def _check_fields(self, estimator, fn: str) -> None:
        """Reject unknown ``fields`` at construction, against the result
        type of ``fn`` (a live estimator) or ``result_fields`` (an
        artifact-backed one); other estimators are not checked."""
        from tpu_pose_torch.api import (EstimateAndFitResult,
                                        MultiPersonResult, PoseEstimator)
        from tpu_pose_torch.fitting.fit import FitResult
        if isinstance(estimator, PoseEstimator):
            known = set({"estimate_and_fit": EstimateAndFitResult,
                         "estimate_and_fit_multi": MultiPersonResult,
                         "fit_smpl": FitResult}[fn]._fields)
        elif hasattr(estimator, "result_fields"):
            known = set(estimator.result_fields)
        else:
            return
        extra = set() if fn == "fit_smpl" else {"letterbox_affine"}
        unknown = set(self.fields) - extra - known
        if unknown:
            raise ValueError(f"unknown result fields: {sorted(unknown)}")

    # -- client side ------------------------------------------------------

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one (H, W, 3) frame of any resolution; resolves to the
        result for that frame, as numpy, with ``joints2d`` in this
        frame's source pixels. A frame of another size than the network's
        letterboxes here, on the caller's thread."""
        if self.fn == "fit_smpl":
            raise ValueError("fn='fit_smpl' servers take joints, not "
                             "frames — use submit_fit(joints2d, conf)")
        image = np.asarray(image)
        if image.ndim != 3:
            raise ValueError(f"submit takes one (H, W, 3) frame, "
                             f"got shape {image.shape}")
        affine = None
        if (self._net_size is not None
                and image.shape[:2] != (self._net_size, self._net_size)):
            image, affine = pre.letterbox_image_np(image, self._net_size)
        return self._enqueue(image, affine)

    def submit_many(self, images: np.ndarray) -> list:
        """Enqueue an (N, H, W, 3) stack as N independent requests."""
        return [self.submit(im) for im in images]

    def submit_fit(self, joints2d: np.ndarray,
                   conf: np.ndarray) -> Future:
        """A ``fn="fit_smpl"`` request: one person's 2D joints (P, 2) in
        network-frame pixels and confidences (P,), e.g. an external
        detector's output through ``models/joints.coco_to_cpm``.
        Resolves to that request's fit result."""
        if self.fn != "fit_smpl":
            raise ValueError("submit_fit needs a fn='fit_smpl' server")
        joints2d = np.asarray(joints2d, np.float32)
        conf = np.asarray(conf, np.float32)
        if (joints2d.ndim != 2 or joints2d.shape[-1] != 2
                or conf.shape != joints2d.shape[:1]):
            raise ValueError(
                f"submit_fit takes joints2d (P, 2) + conf (P,), got "
                f"{joints2d.shape}, {conf.shape}")
        # Checked here, not on the dispatch thread: a malformed request
        # fails alone, never the batch other clients share.
        if (self._num_joints is not None
                and joints2d.shape[0] != self._num_joints):
            raise ValueError(
                f"this server fits {self._num_joints} joints, got "
                f"{joints2d.shape[0]}")
        return self._enqueue((joints2d, conf), None)

    def _enqueue(self, payload, affine) -> Future:
        fut: Future = Future()
        # The lock pairs the closed check with the put: a submit racing
        # shutdown() could otherwise land behind the sentinel after the
        # dispatcher has drained and exited, a future never resolved.
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("server is shut down")
            self._check_backpressure()
            self._queue.put((payload, fut, time.perf_counter(), affine))
        return fut

    def _check_backpressure(self) -> None:
        """Shed when the backlog is at ``max_queue`` (under _submit_lock,
        so the depth check and the put are atomic against other
        submitters; the dispatcher only removes)."""
        if self.max_queue <= 0:
            return
        depth = self._queue.qsize()
        if depth < self.max_queue:
            return
        self.stats.record_shed()
        # Batches ahead × the measured service time of a batch; 0.5 s
        # before the first batch is done. Bounded so a bad estimate never
        # sends clients away for minutes.
        per_batch = self._service_ema_s or 0.5
        retry = min(30.0, max(0.1, (depth / self.max_batch) * per_batch))
        raise ServerOverloaded(depth, self.max_queue, retry)

    def queue_depth(self) -> int:
        """Requests accepted but not yet collected by the dispatcher."""
        return self._queue.qsize()

    def telemetry(self) -> dict:
        """``stats.snapshot()`` with the queue and backpressure gauges:
        what ``/stats`` and ``/metrics`` serve."""
        snap = self.stats.snapshot()
        snap["queue_depth"] = self.queue_depth()
        snap["max_queue"] = self.max_queue
        snap["service_s_ema"] = self._service_ema_s or 0.0
        return snap

    # -- dispatch side ----------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _collect(self, wait: bool = True, batch: Optional[list] = None):
        """Gather a batch: a list of queue items, [] if nothing is
        available, or None on the shutdown sentinel.

        ``wait=True`` (nothing pending): block for the first request, then
        drain until ``max_batch`` or the ``max_wait`` deadline.
        ``wait=False`` (a batch is pending): take what is queued now.
        ``batch``: top up these items instead of starting from a first
        request, until ``max_batch`` or until no request has arrived for
        ``max_wait``."""
        top_up = batch is not None
        if batch is None:
            try:
                first = self._queue.get(timeout=0.1 if wait else 0.0,
                                        block=wait)
            except queue.Empty:
                return []
            if first is None:  # shutdown sentinel
                return None
            batch = [first]
        deadline = time.perf_counter() + (self.max_wait_s if wait else 0.0)
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            try:
                item = self._queue.get(
                    timeout=max(remaining, 0.0) if remaining > 0 else None,
                    block=remaining > 0)
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # re-post for the outer loop
                break
            batch.append(item)
            if top_up:
                deadline = time.perf_counter() + self.max_wait_s
        return batch

    @staticmethod
    def _resolve(fut: Future, value=None, exc=None) -> None:
        """Resolve a future that its caller may have cancelled (an
        unguarded set_result would raise InvalidStateError and kill the
        dispatch thread for every other client)."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)
        except Exception:
            pass  # cancelled or already resolved: the caller moved on

    def _drain_failed(self, exc: Exception) -> None:
        """Fail every request still queued (shutdown)."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                self._resolve(item[1], exc=exc)

    def _launch(self, batch):
        """Pad and run one batch; return the pending record (with a CUDA
        event recorded after the launch), or None if the call failed (its
        futures already failed)."""
        payloads = [b[0] for b in batch]
        futures = [b[1] for b in batch]
        n = len(payloads)
        bucket = self._bucket_for(n)
        # Pad by repeating the last request: real values keep every padded
        # lane on the measured numeric path (an all-zeros frame or joint
        # set is a degenerate fit input).
        pad = [payloads[-1]] * (bucket - n)
        # The port's calls spend their time on the host, so a batch's
        # service time starts before the call (JAX's returns at once).
        t_launch = time.perf_counter()
        try:
            if self.fn == "fit_smpl":
                args = tuple(np.stack([p[i] for p in payloads + pad])
                             for i in range(2))
            else:
                args = (np.stack(payloads + pad),)
            res = getattr(self.estimator, self.fn)(
                *args, **self.fn_kwargs)
            if self.fields is not None:
                # Estimators return a NamedTuple; artifact-backed ones a
                # dict.
                res = {k: (res[k] if isinstance(res, dict)
                           else getattr(res, k))
                       for k in self.fields if k != "letterbox_affine"}
            event = None
            if self._cuda is not None:
                event = torch.cuda.Event()
                event.record()
            return {"res": res, "futures": futures, "event": event,
                    "host_s": time.perf_counter() - t_launch,
                    "t_enq": [b[2] for b in batch],
                    "affines": [b[3] for b in batch], "n": n,
                    "bucket": bucket, "t_launch": t_launch}
        except Exception as e:  # a failed call fails this batch only
            for fut in futures:
                self._resolve(fut, exc=e)
            return None

    def _ready(self, pending) -> bool:
        """Whether to finish the pending batch before the next launch: its
        event has fired, or fires within the host time its own launch
        took (the event is queried just after it was recorded, when the
        eager call's last kernels may still be running; waiting for them
        costs less than the launch it would delay). On the CPU, always."""
        ready = self.finish_ready_first
        event = pending["event"]
        if ready and event is not None:
            deadline = time.perf_counter() + pending["host_s"]
            while not event.query() and time.perf_counter() < deadline:
                time.sleep(2e-4)
            ready = event.query()
        self.pipeline_counts["finished_first" if ready
                             else "overlapped"] += 1
        return ready

    def _finish(self, pending) -> None:
        """Copy a pending batch's results to the host (one copy per field
        for the whole batch), map joints back to each request's source
        frame, and resolve its futures."""
        futures = pending["futures"]
        try:
            res = _map(_to_numpy, pending["res"])
            now = time.perf_counter()
            # A batch's service time (launch → results on the host), as an
            # EWMA for the Retry-After hint; the first batch seeds it.
            service = now - pending["t_launch"]
            self._service_ema_s = (
                service if self._service_ema_s is None
                else 0.8 * self._service_ema_s + 0.2 * service)
            want_affine = (self.fields is not None
                           and "letterbox_affine" in self.fields)
            ident = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
            for i, fut in enumerate(futures):
                out = _map(lambda x, i=i: x[i], res)
                a = pending["affines"][i]
                if a is not None:
                    src = lambda j: (j - a[2:4]) / a[0:2]  # noqa: E731
                    if isinstance(out, dict) and "joints2d" in out:
                        out["joints2d"] = src(out["joints2d"])
                    elif hasattr(out, "joints2d"):
                        out = out._replace(joints2d=src(out.joints2d))
                if want_affine and isinstance(out, dict):
                    out["letterbox_affine"] = ident if a is None else a
                self._resolve(fut, out)
            self.stats.record_batch(
                pending["n"], pending["bucket"] - pending["n"],
                [(now - t) * 1e3 for t in pending["t_enq"]])
        except Exception as e:  # reach every caller, keep serving
            for fut in futures:
                self._resolve(fut, exc=e)

    def _device_scope(self):
        if self._cuda is None:
            return contextlib.nullcontext()
        return torch.cuda.device(self._cuda)

    def _dispatch_loop(self):
        with self._device_scope(), torch.enable_grad():
            pending = None
            while True:
                batch = self._collect(wait=pending is None)
                if batch is None:
                    # Sentinel: finish the pending batch, then fail any
                    # submit that raced shutdown() and queued behind the
                    # sentinel, rather than leave its future pending.
                    if pending is not None:
                        self._finish(pending)
                    self._drain_failed(RuntimeError("server is shut down"))
                    return
                if pending is not None and (not batch
                                            or self._ready(pending)):
                    self._finish(pending)
                    pending = None
                    if batch:
                        # The finished batch's callers may answer with new
                        # requests, one after the other: let them join
                        # this batch, or a batch split once stays split,
                        # each half waiting out the other's launch.
                        batch = self._collect(batch=batch)
                inflight = self._launch(batch) if batch else None
                if pending is not None:
                    self._finish(pending)
                pending = inflight

    # -- lifecycle --------------------------------------------------------

    def shutdown(self, wait: bool = True):
        """Stop accepting requests; finish the queue, then stop."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        if wait:
            self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
