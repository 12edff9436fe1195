"""Host-side video-file IO on OpenCV (port of ``tpu_pose/utils/
videoio.py``; cv2 is imported when a file is opened).

Host only: the device path starts at the uint8 frame batch. Frames are
RGB uint8 everywhere in this package; the conversion from and to
OpenCV's BGR happens here and nowhere else.

Container support depends on the host's OpenCV build: MJPG ``.avi``
encodes and decodes with the bundled codecs everywhere; ``.mp4`` needs an
FFmpeg-enabled build (``VideoWriter.close`` detects a dead writer and
says so instead of leaving an unreadable file).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v", ".mpg",
              ".mpeg")


def is_video_path(path: str) -> bool:
    """True if ``path`` looks like a video file (by extension)."""
    return os.path.splitext(str(path))[1].lower() in VIDEO_EXTS


def _require_cv2():
    try:
        import cv2
        return cv2
    except ImportError as e:
        raise ImportError(
            "video-file IO needs OpenCV (cv2); install opencv-python or "
            "supply frames as .npy / image files instead") from e


def _open_capture(path: str):
    cv2 = _require_cv2()
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(
            f"OpenCV could not open {path!r} — unsupported container/"
            f"codec for this cv2 build? (MJPG .avi decodes everywhere; "
            f".mp4 needs an FFmpeg-enabled build)")
    return cap, cv2


def video_info(path: str) -> dict:
    """Container metadata: ``num_frames`` (0 when the container does not
    declare it), ``fps``, ``width``, ``height``."""
    cap, cv2 = _open_capture(path)
    try:
        return {
            "num_frames": max(int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), 0),
            "fps": float(cap.get(cv2.CAP_PROP_FPS)) or 0.0,
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        }
    finally:
        cap.release()


def iter_video(path: str, chunk: int, stride: int = 1,
               limit: int = 0) -> Iterator[np.ndarray]:
    """Stream a video file as ``(≤chunk, H, W, 3)`` RGB uint8 batches —
    bounded memory for arbitrarily long files; the natural feeder for
    ``api.VideoSession`` / ``api.MultiPersonVideoSession`` ``push()``.

    ``stride``: keep every stride-th frame. ``limit``: stop after this
    many KEPT frames (0 = all).
    """
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if stride <= 0:
        raise ValueError(f"stride must be positive, got {stride}")
    cap, cv2 = _open_capture(path)
    try:
        buf, kept, idx = [], 0, 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if idx % stride == 0:
                buf.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                kept += 1
                if len(buf) == chunk:
                    yield np.stack(buf)
                    buf = []
                if limit and kept >= limit:
                    break
            idx += 1
        if buf:
            yield np.stack(buf)
    finally:
        cap.release()


def read_video(path: str, stride: int = 1, limit: int = 0) -> np.ndarray:
    """Whole file → ``(T, H, W, 3)`` RGB uint8 (see :func:`iter_video`
    for the bounded-memory form). Raises on an empty/undecodable file."""
    chunks = list(iter_video(path, chunk=256, stride=stride, limit=limit))
    if not chunks:
        raise ValueError(f"no decodable frames in {path!r}")
    return np.concatenate(chunks) if len(chunks) > 1 else chunks[0]


class VideoWriter:
    """Incremental RGB video writer (for streaming pipelines that render
    window by window). Frame size is fixed by the first ``write``;
    ``close()`` verifies the file actually decodes — a cv2 writer with a
    missing codec silently emits a header-only file (observed for mp4v
    ``.mp4`` without FFmpeg). Default codec by extension: ``.avi`` →
    MJPG (every cv2 build), else mp4v."""

    def __init__(self, path: str, fps: float = 30.0,
                 fourcc: Optional[str] = None):
        self._cv2 = _require_cv2()
        self.path = path
        self.fps = float(fps)
        self.fourcc = fourcc or ("MJPG" if path.lower().endswith(".avi")
                                 else "mp4v")
        self._writer = None
        self._size = None
        self.frames_written = 0

    def write(self, frame: np.ndarray) -> None:
        frame = np.asarray(frame, np.uint8)
        if frame.ndim != 3 or frame.shape[-1] != 3:
            raise ValueError(f"frames must be (H, W, 3) RGB, got "
                             f"{frame.shape}")
        if self._writer is None:
            h, w = frame.shape[:2]
            self._size = (h, w)
            self._writer = self._cv2.VideoWriter(
                self.path, self._cv2.VideoWriter_fourcc(*self.fourcc),
                self.fps, (w, h))
        if frame.shape[:2] != self._size:
            raise ValueError(
                f"frame {self.frames_written} has shape {frame.shape}, "
                f"expected {self._size + (3,)} (video frames must "
                f"share one size)")
        self._writer.write(self._cv2.cvtColor(frame,
                                              self._cv2.COLOR_RGB2BGR))
        self.frames_written += 1

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None
            cap = self._cv2.VideoCapture(self.path)
            ok = (cap.isOpened()
                  and int(cap.get(self._cv2.CAP_PROP_FRAME_COUNT))
                  >= self.frames_written)
            cap.release()
            if not ok:
                raise ValueError(
                    f"cv2 wrote an unreadable file at {self.path!r} "
                    f"(codec {self.fourcc} unavailable in this "
                    f"build?) — use a .avi path (MJPG) instead")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_video(path: str, frames, fps: float = 30.0,
                fourcc: Optional[str] = None) -> None:
    """Write RGB uint8 frames (iterable of (H, W, 3) or one (T, H, W, 3)
    array) to ``path`` — the one-shot form of :class:`VideoWriter`."""
    n = 0
    with VideoWriter(path, fps=fps, fourcc=fourcc) as w:
        for fr in frames:
            w.write(fr)
            n += 1
    if n == 0:
        raise ValueError("write_video got zero frames")
