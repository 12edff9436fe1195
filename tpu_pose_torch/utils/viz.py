"""Visualization and export helpers (port of ``tpu_pose/utils/viz.py``,
numpy only; PIL is imported when an image is saved).

Host side, off the device path: 2D skeleton drawing on a numpy canvas,
mesh export as Wavefront OBJ, a z-buffered mesh render, heatmap tiling.
Pass arrays on the host (``tensor.cpu().numpy()``).
"""

from __future__ import annotations

import numpy as np

# CPM-14 limb connectivity (pairs of joint indices, models/joints.py order).
CPM_LIMBS = (
    (0, 1),                      # head-neck
    (1, 2), (2, 3), (3, 4),      # right arm
    (1, 5), (5, 6), (6, 7),      # left arm
    (1, 8), (8, 9), (9, 10),     # right leg (via torso)
    (1, 11), (11, 12), (12, 13)  # left leg
)


def draw_skeleton(image: np.ndarray, joints_px: np.ndarray,
                  conf: np.ndarray | None = None,
                  conf_threshold: float = 0.2,
                  radius: int = 4) -> np.ndarray:
    """Rasterize joints + limbs onto a copy of ``image`` (H, W, 3) uint8."""
    img = np.array(image, copy=True)
    h, w = img.shape[:2]
    joints = np.asarray(joints_px)
    ok = (np.asarray(conf) >= conf_threshold if conf is not None
          else np.ones(len(joints), bool))

    def clip(v, lo, hi):
        return int(max(lo, min(hi, v)))

    for a, b in CPM_LIMBS:
        if not (ok[a] and ok[b]):
            continue
        xa, ya, xb, yb = *joints[a], *joints[b]
        n = int(max(abs(xb - xa), abs(yb - ya), 1))
        for t in range(n + 1):
            x = clip(xa + (xb - xa) * t / n, 0, w - 1)
            y = clip(ya + (yb - ya) * t / n, 0, h - 1)
            img[y, x] = (0, 255, 0)
    for j, (x, y) in enumerate(joints):
        if not ok[j]:
            continue
        y0, y1 = clip(y - radius, 0, h - 1), clip(y + radius, 0, h - 1)
        x0, x1 = clip(x - radius, 0, w - 1), clip(x + radius, 0, w - 1)
        img[y0:y1 + 1, x0:x1 + 1] = (255, 0, 0)
    return img


def export_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Write the fitted SMPL mesh as Wavefront OBJ (1-indexed faces)."""
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces:
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


save_obj = export_obj  # script-facing alias


def project_vertices_weak_perspective(vertices: np.ndarray,
                                      cam: np.ndarray,
                                      img_size: int) -> np.ndarray:
    """Fitted-mesh vertices (V,3) + weak-perspective cam (s, tx, ty) →
    (V,2) pixel coords, matching models/camera.py's normalized frame."""
    v = np.asarray(vertices)
    s, tx, ty = np.asarray(cam)
    norm = s * v[:, :2] + np.array([tx, ty])  # [-1, 1] frame
    return (norm + 1.0) * (img_size / 2.0)


def draw_mesh_overlay(image: np.ndarray, vertices_px: np.ndarray,
                      color=(120, 200, 255), alpha: float = 0.6
                      ) -> np.ndarray:
    """Splat projected mesh vertices onto the image: the cheap form when
    no faces are available; :func:`rasterize_mesh` is the real render."""
    img = np.array(image, copy=True)
    h, w = img.shape[:2]
    pts = np.asarray(vertices_px)
    xs = np.clip(pts[:, 0].astype(np.int64), 0, w - 1)
    ys = np.clip(pts[:, 1].astype(np.int64), 0, h - 1)
    blended = (img[ys, xs].astype(np.float32) * (1 - alpha)
               + np.asarray(color, np.float32) * alpha)
    img[ys, xs] = blended.astype(img.dtype)
    return img


def rasterize_mesh(image: np.ndarray, vertices_px: np.ndarray,
                   depth: np.ndarray, faces: np.ndarray,
                   vertices3d: np.ndarray | None = None,
                   color=(120, 200, 255), alpha: float = 0.85
                   ) -> np.ndarray:
    """Z-buffered triangle rasterization of the fitted mesh onto an image
    (a hidden-surface render, not a vertex splat).

    Host-side numpy (viz is off the device path): per-face
    bounding-box barycentric fill against a float z-buffer, with flat
    Lambertian shading from camera-space face normals when ``vertices3d``
    is given. Convention: camera looks down +z, so SMALLER depth wins.

    Args:
      image: (H, W, 3) uint8 background.
      vertices_px: (V, 2) projected vertex pixels in image coords.
      depth: (V,) camera-space per-vertex depth (smaller = closer).
      faces: (F, 3) int vertex indices.
      vertices3d: optional (V, 3) camera-space vertices for shading.
    Returns a blended uint8 copy.
    """
    img = np.asarray(image, np.float32).copy()
    h, w = img.shape[:2]
    v = np.asarray(vertices_px, np.float64)
    z = np.asarray(depth, np.float64)
    f = np.asarray(faces, np.int64)

    if vertices3d is not None:
        p = np.asarray(vertices3d, np.float64)[f]        # (F, 3, 3)
        n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        nz = np.abs(n[:, 2]) / (np.linalg.norm(n, axis=1) + 1e-12)
        face_shade = 0.35 + 0.65 * nz                    # headlight Lambert
    else:
        face_shade = np.ones(len(f))

    zbuf = np.full((h, w), np.inf, np.float64)
    shade = np.zeros((h, w), np.float32)
    covered = np.zeros((h, w), bool)

    tri = v[f]                                           # (F, 3, 2)
    tz = z[f]                                            # (F, 3)
    # Skip faces fully off-screen up front (cheap vectorized cull).
    xmin = np.floor(tri[..., 0].min(1)).astype(np.int64)
    xmax = np.ceil(tri[..., 0].max(1)).astype(np.int64)
    ymin = np.floor(tri[..., 1].min(1)).astype(np.int64)
    ymax = np.ceil(tri[..., 1].max(1)).astype(np.int64)
    live = (xmax >= 0) & (xmin < w) & (ymax >= 0) & (ymin < h)

    for i in np.nonzero(live)[0]:
        x0, x1 = max(xmin[i], 0), min(xmax[i], w - 1)
        y0, y1 = max(ymin[i], 0), min(ymax[i], h - 1)
        (ax, ay), (bx, by), (cx, cy) = tri[i]
        den = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
        if abs(den) < 1e-12:
            continue  # degenerate (edge-on) face
        gy, gx = np.mgrid[y0:y1 + 1, x0:x1 + 1]
        l0 = ((by - cy) * (gx - cx) + (cx - bx) * (gy - cy)) / den
        l1 = ((cy - ay) * (gx - cx) + (ax - cx) * (gy - cy)) / den
        l2 = 1.0 - l0 - l1
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        if not inside.any():
            continue
        zpix = l0 * tz[i, 0] + l1 * tz[i, 1] + l2 * tz[i, 2]
        sub = (slice(y0, y1 + 1), slice(x0, x1 + 1))
        closer = inside & (zpix < zbuf[sub])
        zbuf[sub][closer] = zpix[closer]
        shade[sub][closer] = face_shade[i]
        covered[sub][closer] = True

    col = np.asarray(color, np.float32)
    img[covered] = ((1.0 - alpha) * img[covered]
                    + alpha * shade[covered, None] * col[None, :])
    return np.clip(img, 0, 255).astype(np.uint8)


def save_mesh_overlay(path: str, image: np.ndarray, vertices: np.ndarray,
                      cam: np.ndarray, img_size: int,
                      faces: np.ndarray | None = None,
                      affine: np.ndarray | None = None) -> None:
    """Occlusion-correct mesh overlay (weak-perspective camera).

    ``affine``: optional letterbox affine (``ops/preprocess.letterbox_affine``)
    mapping source→network pixels; when given, network-frame projections
    are mapped back through its inverse instead of a plain rescale."""
    pts = project_vertices_weak_perspective(vertices, cam, img_size)
    hh, ww = np.asarray(image).shape[:2]
    if affine is not None:
        a = np.asarray(affine, np.float64)
        pts = (pts - a[2:4]) / a[0:2]
    else:  # rescale from the network frame to this image's resolution
        pts = pts * np.array([ww / img_size, hh / img_size])
    if faces is None:
        save_image(path, draw_mesh_overlay(image, pts))
    else:
        v3 = np.asarray(vertices)
        save_image(path, rasterize_mesh(image, pts, v3[:, 2], faces,
                                        vertices3d=v3))


def save_image(path: str, image: np.ndarray) -> None:
    """PNG via PIL when available; falls back to .npy next to ``path``."""
    try:
        from PIL import Image
        Image.fromarray(np.asarray(image)).save(path)
    except ImportError:  # no PIL on this host
        np.save(path + ".npy", np.asarray(image))


def save_skeleton_overlay(path: str, image: np.ndarray,
                          joints_px: np.ndarray,
                          conf: np.ndarray | None = None) -> None:
    save_image(path, draw_skeleton(image, joints_px, conf))


def tile_heatmaps(heatmaps: np.ndarray, cols: int = 5) -> np.ndarray:
    """(H, W, C) belief maps → one uint8 grayscale contact sheet."""
    hm = np.asarray(heatmaps)
    h, w, c = hm.shape
    rows = -(-c // cols)
    sheet = np.zeros((rows * h, cols * w), np.float32)
    for i in range(c):
        r, cc = divmod(i, cols)
        sheet[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = hm[..., i]
    lo, hi = sheet.min(), sheet.max()
    return ((sheet - lo) / (hi - lo + 1e-8) * 255).astype(np.uint8)
