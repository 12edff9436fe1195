"""Hard synthetic benchmark (port of ``tpu_pose/data/synthetic_hard.py``):
mesh-rendered people on cluttered frames.

The easy set (``data/synthetic.py``) paints one Gaussian blob per joint
with the joint encoded in its colour. This module renders the synthetic
SMPL body itself:

- **Body render**: painter's-algorithm splatting of the posed vertex
  cloud (far to near, so a body occludes itself), depth-cue shading,
  per-vertex static texture noise and per-frame random clothing colours
  by region (regions are groups of dominant LBS joints);
- **Scale and offset jitter**: person extent uniform in ``scale_range``
  of half the frame, the center uniform within the in-frame margin;
- **Backgrounds**: smooth low-frequency colour fields with clutter
  (rectangles and Gaussian blobs, some skin-toned);
- **Occlusion**: with probability ``occlusion_prob`` a rectangle drawn
  over the person (per-joint visibility recorded; the heatmap targets
  keep occluded joints);
- **Several people**: k bodies composited far to near, distractor people
  behind or in front of the target, tracked crossing and enter/leave
  videos.

Host numpy. The draws are numpy ``RandomState``s in the JAX package's
order, so θ, β and every random choice are bit-identical to its. The SMPL
joints and vertices come from the port's ``smpl_forward_batch`` on the
CPU in float32 (a model on another device is copied to the CPU first),
where the JAX package runs its jitted forward: labels agree to float32
rounding, and a splat whose rounded pixel or depth order sits on an edge
can land one pixel over.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from tpu_pose_torch.data import synthetic
from tpu_pose_torch.models import joints as joints_lib
from tpu_pose_torch.models import smpl as smpl_lib
from tpu_pose_torch.ops import preprocess as pre
from tpu_pose_torch.utils.config import CPMConfig

# Clothing-region grouping of the 24 SMPL joints: shirts cover the torso
# and arm chain, pants the legs, skin the head, hands and feet. Region
# colours redraw every frame.
_REGION_OF_JOINT = np.array([
    1,           # 0 pelvis → pants
    1, 1,        # 1,2 hips
    0,           # 3 spine1
    1, 1,        # 4,5 knees
    0,           # 6 spine2
    1, 1,        # 7,8 ankles
    0,           # 9 spine3
    2, 2,        # 10,11 feet → skin
    0,           # 12 neck
    0, 0,        # 13,14 collars
    2,           # 15 head → skin
    0, 0,        # 16,17 shoulders
    0, 0,        # 18,19 elbows
    2, 2,        # 20,21 wrists → skin
    2, 2,        # 22,23 hands
], np.int64)


def _host_model(model):
    return model if model.device.type == "cpu" else model.to("cpu")


def _smpl_np(model, theta: np.ndarray, beta: np.ndarray):
    """(joints (n, 24, 3), vertices (n, V, 3)) of the batched SMPL forward
    on the CPU in float32 (the joints are ``synthetic._smpl_joints_np``'s:
    the same forward)."""
    with torch.no_grad():
        out = smpl_lib.smpl_forward_batch(
            _host_model(model),
            torch.from_numpy(np.ascontiguousarray(beta, np.float32)),
            torch.from_numpy(np.ascontiguousarray(theta, np.float32)))
    return out.joints.numpy(), out.vertices.numpy()


def _vertex_regions(model) -> np.ndarray:
    """(V,) region id per vertex: the region of its dominant LBS joint."""
    w = model.weights.detach().cpu().numpy()
    dom = np.argmax(w, axis=1)
    table = _REGION_OF_JOINT
    if len(table) < w.shape[1]:  # small test models
        table = np.resize(table, w.shape[1])
    return table[dom]


def random_background(rng: np.random.RandomState, size: int,
                      clutter: int = 6) -> np.ndarray:
    """(size, size, 3) float in [0, 1]: a low-frequency colour field and
    ``clutter`` rectangles or Gaussian blobs (some skin-toned)."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.empty((size, size, 3), np.float32)
    for c in range(3):
        fx, fy = rng.uniform(0.5, 3.0, 2)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        base = rng.uniform(0.15, 0.75)
        amp = rng.uniform(0.05, 0.25)
        img[..., c] = base + amp * np.sin(2 * np.pi * fx * xs + px) \
            * np.cos(2 * np.pi * fy * ys + py)
    for _ in range(clutter):
        color = (_random_skin(rng) if rng.rand() < 0.3
                 else rng.uniform(0.05, 0.95, 3))
        if rng.rand() < 0.5:  # rectangle
            w = rng.randint(size // 12, size // 3)
            h = rng.randint(size // 12, size // 3)
            x0 = rng.randint(0, size - w)
            y0 = rng.randint(0, size - h)
            a = rng.uniform(0.5, 1.0)
            img[y0:y0 + h, x0:x0 + w] = (
                (1 - a) * img[y0:y0 + h, x0:x0 + w] + a * color)
        else:  # Gaussian blob, a heatmap-like decoy
            cx, cy = rng.uniform(0, size, 2)
            sig = rng.uniform(size / 40, size / 10)
            g = np.exp(-((xs * size - cx) ** 2 + (ys * size - cy) ** 2)
                       / (2 * sig * sig))
            img += g[..., None] * (color - img) * rng.uniform(0.4, 0.9)
    return np.clip(img, 0.0, 1.0)


def _random_skin(rng) -> np.ndarray:
    t = rng.uniform(0.35, 0.85)
    return np.array([t, t * rng.uniform(0.68, 0.82),
                     t * rng.uniform(0.5, 0.66)], np.float32)


def _region_colors(rng) -> np.ndarray:
    """(3 regions, 3) per-frame clothing colours: shirt, pants, skin."""
    return np.stack([rng.uniform(0.1, 0.95, 3),
                     rng.uniform(0.05, 0.8, 3),
                     _random_skin(rng)]).astype(np.float32)


def splat_person(img: np.ndarray, verts_px: np.ndarray, depth: np.ndarray,
                 vert_colors: np.ndarray, radius: int) -> np.ndarray:
    """Painter's-algorithm vertex splatting: vertices sorted far to near,
    round splats of ``radius`` written by numpy fancy assignment
    (duplicate indices keep the last write, the nearest vertex). Modifies
    ``img`` ([0, 1] float32) in place; returns the coverage mask."""
    size = img.shape[0]
    order = np.argsort(-depth, kind="stable")        # far first
    xs = np.round(verts_px[order, 0]).astype(np.int64)
    ys = np.round(verts_px[order, 1]).astype(np.int64)
    cols = vert_colors[order]
    mask = np.zeros(img.shape[:2], bool)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx * dx + dy * dy > radius * radius + 0.5:
                continue
            x = np.clip(xs + dx, 0, size - 1)
            y = np.clip(ys + dy, 0, size - 1)
            ok = ((xs + dx >= 0) & (xs + dx < size)
                  & (ys + dy >= 0) & (ys + dy < size))
            img[y[ok], x[ok]] = cols[ok]
            mask[y[ok], x[ok]] = True
    return mask


def _occlude(rng, img: np.ndarray, center_px: np.ndarray,
             extent_px: float) -> Tuple[np.ndarray, np.ndarray]:
    """One random occluder rectangle over the person region. Returns its
    (x0, y0) and (x1, y1) in pixels."""
    size = img.shape[0]
    w = int(extent_px * rng.uniform(0.25, 0.55))
    h = int(extent_px * rng.uniform(0.25, 0.55))
    cx = center_px[0] + extent_px * rng.uniform(-0.6, 0.6)
    cy = center_px[1] + extent_px * rng.uniform(-0.6, 0.6)
    x0 = int(np.clip(cx - w / 2, 0, size - 2))
    y0 = int(np.clip(cy - h / 2, 0, size - 2))
    x1 = int(np.clip(x0 + w, x0 + 1, size - 1))
    y1 = int(np.clip(y0 + h, y0 + 1, size - 1))
    img[y0:y1, x0:x1] = rng.uniform(0.05, 0.95, 3)
    return np.array([x0, y0], np.float32), np.array([x1, y1], np.float32)


class _BodyCache:
    """Per-model render constants (vertex regions, static texture)."""

    def __init__(self, model, seed: int = 0):
        rng = np.random.RandomState(seed + 12345)
        self.regions = _vertex_regions(model)
        self.weights = model.weights.detach().cpu().numpy().astype(
            np.float32)
        n_verts = model.v_template.shape[0]
        self.texture = rng.uniform(0.85, 1.15, (n_verts, 1)).astype(
            np.float32)


def render_person(img: np.ndarray, rng: np.random.RandomState,
                  cache: _BodyCache, verts3d: np.ndarray,
                  joints3d: np.ndarray,
                  center3d: np.ndarray, scale_px: float,
                  center_px: np.ndarray,
                  contract: float = 0.35) -> np.ndarray:
    """Render one posed body into ``img`` in place; returns its coverage
    mask (used to mark the target's joints a foreground distractor covers
    as occluded).

    verts3d: (V, 3) posed SMPL vertices (+z away from the camera). The
    x/y mapping is the joint projection of :func:`make_hard_examples`:
    px = (v − center3d) · scale_px + center_px.

    ``contract`` pulls each vertex toward its LBS-weighted joint position
    before splatting: the synthetic model's template is a broad ellipsoid
    whose spread dwarfs the skeleton, so raw it renders as a haze; pulled
    in, the mass forms limb-localized clusters that follow the pose (with
    a real SMPL file, 1.0 renders the true surface)."""
    jw = cache.weights @ joints3d                     # (V, 3) bone anchor
    verts3d = jw + (verts3d - jw) * contract
    v = (verts3d - center3d) * scale_px
    px = v[:, :2] + center_px
    z = v[:, 2]
    # Depth-cue shading (nearer is brighter).
    zr = z.max() - z.min() + 1e-6
    shade = (0.55 + 0.45 * (z.max() - z) / zr)[:, None] * cache.texture
    colors = _region_colors(rng)[cache.regions] * shade
    colors = np.clip(colors, 0.0, 1.0)
    radius = max(1, int(round(scale_px / 80.0)))
    return splat_person(img, px, z, colors, radius)


def make_hard_examples(model, n: int, cfg: CPMConfig = CPMConfig(),
                       seed: int = 0,
                       scale_range: Tuple[float, float] = (0.45, 0.95),
                       occlusion_prob: float = 0.4,
                       clutter: int = 6,
                       heatmap_sigma: float = 3.0,
                       theta: np.ndarray | None = None,
                       beta: np.ndarray | None = None,
                       flip_prob: float = 0.0,
                       truncation: float = 0.0,
                       distractor_prob: float = 0.0,
                       max_distractors: int = 1,
                       union_stage1: bool = False
                       ) -> Dict[str, np.ndarray]:
    """n hard frames: the ``data/synthetic.py`` example schema and
    ``centers`` (n, 2) person center px, ``scales`` (n,) person extent as
    a fraction of half the frame, ``visibility`` (n, 14), 0 where an
    occluder covers the joint. The 14 CPM joints' centered extent maps to
    ``scale·(size/2)`` px around ``center`` (the easy set is scale 0.8 at
    the frame center).

    ``flip_prob``: probability of mirroring an example (columns reversed,
    x → size−1−x, left and right joints swapped by
    ``joints.CPM_FLIP_PERM``, heatmaps painted after the flip).

    ``truncation``: lets the center offset push the person up to this
    fraction of its own extent past the frame edge; joints outside the
    frame are marked invisible.

    ``distractor_prob``: probability of rendering non-target bodies too
    (random pose and scale, placed away from the target, each in front of
    or behind it; a foreground one marks the target joints it covers as
    occluded). Center, heatmaps and joints stay the target's. Distractor
    randomness comes from a separate stream, so every frame's target
    content equals the ``distractor_prob=0`` set's. Extra keys:
    ``has_distractor`` (n,) 0/1, ``num_distractors`` (n,) and
    ``distractor_centers`` (n, 2), NaN where absent.

    ``max_distractors`` > 1: a triggered frame renders 1..max_distractors
    bodies (the count drawn from the distractor stream).

    ``union_stage1``: also return ``heatmaps_stage1``, whose joint
    channels are the pointwise max over the target and every rendered
    distractor (stage 1 sees only the image, so it is taught to find
    everyone; the center-hinted stages keep target-only targets). Feed it
    to ``cpm_train.stage_supervision_loss(stage1_heatmaps=...)``."""
    rng = np.random.RandomState(seed)
    if theta is None:
        theta, beta = synthetic.sample_poses(rng, n)
    j3d, verts = _smpl_np(model, theta, beta)
    j3d14 = j3d[:, joints_lib.CPM_TO_SMPL]

    rng_d = np.random.RandomState(seed * 31 + 555777)
    has_distractor = np.zeros((n,), np.float32)
    num_distractors = np.zeros((n,), np.int64)
    distractor_centers = np.full((n, 2), np.nan, np.float32)
    d_sets = []
    if distractor_prob > 0.0:
        # One pose set per distractor slot, all drawn up front, so the
        # per-frame draws do not depend on the frame's position.
        for _ in range(max(1, max_distractors)):
            theta_d, beta_d = synthetic.sample_poses(rng_d, n)
            d_sets.append(_smpl_np(model, theta_d, beta_d))

    size = cfg.input_size
    cache = _BodyCache(model)
    images = np.zeros((n, size, size, 3), np.uint8)
    heatmaps = np.zeros((n, size // cfg.stride, size // cfg.stride,
                         cfg.num_joints + 1), np.float32)
    heatmaps_s1 = (np.zeros_like(heatmaps) if union_stage1 else None)
    joints2d = np.zeros((n, 14, 2), np.float32)
    centers = np.zeros((n, 2), np.float32)
    scales = np.zeros((n,), np.float32)
    visibility = np.ones((n, 14), np.float32)

    for i in range(n):
        c3d = j3d14[i].mean(0)
        extent = np.abs(j3d14[i] - c3d).max()
        s_frac = rng.uniform(*scale_range)
        scale_px = s_frac * (size / 2.0) / max(extent, 1e-3)
        margin = (max(0.0, (0.98 - s_frac)) * (size / 2.0)
                  + truncation * s_frac * (size / 2.0))
        center_px = (size / 2.0
                     + rng.uniform(-margin, margin, 2)).astype(np.float32)

        img = random_background(rng, size, clutter=clutter)

        d_renders = []
        d_px = []
        if distractor_prob > 0.0 and rng_d.rand() < distractor_prob:
            nd = (1 if max_distractors <= 1
                  else int(rng_d.randint(1, max_distractors + 1)))
            placed = [(center_px, s_frac)]
            for di in range(nd):
                j3d_d, verts_d = d_sets[di]
                j14_d = j3d_d[i][joints_lib.CPM_TO_SMPL]
                c3d_d = j14_d.mean(0)
                ext_d = np.abs(j14_d - c3d_d).max()
                sf_d = rng_d.uniform(*scale_range)
                scale_px_d = sf_d * (size / 2.0) / max(ext_d, 1e-3)
                # Away from the target and earlier distractors: at least
                # 0.55 × the summed extents apart (partial overlap is the
                # hard case), else the least crowded candidate.
                cands = rng_d.uniform(0.08 * size, 0.92 * size, (20, 2))
                margin = np.min(np.stack([
                    np.linalg.norm(cands - pc[None], axis=1)
                    - 0.55 * (ps + sf_d) * (size / 2.0)
                    for pc, ps in placed]), axis=0)
                ok = np.nonzero(margin >= 0.0)[0]
                c_d = (cands[ok[0]] if len(ok)
                       else cands[np.argmax(margin)]).astype(np.float32)
                in_front = rng_d.rand() < 0.5
                d_renders.append((verts_d[i], j3d_d[i], c3d_d, scale_px_d,
                                  c_d, in_front))
                d_px.append((j14_d - c3d_d)[:, :2] * scale_px_d + c_d)
                placed.append((c_d, sf_d))
            has_distractor[i] = 1.0
            num_distractors[i] = nd
            distractor_centers[i] = d_renders[0][4]
            for dr in d_renders:
                if not dr[5]:                       # behind the target
                    render_person(img, rng_d, cache, *dr[:5])

        render_person(img, rng, cache, verts[i], j3d[i], c3d, scale_px,
                      center_px)

        px = (j3d14[i] - c3d)[:, :2] * scale_px + center_px
        visibility[i, ((px < 0.0) | (px > size - 1.0)).any(axis=1)] = 0.0

        for dr in d_renders:
            if dr[5]:                               # in front
                d_mask = render_person(img, rng_d, cache, *dr[:5])
                xi = np.clip(np.round(px[:, 0]), 0,
                             size - 1).astype(np.int64)
                yi = np.clip(np.round(px[:, 1]), 0,
                             size - 1).astype(np.int64)
                visibility[i, d_mask[yi, xi]] = 0.0  # covered → occluded

        if rng.rand() < occlusion_prob:
            extent_px = s_frac * (size / 2.0)
            lo, hi = _occlude(rng, img, center_px, extent_px)
            inside = ((px >= lo) & (px <= hi)).all(axis=1)
            visibility[i, inside] = 0.0

        if flip_prob > 0.0 and rng.rand() < flip_prob:
            img = img[:, ::-1]
            px = px[joints_lib.CPM_FLIP_PERM]
            px[:, 0] = size - 1.0 - px[:, 0]
            visibility[i] = visibility[i][joints_lib.CPM_FLIP_PERM]
            center_px = np.array(
                [size - 1.0 - center_px[0], center_px[1]], np.float32)
            if has_distractor[i]:
                distractor_centers[i, 0] = (size - 1.0
                                            - distractor_centers[i, 0])
                d_px = [p[joints_lib.CPM_FLIP_PERM] for p in d_px]
                for p in d_px:
                    p[:, 0] = size - 1.0 - p[:, 0]

        images[i] = (img * 255).astype(np.uint8)
        joints2d[i] = px
        centers[i] = center_px
        scales[i] = s_frac
        heatmaps[i] = synthetic.gaussian_heatmaps(px, size, cfg.stride,
                                                  heatmap_sigma)
        if union_stage1:
            hm_u = heatmaps[i].copy()
            for p in d_px:
                hm_d = synthetic.gaussian_heatmaps(p, size, cfg.stride,
                                                   heatmap_sigma)
                hm_u[..., :-1] = np.maximum(hm_u[..., :-1],
                                            hm_d[..., :-1])
            hm_u[..., -1] = 1.0 - hm_u[..., :-1].max(-1)
            heatmaps_s1[i] = hm_u
    out = {
        "images": images, "heatmaps": heatmaps, "joints2d": joints2d,
        "gt_joints3d": j3d.astype(np.float32),
        "theta": theta, "beta": beta,
        "centers": centers, "scales": scales, "visibility": visibility,
    }
    if distractor_prob > 0.0:
        out["has_distractor"] = has_distractor
        out["num_distractors"] = num_distractors
        out["distractor_centers"] = distractor_centers
    if union_stage1:
        out["heatmaps_stage1"] = heatmaps_s1
    return out


def make_hard_multi_examples(model, n: int, cfg: CPMConfig = CPMConfig(),
                             seed: int = 0,
                             scale_range: Tuple[float, float] = (0.4, 0.55),
                             clutter: int = 4,
                             num_people: int = 2) -> Dict[str, np.ndarray]:
    """k-person hard frames for per-person 3D accuracy: ``num_people``
    bodies at separated centers with jitter, composited far to near in a
    random depth order (the nearer person occludes).

    Returns images (n, S, S, 3) uint8 and per-person ground truth on axis
    1: joints2d (n, k, 14, 2), gt_joints3d (n, k, 24, 3), centers
    (n, k, 2), theta (n, k, 72), beta (n, k, 10)."""
    k = num_people
    rng = np.random.RandomState(seed)
    parts = [synthetic.sample_poses(rng, n) for _ in range(k)]
    theta = np.concatenate([t for t, _ in parts])
    beta = np.concatenate([b for _, b in parts])
    j3d, verts = _smpl_np(model, theta, beta)

    size = cfg.input_size
    xfracs = ((0.28, 0.72) if k == 2
              else tuple(np.linspace(0.16, 0.84, k)))
    cache = _BodyCache(model)
    images = np.zeros((n, size, size, 3), np.uint8)
    joints2d = np.zeros((n, k, 14, 2), np.float32)
    centers = np.zeros((n, k, 2), np.float32)

    for i in range(n):
        img = random_background(rng, size, clutter=clutter)
        # Spread placement with jitter; random depth order (far first).
        if k == 2:
            order = [0, 1] if rng.rand() < 0.5 else [1, 0]
        else:
            order = rng.permutation(k)
        for slot in order:
            idx = i + slot * n
            j14 = j3d[idx][joints_lib.CPM_TO_SMPL]
            c3d = j14.mean(0)
            extent = np.abs(j14 - c3d).max()
            s_frac = rng.uniform(*scale_range)
            scale_px = s_frac * (size / 2.0) / max(extent, 1e-3)
            cx = size * xfracs[slot] + rng.uniform(-0.05, 0.05) * size
            cy = size * 0.5 + rng.uniform(-0.1, 0.1) * size
            center_px = np.array([cx, cy], np.float32)
            render_person(img, rng, cache, verts[idx], j3d[idx], c3d,
                          scale_px, center_px)
            joints2d[i, slot] = (j14 - c3d)[:, :2] * scale_px + center_px
            centers[i, slot] = center_px
        images[i] = (img * 255).astype(np.uint8)

    def stack_k(a):
        return np.stack([a[p * n:(p + 1) * n] for p in range(k)], axis=1)

    return {
        "images": images, "joints2d": joints2d, "centers": centers,
        "gt_joints3d": stack_k(j3d).astype(np.float32),
        "theta": stack_k(theta), "beta": stack_k(beta),
    }


def _keyframe_poses(rng, num_frames: int, people: int,
                    keyframe_every: int):
    """Per person a smooth pose sequence (keyframes joined by a cosine
    ease, as ``synthetic.make_video_examples``) and one body shape:
    theta (T, people, 72), beta (T, people, 10)."""
    t_idx = np.arange(num_frames, dtype=np.float64)
    n_keys = max(2, num_frames // keyframe_every + 2)
    theta = np.zeros((num_frames, people, 72), np.float32)
    beta = np.zeros((num_frames, people, 10), np.float32)
    for p in range(people):
        k_theta, k_beta = synthetic.sample_poses(rng, n_keys)
        t = t_idx / keyframe_every
        i0 = np.minimum(t.astype(np.int64), n_keys - 2)
        w = (1.0 - np.cos(np.pi * (t - i0))) / 2.0
        theta[:, p] = ((1.0 - w)[:, None] * k_theta[i0]
                       + w[:, None] * k_theta[i0 + 1])
        beta[:, p] = k_beta[0]
    return theta, beta


def make_hard_multi_video(model, num_frames: int,
                          cfg: CPMConfig = CPMConfig(), seed: int = 0,
                          scale_range: Tuple[float, float] = (0.4, 0.55),
                          clutter: int = 4, crossing: bool = True,
                          keyframe_every: int = 8,
                          num_people: int = 2,
                          x_span: float = 0.0) -> Dict[str, np.ndarray]:
    """k-person hard video for the track-association benchmark
    (``api.estimate_and_fit_video_multi``, ``fitting/tracking.py``).

    Each person gets a smooth pose sequence and a linear center path; with
    ``crossing`` person p walks from slot p to slot k−1−p, so every pair
    swaps sides mid-sequence, the nearer person (lower index, rendered
    last) occluding the farther, and a center-only association would swap
    identities. One static background per sequence, no occluders. Each
    person's clothing colours are constant over frames and distinct
    between people (render stream seeded per person).

    ``x_span`` > 0 sets the horizontal start spread: people start at
    ``linspace(0.5 − x_span/2, 0.5 + x_span/2, k)`` of the frame width
    (the default layout puts k = 4 people 69 px apart, inside the 96 px
    NMS radius). 0 keeps the default layout.

    Returns images (T, S, S, 3) uint8 and ground truth in person-identity
    order on axis 1: joints2d (T, k, 14, 2), gt_joints3d (T, k, 24, 3),
    centers (T, k, 2), theta (T, k, 72), beta (T, k, 10)."""
    k = num_people
    rng = np.random.RandomState(seed)
    size = cfg.input_size
    t_idx = np.arange(num_frames, dtype=np.float64)
    theta, beta = _keyframe_poses(rng, num_frames, k, keyframe_every)
    j3d, verts = _smpl_np(model, theta.reshape(num_frames * k, 72),
                          beta.reshape(num_frames * k, 10))
    j3d = j3d.reshape(num_frames, k, -1, 3)
    verts = verts.reshape(num_frames, k, -1, 3)

    u = t_idx / max(num_frames - 1, 1)                 # 0 → 1
    if x_span > 0:
        pos = np.linspace(0.5 - x_span / 2.0, 0.5 + x_span / 2.0, k)
    else:
        pos = np.array((0.28, 0.72) if k == 2
                       else np.linspace(0.22, 0.78, k))
    xs_path = []
    for p in range(k):
        x_from, x_to = pos[p], (pos[k - 1 - p] if crossing else pos[p])
        xs_path.append(x_from + (x_to - x_from) * u)
    ys_path = [0.5 + 0.06 * np.sin(2 * np.pi * u + rng.uniform(0, 6.3))
               for _ in range(k)]
    cx = np.stack(xs_path, 1) * size                   # (T, k)
    cy = np.stack(ys_path, 1) * size
    s_frac = rng.uniform(*scale_range, size=k)

    cache = _BodyCache(model)
    background = random_background(rng, size, clutter=clutter)
    images = np.zeros((num_frames, size, size, 3), np.uint8)
    joints2d = np.zeros((num_frames, k, 14, 2), np.float32)
    centers = np.zeros((num_frames, k, 2), np.float32)
    for i in range(num_frames):
        img = background.copy()
        for p in range(k - 1, -1, -1):                 # far (k−1) first
            j14 = j3d[i, p][joints_lib.CPM_TO_SMPL]
            c3d = j14.mean(0)
            extent = np.abs(j14 - c3d).max()
            scale_px = s_frac[p] * (size / 2.0) / max(extent, 1e-3)
            center_px = np.array([cx[i, p], cy[i, p]], np.float32)
            render_person(img, np.random.RandomState(seed + 7 * p),
                          cache, verts[i, p], j3d[i, p], c3d, scale_px,
                          center_px)
            joints2d[i, p] = (j14 - c3d)[:, :2] * scale_px + center_px
            centers[i, p] = center_px
        images[i] = (img * 255).astype(np.uint8)

    return {
        "images": images, "joints2d": joints2d, "centers": centers,
        "gt_joints3d": j3d.astype(np.float32),
        "theta": theta, "beta": beta,
    }


def hard_train_batches(model, batch_size: int, num_batches: int,
                       cfg: CPMConfig = CPMConfig(), seed: int = 0,
                       raw_images: bool = False,
                       scale_range: Tuple[float, float] = (0.45, 0.95),
                       occlusion_prob: float = 0.4,
                       flip_prob: float = 0.5,
                       distractor_prob: float = 0.0,
                       max_distractors: int = 1,
                       union_stage1: bool = False
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """Training batches on the hard set, in the schema of
    ``synthetic.cpm_train_batches``. Center maps are painted at each
    frame's ground-truth person center (the CPM training convention; at
    inference ``refine_center`` supplies it). ``flip_prob`` mirrors that
    share of the examples; ``distractor_prob`` and ``max_distractors``
    render non-target bodies, the targets still those of the centered
    person; ``union_stage1`` adds ``heatmaps_stage1`` (see
    :func:`make_hard_examples`). ``raw_images=True`` yields uint8 images;
    otherwise x/256 − 0.5 in float32."""
    for b in range(num_batches):
        ex = make_hard_examples(model, batch_size, cfg,
                                seed=seed * 9973 + b,
                                scale_range=scale_range,
                                occlusion_prob=occlusion_prob,
                                flip_prob=flip_prob,
                                distractor_prob=distractor_prob,
                                max_distractors=max_distractors,
                                union_stage1=union_stage1)
        cmaps = pre.gaussian_center_maps(
            cfg.input_size, cfg.center_sigma,
            torch.from_numpy(ex["centers"])).numpy()
        batch = {
            "images": (ex["images"] if raw_images
                       else ex["images"].astype(np.float32) / 256.0 - 0.5),
            "center_maps": cmaps.astype(np.float32),
            "heatmaps": ex["heatmaps"],
        }
        if union_stage1:
            batch["heatmaps_stage1"] = ex["heatmaps_stage1"]
        yield batch


def hard_eval_batches(model, batch_size: int, num_batches: int,
                      cfg: CPMConfig = CPMConfig(), seed: int = 1000,
                      **kw) -> Iterator[Dict[str, np.ndarray]]:
    """Eval batches on the hard set, in the schema of
    ``synthetic.eval_batches``."""
    for b in range(num_batches):
        ex = make_hard_examples(model, batch_size, cfg,
                                seed=seed * 9973 + b, **kw)
        yield {"images": ex["images"], "gt_joints3d": ex["gt_joints3d"],
               "gt_joints2d": ex["joints2d"]}


def make_empty_examples(n: int, cfg: CPMConfig = CPMConfig(),
                        seed: int = 0, clutter: int = 6,
                        occluder_prob: float = 0.4) -> Dict[str, np.ndarray]:
    """Person-free hard frames: the backgrounds of
    :func:`make_hard_examples` (colour fields, clutter, an occluder
    rectangle with ``occluder_prob``) with no body, the negative class of
    the empty-frame operating point (``select_people(allow_empty=True)``).

    Returns {"images": (n, S, S, 3) uint8}."""
    rng = np.random.RandomState(seed)
    size = cfg.input_size
    images = np.zeros((n, size, size, 3), np.uint8)
    for i in range(n):
        img = random_background(rng, size, clutter=clutter)
        if rng.rand() < occluder_prob:
            _occlude(rng, img,
                     np.array([size / 2.0, size / 2.0], np.float32),
                     0.7 * (size / 2.0))
        images[i] = (img * 255).astype(np.uint8)
    return {"images": images}


def make_hard_enterleave_video(model, num_frames: int,
                               cfg: CPMConfig = CPMConfig(), seed: int = 0,
                               scale_range: Tuple[float, float] = (0.4, 0.55),
                               clutter: int = 4, keyframe_every: int = 8,
                               leave_at: float = 0.45,
                               enter_at: float = 0.6
                               ) -> Dict[str, np.ndarray]:
    """Enter/leave hard video for the track birth and death benchmark:
    three identities in a two-slot world.

    - person A stays in frame the whole sequence (a gentle wander);
    - person B starts in frame and walks out of the right edge, gone by
      ``leave_at``·T for good;
    - person C walks in from the left edge from ``enter_at``·T on, with
      other clothing colours than B, so a tracker must give birth to a
      new identity rather than resurrect B's.

    Ground truth per identity (axis 1 of size 3) with ``present`` (T, 3):
    a person is present while ≥ 60 % of its 14 joints are in frame.

    Returns images (T, S, S, 3) uint8, joints2d (T, 3, 14, 2) (off-frame
    positions included), centers (T, 3, 2), gt_joints3d (T, 3, 24, 3),
    theta (T, 3, 72), beta (T, 3, 10), present (T, 3) float 0/1."""
    n_id = 3
    rng = np.random.RandomState(seed)
    size = cfg.input_size
    t_idx = np.arange(num_frames, dtype=np.float64)
    theta, beta = _keyframe_poses(rng, num_frames, n_id, keyframe_every)
    j3d, verts = _smpl_np(model, theta.reshape(num_frames * n_id, 72),
                          beta.reshape(num_frames * n_id, 10))
    j3d = j3d.reshape(num_frames, n_id, -1, 3)
    verts = verts.reshape(num_frames, n_id, -1, 3)

    u = t_idx / max(num_frames - 1, 1)                  # 0 → 1
    # A wanders around x = 0.3; B exits right (fully off by leave_at); C
    # enters left (fully off before enter_at). "Off" is 0.25 frames past
    # the edge, more than half a person's width at these scales.
    xa = 0.30 + 0.05 * np.sin(2 * np.pi * u + rng.uniform(0, 6.3))
    ub = np.clip(u / max(leave_at, 1e-6), 0.0, 1.0)
    xb = 0.70 + (1.25 - 0.70) * ub
    uc = np.clip((u - enter_at) / max(1.0 - enter_at, 1e-6), 0.0, 1.0)
    xc = -0.25 + (0.62 - (-0.25)) * uc
    ys = [0.5 + 0.05 * np.sin(2 * np.pi * u + rng.uniform(0, 6.3))
          for _ in range(n_id)]
    cx = np.stack([xa, xb, xc], 1) * size               # (T, 3)
    cy = np.stack(ys, 1) * size
    s_frac = rng.uniform(*scale_range, size=n_id)

    cache = _BodyCache(model)
    background = random_background(rng, size, clutter=clutter)
    images = np.zeros((num_frames, size, size, 3), np.uint8)
    joints2d = np.zeros((num_frames, n_id, 14, 2), np.float32)
    centers = np.zeros((num_frames, n_id, 2), np.float32)
    present = np.zeros((num_frames, n_id), np.float32)
    for i in range(num_frames):
        img = background.copy()
        for p in range(n_id - 1, -1, -1):               # far first
            j14 = j3d[i, p][joints_lib.CPM_TO_SMPL]
            c3d = j14.mean(0)
            extent = np.abs(j14 - c3d).max()
            scale_px = s_frac[p] * (size / 2.0) / max(extent, 1e-3)
            center_px = np.array([cx[i, p], cy[i, p]], np.float32)
            px = (j14 - c3d)[:, :2] * scale_px + center_px
            joints2d[i, p] = px
            centers[i, p] = center_px
            in_frame = ((px >= 0.0) & (px <= size - 1.0)).all(axis=1)
            present[i, p] = float(in_frame.mean() >= 0.6)
            if in_frame.any():                          # partly visible
                render_person(img, np.random.RandomState(seed + 7 * p),
                              cache, verts[i, p], j3d[i, p], c3d,
                              scale_px, center_px)
        images[i] = (img * 255).astype(np.uint8)

    return {
        "images": images, "joints2d": joints2d, "centers": centers,
        "gt_joints3d": j3d.astype(np.float32),
        "theta": theta, "beta": beta, "present": present,
    }
