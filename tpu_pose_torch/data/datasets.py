"""Public-dataset readers and their converters to the npz-shard
interchange (port of ``tpu_pose/data/datasets.py``, numpy and PIL on the
host, the same arithmetic line for line).

Each reader parses a dataset's own distribution schema: Matlab
``joints.mat`` (LSP, LSPET) and ``mpii_human_pose_v1_u12_1.mat`` (MPII),
COCO's ``person_keypoints_*.json``, the preprocessed Human3.6M
``data_3d_h36m.npz`` and the 3DPW ``sequenceFiles`` pickles. The
converters crop each person, map the joints into the crop and write the
shards ``data/pipeline.py`` streams to ``parallel/eval.py``.

Joint-order conventions (from the datasets' own readmes):

- LSP / LSPET 14 joints: r_ankle, r_knee, r_hip, l_hip, l_knee,
  l_ankle, r_wrist, r_elbow, r_shoulder, l_shoulder, l_elbow, l_wrist,
  neck, head_top. The visibility flag is inverted between the two
  releases: original LSP's third row is 1 for an occluded joint,
  LSPET's is 1 for a visible joint.
- MPII 16 joints by ``id``: 0 r_ankle … 5 l_ankle, 6 pelvis, 7 thorax,
  8 upper_neck, 9 head_top, 10 r_wrist … 15 l_wrist. PCKh normalizes
  by 0.6 × the annotated head-rectangle diagonal (the official
  SC_BIAS).
- Human3.6M 32 raw joints → the standard 17-joint evaluation subset
  (``models/joints.py`` ``H36M_JOINT_NAMES`` order).

Every converter emits joints in the CPM 14-joint order
(``models/joints.py`` ``CPM_JOINT_NAMES``) in output-crop pixels, cell
corner convention. ``scipy.io``, ``scipy.spatial.transform`` and PIL are
imported where they are used.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpu_pose_torch.data import pipeline

__all__ = [
    "LSP_TO_CPM", "MPII_TO_CPM", "H36M_32_TO_17", "MPII_SC_BIAS",
    "load_lsp", "load_mpii", "load_coco", "load_h36m_3d_npz",
    "load_3dpw", "threedpw_to_shards", "THREEDPW_GENDER_CODES",
    "crop_person", "crop_point_map", "lsp_to_shards", "mpii_to_shards", "coco_to_shards",
    "sequences_to_shards",
]

# LSP order (above) → CPM order (head, neck, r_sho, r_elb, r_wri, l_sho,
# l_elb, l_wri, r_hip, r_knee, r_ank, l_hip, l_knee, l_ank).
LSP_TO_CPM = np.array([13, 12, 8, 7, 6, 9, 10, 11, 2, 1, 0, 3, 4, 5],
                      dtype=np.int32)
# MPII id → CPM order (pelvis 6 and thorax 7 have no CPM slot).
MPII_TO_CPM = np.array([9, 8, 12, 11, 10, 13, 14, 15, 2, 1, 0, 3, 4, 5],
                       dtype=np.int32)
# Human3.6M raw 32-joint skeleton → the standard 17 evaluation joints
# (pelvis, r-leg, l-leg, spine, neck, head, site, l-arm, r-arm).
H36M_32_TO_17 = np.array(
    [0, 1, 2, 3, 6, 7, 8, 12, 13, 14, 15, 17, 18, 19, 25, 26, 27],
    dtype=np.int32)
# Official MPII PCKh head-size bias: headsize = 0.6 · ‖head rect diag‖.
MPII_SC_BIAS = 0.6


# -- LSP / LSPET -----------------------------------------------------------

def load_lsp(mat_path: str, visibility: str = "auto"
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an LSP-family ``joints.mat``.

    Handles both layouts: original LSP ``joints`` is (3, 14, N) with the
    third ROW a 1-means-OCCLUDED flag; LSPET is (14, 3, N) with the
    third COLUMN a 1-means-VISIBLE flag. ``visibility`` overrides the
    flag convention ("occluded_flag" | "visible_flag"); "auto" infers it
    from the layout (the releases differ in both, so layout determines
    convention).

    Returns (joints2d (N, 14, 2) float32 in source-image pixels, CPM
    joint order; conf (N, 14) float32 1=visible).
    """
    import scipy.io
    m = scipy.io.loadmat(mat_path)
    if "joints" not in m:
        raise ValueError(f"{mat_path} has no 'joints' array "
                         f"(keys: {[k for k in m if not k.startswith('__')]})")
    j = np.asarray(m["joints"], np.float64)
    if j.ndim != 3:
        raise ValueError(f"'joints' must be 3-D, got shape {j.shape}")
    if j.shape[:2] == (3, 14):            # original LSP
        j = np.transpose(j, (2, 1, 0))    # (N, 14, 3)
        inferred = "occluded_flag"
    elif j.shape[:2] == (14, 3):          # LSPET
        j = np.transpose(j, (2, 0, 1))    # (N, 14, 3)
        inferred = "visible_flag"
    else:
        raise ValueError(
            f"'joints' shape {j.shape} is neither LSP (3,14,N) nor "
            f"LSPET (14,3,N)")
    conv = inferred if visibility == "auto" else visibility
    if conv not in ("occluded_flag", "visible_flag"):
        raise ValueError(f"unknown visibility convention {conv!r}")
    flag = j[:, :, 2]
    conf = (1.0 - flag) if conv == "occluded_flag" else flag
    joints = j[:, LSP_TO_CPM, :2].astype(np.float32)
    conf = np.clip(conf[:, LSP_TO_CPM], 0.0, 1.0).astype(np.float32)
    return joints, conf


# -- MPII ------------------------------------------------------------------

def _scalar(v, default=None):
    """Squeeze a loadmat cell down to a python float, tolerating the
    empty arrays MPII uses for missing fields."""
    a = np.asarray(v).ravel()
    if a.size == 0:
        return default
    return float(a[0])


def load_mpii(mat_path: str, train_only: bool = True,
              require_head_rect: bool = True) -> List[dict]:
    """Parse ``mpii_human_pose_v1_u12_1.mat`` (the official MPII
    annotation release: a ``RELEASE`` struct with ``annolist`` /
    ``img_train`` / ``single_person``).

    Emits one record per ANNOTATED PERSON (MPII is multi-person; each
    annorect with annopoints becomes a person-centric sample, matching
    how the CPM lineage consumes it):

    ``{"image": str, "center": (2,) float, "scale": float (person height
    / 200, MPII's unit), "joints2d": (14, 2) float32 CPM order in
    SOURCE pixels, "conf": (14,) float32 1=annotated, "visible": (14,)
    float32, "headsize": float (0.6·head-rect diagonal, the official
    PCKh normalizer)}``

    Test-set images (``img_train == 0``) carry no joint annotations and
    are skipped when ``train_only``. Rects without a head rectangle are
    skipped when ``require_head_rect`` (PCKh needs the normalizer).
    """
    import scipy.io
    m = scipy.io.loadmat(mat_path, struct_as_record=False, squeeze_me=True)
    if "RELEASE" not in m:
        raise ValueError(f"{mat_path} has no RELEASE struct")
    release = m["RELEASE"]
    annolist = np.atleast_1d(release.annolist)
    img_train = np.atleast_1d(release.img_train).astype(int)
    records: List[dict] = []
    for i, anno in enumerate(annolist):
        if train_only and not img_train[i]:
            continue
        name = str(anno.image.name)
        rects = getattr(anno, "annorect", None)
        if rects is None:
            continue
        for rect in np.atleast_1d(rects):
            if rect is None or not hasattr(rect, "annopoints"):
                continue
            pts = getattr(rect, "annopoints", None)
            if pts is None or isinstance(pts, np.ndarray) and pts.size == 0:
                continue
            point = np.atleast_1d(pts.point)
            joints = np.zeros((16, 2), np.float32)
            annotated = np.zeros(16, np.float32)
            visible = np.zeros(16, np.float32)
            for p in point:
                pid = int(_scalar(p.id))
                if not 0 <= pid < 16:
                    continue
                joints[pid] = (_scalar(p.x), _scalar(p.y))
                annotated[pid] = 1.0
                vis = getattr(p, "is_visible", None)
                v = (_scalar(vis, default=1.0) if vis is not None else 1.0)
                visible[pid] = float(v) if v is not None else 1.0
            x1, y1 = _scalar(getattr(rect, "x1", None)), _scalar(
                getattr(rect, "y1", None))
            x2, y2 = _scalar(getattr(rect, "x2", None)), _scalar(
                getattr(rect, "y2", None))
            if x1 is None or x2 is None:
                if require_head_rect:
                    continue
                headsize = None
            else:
                headsize = MPII_SC_BIAS * float(
                    np.hypot(x2 - x1, y2 - y1))
            scale = _scalar(getattr(rect, "scale", None))
            objpos = getattr(rect, "objpos", None)
            center = (np.array([_scalar(objpos.x), _scalar(objpos.y)],
                               np.float32)
                      if objpos is not None and not (
                          isinstance(objpos, np.ndarray)
                          and objpos.size == 0)
                      else joints[annotated > 0].mean(0))
            records.append({
                "image": name,
                "center": np.asarray(center, np.float32),
                "scale": float(scale) if scale is not None else None,
                "joints2d": joints[MPII_TO_CPM],
                "conf": annotated[MPII_TO_CPM],
                "visible": visible[MPII_TO_CPM],
                "headsize": headsize,
            })
    return records


# -- COCO keypoints --------------------------------------------------------

# COCO 17 keypoints: 0 nose, 1/2 l/r eye, 3/4 l/r ear, 5/6 l/r shoulder,
# 7/8 l/r elbow, 9/10 l/r wrist, 11/12 l/r hip, 13/14 l/r knee,
# 15/16 l/r ankle. Direct CPM correspondences (CPM slot → COCO id); the
# two CPM joints COCO lacks are synthesized: neck = shoulder midpoint
# (the standard COCO→MPII-style conversion) and head = nose (the closest
# available proxy, ~half a head low — documented approximation). ONE
# copy of the correspondence, shared with the detector-output converter
# joints.coco_to_cpm.
from tpu_pose_torch.models.joints import \
    COCO_TO_CPM_DIRECT as _COCO_DIRECT  # noqa: E402


def load_coco(json_path: str, person_category: int = 1) -> List[dict]:
    """Parse a COCO-keypoints annotation file (the
    ``person_keypoints_*.json`` schema: ``images`` + ``annotations``
    with 17×(x, y, v) keypoint triplets — also what most labeling tools
    export). One record per annotated person, same shape as
    :func:`load_mpii`'s records:

    ``{"image": file_name, "center", "scale" (bbox height / 200, the
    MPII unit), "joints2d" (14, 2) CPM order, "conf" (14,) 1 = labeled,
    "visible" (14,), "headsize" (nose–shoulder-midpoint distance — COCO
    has no head rectangle; documented proxy, like LSP's)}``

    CPM joints COCO lacks: neck = shoulder midpoint (labeled only when
    both shoulders are), head = nose. v∈{0 unlabeled, 1 occluded,
    2 visible} maps to conf = v>0, visible = v==2.
    """
    import json as json_lib
    with open(json_path) as f:
        data = json_lib.load(f)
    if "annotations" not in data or "images" not in data:
        raise ValueError(
            f"{json_path} is not a COCO annotation file "
            f"(keys: {sorted(data)[:8]})")
    name_of = {im["id"]: im["file_name"] for im in data["images"]}
    records: List[dict] = []
    for ann in data["annotations"]:
        if ann.get("category_id", 1) != person_category:
            continue
        kp = np.asarray(ann.get("keypoints", ()), np.float32)
        if kp.size != 51 or ann.get("num_keypoints", 0) == 0:
            continue
        kp = kp.reshape(17, 3)
        joints = np.zeros((14, 2), np.float32)
        conf = np.zeros(14, np.float32)
        visible = np.zeros(14, np.float32)
        for cpm_i, coco_i in _COCO_DIRECT.items():
            x, y, v = kp[coco_i]
            if v > 0:
                joints[cpm_i] = (x, y)
                conf[cpm_i] = 1.0
                visible[cpm_i] = float(v == 2)
        if kp[5, 2] > 0 and kp[6, 2] > 0:      # neck = shoulder midpoint
            joints[1] = (kp[5, :2] + kp[6, :2]) / 2.0
            conf[1] = 1.0
            visible[1] = float(kp[5, 2] == 2 and kp[6, 2] == 2)
        if kp[0, 2] > 0:                       # head ≈ nose
            joints[0] = kp[0, :2]
            conf[0] = 1.0
            visible[0] = float(kp[0, 2] == 2)
        if not conf.any():
            # Only unmappable keypoints labeled (eyes/ears): nothing a
            # CPM-frame consumer can use — skip rather than crash on the
            # empty bbox reduction below.
            continue
        if "bbox" in ann:
            x0, y0, w, h = ann["bbox"]
        else:
            lo, hi = joints[conf > 0].min(0), joints[conf > 0].max(0)
            x0, y0 = lo
            w, h = hi - lo
        # COCO has no head rectangle: use the nose–neck segment, or (if
        # either is unlabeled) ~an anatomical head length, 0.13 × the
        # person bbox height.
        headsize = (float(np.linalg.norm(joints[0] - joints[1]))
                    if conf[0] and conf[1] else 0.13 * float(h))
        # OKS object scale s² — the annotation's segmentation area when
        # present (what the official eval uses), else the conventional
        # bbox stand-in 0.53·w·h (utils/metrics.keypoint_bbox_area_np).
        area = float(ann.get("area", 0.53 * w * h))
        records.append({
            "image": name_of.get(ann["image_id"], str(ann["image_id"])),
            "center": np.array([x0 + w / 2.0, y0 + h / 2.0], np.float32),
            "scale": float(h) / 200.0,
            "joints2d": joints,
            "conf": conf,
            "visible": visible,
            "headsize": headsize,
            "area": area,
        })
    return records


def coco_to_shards(json_path: str, images_dir: str, out_dir: str,
                   out_size: int = 368, margin: float = 1.25,
                   shard_size: int = 256,
                   limit: Optional[int] = None) -> List[str]:
    """COCO keypoints → person-centric npz shards (one sample per
    annotated person, cropped at the bbox center, side = ``margin`` ×
    bbox height). Same shard keys as :func:`lsp_to_shards`."""
    records = [r for r in load_coco(json_path)
               if r["scale"] > 0 and r["conf"].sum() >= 4]
    if limit is not None:
        records = records[:limit]
    if not records:
        raise ValueError(f"no usable annotated people in {json_path}")
    return _records_to_shards(records, images_dir, out_dir, out_size,
                              margin, shard_size)


# -- Human3.6M -------------------------------------------------------------

def load_h36m_3d_npz(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Load the widely-redistributed preprocessed H3.6M 3D-position
    archive (``data_3d_h36m.npz`` with a pickled ``positions_3d`` dict:
    subject → action → (T, 32 or 17, 3) float32 meters). 32-joint raw
    skeletons are reduced to the standard 17-joint evaluation subset
    (:data:`H36M_32_TO_17`, models/joints.py order).
    """
    with np.load(path, allow_pickle=True) as z:
        if "positions_3d" not in z:
            raise ValueError(
                f"{path} has no 'positions_3d' (keys: {z.files})")
        raw = z["positions_3d"].item()
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for subj, actions in raw.items():
        out[subj] = {}
        for act, pos in actions.items():
            pos = np.asarray(pos, np.float32)
            if pos.ndim != 3 or pos.shape[-1] != 3:
                raise ValueError(
                    f"positions_3d[{subj}][{act}] has shape {pos.shape}, "
                    f"want (T, J, 3)")
            if pos.shape[1] == 32:
                pos = pos[:, H36M_32_TO_17]
            out[subj][act] = pos
    return out


def load_3dpw(pkl_path: str) -> dict:
    """Parse one official 3DPW sequence file
    (``sequenceFiles/<split>/<name>.pkl``, a py2-era pickle) — the
    public in-the-wild dataset with SMPL ground truth, i.e. the one
    public benchmark where the evaluator's mesh-level PVE / PA-PVE
    protocol has real annotations. Schema (the dataset's own release;
    exercised against fabricated files by the tests):

    - ``poses``/``betas``/``trans``: per-actor lists — (T, 72) SMPL pose
      in WORLD coordinates, (≥10,) shape, (T, 3) translation.
    - ``jointPositions``: per-actor (T, 72) = 24 SMPL joints, world
      meters.
    - ``cam_poses``: (T, 4, 4) world→camera extrinsics;
      ``cam_intrinsics``: (3, 3) K; ``campose_valid``: per-actor (T,).
    - ``img_frame_ids``: (T,) indices into
      ``imageFiles/<sequence>/image_%05d.jpg``; ``genders``: per-actor.

    Returns a dict: ``sequence``, ``cam_poses`` (T,4,4),
    ``cam_intrinsics`` (3,3), ``img_frame_ids`` (T,), and ``actors`` —
    a list of dicts with ``poses`` (T,72), ``betas`` (10,),
    ``joint_positions`` (T,24,3), ``trans`` (T,3), ``valid`` (T,) bool,
    ``gender``.
    """
    import pickle
    with open(pkl_path, "rb") as f:
        seq = pickle.load(f, encoding="latin1")
    missing = [k for k in ("poses", "betas", "jointPositions",
                           "cam_poses", "cam_intrinsics") if k not in seq]
    if missing:
        raise ValueError(
            f"{pkl_path} is not a 3DPW sequence file (missing "
            f"{missing}; keys: {sorted(seq)})")
    cam_poses = np.asarray(seq["cam_poses"], np.float64)
    if cam_poses.ndim != 3 or cam_poses.shape[1:] != (4, 4):
        raise ValueError(f"cam_poses has shape {cam_poses.shape}, "
                         f"want (T, 4, 4)")
    t_total = cam_poses.shape[0]
    k_mat = np.asarray(seq["cam_intrinsics"], np.float64).reshape(3, 3)
    frame_ids = np.asarray(
        seq.get("img_frame_ids", np.arange(t_total)), np.int64).reshape(-1)
    n_actors = len(seq["poses"])
    valid_all = seq.get("campose_valid",
                        [np.ones(t_total)] * n_actors)
    genders = seq.get("genders", ["?"] * n_actors)
    trans_all = seq.get("trans",
                        [np.zeros((t_total, 3))] * n_actors)
    actors = []
    for a in range(n_actors):
        poses = np.asarray(seq["poses"][a], np.float64).reshape(
            t_total, 72)
        # SMPL-1.1-style files may carry >10 betas; the first 10 are the
        # standard shape space every SMPL implementation consumes.
        betas = np.asarray(seq["betas"][a], np.float64).reshape(-1)[:10]
        jp = np.asarray(seq["jointPositions"][a], np.float64).reshape(
            t_total, 24, 3)
        actors.append({
            "poses": poses,
            "betas": betas,
            "joint_positions": jp,
            "trans": np.asarray(trans_all[a], np.float64).reshape(
                t_total, 3),
            "valid": np.asarray(valid_all[a]).reshape(t_total) > 0,
            "gender": str(genders[a]),
        })
    name = seq.get("sequence") or os.path.splitext(
        os.path.basename(pkl_path))[0]
    return {"sequence": str(name), "cam_poses": cam_poses,
            "cam_intrinsics": k_mat, "img_frame_ids": frame_ids,
            "actors": actors}


def _compose_global_orient(theta: np.ndarray, rot: np.ndarray
                           ) -> np.ndarray:
    """World-frame SMPL pose → camera frame: replace the global-orient
    axis-angle ``theta[:3]`` with ``rot · R(theta[:3])`` (body joints
    2..23 are parent-relative and unaffected). Host scipy — conversion
    is one-time IO."""
    from scipy.spatial.transform import Rotation
    out = np.asarray(theta, np.float64).copy()
    r_glob = Rotation.from_rotvec(out[:3]).as_matrix()
    out[:3] = Rotation.from_matrix(rot @ r_glob).as_rotvec()
    return out


# 3DPW gender letters → the uint8 codes shards carry (npz shards hold
# arrays, not strings).
THREEDPW_GENDER_CODES = {"n": 0, "m": 1, "f": 2}


def threedpw_to_shards(pkl_path: str, images_dir: str, out_dir: str,
                       out_size: int = 368, margin: float = 1.3,
                       shard_size: int = 256,
                       limit: Optional[int] = None,
                       gender: Optional[str] = None) -> List[str]:
    """One 3DPW sequence file + its image directory
    (``imageFiles/<sequence>/``) → evaluation shards for
    ``parallel/eval.evaluate_h36m_style``: per valid (actor, frame) a
    person crop (``images``), the 24 SMPL GT joints in CAMERA-frame
    meters (``gt_joints3d`` — the evaluator's joint convention, pelvis
    root), crop-pixel 14-joint 2D GT projected through the sequence
    intrinsics (``gt_joints2d`` + all-ones ``conf``), and the SMPL
    parameters with the global orient composed into the camera frame
    (``gt_theta``, ``gt_beta``) — which switches on the evaluator's
    mesh-level PVE / PA-PVE protocol, plus the actor's ``gt_gender``
    code (:data:`THREEDPW_GENDER_CODES`). 3DPW's annotations are
    gendered: either pose GT through the neutral model (the common
    approximation — say so when quoting numbers) or convert per-gender
    directories (``gender="m"``/``"f"`` keeps only matching actors) and
    pass the gendered model as the evaluator's ``gt_smpl_model``."""
    from tpu_pose_torch.models.joints import CPM_TO_SMPL
    seq = load_3dpw(pkl_path)
    k_mat = seq["cam_intrinsics"]
    images, j2d, j3d, thetas, betas, confs = [], [], [], [], [], []
    genders, focals = [], []
    # Effective focal in OUTPUT-CROP pixels: the crop scales image
    # pixels by ``zoom``, so f_crop = fx·zoom (square pixels assumed —
    # 3DPW's K has fx≈fy). The person-centered crop also moves the
    # principal point to the person, which is exactly the SMPLify-style
    # perspective camera's assumption (FitConfig.focal + principal point
    # at the frame center) — use it via eval_h36m's --focal/auto.
    fx = float(k_mat[0, 0])
    for actor in seq["actors"]:
        if gender is not None and actor["gender"][:1].lower() != gender:
            continue
        for t, frame_id in enumerate(seq["img_frame_ids"]):
            if limit is not None and len(images) >= limit:
                break
            if not actor["valid"][t]:
                continue
            rot = seq["cam_poses"][t, :3, :3]
            tvec = seq["cam_poses"][t, :3, 3]
            j_cam = actor["joint_positions"][t] @ rot.T + tvec
            if (j_cam[:, 2] <= 0.05).any():
                continue  # behind / grazing the camera
            uvw = j_cam @ k_mat.T
            px24 = uvw[:, :2] / uvw[:, 2:3]
            px14 = px24[np.asarray(CPM_TO_SMPL)]
            img = _load_image(os.path.join(
                images_dir, f"image_{int(frame_id):05d}.jpg"))
            lo, hi = px14.min(0), px14.max(0)
            side = float(max(hi[0] - lo[0], hi[1] - lo[1], 8.0)) * margin
            crop, origin, zoom = crop_person(img, (lo + hi) / 2.0, side,
                                             out_size)
            images.append(crop)
            j2d.append(crop_point_map(px14, origin,
                                      zoom).astype(np.float32))
            j3d.append(j_cam.astype(np.float32))
            thetas.append(_compose_global_orient(
                actor["poses"][t], rot).astype(np.float32))
            betas.append(actor["betas"].astype(np.float32))
            confs.append(np.ones(14, np.float32))
            genders.append(THREEDPW_GENDER_CODES.get(
                actor["gender"][:1].lower(), 0))
            focals.append(np.float32(fx * zoom))
    if not images:
        raise ValueError(f"no valid (actor, frame) samples in {pkl_path}")
    return pipeline.write_npz_shards(out_dir, {
        "images": np.stack(images),
        "gt_joints2d": np.stack(j2d),
        "conf": np.stack(confs),
        "gt_joints3d": np.stack(j3d),
        "gt_theta": np.stack(thetas),
        "gt_beta": np.stack(betas),
        "gt_gender": np.asarray(genders, np.uint8),
        "focal_px": np.asarray(focals, np.float32),
    }, shard_size=shard_size)


# -- cropping / shard conversion ------------------------------------------

def crop_point_map(pts: np.ndarray, origin: np.ndarray,
                   zoom: float) -> np.ndarray:
    """Source-pixel points → crop pixels for :func:`crop_person`:

        ``p_out = (p_src − origin) · zoom + 0.5·zoom − 0.5``.

    The ``0.5·zoom − 0.5`` term is PIL's (and the resize's)
    half-integer pixel-CENTER resize convention — the same convention
    class as ``cpm.crop_index_translation`` and the letterbox affine's
    ``+0.5·s − 0.5`` offsets. Dropping it biases mapped points by up to
    ``0.5·(zoom−1)`` px (≈1.3 px on an MPII-style 100→368 upscale crop;
    verified with sub-pixel blob centroids). ONE copy used by every
    shard converter so GT joints and image content stay aligned."""
    return (np.asarray(pts, np.float64) - np.asarray(origin)) * zoom \
        + 0.5 * zoom - 0.5


def crop_person(img: np.ndarray, center: Sequence[float], side: float,
                out_size: int) -> Tuple[np.ndarray, np.ndarray, float]:
    """Square person crop → ``(out_size, out_size)`` uint8, zero-padded
    outside the source. Returns ``(crop, origin (2,), zoom)``; map
    points with :func:`crop_point_map` (NOT the raw
    ``(p − origin)·zoom`` — see its docstring for the half-pixel term).
    """
    from PIL import Image
    h, w = img.shape[:2]
    side_i = max(int(round(side)), 2)
    cx, cy = float(center[0]), float(center[1])
    x0 = int(round(cx - side_i / 2.0))
    y0 = int(round(cy - side_i / 2.0))
    canvas = np.zeros((side_i, side_i, 3), np.uint8)
    sx0, sy0 = max(x0, 0), max(y0, 0)
    sx1, sy1 = min(x0 + side_i, w), min(y0 + side_i, h)
    if sx1 > sx0 and sy1 > sy0:
        canvas[sy0 - y0: sy1 - y0, sx0 - x0: sx1 - x0] = (
            img[sy0:sy1, sx0:sx1])
    crop = np.asarray(
        Image.fromarray(canvas).resize((out_size, out_size),
                                       Image.BILINEAR))
    zoom = out_size / float(side_i)
    return crop, np.array([x0, y0], np.float32), zoom


def _load_image(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _lsp_image_path(images_dir: str, idx: int) -> str:
    for pat in (f"im{idx + 1:04d}.jpg", f"im{idx + 1:05d}.jpg",
                f"im{idx + 1:04d}.png", f"im{idx + 1:05d}.png"):
        p = os.path.join(images_dir, pat)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"no LSP image #{idx + 1} under {images_dir} "
        f"(tried im{idx + 1:04d}/im{idx + 1:05d} .jpg/.png)")


def lsp_to_shards(mat_path: str, images_dir: str, out_dir: str,
                  out_size: int = 368, margin: float = 1.5,
                  shard_size: int = 256,
                  limit: Optional[int] = None) -> List[str]:
    """LSP/LSPET → person-centric npz shards the 2D evaluator streams.

    Crop: square around the annotated-joint bounding box, side =
    ``margin`` × its larger extent (LSP images are already roughly
    person-centric; the crop normalizes framing). Shard keys: ``images``
    (N, S, S, 3) uint8, ``gt_joints2d`` (N, 14, 2) crop pixels,
    ``conf`` (N, 14), ``headsize`` (N,) — head–neck length in crop
    pixels (LSP has no head rectangle; the head-segment proxy is the
    metric's documented fallback, utils/metrics.pckh).
    """
    joints, conf = load_lsp(mat_path)
    n = len(joints) if limit is None else min(limit, len(joints))
    images, out_j, out_hs = [], [], []
    for i in range(n):
        img = _load_image(_lsp_image_path(images_dir, i))
        ann = conf[i] > 0
        pts = joints[i][ann] if ann.any() else joints[i]
        lo, hi = pts.min(0), pts.max(0)
        side = float(max(hi[0] - lo[0], hi[1] - lo[1], 8.0)) * margin
        crop, origin, zoom = crop_person(img, (lo + hi) / 2.0, side,
                                         out_size)
        j = crop_point_map(joints[i], origin, zoom)
        images.append(crop)
        out_j.append(j.astype(np.float32))
        out_hs.append(np.float32(np.linalg.norm(j[0] - j[1])))
    return pipeline.write_npz_shards(out_dir, {
        "images": np.stack(images),
        "gt_joints2d": np.stack(out_j),
        "conf": conf[:n],
        "headsize": np.asarray(out_hs, np.float32),
    }, shard_size=shard_size)


def _records_to_shards(records: List[dict], images_dir: str,
                       out_dir: str, out_size: int, margin: float,
                       shard_size: int) -> List[str]:
    """Shared person-record → crop → shard loop for the MPII/COCO-style
    records (center + scale in MPII's height/200 unit): ONE copy of the
    crop/affine/headsize math so the converters cannot drift."""
    images, out_j, out_c, out_hs, out_area = [], [], [], [], []
    for r in records:
        img = _load_image(os.path.join(images_dir, r["image"]))
        side = float(r["scale"]) * 200.0 * margin
        crop, origin, zoom = crop_person(img, r["center"], side, out_size)
        images.append(crop)
        out_j.append(crop_point_map(r["joints2d"], origin,
                                    zoom).astype(np.float32))
        out_c.append(r["conf"])
        out_hs.append(np.float32(r["headsize"] * zoom))
        if r.get("area") is not None:
            # Areas transform by the crop affine's Jacobian (zoom²).
            out_area.append(np.float32(r["area"] * zoom * zoom))
    arrays = {
        "images": np.stack(images),
        "gt_joints2d": np.stack(out_j),
        "conf": np.stack(out_c),
        "headsize": np.asarray(out_hs, np.float32),
    }
    if len(out_area) == len(records):   # COCO records carry OKS area
        arrays["area"] = np.asarray(out_area, np.float32)
    return pipeline.write_npz_shards(out_dir, arrays,
                                     shard_size=shard_size)


def mpii_to_shards(mat_path: str, images_dir: str, out_dir: str,
                   out_size: int = 368, margin: float = 1.25,
                   shard_size: int = 256,
                   limit: Optional[int] = None) -> List[str]:
    """MPII → person-centric npz shards (one sample per annotated
    person, cropped at the annotation's ``objpos``/``scale``: side =
    ``margin`` × scale × 200 px, MPII's person-height unit). Shard keys
    as :func:`lsp_to_shards`, with ``headsize`` the OFFICIAL
    0.6·head-rect diagonal scaled into crop pixels.
    """
    records = [r for r in load_mpii(mat_path)
               if r["scale"] and r["headsize"]]
    if limit is not None:
        records = records[:limit]
    if not records:
        raise ValueError(f"no usable annotated people in {mat_path}")
    return _records_to_shards(records, images_dir, out_dir, out_size,
                              margin, shard_size)


def sequences_to_shards(images: np.ndarray, gt_joints3d: np.ndarray,
                        out_dir: str, shard_size: int = 256,
                        gt_joints2d: Optional[np.ndarray] = None,
                        gt_theta: Optional[np.ndarray] = None,
                        gt_beta: Optional[np.ndarray] = None,
                        ) -> List[str]:
    """Pack aligned frames + 3D GT (e.g. H3.6M frames with
    :func:`load_h36m_3d_npz` positions, joints already in the evaluation
    convention) into the shards ``scripts/eval_h36m.py`` streams.
    Optional SMPL GT (``gt_theta`` (T, 72) + ``gt_beta`` (T, 10), the
    3DPW-style annotation) enables the evaluator's mesh-level PVE /
    PA-PVE protocol."""
    if len(images) != len(gt_joints3d):
        raise ValueError(
            f"images ({len(images)}) and gt_joints3d "
            f"({len(gt_joints3d)}) must align")
    arrays = {"images": np.ascontiguousarray(images, np.uint8),
              "gt_joints3d": np.asarray(gt_joints3d, np.float32)}
    if gt_joints2d is not None:
        arrays["gt_joints2d"] = np.asarray(gt_joints2d, np.float32)
    if (gt_theta is None) != (gt_beta is None):
        raise ValueError("gt_theta and gt_beta come together")
    if gt_theta is not None:
        arrays["gt_theta"] = np.asarray(gt_theta, np.float32)
        arrays["gt_beta"] = np.asarray(gt_beta, np.float32)
    return pipeline.write_npz_shards(out_dir, arrays,
                                     shard_size=shard_size)
