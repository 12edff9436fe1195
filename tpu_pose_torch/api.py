"""Public API (port of ``tpu_pose/api.py``):

- ``estimate_2d(images)``      — CPM heatmaps + decoded 2D joints.
- ``fit_smpl(joints2d, conf)`` — SMPLify-style 3D fit from 2D joints.
- ``estimate_and_fit(images)`` — raw images → 2D joints → fit → posed mesh.
- ``estimate_and_fit_video(frames, mode)`` — one sequence, one fit
  (smooth, temporal or independent); ``estimate_and_fit_video_stream``
  — any length in anchored chunks; :class:`VideoSession` — the same,
  fed frames as they arrive.
- ``estimate_and_fit_multi(images)`` — up to ``max_people`` people per
  frame, each fitted; ``estimate_and_fit_video_multi(frames)`` — tracked
  people in a video, one smooth fit per track; its stream form and
  :class:`MultiPersonVideoSession`.

``PoseEstimator`` bundles the CPM, the SMPL model, the prior and the
configs on one device. Inputs may be numpy arrays or tensors; outputs are
tensors on the estimator's device. The first three are also module-level
functions, on a given ``estimator=`` or a synthetic one on the GPU built
at first use.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu_pose_torch.fitting import fit as fit_lib
from tpu_pose_torch.fitting import init_head as head_lib
from tpu_pose_torch.fitting import priors as priors_lib
from tpu_pose_torch.fitting import temporal, tracking
from tpu_pose_torch.fitting.fit import FitResult
from tpu_pose_torch.models import cpm as cpm_lib
from tpu_pose_torch.models import smpl as smpl_lib
from tpu_pose_torch.models import smpl_data as smpl_data_lib
from tpu_pose_torch.ops import preprocess as pre
from tpu_pose_torch.utils import tf_converter
from tpu_pose_torch.utils.config import CPMConfig, FitConfig, FrontEndConfig
from tpu_pose_torch.utils.device import no_grad, resolve_device


class Estimate2DResult(NamedTuple):
    heatmaps: torch.Tensor   # (B, 46, 46, P+1)
    joints2d: torch.Tensor   # (B, P, 2) input-frame pixels
    conf: torch.Tensor       # (B, P)


class MultiPersonResult(NamedTuple):
    joints2d: torch.Tensor       # (B, K, P, 2)
    conf: torch.Tensor           # (B, K, P)
    person_scores: torch.Tensor  # (B, K) person evidence at each center
    person_mask: torch.Tensor    # (B, K) bool: hypotheses judged people
    theta: torch.Tensor          # (B, K, 72)
    beta: torch.Tensor           # (B, K, 10)
    cam: torch.Tensor            # (B, K, 3)
    vertices: torch.Tensor       # (B, K, 6890, 3)
    joints3d: torch.Tensor       # (B, K, 24, 3)
    energy: torch.Tensor         # (B, K)


class MultiPersonVideoResult(NamedTuple):
    """Track-ordered multi-person video: index i on the track axis is the
    same person (track i) in every frame."""
    joints2d: torch.Tensor       # (T, K, P, 2) source-frame px
    conf: torch.Tensor           # (T, K, P)
    person_scores: torch.Tensor  # (T, K)
    frame_mask: torch.Tensor     # (T, K) bool: track i present at frame t
    track_mask: torch.Tensor     # (K,) bool: present in ≥ half the frames
    perm: torch.Tensor           # (T, K) int32 slot of track i at frame t
    theta: torch.Tensor          # (K, T, 72)
    beta: torch.Tensor           # (K, T, 10)
    cam: torch.Tensor            # (K, T, 3)
    vertices: torch.Tensor       # (K, T, 6890, 3)
    joints3d: torch.Tensor       # (K, T, 24, 3)
    energy: torch.Tensor         # (K, T)


class EstimateAndFitResult(NamedTuple):
    joints2d: torch.Tensor   # (B, P, 2)
    conf: torch.Tensor       # (B, P)
    theta: torch.Tensor      # (B, 72)
    beta: torch.Tensor       # (B, 10)
    cam: torch.Tensor        # (B, 3)
    vertices: torch.Tensor   # (B, 6890, 3) fitted mesh
    joints3d: torch.Tensor   # (B, 24, 3)
    energy: torch.Tensor     # (B,)


def _check_frames(images, what: str = "images") -> None:
    """Entry-point input validation: a wrong-rank or wrong-channel frame
    stack otherwise surfaces as an opaque conv error deep in the CPM."""
    shape = getattr(images, "shape", None)
    if shape is None or len(shape) != 4 or shape[-1] != 3:
        raise ValueError(
            f"{what} must be a (batch/T, H, W, 3) frame stack, got "
            f"shape {None if shape is None else tuple(shape)} — wrap a "
            f"single frame as images[None]")


def _check_fit_inputs(joints2d, conf, num_joints: int) -> None:
    js = getattr(joints2d, "shape", None)
    cs = getattr(conf, "shape", None)
    js = None if js is None else tuple(js)
    cs = None if cs is None else tuple(cs)
    ok = (js is not None and cs is not None
          and len(js) in (2, 3) and js[-1] == 2
          and js[-2] == num_joints and cs == js[:-1])
    if not ok:
        raise ValueError(
            f"fit_smpl takes joints2d ([B,] {num_joints}, 2) in pixels "
            f"with matching conf ([B,] {num_joints}); got joints2d "
            f"{js}, conf {cs}")


class PoseEstimator:
    """Bundles the CPM, SMPL model data, prior and configs on one device.

    Construction:
      - ``PoseEstimator.create_synthetic(seed)`` — random CPM weights and
        the synthetic SMPL model and GMM prior.
      - ``PoseEstimator.from_files(cpm_npz, smpl_pkl, gmm_pkl)`` — real
        assets in the JAX package's formats.
      - ``PoseEstimator.from_numpy(...)`` — the JAX package's arrays.

    ``device=None`` means CUDA, and raises without it. Front-end knobs are
    those of :class:`FrontEndConfig`, as keywords or as ``front_end=``
    (``scale_tta`` factors must lie in (0, 16)). ``init_head``: a trained
    head's parameters (``fitting/init_head.py``; a dict of arrays or
    tensors, e.g. from ``load_head``), or None for the mean-pose init; the
    head initializes the single-start fits of ``fit_smpl``,
    ``estimate_and_fit`` and ``estimate_and_fit_multi`` (multistart
    enumerates yaw hypotheses itself; the video paths never use it).

    int8 serving path: ``quantize=True`` quantizes the CPM
    (``models/cpm.quantize_params``) with static activation scales
    calibrated on ``calibration_images`` when given, dynamic ones
    otherwise. With ``int8_min_batch > 1`` the float CPM is kept too, and
    each call picks by batch size: float below ``int8_min_batch``, int8
    at or above it (0 or 1: int8 always). An already-quantized CPM
    (:class:`~tpu_pose_torch.models.cpm.QuantizedCPM`, e.g. from a
    quantized npz) is used as it is. ``cpm_microbatch > 0`` runs the CPM
    in sequential chunks of that many frames.
    """

    def __init__(self, cpm, smpl_model, prior=None,
                 cpm_cfg: CPMConfig = CPMConfig(),
                 fit_cfg: FitConfig = FitConfig(),
                 quantize: bool = False,
                 calibration_images=None,
                 init_head=None,
                 front_end: Optional[FrontEndConfig] = None,
                 device=None,
                 **knobs):
        unknown = set(knobs) - {f.name for f in
                                dataclasses.fields(FrontEndConfig)}
        if unknown:
            raise TypeError(f"unexpected keyword arguments {sorted(unknown)}")
        if front_end is not None:
            defaults = FrontEndConfig()
            clash = [k for k, v in knobs.items()
                     if v != getattr(defaults, k)]
            if clash:
                raise ValueError(
                    "pass front-end knobs either via front_end= or as "
                    f"individual keywords, not both (got both for {clash})")
            fe = front_end
        else:
            fe = FrontEndConfig(**knobs)
        fe = dataclasses.replace(
            fe, scale_tta=tuple(float(s) for s in fe.scale_tta))
        if not all(0.0 < s < 16.0 for s in fe.scale_tta):
            raise ValueError(f"scale_tta factors must be in (0, 16), got "
                             f"{fe.scale_tta}")
        self.front_end = fe
        self.fit_restarts = fe.fit_restarts
        self.int8_min_batch = fe.int8_min_batch
        self.cpm_microbatch = fe.cpm_microbatch
        self.refine_center = fe.refine_center
        self.refine_scale = fe.refine_scale
        self.scale_from_refined = fe.scale_from_refined
        self.flip_tta = fe.flip_tta
        self.scale_tta = fe.scale_tta
        self.letterbox = fe.letterbox
        self.device = resolve_device(device)
        self.init_head = None if init_head is None else {
            k: self._tensor(v, torch.float32) for k, v in init_head.items()}
        cpm = cpm.to(self.device).eval()
        # The float twin, kept only when quantizing happens here (an
        # already-quantized CPM has none to fall back to).
        self.cpm_bf16 = None
        if quantize and not isinstance(cpm, cpm_lib.QuantizedCPM):
            act_scales = None
            if calibration_images is not None:
                act_scales = self._calibrate(cpm, cpm_cfg,
                                             calibration_images)
            if fe.int8_min_batch > 1:
                self.cpm_bf16 = cpm
            cpm = cpm_lib.quantize_params(cpm, act_scales).eval()
        self.cpm = cpm
        self.smpl_model = smpl_model.to(self.device)
        self.prior = None if prior is None else prior.to(self.device)
        self.cpm_cfg = cpm_cfg
        self.fit_cfg = fit_cfg
        self._scale_tta_warned = False

    # -- constructors -----------------------------------------------------

    @classmethod
    def create_synthetic(cls, seed: int = 0,
                         cpm_cfg: CPMConfig = CPMConfig(),
                         fit_cfg: FitConfig = FitConfig(),
                         with_prior: bool = True,
                         prior=None, device=None, **kw) -> "PoseEstimator":
        """Random He-init CPM weights from ``seed`` (numpy, see
        ``models/cpm.init_cpm_params``), the synthetic SMPL model and the
        synthetic GMM-8 prior — built on ``device`` (default CUDA)."""
        device = resolve_device(device)
        cpm = cpm_lib.init_cpm_params(seed, cpm_cfg, device=device)
        model = smpl_data_lib.synthetic_smpl(seed=seed, device=device)
        if prior is None and with_prior:
            prior = priors_lib.synthetic_gmm_prior(seed, device=device)
        return cls(cpm, model, prior, cpm_cfg, fit_cfg, device=device, **kw)

    @classmethod
    def from_files(cls, cpm_params_npz: str, smpl_pkl: str,
                   gmm_pkl: Optional[str] = None,
                   cpm_cfg: CPMConfig = CPMConfig(),
                   fit_cfg: FitConfig = FitConfig(),
                   prior=None, device=None, **kw) -> "PoseEstimator":
        """Real assets: a CPM params npz (``tf_converter.save_params_npz``
        format), an SMPL ``.pkl`` and optionally a SMPLify GMM ``.pkl``."""
        device = resolve_device(device)
        cpm = cpm_lib.cpm_params_from_numpy(
            tf_converter.load_params_npz(cpm_params_npz), cpm_cfg, device)
        model = smpl_data_lib.load_smpl_pickle(smpl_pkl, device=device)
        if prior is None and gmm_pkl:
            prior = priors_lib.load_gmm_pickle(gmm_pkl, device=device)
        return cls(cpm, model, prior, cpm_cfg, fit_cfg, device=device, **kw)

    @classmethod
    def from_numpy(cls, cpm_params: dict, smpl_arrays: dict,
                   prior_arrays: Optional[dict] = None,
                   cpm_cfg: CPMConfig = CPMConfig(),
                   fit_cfg: FitConfig = FitConfig(),
                   device=None, **kw) -> "PoseEstimator":
        """From the JAX package's arrays, converted to numpy by the
        caller: CPM params ``{layer: {"w": HWIO, "b"}}``, the SMPLData
        fields, and the GMM prior's ``means``/``precisions``/``log_consts``
        (or None for no prior)."""
        device = resolve_device(device)
        cpm = cpm_lib.cpm_params_from_numpy(cpm_params, cpm_cfg, device)
        model = smpl_data_lib.SMPLData.from_numpy(smpl_arrays, device)
        prior = (None if prior_arrays is None else
                 priors_lib.gmm_prior_from_numpy(device=device,
                                                 **prior_arrays))
        return cls(cpm, model, prior, cpm_cfg, fit_cfg, device=device, **kw)

    # -- entry points -----------------------------------------------------

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _calibrate(self, cpm, cfg: CPMConfig, images) -> dict:
        """Static activation scales from raw calibration frames
        (preprocessed and center-mapped as the entry points do)."""
        x = pre.preprocess(self._tensor(images), cfg.input_size)
        cmap = None
        if cfg.use_center_map:
            cm = pre.gaussian_center_map(cfg.input_size, cfg.center_sigma,
                                         device=x.device)
            cmap = cm.expand(x.shape[0], *cm.shape)
        return cpm_lib.calibrate_act_scales(cpm, x, cmap, cfg)

    def _head_init(self, joints2d_px: torch.Tensor, conf: torch.Tensor):
        """The learned init of a batch of network-frame pixel joints, or
        None when no head is attached."""
        if self.init_head is None:
            return None
        half = self.fit_cfg.img_size / 2.0
        with no_grad():
            return head_lib.head_init_pytree(
                self.init_head, self.smpl_model, (joints2d_px - half) / half,
                conf, self.fit_cfg)

    def _params_for_batch(self, batch_size: int):
        """Precision policy: the float CPM below ``int8_min_batch``, the
        int8 one at or above it (the same CPM unless built with
        ``quantize=True``)."""
        if self.cpm_bf16 is not None and batch_size < self.int8_min_batch:
            return self.cpm_bf16
        return self.cpm

    def _front_end(self, frames, chunk: Optional[int] = None,
                   cpm=None, **knobs):
        """The 2D front end with this estimator's knobs (``knobs``
        override them) in ``chunk``-frame micro-chunks (default
        ``cpm_microbatch``), by the precision policy unless ``cpm`` is
        given: (heatmaps, joints, conf), joints in the network frame
        unless ``source_frame=True`` is passed."""
        kw = dict(refine_center=self.refine_center,
                  refine_scale=self.refine_scale,
                  scale_from_refined=self.scale_from_refined,
                  flip_tta=self.flip_tta, scale_tta=self.scale_tta,
                  letterbox=self.letterbox, source_frame=False)
        kw.update(knobs)
        if cpm is None:
            cpm = self._params_for_batch(frames.shape[0])
        with no_grad():
            return cpm_lib.estimate_2d_microbatched(
                cpm, self._tensor(frames), self.cpm_cfg,
                chunk=self.cpm_microbatch if chunk is None else chunk, **kw)

    def estimate_2d(self, images, refine_center: Optional[bool] = None,
                    refine_scale: Optional[bool] = None,
                    letterbox: Optional[bool] = None,
                    flip_tta: Optional[bool] = None,
                    scale_tta: Optional[tuple] = None) -> Estimate2DResult:
        """Images (B, H, W, 3) uint8/float → heatmaps, 2D joints, conf.
        Each knob left at None takes the constructor's setting; with
        ``letterbox`` the joints are in source-image pixels."""
        _check_frames(images)
        knobs = {k: v for k, v in (
            ("refine_center", refine_center), ("refine_scale", refine_scale),
            ("letterbox", letterbox), ("flip_tta", flip_tta),
            ("scale_tta", None if scale_tta is None
             else tuple(float(s) for s in scale_tta))) if v is not None}
        hm, joints, conf = self._front_end(images, source_frame=True,
                                           **knobs)
        return Estimate2DResult(hm, joints, conf)

    def fit_smpl(self, joints2d, conf, init: Optional[dict] = None,
                 restarts: int = 1) -> FitResult:
        """2D joints (pixels, CPM order) → (θ, β, cam). Batched if a
        leading axis is present. ``restarts > 1`` fits that many
        global-yaw hypotheses per sample and keeps the lowest energy;
        otherwise the fit starts from ``init``, or the head's init when
        one is attached."""
        _check_fit_inputs(joints2d, conf, self.cpm_cfg.num_joints)
        j = self._tensor(joints2d, torch.float32)
        c = self._tensor(conf, torch.float32)
        single = j.dim() == 2
        if single:
            j, c = j[None], c[None]
            if init is not None:
                init = {k: v[None] for k, v in init.items()}
        if restarts > 1:
            if init is not None:
                raise ValueError("init and restarts>1 are exclusive")
            res = fit_lib.fit_smpl_multistart(
                self.smpl_model, j, c, self.fit_cfg, self.prior,
                restarts=restarts)
        else:
            if init is not None:
                init = {k: self._tensor(v, torch.float32)
                        for k, v in init.items()}
            else:
                init = self._head_init(j, c)
            res = fit_lib.fit_smpl_batch(self.smpl_model, j, c,
                                         self.fit_cfg, self.prior, init)
        return FitResult(*(f[0] for f in res)) if single else res

    def _to_source_frame(self, joints: torch.Tensor, images
                         ) -> torch.Tensor:
        """Network-frame joints (..., P, 2) → source-image pixels when
        this estimator letterboxes; identity otherwise."""
        if not self.letterbox:
            return joints
        return pre.joints_to_source_frame(joints, pre.letterbox_affine(
            images.shape[1], images.shape[2], self.cpm_cfg.input_size))

    def _mesh(self, res: FitResult):
        """The final mesh of fitted (..., 72) θ and (..., 10) β at the
        exact tier (full float32, TF32 off), leading axes kept."""
        lead = res.theta.shape[:-1]
        with no_grad():
            out = smpl_lib.smpl_forward(
                self.smpl_model, res.beta.reshape(-1, res.beta.shape[-1]),
                res.theta.reshape(-1, res.theta.shape[-1]),
                precision=smpl_lib.EXACT_PRECISION)
        return (out.vertices.reshape(*lead, *out.vertices.shape[1:]),
                out.joints.reshape(*lead, *out.joints.shape[1:]))

    def _finish(self, joints, conf, res: FitResult, images
                ) -> EstimateAndFitResult:
        """The final mesh at the exact tier and the joints mapped to
        source pixels."""
        vertices, joints3d = self._mesh(res)
        return EstimateAndFitResult(
            joints2d=self._to_source_frame(joints, images), conf=conf,
            theta=res.theta, beta=res.beta, cam=res.cam,
            vertices=vertices, joints3d=joints3d, energy=res.energy)

    def estimate_and_fit(self, images) -> EstimateAndFitResult:
        """The main path: raw image batch → 2D joints (the front end with
        this estimator's knobs, CPM + soft-argmax decode) → batched
        SMPLify fit on the network-frame joints → posed mesh at the exact
        tier. CPM precision follows the batch-size policy
        (``int8_min_batch``)."""
        _check_frames(images)
        _, joints, conf = self._front_end(images)
        if self.fit_restarts > 1:
            res = fit_lib.fit_smpl_multistart(
                self.smpl_model, joints, conf, self.fit_cfg, self.prior,
                restarts=self.fit_restarts)
        else:
            res = fit_lib.fit_smpl_batch(self.smpl_model, joints, conf,
                                         self.fit_cfg, self.prior,
                                         self._head_init(joints, conf))
        return self._finish(joints, conf, res, images)

    # -- video --------------------------------------------------------------

    def estimate_and_fit_video(self, frames, mode: str = "smooth",
                               mesh=None) -> EstimateAndFitResult:
        """One frame sequence (T, H, W, 3) → 2D joints → one
        whole-sequence fit → posed meshes. ``mode``: "smooth" (the joint
        sequence fit with Viterbi yaw, shared β and smoothness,
        ``fitting/temporal.fit_video_smooth``, with
        max(``fit_restarts``, 1) hypotheses per frame), "temporal" (the
        reference's warm start, ``fit_video``) or "independent"
        (per-frame cold starts). CPM precision follows the batch-size
        policy at T.

        ``mesh`` (``parallel/mesh.make_mesh``; every rank calls with the
        whole sequence, T divisible by the mesh size) splits the frames
        over its ranks: each runs the front end, its part of the fit and
        the mesh on its frames (:meth:`_video`), and the results
        are gathered, so each rank returns the whole sequence's."""
        _check_frames(frames, "frames")
        if mode not in ("smooth", "temporal", "independent"):
            raise ValueError(f"unknown video mode: {mode!r}")
        if mesh is None:
            return self._video(frames, mode)
        from tpu_pose_torch.parallel import mesh as mesh_lib
        shard = mesh_lib.frame_shard(mesh, self.device)
        rows = mesh_lib.shard_rows(frames.shape[0], mesh)
        out = self._video(frames[rows], mode, shard)
        return EstimateAndFitResult(*(shard.gather(f) for f in out))

    def _video(self, frames, mode: str,
               shard=None) -> EstimateAndFitResult:
        """:meth:`estimate_and_fit_video` on ``frames``; with a ``shard``
        (``parallel/mesh.FrameShard``), one rank's part on its T/n
        ``frames``: the front end with the CPM that the whole sequence's
        T picks, its part of the fit (``temporal.fit_video_mode``) and its
        frames' meshes. Every rank of the shard's group calls it together;
        a sharded video artifact is this function exported."""
        t = frames.shape[0] * (1 if shard is None else shard.size)
        _, joints, conf = self._front_end(frames,
                                          cpm=self._params_for_batch(t))
        res = temporal.fit_video_mode(
            mode, self.smpl_model, joints, conf, self.fit_cfg, self.prior,
            restarts=max(self.fit_restarts, 1), shard=shard)
        return self._finish(joints, conf, res, frames)

    def estimate_and_fit_video_stream(self, frames, chunk: int = 64
                                      ) -> EstimateAndFitResult:
        """Any-length video with bounded memory: the 2D front end in
        ``cpm_microbatch``-frame micro-chunks (``chunk`` when
        ``cpm_microbatch`` is 0), then the anchored chunked smooth fit
        (``fitting/temporal.fit_video_stream``)."""
        _check_frames(frames, "frames")
        chunk2d = self.cpm_microbatch if self.cpm_microbatch > 0 else chunk
        _, joints, conf = self._front_end(frames, chunk=chunk2d)
        res = temporal.fit_video_stream(
            self.smpl_model, joints, conf, self.fit_cfg, self.prior,
            chunk=chunk, restarts=max(self.fit_restarts, 1))
        return self._finish(joints, conf, res, frames)

    def _video_window(self, cpm, frames: torch.Tensor,
                      pad_mask: torch.Tensor, anchor=None):
        """One window of a :class:`VideoSession`: the 2D front end, conf
        multiplied by ``pad_mask`` (pad frames carry no weight), the
        anchored smooth fit with the pads masked out. Returns (result,
        the anchor for the next window: the window's last solution)."""
        _, joints, conf = self._front_end(frames, cpm=cpm)
        conf = conf * pad_mask[:, None]
        res = temporal.fit_video_smooth(
            self.smpl_model, joints, conf, self.fit_cfg, self.prior,
            restarts=max(self.fit_restarts, 1), frame_mask=pad_mask,
            anchor=anchor)
        new_anchor = {"theta": res.theta[-1], "beta": res.beta[-1],
                      "cam": res.cam[-1]}
        return self._finish(joints, conf, res, frames), new_anchor

    # -- multi-person -------------------------------------------------------

    def _warn_multi_ignores_scale_tta(self) -> None:
        """``scale_tta`` applies to the single-person front end only (the
        multi-person paths normalize scale per hypothesis with
        ``refine_scale``); say so once per estimator."""
        if self.scale_tta and not self._scale_tta_warned:
            warnings.warn(
                "scale_tta is ignored by the multi-person paths (use "
                "refine_scale for per-hypothesis scale normalization)",
                stacklevel=3)
            self._scale_tta_warned = True

    def _multi_2d(self, frames, cpm=None, **kw):
        """``models/cpm.estimate_2d_multi`` with this estimator's
        letterbox, refine_scale and flip_tta (``kw`` adds the rest), by
        the precision policy unless ``cpm`` is given, on the whole batch
        at once: (heatmaps, joints in the network frame, conf,
        person_scores)."""
        if cpm is None:
            cpm = self._params_for_batch(frames.shape[0])
        with no_grad():
            return cpm_lib.estimate_2d_multi(
                cpm, self._tensor(frames), self.cpm_cfg,
                letterbox=self.letterbox, refine_scale=self.refine_scale,
                flip_tta=self.flip_tta, **kw)

    def estimate_and_fit_multi(self, images, max_people: int = 2,
                               min_person_score: float = 0.05,
                               person_score_frac: float = 0.4,
                               dup_px: float = 30.0,
                               allow_empty: bool = False,
                               nms_radius_px: float = 96.0,
                               dup_joint_frac: float = 0.0
                               ) -> MultiPersonResult:
        """Up to ``max_people`` people per frame: images (B, H, W, 3) →
        ``estimate_2d_multi`` hypotheses (stage 1 once per image, the
        refinement stages per hypothesis) → a fit of every one of the B·k
        hypotheses (yaw multistart when ``fit_restarts`` > 1) → meshes at
        the exact tier. ``person_mask`` is ``models/cpm.select_people``'s
        call (thresholds ``min_person_score`` and ``person_score_frac``,
        dedupe at ``dup_px``, ``dup_joint_frac``; the top hypothesis kept
        unless ``allow_empty``). CPM precision follows the batch-size
        policy; ``scale_tta`` is ignored (with a warning)."""
        _check_frames(images)
        self._warn_multi_ignores_scale_tta()
        _, joints, conf, scores = self._multi_2d(
            images, max_people=max_people, nms_radius_px=nms_radius_px)
        mask = cpm_lib.select_people(scores, min_person_score,
                                     person_score_frac, joints=joints,
                                     dup_px=dup_px, allow_empty=allow_empty,
                                     dup_joint_frac=dup_joint_frac)
        b, k = joints.shape[:2]
        flat_j = joints.reshape(b * k, *joints.shape[2:])
        flat_c = conf.reshape(b * k, -1)
        if self.fit_restarts > 1:
            res = fit_lib.fit_smpl_multistart(
                self.smpl_model, flat_j, flat_c, self.fit_cfg, self.prior,
                restarts=self.fit_restarts)
        else:
            res = fit_lib.fit_smpl_batch(self.smpl_model, flat_j, flat_c,
                                         self.fit_cfg, self.prior,
                                         self._head_init(flat_j, flat_c))
        res = FitResult(*(f.reshape(b, k, *f.shape[1:]) for f in res))
        vertices, joints3d = self._mesh(res)
        return MultiPersonResult(
            joints2d=self._to_source_frame(joints, images), conf=conf,
            person_scores=scores, person_mask=mask, theta=res.theta,
            beta=res.beta, cam=res.cam, vertices=vertices,
            joints3d=joints3d, energy=res.energy)

    def _video_multi(self, cpm, frames, max_people: int = 2,
                     min_person_score: float = 0.05,
                     person_score_frac: float = 0.4, dup_px: float = 30.0,
                     temporal_hints: bool = True, hint_passes: int = 1,
                     hint_crop: bool = False,
                     hint_crop_min_conf: float = 0.0,
                     track_reassociate: bool = False,
                     allow_empty: bool = False,
                     track_birth_cost: float = 0.05,
                     track_death_frames: int = 0,
                     track_anchor_refresh: float = 0.0,
                     presence_keep_frac: float = 1.0,
                     nms_radius_px: float = 96.0, pad_mask=None,
                     track_state=None, anchors=None,
                     return_carry: bool = False):
        """The tracked multi-person pipeline on one sequence or window
        (the JAX package's ``_estimate_and_fit_video_multi_impl``).
        ``pad_mask`` (T,) 0 marks a window's pad frames: they score −1e9,
        count as absent and carry no weight. ``track_state`` and
        ``anchors`` continue a previous window; with ``return_carry`` the
        result comes with the next window's (state, anchors)."""
        frames = self._tensor(frames)
        prev_presence = None
        if anchors is not None and "presence" in anchors:
            # The hysteresis carry rides the anchors but is no fit anchor.
            anchors = dict(anchors)
            prev_presence = anchors.pop("presence")

        def decode(**kw):
            return self._multi_2d(frames, cpm=cpm, max_people=max_people,
                                  nms_radius_px=nms_radius_px, **kw)

        def select(scores, joints, min_score, frac, allow):
            return cpm_lib.select_people(
                scores, min_score, frac, joints=joints, dup_px=dup_px,
                allow_empty=allow, order_by_score=temporal_hints)

        def unpad(x):
            return x if live is None else torch.where(live, x, -1e9)

        live = None if pad_mask is None else pad_mask[:, None] > 0
        _, joints, conf, scores = decode()
        t, k = scores.shape
        size = self.cpm_cfg.input_size
        xnet = pre.preprocess(frames, size, letterbox=self.letterbox)

        def associate(j, s):
            """Viterbi identities from size-normalized joints (geometry)
            and the colors at the joints (appearance)."""
            return tracking.associate_tracks_viterbi(
                j.reshape(t, k, -1) / size,
                tracking.appearance_features(xnet, j), s,
                score_gate=min_person_score, birth_cost=track_birth_cost,
                death_frames=track_death_frames,
                anchor_refresh=track_anchor_refresh,
                init_state=track_state, return_state=True)

        perm, new_state = associate(joints, unpad(scores))
        tj, tc, ts = (tracking.gather_tracks(x, perm)
                      for x in (joints, conf, scores))
        ts = unpad(ts)
        sel_joints, sel_scores = joints, scores
        if temporal_hints:
            # Re-decode with each track's smoothed center as its slot's
            # hint: slot i of the hinted pass is track i.
            for _ in range(max(int(hint_passes), 1)):
                w_hint = cpm_lib.select_people(
                    ts, min_person_score, person_score_frac, joints=tj,
                    dup_px=dup_px, allow_empty=True, order_by_score=True)
                ctr = tj.mean(-2)                                 # (T, k, 2)
                w_s = torch.clamp_min(ts, 0.0) * w_hint
                if live is not None:
                    # Pad frames observe the track's weighted mean center:
                    # the smoother's weight floor would still tie them to
                    # their raw (pad-content) centers.
                    mean_ctr = ((ctr * w_s[..., None]).sum(0)
                                / (w_s.sum(0)[:, None] + 1e-8))
                    ctr = torch.where(live[..., None], ctr, mean_ctr[None])
                hints = tracking.smooth_track_centers(ctr, w_s)
                # hint_crop_dup_px is not passed: its default (30 px), as
                # in the JAX package.
                _, tj, tc, ts = decode(center_hints=hints,
                                       hint_crop=hint_crop,
                                       hint_crop_min_conf=hint_crop_min_conf)
                ts = unpad(ts)
            sel_joints, sel_scores = tj, ts
            if track_reassociate:
                # Associate again on the hinted decodes, from the same
                # carried state; the next window chains on this pass.
                perm2, new_state = associate(tj, ts)
                tj, tc, ts = (tracking.gather_tracks(x, perm2)
                              for x in (tj, tc, ts))
                perm = tracking.compose_perms(perm, perm2)
                sel_joints, sel_scores = tj, ts

        def presence(min_score, frac, allow):
            m = select(sel_scores, sel_joints, min_score, frac, allow)
            if not temporal_hints:
                m = tracking.gather_tracks(m, perm)
            return m if live is None else m & live

        fmask = presence(min_person_score, person_score_frac, allow_empty)
        if presence_keep_frac < 1.0:
            weak = presence(min_person_score * presence_keep_frac,
                            person_score_frac * presence_keep_frac, True)
            init = (prev_presence if prev_presence is not None else
                    torch.zeros(k, dtype=torch.bool, device=fmask.device))
            fmask = tracking.presence_hysteresis(fmask, weak, init)
        track_mask = fmask.to(torch.float32).mean(0) >= 0.5

        # One smooth fit per track, absent frames masked out; an all-absent
        # track falls back to an all-ones mask (its fit is flagged by
        # track_mask, and an all-masked sequence would give NaN).
        fm = fmask.to(torch.float32).T                            # (k, T)
        fm = torch.where((fm > 0).any(1, keepdim=True), fm,
                         torch.ones_like(fm))
        res = temporal.fit_video_smooth_tracks(
            self.smpl_model, tj.transpose(0, 1), tc.transpose(0, 1),
            self.fit_cfg, self.prior, restarts=max(self.fit_restarts, 1),
            frame_mask=fm, anchor=anchors)
        vertices, joints3d = self._mesh(res)
        result = MultiPersonVideoResult(
            joints2d=self._to_source_frame(tj, frames), conf=tc,
            person_scores=ts, frame_mask=fmask, track_mask=track_mask,
            perm=perm, theta=res.theta, beta=res.beta, cam=res.cam,
            vertices=vertices, joints3d=joints3d, energy=res.energy)
        if not return_carry:
            return result
        # The next window's carry: the tracker state and each track's
        # last-frame solution (a window whose carry is used is full).
        new_anchors = {"theta": res.theta[:, -1], "beta": res.beta[:, -1],
                       "cam": res.cam[:, -1]}
        if presence_keep_frac < 1.0:
            new_anchors["presence"] = fmask[-1]
        return result, new_state, new_anchors

    def estimate_and_fit_video_multi(self, frames, max_people: int = 2,
                                     min_person_score: float = 0.05,
                                     person_score_frac: float = 0.4,
                                     dup_px: float = 30.0,
                                     temporal_hints: bool = True,
                                     hint_passes: int = 1,
                                     hint_crop: bool = False,
                                     hint_crop_min_conf: float = 0.0,
                                     track_reassociate: bool = False,
                                     allow_empty: bool = False,
                                     track_birth_cost: float = 0.05,
                                     track_death_frames: int = 0,
                                     track_anchor_refresh: float = 0.0,
                                     presence_keep_frac: float = 1.0,
                                     nms_radius_px: float = 96.0
                                     ) -> MultiPersonVideoResult:
        """Tracked multi-person video, frames (T, H, W, 3):

        1. ``estimate_2d_multi`` on every frame (``max_people`` slots);
        2. identities by ``fitting/tracking.associate_tracks_viterbi`` on
           the slots' joints and appearance (track births at
           ``track_birth_cost``, deaths after ``track_death_frames``
           non-live frames, anchor refresh at ``track_anchor_refresh``);
        3. with ``temporal_hints``, ``hint_passes`` rounds of smoothing
           each track's centers and decoding again with them as the
           slots' hints (``hint_crop``, ``hint_crop_min_conf``: the crop
           pass centered on the hint); ``track_reassociate`` associates
           again on the hinted decodes;
        4. presence per frame by ``select_people`` (``allow_empty``;
           ``presence_keep_frac`` < 1 adds hysteresis) and per track
           (``track_mask``: present in half the frames or more);
        5. one smooth sequence fit per track with its absent frames masked
           (``fitting/temporal.fit_video_smooth_tracks``), max(
           ``fit_restarts``, 1) yaw hypotheses per frame.

        Axis 1 of the 2D fields and axis 0 of the fit fields are the
        track; ``perm`` maps tracks to each frame's slots. CPM precision
        follows the batch-size policy at T."""
        _check_frames(frames, "frames")
        self._warn_multi_ignores_scale_tta()
        return self._video_multi(
            None, frames, max_people=max_people,
            min_person_score=min_person_score,
            person_score_frac=person_score_frac, dup_px=dup_px,
            temporal_hints=temporal_hints, hint_passes=hint_passes,
            hint_crop=hint_crop, hint_crop_min_conf=hint_crop_min_conf,
            track_reassociate=track_reassociate, allow_empty=allow_empty,
            track_birth_cost=track_birth_cost,
            track_death_frames=track_death_frames,
            track_anchor_refresh=track_anchor_refresh,
            presence_keep_frac=presence_keep_frac,
            nms_radius_px=nms_radius_px)

    def estimate_and_fit_video_multi_stream(
            self, frames, max_people: int = 2, chunk: int = 64,
            min_person_score: float = 0.05, person_score_frac: float = 0.4,
            dup_px: float = 30.0, temporal_hints: bool = True,
            hint_passes: int = 1, hint_crop: bool = False,
            hint_crop_min_conf: float = 0.0,
            track_reassociate: bool = False, allow_empty: bool = False,
            track_birth_cost: float = 0.05, track_death_frames: int = 0,
            track_anchor_refresh: float = 0.0,
            presence_keep_frac: float = 1.0) -> MultiPersonVideoResult:
        """Any-length tracked video in ``chunk``-frame windows (a
        :class:`MultiPersonVideoSession` fed all frames, then flushed):
        the tracker state and presence carry across windows, and each
        track's fit is anchored to its previous window's last solution.
        The last partial window is padded with zero frames, masked out.
        Up to ``chunk`` frames run as one
        :meth:`estimate_and_fit_video_multi` call."""
        _check_frames(frames, "frames")
        kw = dict(max_people=max_people, min_person_score=min_person_score,
                  person_score_frac=person_score_frac, dup_px=dup_px,
                  temporal_hints=temporal_hints, hint_passes=hint_passes,
                  hint_crop=hint_crop,
                  hint_crop_min_conf=hint_crop_min_conf,
                  track_reassociate=track_reassociate,
                  allow_empty=allow_empty,
                  track_birth_cost=track_birth_cost,
                  track_death_frames=track_death_frames,
                  track_anchor_refresh=track_anchor_refresh,
                  presence_keep_frac=presence_keep_frac)
        if frames.shape[0] <= chunk:
            return self.estimate_and_fit_video_multi(frames, **kw)
        sess = MultiPersonVideoSession(self, chunk=chunk, **kw)
        outs = [r for r in (sess.push(frames), sess.flush())
                if r is not None]
        return _concat_video_multi(outs)


def _concat(outs) -> EstimateAndFitResult:
    if len(outs) == 1:
        return outs[0]
    return EstimateAndFitResult(*(torch.cat(fs) for fs in zip(*outs)))


# MultiPersonVideoResult's fields by their time axis: 0 for the 2D fields,
# 1 for the per-track fit fields.
_VIDEO_MULTI_T_FIRST = ("joints2d", "conf", "person_scores", "frame_mask",
                        "perm")
_VIDEO_MULTI_K_FIRST = ("theta", "beta", "cam", "vertices", "joints3d",
                        "energy")


def _concat_video_multi(outs) -> MultiPersonVideoResult:
    """Windows' results joined along time (the track axis lines up by the
    carried tracker state); ``track_mask`` is recomputed over them all."""
    if len(outs) == 1:
        return outs[0]
    fields = {f: torch.cat([getattr(o, f) for o in outs], 0)
              for f in _VIDEO_MULTI_T_FIRST}
    fields.update({f: torch.cat([getattr(o, f) for o in outs], 1)
                   for f in _VIDEO_MULTI_K_FIRST})
    fields["track_mask"] = fields["frame_mask"].to(torch.float32).mean(0) \
        >= 0.5
    return MultiPersonVideoResult(**fields)


class _WindowedSession:
    """Frames pushed over time, buffered on the estimator's device and run
    in ``chunk``-frame windows; the last partial window is padded with
    zero frames (``pad_mask`` 0) at ``flush()``. The CPM's precision is
    the policy's at ``chunk`` frames. Subclasses run a window
    (``_run_window``) and join windows' results (``_join``)."""

    def __init__(self, estimator: PoseEstimator, chunk: int):
        self._est = estimator
        self.chunk = int(chunk)
        self._cpm = estimator._params_for_batch(self.chunk)
        self._buf: list = []
        self._buffered = 0
        self._closed = False

    @property
    def frames_buffered(self) -> int:
        """Frames pushed but not yet run (fewer than ``chunk``)."""
        return self._buffered

    def _padded(self, win: torch.Tensor, n_real: int):
        """(the window padded to ``chunk`` frames with zeros, its
        pad_mask)."""
        pad_mask = torch.ones(self.chunk, device=win.device)
        if n_real < self.chunk:
            win = torch.cat([win, win.new_zeros(
                (self.chunk - n_real,) + win.shape[1:])])
            pad_mask[n_real:] = 0.0
        return win, pad_mask

    def _take(self) -> torch.Tensor:
        buf = torch.cat(self._buf) if len(self._buf) > 1 else self._buf[0]
        self._buf = []
        return buf

    def push(self, frames):
        """Buffer ``frames`` (T, H, W, 3) or one frame (H, W, 3); return
        the results of the windows this completed, or None."""
        if self._closed:
            raise RuntimeError("session already flushed")
        frames = self._est._tensor(frames)
        if frames.dim() == 3:
            frames = frames[None]
        _check_frames(frames, "frames")
        self._buf.append(frames)
        self._buffered += frames.shape[0]
        outs = []
        while self._buffered >= self.chunk:
            buf = self._take()
            win, rest = buf[:self.chunk], buf[self.chunk:]
            if rest.shape[0]:
                self._buf = [rest]
            self._buffered -= self.chunk
            outs.append(self._run_window(win, self.chunk))
        return self._join(outs) if outs else None

    def flush(self):
        """Run the last partial window, if any, and close the session;
        either call on a closed session raises ``RuntimeError``."""
        if self._closed:
            raise RuntimeError("session already flushed")
        self._closed = True
        if self._buffered == 0:
            return None
        buf = self._take()
        self._buffered = 0
        return self._run_window(buf, buf.shape[0])


class VideoSession(_WindowedSession):
    """Online single-person video: the incremental form of
    :meth:`PoseEstimator.estimate_and_fit_video_stream` for frames that
    arrive over time. Each full ``chunk``-frame window runs the 2D front
    end and the anchored smooth fit, and its last solution anchors the
    next window (facing, boundary smoothness and the shared β carry
    over); pad frames' conf is zeroed and masked.

    ``push(frames)`` returns the results of the windows it completed, or
    None; ``flush()`` runs the last partial window and closes the
    session."""

    _join = staticmethod(_concat)

    def __init__(self, estimator: PoseEstimator, chunk: int = 64):
        super().__init__(estimator, chunk)
        self._anchor = None

    def _run_window(self, win: torch.Tensor,
                    n_real: int) -> EstimateAndFitResult:
        win, pad_mask = self._padded(win, n_real)
        res, self._anchor = self._est._video_window(
            self._cpm, win, pad_mask, anchor=self._anchor)
        return EstimateAndFitResult(*(f[:n_real] for f in res))


class MultiPersonVideoSession(_WindowedSession):
    """Online tracked multi-person video: the incremental form of
    :meth:`PoseEstimator.estimate_and_fit_video_multi_stream`, with the
    same knobs. Each full ``chunk``-frame window runs the whole tracked
    pipeline; the tracker state (committed identities, anchors, births
    and deaths), the presence carry and each track's last solution carry
    to the next window, so track i is the same person for the whole
    session. Pad frames are masked out of the tracker, presence and fits.

    ``push(frames)`` returns the results of the windows it completed
    (``track_mask`` over those windows), or None; ``flush()`` runs the
    last partial window and closes the session."""

    _join = staticmethod(_concat_video_multi)

    def __init__(self, estimator: PoseEstimator, max_people: int = 2,
                 chunk: int = 64, min_person_score: float = 0.05,
                 person_score_frac: float = 0.4, dup_px: float = 30.0,
                 temporal_hints: bool = True, hint_passes: int = 1,
                 hint_crop: bool = False, hint_crop_min_conf: float = 0.0,
                 track_reassociate: bool = False, allow_empty: bool = False,
                 track_birth_cost: float = 0.05,
                 track_death_frames: int = 0,
                 track_anchor_refresh: float = 0.0,
                 presence_keep_frac: float = 1.0):
        estimator._warn_multi_ignores_scale_tta()
        super().__init__(estimator, chunk)
        self._kw = dict(max_people=max_people,
                        min_person_score=min_person_score,
                        person_score_frac=person_score_frac, dup_px=dup_px,
                        temporal_hints=temporal_hints,
                        hint_passes=hint_passes, hint_crop=hint_crop,
                        hint_crop_min_conf=hint_crop_min_conf,
                        track_reassociate=track_reassociate,
                        allow_empty=allow_empty,
                        track_birth_cost=track_birth_cost,
                        track_death_frames=track_death_frames,
                        track_anchor_refresh=track_anchor_refresh,
                        presence_keep_frac=presence_keep_frac)
        self._state = None
        self._anchors = None

    def _run_window(self, win: torch.Tensor,
                    n_real: int) -> MultiPersonVideoResult:
        win, pad_mask = self._padded(win, n_real)
        res, self._state, self._anchors = self._est._video_multi(
            self._cpm, win, pad_mask=pad_mask, track_state=self._state,
            anchors=self._anchors, return_carry=True, **self._kw)
        return res._replace(
            **{f: getattr(res, f)[:n_real] for f in _VIDEO_MULTI_T_FIRST},
            **{f: getattr(res, f)[:, :n_real] for f in _VIDEO_MULTI_K_FIRST})


# -- module-level functional forms ----------------------------------------

_default_estimator: Optional[PoseEstimator] = None


def _default() -> PoseEstimator:
    """One synthetic estimator on the GPU, built on first use."""
    global _default_estimator
    if _default_estimator is None:
        _default_estimator = PoseEstimator.create_synthetic()
    return _default_estimator


def estimate_2d(images, estimator: Optional[PoseEstimator] = None
                ) -> Estimate2DResult:
    return (estimator or _default()).estimate_2d(images)


def fit_smpl(joints2d, conf, estimator: Optional[PoseEstimator] = None,
             **kw) -> FitResult:
    return (estimator or _default()).fit_smpl(joints2d, conf, **kw)


def estimate_and_fit(images, estimator: Optional[PoseEstimator] = None
                     ) -> EstimateAndFitResult:
    return (estimator or _default()).estimate_and_fit(images)
