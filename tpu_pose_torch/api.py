"""Public API (port of ``tpu_pose/api.py``):

- ``estimate_2d(images)``      — CPM heatmaps + decoded 2D joints.
- ``fit_smpl(joints2d, conf)`` — SMPLify-style 3D fit from 2D joints.
- ``estimate_and_fit(images)`` — raw images → 2D joints → fit → posed mesh.
- ``estimate_and_fit_video(frames, mode)`` — one sequence, one fit
  (smooth, temporal or independent); ``estimate_and_fit_video_stream``
  — any length in anchored chunks; :class:`VideoSession` — the same,
  fed frames as they arrive.

``PoseEstimator`` bundles the CPM, the SMPL model, the prior and the
configs on one device. Inputs may be numpy arrays or tensors; outputs are
tensors on the estimator's device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu_pose_torch.fitting import fit as fit_lib
from tpu_pose_torch.fitting import priors as priors_lib
from tpu_pose_torch.fitting import temporal
from tpu_pose_torch.fitting.fit import FitResult
from tpu_pose_torch.models import cpm as cpm_lib
from tpu_pose_torch.models import smpl as smpl_lib
from tpu_pose_torch.models import smpl_data as smpl_data_lib
from tpu_pose_torch.ops import preprocess as pre
from tpu_pose_torch.utils import tf_converter
from tpu_pose_torch.utils.config import CPMConfig, FitConfig, FrontEndConfig
from tpu_pose_torch.utils.device import resolve_device


class Estimate2DResult(NamedTuple):
    heatmaps: torch.Tensor   # (B, 46, 46, P+1)
    joints2d: torch.Tensor   # (B, P, 2) input-frame pixels
    conf: torch.Tensor       # (B, P)


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
    (``scale_tta`` factors must lie in (0, 16)); ``init_head`` raises
    ``NotImplementedError`` (ROADMAP.md A.14).

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
        if init_head is not None:
            raise NotImplementedError(
                "not ported yet: init_head (ROADMAP.md A.14)")
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
        with torch.no_grad():
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
        global-yaw hypotheses per sample and keeps the lowest energy."""
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

    def _finish(self, joints, conf, res: FitResult, images
                ) -> EstimateAndFitResult:
        """The final mesh at the exact tier (full float32, TF32 off) and
        the joints mapped to source pixels."""
        with torch.no_grad():
            out = smpl_lib.smpl_forward(self.smpl_model, res.beta,
                                        res.theta,
                                        precision=smpl_lib.EXACT_PRECISION)
        return EstimateAndFitResult(
            joints2d=self._to_source_frame(joints, images), conf=conf,
            theta=res.theta, beta=res.beta, cam=res.cam,
            vertices=out.vertices, joints3d=out.joints, energy=res.energy)

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
                                         self.fit_cfg, self.prior)
        return self._finish(joints, conf, res, images)

    # -- video --------------------------------------------------------------

    def estimate_and_fit_video(self, frames, mode: str = "smooth"
                               ) -> EstimateAndFitResult:
        """One frame sequence (T, H, W, 3) → 2D joints → one
        whole-sequence fit → posed meshes. ``mode``: "smooth" (the joint
        sequence fit with Viterbi yaw, shared β and smoothness,
        ``fitting/temporal.fit_video_smooth``, with
        max(``fit_restarts``, 1) hypotheses per frame), "temporal" (the
        reference's warm start, ``fit_video``) or "independent"
        (per-frame cold starts). CPM precision follows the batch-size
        policy at T."""
        _check_frames(frames, "frames")
        if mode not in ("smooth", "temporal", "independent"):
            raise ValueError(f"unknown video mode: {mode!r}")
        _, joints, conf = self._front_end(frames)
        args = (self.smpl_model, joints, conf, self.fit_cfg, self.prior)
        if mode == "smooth":
            res = temporal.fit_video_smooth(
                *args, restarts=max(self.fit_restarts, 1))
        elif mode == "temporal":
            res = temporal.fit_video(*args)
        else:
            res = temporal.fit_video_independent(*args)
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


def _concat(outs) -> EstimateAndFitResult:
    if len(outs) == 1:
        return outs[0]
    return EstimateAndFitResult(*(torch.cat(fs) for fs in zip(*outs)))


class VideoSession:
    """Online single-person video: the incremental form of
    :meth:`PoseEstimator.estimate_and_fit_video_stream` for frames that
    arrive over time. Frames buffer on the estimator's device; each full
    ``chunk``-frame window runs the 2D front end and the anchored smooth
    fit, and its last solution anchors the next window (facing, boundary
    smoothness and the shared β carry over). The CPM's precision is the
    policy's at ``chunk`` frames.

    ``push(frames)`` returns the results of the windows it completed, or
    None. ``flush()`` runs the last partial window, padded with zero
    images whose conf is zeroed and masked, and closes the session;
    either call on a closed session raises ``RuntimeError``."""

    def __init__(self, estimator: PoseEstimator, chunk: int = 64):
        self._est = estimator
        self.chunk = int(chunk)
        self._cpm = estimator._params_for_batch(self.chunk)
        self._buf: list = []
        self._buffered = 0
        self._anchor = None
        self._closed = False

    @property
    def frames_buffered(self) -> int:
        """Frames pushed but not yet run (fewer than ``chunk``)."""
        return self._buffered

    def _run_window(self, win: torch.Tensor,
                    n_real: int) -> EstimateAndFitResult:
        pad_mask = torch.ones(self.chunk, device=win.device)
        if n_real < self.chunk:
            win = torch.cat([win, win.new_zeros(
                (self.chunk - n_real,) + win.shape[1:])])
            pad_mask[n_real:] = 0.0
        res, self._anchor = self._est._video_window(
            self._cpm, win, pad_mask, anchor=self._anchor)
        return EstimateAndFitResult(*(f[:n_real] for f in res))

    def _take(self) -> torch.Tensor:
        buf = torch.cat(self._buf) if len(self._buf) > 1 else self._buf[0]
        self._buf = []
        return buf

    def push(self, frames) -> Optional[EstimateAndFitResult]:
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
        return _concat(outs) if outs else None

    def flush(self) -> Optional[EstimateAndFitResult]:
        if self._closed:
            raise RuntimeError("session already flushed")
        self._closed = True
        if self._buffered == 0:
            return None
        buf = self._take()
        self._buffered = 0
        return self._run_window(buf, buf.shape[0])
