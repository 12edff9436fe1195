"""Temporal / video fitting (port of ``tpu_pose/fitting/temporal.py``).

- :func:`fit_video`: the reference's temporal init — a multi-start fit of
  frame 0, short warm-started fits frame by frame, then every frame
  refined together with the last stage.
- :func:`fit_video_independent`: every frame cold-started, batched.
- :func:`fit_video_smooth`: one joint whole-sequence optimization — per
  frame all yaw hypotheses of a multi-start fit, the consistent path
  through them (:func:`_viterbi_select`), then Adam over the whole
  sequence with one shared β and temporal smoothness;
  :func:`fit_video_smooth_tracks` fits several such sequences (the tracks
  of a multi-person video) in one batch.
- :func:`fit_video_stream`: :func:`fit_video_smooth` over fixed-size
  chunks, each anchored to the previous chunk's last solution.

The JAX package's ``lax.scan`` loops are Python loops over device
tensors here; nothing reads a device value on the host. The Viterbi
selection's loops are ``scan``s, and inside an export
(``fit.exporting()``) the warm starts are too
(:func:`_warm_starts_scan`, the same steps), so an artifact runs any
number of frames.

Frame sharding (``mesh=``, JAX's ``jit`` with T in ``P("data")``): every
rank calls the function on the whole sequence, fits its block of frames
and gathers the results, so it returns what the single-device call
returns. The smooth fit's hypotheses are fitted on each rank's frames and
gathered for the Viterbi selection, which every rank runs on the whole
lattice; its joint refine trades the edge frames' θ and cam with the
neighbouring ranks at every step (``parallel/mesh.halo_exchange``) and
sums the shared β's gradient over them (``mesh.psum``). The temporal
mode's warm-start chain is serial: every rank runs it on the gathered
joints, then refines its own frames. :func:`fit_video_mode` with a
shard is one rank's part, on its own frames (what a sharded artifact
runs).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Optional

import torch

from tpu_pose_torch.fitting import fit as fit_lib
from tpu_pose_torch.fitting.energy import fit_energy
from tpu_pose_torch.fitting.fit import (FitResult, _normalize_obs, _run_adam,
                                        capsule_spec_for, fit_smpl_batch,
                                        fit_smpl_multistart, fit_smpl_single)
from tpu_pose_torch.models.smpl_data import SMPLData
from tpu_pose_torch.utils.config import FitConfig
from tpu_pose_torch.utils.device import no_grad


def warmstart_schedule(cfg: FitConfig, iters: int = 30) -> FitConfig:
    """Truncated single-stage schedule for the sequential pass: the last
    stage with ``iters`` steps."""
    stage = dataclasses.replace(cfg.stages[-1], iters=iters)
    return dataclasses.replace(cfg, stages=(stage,))


def _params(res) -> dict:
    return {"theta": res.theta, "beta": res.beta, "cam": res.cam}


def _on_mesh(mesh, fn, joints2d: torch.Tensor, conf: torch.Tensor,
             *args, frame_dim: int = 0, frame_mask=None, **kw) -> FitResult:
    """``fn(joints2d, conf, *args, shard=…, **kw)`` on this rank's frames
    of the whole sequence (``frame_dim`` of each input), its results
    gathered: the whole sequence's, on every rank."""
    from tpu_pose_torch.parallel import mesh as mesh_lib
    shard = mesh_lib.frame_shard(mesh, joints2d.device)
    mesh_lib.shard_rows(joints2d.shape[frame_dim], mesh)   # divisible
    if frame_mask is not None:
        kw["frame_mask"] = shard.rows(frame_mask, frame_dim)
    res = fn(shard.rows(joints2d, frame_dim), shard.rows(conf, frame_dim),
             *args, shard=shard, **kw)
    return FitResult(*(shard.gather(f, frame_dim) for f in res))


def fit_video(model: SMPLData, joints2d_seq: torch.Tensor,
              conf_seq: torch.Tensor, cfg: FitConfig = FitConfig(),
              prior: Any = None, warm_iters: int = 30,
              anchor_restarts: int = 4, mesh=None) -> FitResult:
    """Temporal-init video fit, joints2d_seq (T, P, 2) pixels, conf_seq
    (T, P). Frame 0 gets a multi-start staged fit (``anchor_restarts`` >
    1); frames 1..T−1 each get ``warm_iters`` steps of the last stage
    seeded from frame t−1's solution, one after another; then every frame
    is refined together with the full last stage. With a ``mesh`` (the
    frames split over its ranks) every rank runs the chain on every frame
    and refines its own (the chain is serial, in JAX's scan too)."""
    if mesh is not None:
        return _on_mesh(mesh, lambda j, c, shard: _fit_video(
            model, j, c, cfg, prior, warm_iters, anchor_restarts, shard),
            joints2d_seq, conf_seq)
    return _fit_video(model, joints2d_seq, conf_seq, cfg, prior, warm_iters,
                      anchor_restarts)


def _fit_video(model: SMPLData, joints2d_seq: torch.Tensor,
               conf_seq: torch.Tensor, cfg: FitConfig, prior: Any,
               warm_iters: int = 30, anchor_restarts: int = 4,
               shard: Any = None) -> FitResult:
    """:func:`fit_video`; with a ``shard`` (``parallel/mesh.FrameShard``)
    on this rank's frames: the chain runs on the gathered sequence, the
    refine on this rank's frames, whose results it returns."""
    joints_rows, conf_rows = joints2d_seq, conf_seq
    if shard is not None:
        p = joints2d_seq.shape[1]
        both = shard.gather(torch.cat([joints2d_seq.flatten(1), conf_seq],
                                      -1))
        joints2d_seq = both[:, :2 * p].unflatten(1, (p, 2))
        conf_seq = both[:, 2 * p:]
    if anchor_restarts > 1:
        first = fit_smpl_multistart(model, joints2d_seq[:1], conf_seq[:1],
                                    cfg, prior, restarts=anchor_restarts)
        first = FitResult(*(f[0] for f in first))
    else:
        first = fit_smpl_single(model, joints2d_seq[0], conf_seq[0], cfg,
                                prior)
    warm_cfg = warmstart_schedule(cfg, warm_iters)
    n = joints2d_seq.shape[0]
    if fit_lib.exporting() and not (isinstance(n, int) and n == 1):
        init = _warm_starts_scan(model, joints2d_seq, conf_seq, warm_cfg,
                                 prior, _params(first))
    else:
        seq = [_params(first)]
        for t in range(1, n):
            # An export's scan form replays the first frame's graph for
            # every frame: record that one only.
            with (contextlib.nullcontext() if t == 1
                  else fit_lib.not_recording()):
                seq.append(_params(fit_smpl_single(
                    model, joints2d_seq[t], conf_seq[t], warm_cfg, prior,
                    init=seq[-1])))
        init = {k: torch.stack([p[k] for p in seq]) for k in seq[0]}
    if shard is not None:
        init = {k: shard.rows(v) for k, v in init.items()}
    refine_cfg = warmstart_schedule(cfg, cfg.stages[-1].iters)
    return fit_smpl_batch(model, joints_rows, conf_rows, refine_cfg, prior,
                          init)


def _warm_starts_scan(model: SMPLData, joints2d_seq: torch.Tensor,
                      conf_seq: torch.Tensor, warm_cfg: FitConfig,
                      prior: Any, first: dict) -> dict:
    """:func:`fit_video`'s warm starts as one ``scan`` over frames 1..T−1
    (for an export: T may be symbolic): each step is frame t's
    ``warm_cfg`` fit seeded from frame t−1's solution, the eager loop's
    call (its stages; the final energy it also computes is not used).
    Returns the (T, ...) inits, frame 0's ``first``."""
    static = (model, prior, capsule_spec_for(model, warm_cfg.stages))
    leaves = fit_lib._flatten(static)
    keys = ("theta", "beta", "cam")

    def body(theta, beta, cam, joints2d, conf, *leaves):
        model, prior, capsule_spec = fit_lib._unflatten(static, iter(leaves))
        x = torch.cat([theta, beta, cam])[None].to(torch.float32)
        x, _ = fit_lib.fit_stages(model, _normalize_obs(joints2d[None],
                                                        warm_cfg),
                                  conf[None], x, warm_cfg, prior,
                                  capsule_spec)
        out = tuple(v[0].clone()
                    for v in fit_lib._split(x, warm_cfg).values())
        return out + tuple(t.clone() for t in out)

    out = fit_lib.scan_replaying(body, [fit_lib.dense(first[k])
                                        for k in keys],
                                 [joints2d_seq[1:], conf_seq[1:]],
                                 tuple(t.view_as(t) for t in leaves))
    return {k: torch.cat([first[k][None], seq])
            for k, seq in zip(keys, out[3:])}


def fit_video_independent(model: SMPLData, joints2d_seq: torch.Tensor,
                          conf_seq: torch.Tensor,
                          cfg: FitConfig = FitConfig(),
                          prior: Any = None, mesh=None) -> FitResult:
    """Every frame cold-started, fitted as one batch; with a ``mesh``,
    each rank fits its frames and the results are gathered."""
    if mesh is not None:
        return _on_mesh(mesh, lambda j, c, shard: fit_smpl_batch(
            model, j, c, cfg, prior), joints2d_seq, conf_seq)
    return fit_smpl_batch(model, joints2d_seq, conf_seq, cfg, prior)


def fit_video_mode(mode: str, model: SMPLData, joints2d: torch.Tensor,
                   conf: torch.Tensor, cfg: FitConfig, prior: Any,
                   restarts: int = 4, shard: Any = None) -> FitResult:
    """``api.estimate_and_fit_video``'s fit in ``mode``: "smooth"
    (:func:`fit_video_smooth` with ``restarts`` hypotheses), "temporal"
    (:func:`fit_video`) or "independent" (:func:`fit_video_independent`),
    on joints2d (T, P, 2) and conf (T, P). With a ``shard``
    (``parallel/mesh.FrameShard``) the inputs are this rank's frames and
    so are the results: one rank's part of the frame-sharded fit, which
    every rank of the shard's group runs together (what a sharded video
    artifact runs)."""
    if mode == "smooth":
        res = _fit_smooth_tracks(model, joints2d[None], conf[None], cfg,
                                 prior, restarts=restarts, shard=shard)
        return FitResult(*(f[0] for f in res))
    if mode == "temporal":
        return _fit_video(model, joints2d, conf, cfg, prior, shard=shard)
    return fit_smpl_batch(model, joints2d, conf, cfg, prior)


def _viterbi_select(energy: torch.Tensor, glob: torch.Tensor,
                    weight: float,
                    anchor_glob: Optional[torch.Tensor] = None,
                    frame_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Minimum-cost hypothesis path through the (frame × restart) lattice:
    energy (..., T, R) as unary cost, ``weight``·‖Δ global orientation‖²
    (glob (..., T, R, 3)) between consecutive frames' hypotheses, over
    any leading (track) axes. NaN energies count as +inf. Frames with
    ``frame_mask`` (..., T) 0 add no unary and no transition cost
    (``where``, not a product: a diverged pad hypothesis has e = inf, and
    inf·0 = NaN). ``anchor_glob`` (..., 3) adds a transition from a
    virtual frame −1. Ties go to the first index, as ``jnp.argmin``.
    Returns (..., T) int32 selections, computed on the device.

    Both passes are ``scan``s, so an export runs any T. The forward pass
    runs over all T frames, carrying the path costs and the previous
    frame's orientations (and mask), and leaves frame 0's costs as they
    are; the backtrack runs over the T back-pointers in reverse, emitting
    each frame's selection before it steps back. No tensor has T − 1
    rows: a symbolic T − 1 would be guarded to be ≠ 1, which rules out
    T = 2."""
    from torch._higher_order_ops.scan import scan_op
    e = torch.where(torch.isnan(energy), math.inf, energy)
    if frame_mask is not None:
        e = torch.where(frame_mask[..., None] > 0, e, 0.0)
    cost = e[..., 0, :]
    if anchor_glob is not None:
        cost = cost + weight * ((glob[..., 0, :, :]
                                 - anchor_glob[..., None, :]) ** 2).sum(-1)
    n = e.shape[-2]
    first = torch.arange(n, device=e.device) == 0

    def forward(cost, g_prev, *rest):
        if frame_mask is None:
            g_t, e_t, first = rest
            w = weight
            carry = ()
        else:
            m_prev, g_t, e_t, first, m_t = rest
            w = (weight * m_t * m_prev)[..., None, None]
            carry = (m_t.clone(),)
        trans = ((g_t[..., None, :, :] - g_prev[..., :, None, :]) ** 2
                 ).sum(-1)                               # (..., R_prev, R)
        tot = cost[..., :, None] + w * trans + e_t[..., None, :]
        cost = torch.where(first, cost, tot.amin(dim=-2))
        return (cost, g_t.clone()) + carry + (tot.argmin(dim=-2),)

    init = [fit_lib.dense(cost), fit_lib.dense(glob[..., 0, :, :])]
    xs = [glob.movedim(-3, 0), e.movedim(-2, 0), first]
    if frame_mask is not None:
        init.append(fit_lib.dense(frame_mask[..., 0]))
        xs.append(frame_mask.movedim(-1, 0))
    cost, *_, backs = scan_op(forward, init, xs, ())

    def backward(idx, bp):
        return bp.gather(-1, idx), idx.clone()

    # Frame 0's back-pointers are never read: its step leaves the carry.
    _, path = scan_op(backward, [cost.argmin(dim=-1, keepdim=True)],
                      [backs.flip(0)], ())
    return path.flip(0)[..., 0].movedim(0, -1).to(torch.int32)


def fit_video_smooth(model: SMPLData, joints2d_seq: torch.Tensor,
                     conf_seq: torch.Tensor, cfg: FitConfig = FitConfig(),
                     prior: Any = None, restarts: int = 4,
                     select_weight: Optional[float] = None,
                     smooth_theta: Optional[float] = None,
                     smooth_cam: Optional[float] = None,
                     shared_beta: bool = True, iters: int = 100,
                     lr: float = 0.01, anchor: Optional[dict] = None,
                     frame_mask: Optional[torch.Tensor] = None,
                     mesh=None) -> FitResult:
    """Joint whole-sequence fit, joints2d_seq (T, P, 2) pixels, conf_seq
    (T, P):

    1. per frame, all ``restarts`` yaw hypotheses of
       :func:`fit_smpl_multistart` (one batch of T·R fits);
    2. the consistent hypothesis path (:func:`_viterbi_select`);
    3. ``iters`` Adam steps (``lr``) over θ (T, 72), β ((10,) shared, or
       (T, 10)) and cam (T, 3) together, on Σ_t fit energy at the last
       stage + ``smooth_theta``·s²·Σ‖Δθ‖² + ``smooth_cam``·s²·Σ‖Δcam‖²
       (s = the observation scale, as for the priors).

    ``anchor`` ({'theta', 'beta', 'cam'} of the frame before the
    sequence) adds a transition cost to the selection, fixes the shared
    β's init and adds boundary smoothness terms. ``frame_mask`` (T,)
    excludes mask-0 frames (stream pads) from the data, smoothness and
    selection costs and from the shared β's init. The weights default to
    ``cfg.video_select_weight`` / ``video_smooth_theta`` /
    ``video_smooth_cam``. ``beta`` comes back (T, 10) either way;
    ``energy_history`` has shape (0,). One track of
    :func:`fit_video_smooth_tracks`; ``mesh`` splits the frames over its
    ranks (see there)."""
    res = fit_video_smooth_tracks(
        model, joints2d_seq[None], conf_seq[None], cfg, prior,
        restarts=restarts, select_weight=select_weight,
        smooth_theta=smooth_theta, smooth_cam=smooth_cam,
        shared_beta=shared_beta, iters=iters, lr=lr,
        anchor=None if anchor is None else {k: v[None]
                                            for k, v in anchor.items()},
        frame_mask=None if frame_mask is None else frame_mask[None],
        mesh=mesh)
    return FitResult(*(f[0] for f in res))


def fit_video_smooth_tracks(model: SMPLData, joints2d: torch.Tensor,
                            conf: torch.Tensor,
                            cfg: FitConfig = FitConfig(),
                            prior: Any = None, restarts: int = 4,
                            select_weight: Optional[float] = None,
                            smooth_theta: Optional[float] = None,
                            smooth_cam: Optional[float] = None,
                            shared_beta: bool = True, iters: int = 100,
                            lr: float = 0.01,
                            anchor: Optional[dict] = None,
                            frame_mask: Optional[torch.Tensor] = None,
                            mesh=None) -> FitResult:
    """:func:`fit_video_smooth` of K independent sequences at once (the
    JAX package vmaps it over a multi-person video's tracks): joints2d
    (K, T, P, 2), conf (K, T, P), ``anchor`` values and ``frame_mask``
    with a leading K axis. One multistart batch of K·T·R fits, the Viterbi
    selection batched over K, and one Adam loop on all K sequences' θ,
    β and cam (three tensors, updated as their concatenation would be):
    the energies of the sequences are independent and Adam is
    elementwise, so the gradient of their sum gives each sequence its
    own updates. Results are (K, T, ...). The joint refine
    is Adam whatever ``cfg.optimizer`` says, and takes the last stage's
    interpenetration weight, as in the JAX package.

    With a ``mesh`` the T frames are split over its ranks (T divisible
    by its size): each rank fits its frames' hypotheses; the lattice of
    their energies and orientations (and β, and the mask) is gathered
    and every rank selects on all of it; the shared β starts from the
    mean over all T frames; and the refine's energy counts each pair of
    neighbouring frames once, the pair across two ranks with the
    neighbour's row of θ, cam and mask, while the shared β's gradient is
    summed over the ranks. Each rank returns the gathered results."""
    kw = dict(restarts=restarts, select_weight=select_weight,
              smooth_theta=smooth_theta, smooth_cam=smooth_cam,
              shared_beta=shared_beta, iters=iters, lr=lr, anchor=anchor)
    if mesh is not None:
        return _on_mesh(mesh, functools.partial(_fit_smooth_tracks, model),
                        joints2d, conf, cfg, prior, frame_dim=1,
                        frame_mask=frame_mask, **kw)
    return _fit_smooth_tracks(model, joints2d, conf, cfg, prior,
                              frame_mask=frame_mask, **kw)


@dataclasses.dataclass(frozen=True)
class _Exchange:
    """The smooth refine's trades with the neighbouring ranks at each
    Adam step (``fit._run_adam``'s ``exchange``), over θ (K·n, 72), β
    and cam (K·n, 3): before the gradient, the halo (the left
    neighbour's last and the right neighbour's first frame of θ and cam,
    concatenated, (K, 75) each); after it, the shared β's gradient
    summed over the ranks (the energy sums over all frames)."""
    shard: Any
    tracks: int
    shared_beta: bool

    def _edges(self, theta, cam):
        rows = torch.cat([theta, cam], -1).unflatten(0, (self.tracks, -1))
        return rows[:, 0], rows[:, -1]

    def halo(self, xs) -> tuple:
        from tpu_pose_torch.parallel import mesh as mesh_lib
        first, last = self._edges(xs[0], xs[2])
        left, right, _, _ = mesh_lib.halo_exchange(first, last, self.shard)
        return left, right

    def halo_like(self, xs) -> tuple:
        first, _ = self._edges(xs[0], xs[2])
        return torch.zeros_like(first), torch.zeros_like(first)

    def reduce(self, gs) -> tuple:
        from tpu_pose_torch.parallel import mesh as mesh_lib
        theta, beta, cam = gs
        if self.shared_beta:
            beta = mesh_lib.psum(beta, self.shard)
        return theta, beta, cam


def _fit_smooth_tracks(model: SMPLData, joints2d: torch.Tensor,
                       conf: torch.Tensor, cfg: FitConfig, prior: Any,
                       restarts: int = 4,
                       select_weight: Optional[float] = None,
                       smooth_theta: Optional[float] = None,
                       smooth_cam: Optional[float] = None,
                       shared_beta: bool = True, iters: int = 100,
                       lr: float = 0.01, anchor: Optional[dict] = None,
                       frame_mask: Optional[torch.Tensor] = None,
                       shard: Any = None) -> FitResult:
    """:func:`fit_video_smooth_tracks`; with a ``shard``
    (``parallel/mesh.FrameShard``) on this rank's frames, whose results
    it returns (``anchor`` is the whole sequence's)."""
    select_weight = (cfg.video_select_weight if select_weight is None
                     else select_weight)
    smooth_theta = (cfg.video_smooth_theta if smooth_theta is None
                    else smooth_theta)
    smooth_cam = cfg.video_smooth_cam if smooth_cam is None else smooth_cam
    kt, n = joints2d.shape[:2]
    flat_j = joints2d.reshape(kt * n, *joints2d.shape[2:])
    flat_c = conf.reshape(kt * n, -1)
    # With a shard, the whole sequence's mask and selected β (the β
    # init's mean is over all T frames, not a mean of the ranks' means).
    all_mask = frame_mask
    if shard is not None and frame_mask is not None:
        all_mask = shard.gather(frame_mask, 1)
    if restarts > 1:
        every = fit_smpl_multistart(model, flat_j, flat_c, cfg, prior,
                                    restarts=restarts, return_all=True)
        every = FitResult(*(f.reshape(kt, n, *f.shape[1:])
                            for f in every))                # (K, T, R, ...)
        energy, glob, betas = every.energy, every.theta[..., :3], every.beta
        if shard is not None:   # the whole lattice, on every rank
            lattice = shard.gather(
                torch.cat([energy[..., None], glob, betas], -1), 1)
            energy, glob, betas = lattice.split([1, 3, betas.shape[-1]],
                                                -1)
            energy = energy[..., 0]
        sel = _viterbi_select(
            energy, glob, select_weight,
            anchor_glob=None if anchor is None else anchor["theta"][:, :3],
            frame_mask=all_mask).long()
        tracks = torch.arange(kt, device=sel.device)[:, None]
        rows = torch.arange(n, device=sel.device)[None, :]
        if shard is not None:
            every_row = torch.arange(sel.shape[1], device=sel.device)
            all_beta = betas[tracks, every_row[None, :], sel]
            sel = shard.rows(sel, 1)
        base = FitResult(*(f[tracks, rows, sel] for f in every))
        if shard is None:
            all_beta = base.beta
    else:
        base = fit_video_independent(model, flat_j, flat_c, cfg, prior)
        base = FitResult(*(f.reshape(kt, n, *f.shape[1:]) for f in base))
        all_beta = base.beta
        if shard is not None and shared_beta and anchor is None:
            all_beta = shard.gather(base.beta, 1)

    if anchor is not None and shared_beta:
        beta0 = anchor["beta"]
    elif shared_beta and frame_mask is not None:
        # Masked mean: pad frames' β hypotheses must not leak in.
        w = all_mask.to(all_beta.dtype)
        beta0 = ((all_beta * w[..., None]).sum(1)
                 / (w.sum(1) + 1e-8)[:, None])
    else:
        beta0 = all_beta.mean(1) if shared_beta else base.beta
    obs = _normalize_obs(flat_j, cfg)
    stage = cfg.stages[-1]
    scale = (2.0 / cfg.img_size) if cfg.normalize_obs else 1.0
    s2 = scale * scale
    capsule_spec = capsule_spec_for(model, (stage,))

    def split(theta, beta, cam):
        # θ and cam are (K·T, ...) rows, as are the observations, so an
        # export's T is their symbolic dim 0 (and is read from them, not
        # from this call's T); β is (K, 10) when shared.
        theta = theta.reshape(kt, -1, theta.shape[-1])
        beta = (beta[:, None].expand(-1, theta.shape[1], -1) if shared_beta
                else beta.reshape(kt, -1, beta.shape[-1]))
        return {"theta": theta, "beta": beta,
                "cam": cam.reshape(kt, -1, cam.shape[-1])}

    def frame_energies(p, obs, conf, frame_mask, model, prior,
                       capsule_spec):
        e = fit_energy({k: v.reshape(-1, v.shape[-1]) for k, v in p.items()},
                       model, obs, conf, stage, cfg, prior,
                       capsule_spec).reshape(kt, -1)
        # where(), not a product: a NaN/inf pad energy times 0 is NaN.
        return e if frame_mask is None else torch.where(frame_mask > 0, e,
                                                        0.0)

    def pair(a, b, step_mask):
        """The smoothness of consecutive frames' rows b → a of θ and cam
        concatenated, (K, 75) each."""
        d = a - b
        dth, dca = d[:, :-3], d[:, -3:]
        sq_th, sq_ca = (dth * dth).sum(-1), (dca * dca).sum(-1)
        if step_mask is not None:
            sq_th, sq_ca = step_mask * sq_th, step_mask * sq_ca
        return smooth_theta * s2 * sq_th.sum() + smooth_cam * s2 * sq_ca.sum()

    def total_energy(theta, beta, cam, *inputs):
        halo, inputs = ((None, inputs) if shard is None
                        else (inputs[0], inputs[1:]))
        (obs, conf, frame_mask, model, prior, capsule_spec, anchor,
         edges) = inputs
        p = split(theta, beta, cam)
        dth = p["theta"][:, 1:] - p["theta"][:, :-1]
        dca = p["cam"][:, 1:] - p["cam"][:, :-1]
        sq_th, sq_ca = (dth * dth).sum(-1), (dca * dca).sum(-1)
        if frame_mask is not None:
            step_mask = frame_mask[:, 1:] * frame_mask[:, :-1]
            sq_th, sq_ca = step_mask * sq_th, step_mask * sq_ca
        e = (frame_energies(p, obs, conf, frame_mask, model, prior,
                            capsule_spec).sum()
             + smooth_theta * s2 * sq_th.sum()
             + smooth_cam * s2 * sq_ca.sum())
        if halo is not None:
            # The pair across this rank's left edge is its own; the pair
            # across its right edge is the right neighbour's, and enters
            # only the gradient (its value here is r − r = 0), so that
            # the edge frames take both pairs' gradients and the ranks'
            # energies sum to the sequence's, each pair once.
            rows = torch.cat([p["theta"], p["cam"]], -1)
            left, right = halo
            own = edges["has_left"] * pair(rows[:, 0], left,
                                           edges.get("mask_left"))
            theirs = edges["has_right"] * pair(right, rows[:, -1],
                                               edges.get("mask_right"))
            e = e + own + (theirs - theirs.detach())
        if anchor is not None:
            dth0 = p["theta"][:, 0] - anchor["theta"]
            dca0 = p["cam"][:, 0] - anchor["cam"]
            a_th = smooth_theta * s2 * (dth0 * dth0).sum()
            a_ca = smooth_cam * s2 * (dca0 * dca0).sum()
            if edges is not None:   # the rank that holds frame 0's
                a_th, a_ca = edges["first"] * a_th, edges["first"] * a_ca
            e = e + a_th + a_ca
        return e

    x = (base.theta.reshape(kt * n, -1).to(torch.float32),
         (beta0 if shared_beta else beta0.reshape(kt * n, -1)).to(
             torch.float32),
         base.cam.reshape(kt * n, -1).to(torch.float32))
    edges = exchange = None
    if shard is not None:
        from tpu_pose_torch.parallel import mesh as mesh_lib
        edges = shard.edges(x[0].dtype)
        if frame_mask is not None:   # the step masks across the edges
            m_left, m_right, _, _ = mesh_lib.halo_exchange(
                frame_mask[:, 0], frame_mask[:, -1], shard)
            edges["mask_left"] = m_left * frame_mask[:, 0]
            edges["mask_right"] = frame_mask[:, -1] * m_right
        exchange = _Exchange(shard, kt, shared_beta)
    # Every tensor the energy reads goes in args (fit._run_adam).
    args = (obs, flat_c, frame_mask, model, prior, capsule_spec, anchor,
            edges)
    x, _ = _run_adam(total_energy, x, iters, lr, args=args,
                     exchange=exchange)
    p = split(*x)
    with no_grad():
        energy = frame_energies(p, *args[:6])
    return FitResult(theta=p["theta"], beta=p["beta"].contiguous(),
                     cam=p["cam"], energy=energy,
                     energy_history=torch.zeros(kt, 0, device=obs.device))


def fit_video_stream(model: SMPLData, joints2d_seq: torch.Tensor,
                     conf_seq: torch.Tensor, cfg: FitConfig = FitConfig(),
                     prior: Any = None, chunk: int = 64,
                     **smooth_kw) -> FitResult:
    """Arbitrary-length video as anchored ``chunk``-frame
    :func:`fit_video_smooth` calls: chunk i+1 takes chunk i's last real
    solution as its ``anchor``. The final partial chunk is padded by
    repeating its last frame with zero confidence and masked
    (``frame_mask``), so every chunk has the same shape. Returns the
    concatenated (T, ...) results."""
    t_total = joints2d_seq.shape[0]
    if t_total <= chunk:
        return fit_video_smooth(model, joints2d_seq, conf_seq, cfg, prior,
                                **smooth_kw)
    outs, anchor = [], None
    for start in range(0, t_total, chunk):
        j = joints2d_seq[start:start + chunk]
        c = conf_seq[start:start + chunk]
        n_real = j.shape[0]
        mask = torch.ones(chunk, device=j.device)
        if n_real < chunk:
            reps = chunk - n_real
            j = torch.cat([j, j[-1:].expand(reps, *j.shape[1:])])
            c = torch.cat([c, c.new_zeros((reps,) + c.shape[1:])])
            mask[n_real:] = 0.0
        res = fit_video_smooth(model, j, c, cfg, prior, anchor=anchor,
                               frame_mask=mask, **smooth_kw)
        anchor = {"theta": res.theta[n_real - 1],
                  "beta": res.beta[n_real - 1],
                  "cam": res.cam[n_real - 1]}
        outs.append(FitResult(*(f[:n_real] for f in res)))
    return FitResult(*(torch.cat(fs) for fs in zip(*outs)))
