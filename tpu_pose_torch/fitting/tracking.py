"""Multi-person video: identity association over hypothesis slots (port of
``tpu_pose/fitting/tracking.py``).

``models/cpm.estimate_2d_multi`` orders each frame's k hypothesis slots
by peak score, not by person, so slot i can change people from frame to
frame. The functions here re-order every frame's slots into tracks, track
i being the same person in every frame:

- :func:`appearance_features`: the image colors around each decoded
  joint, the re-identification feature that bridges occlusions;
- :func:`associate_tracks`: a greedy per-frame filter;
- :func:`associate_tracks_viterbi`: the whole sequence's assignment as a
  shortest path over the k! per-frame permutations, with track births,
  deaths and anchor refresh, and a state carried across windows;
- :func:`smooth_track_centers`: robust smoothing of each track's center
  trajectory, the hints of the re-decoding pass;
- :func:`presence_hysteresis`, :func:`gather_tracks`,
  :func:`compose_perms`.

The JAX package's ``lax.scan`` loops are Python loops over device tensors
here. Nothing reads a device value on the host: the argmins index with
``index_select`` and ``gather``, never through a Python integer.
"""

from __future__ import annotations

import functools
import itertools

import torch

from tpu_pose_torch.ops import preprocess as pre
from tpu_pose_torch.utils.device import full_f32_matmul

__all__ = ["appearance_features", "associate_tracks", "gather_tracks",
           "compose_perms", "presence_hysteresis",
           "associate_tracks_viterbi", "smooth_track_centers"]


@functools.lru_cache(maxsize=None)
def _permutations(k: int, device: torch.device) -> torch.Tensor:
    """All k! assignments, (k!, k) int64 on ``device``, in
    ``itertools.permutations`` order: row p maps track i → slot
    perms[p, i]."""
    return torch.tensor(list(itertools.permutations(range(k))),
                        dtype=torch.long, device=device)


def appearance_features(images_net: torch.Tensor, joints: torch.Tensor,
                        patch: int = 5) -> torch.Tensor:
    """Per-joint appearance descriptors: images_net (T, S, S, 3) network-
    frame images, joints (T, k, P, 2) network-frame (x, y) decodes →
    (T, k, P·3), each joint's mean color over a ``patch``×``patch`` window
    of bilinear samples around it, clamped at the frame's edges."""
    offs = (torch.arange(patch, dtype=torch.float32, device=joints.device)
            - (patch - 1) / 2.0)
    dy = offs[:, None].expand(patch, patch).reshape(-1)
    dx = offs[None, :].expand(patch, patch).reshape(-1)
    xs = joints[..., 0][..., None] + dx                    # (T, k, P, patch²)
    ys = joints[..., 1][..., None] + dy
    cols = pre.map_coordinates_linear(images_net, ys, xs)  # (..., patch², 3)
    t, k = joints.shape[:2]
    return cols.mean(-2).reshape(t, k, -1)


def _live_flags(s_t: torch.Tensor, score_gate: float,
                gate_frac: float) -> torch.Tensor:
    """A slot is live when its score clears ``score_gate`` and
    ``gate_frac`` of the frame's best score; float 0/1."""
    rel = s_t >= gate_frac * s_t.amax(dim=-1, keepdim=True)
    return ((s_t >= score_gate) & rel).to(torch.float32)


def associate_tracks(feat_seq: torch.Tensor,
                     scores_seq: torch.Tensor | None = None,
                     score_gate: float = 0.0,
                     gate_frac: float = 0.75,
                     ema: float = 0.7,
                     init_state=None,
                     return_state: bool = False):
    """Greedy per-frame association: feat_seq (T, k, D) slot-ordered
    features, scores_seq (T, k) (default all 1) → perm (T, k), ``perm[t,
    i]`` the frame-t slot of track i. Each frame takes the permutation of
    least summed mean-square distance between the live slots and the
    established tracks' states; a live match moves its state by ``ema``
    toward the observation, a non-live slot leaves it. Track i is born as
    frame-0 slot i. ``init_state`` / ``return_state``: the (features (k, D),
    present (k,)) state carried across windows, with which every frame of
    the call is matched."""
    t_frames, k, _ = feat_seq.shape
    feat_seq = feat_seq.to(torch.float32)
    if scores_seq is None:
        scores_seq = torch.ones(t_frames, k, device=feat_seq.device)
    perms = _permutations(k, feat_seq.device)

    if init_state is None:
        state = (feat_seq[0], _live_flags(scores_seq[0], score_gate,
                                          gate_frac))
        out = [torch.arange(k, device=feat_seq.device)]
        start = 1
    else:
        state, out, start = init_state, [], 0
    for t in range(start, t_frames):
        feats, present = state
        f_t = feat_seq[t]
        live_t = _live_flags(scores_seq[t], score_gate, gate_frac)
        gate = live_t[perms] * present[None, :]              # (k!, k)
        d2 = ((f_t[perms] - feats[None]) ** 2).mean(-1)      # (k!, k)
        cost = torch.where(gate > 0, d2, 0.0).sum(-1)
        p = perms.index_select(0, cost.argmin().reshape(1))[0]
        z, l_m = f_t.index_select(0, p), live_t.index_select(0, p)
        blend = torch.where(present[:, None] > 0,
                            (1.0 - ema) * feats + ema * z, z)
        state = (torch.where(l_m[:, None] > 0, blend, feats),
                 torch.maximum(present, l_m))
        out.append(p)
    perm = torch.stack(out).to(torch.int32)
    return (perm, state) if return_state else perm


def gather_tracks(x_seq: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Slot-ordered (T, k, ...) → track-ordered (T, k, ...): index i along
    axis 1 becomes track i, slot perm[t, i] of frame t."""
    rows = torch.arange(x_seq.shape[0], device=x_seq.device)[:, None]
    return x_seq[rows, perm.long()]


def compose_perms(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """The per-frame composition (T, k): gathering with it equals
    gathering with ``first`` and then with ``second``."""
    return first.gather(1, second.long())


def presence_hysteresis(strong: torch.Tensor, weak: torch.Tensor,
                        init: torch.Tensor) -> torch.Tensor:
    """Causal hysteresis over (T, k) bool gates: present[t] = strong[t] |
    (present[t−1] & weak[t]), present[−1] = ``init`` (k,)."""
    prev, out = init, []
    for s_t, w_t in zip(strong, weak):
        prev = s_t | (prev & w_t)
        out.append(prev)
    return torch.stack(out)


def smooth_track_centers(centers: torch.Tensor, weights: torch.Tensor,
                         lam: float = 8.0, robust_sigma_px: float = 30.0,
                         robust_iters: int = 2) -> torch.Tensor:
    """Robust smoothing of track-ordered center trajectories (T, k, 2)
    with weights (T, k) ≥ 0. Per track and coordinate the closed-form
    solution of

        min_c  Σ_t w_t (c_t − o_t)²  +  λ Σ_t (c_{t−1} − 2 c_t + c_{t+1})²

    (w normalized to mean 1 and floored at 1e-3 of a vote, so that a track
    with one observation stays finite), one batched float32 T×T solve per
    track, then ``robust_iters`` rounds of reweighting by
    exp(−r²/σ²). Fewer than three frames come back as they are."""
    t_frames = centers.shape[0]
    if t_frames < 3:
        return centers
    obs = centers.to(torch.float32).transpose(0, 1)            # (k, T, 2)
    w0 = torch.clamp_min(weights.to(torch.float32).transpose(0, 1), 0.0)
    w0 = w0 / (w0.mean(-1, keepdim=True) + 1e-8) + 1e-3        # (k, T)
    eye = torch.eye(t_frames, device=obs.device)
    d2 = eye[:-2] - 2.0 * eye[1:-1] + eye[2:]                  # (T-2, T)
    with full_f32_matmul():
        reg = lam * (d2.T @ d2) + 1e-6 * eye

    def solve(w):
        a = reg + torch.diag_embed(w)
        return torch.linalg.solve_ex(a, w[..., None] * obs)[0]

    sm = solve(w0)
    for _ in range(robust_iters):
        r2 = ((sm - obs) ** 2).sum(-1)                         # (k, T)
        w = w0 * torch.exp(-r2 / (robust_sigma_px ** 2))
        w = w / (w.mean(-1, keepdim=True) + 1e-8) + 1e-3
        sm = solve(w)
    return sm.transpose(0, 1)


def associate_tracks_viterbi(geom_seq: torch.Tensor,
                             app_seq: torch.Tensor,
                             scores_seq: torch.Tensor | None = None,
                             w_app: float = 2.0,
                             w_anchor: float = 8.0,
                             score_gate: float = 0.0,
                             gate_frac: float = 0.75,
                             birth_cost: float = 0.05,
                             death_frames: int = 0,
                             anchor_refresh: float = 0.0,
                             init_state=None,
                             return_state: bool = False):
    """The whole sequence's identity assignment as a Viterbi path over
    the k! per-frame permutations: geom_seq (T, k, Dg) and app_seq
    (T, k, Da) slot features, scores_seq (T, k) → perm (T, k) int32 (and,
    with ``return_state``, the state for the next window).

    - Liveness as in :func:`associate_tracks`; non-live slots carry no
      cost, and the previous-frame features advance on live slots only.
    - Node cost, predecessor q supplying the anchors and state p the
      observations: an anchored track pays ``w_anchor``·(appearance MSE to
      its anchor), an unanchored one ``w_anchor``·``birth_cost`` for a live
      observation, averaged over the live slots.
    - Edge cost: the live-weighted mean-square change of geometry plus
      ``w_app`` × that of appearance, plus 1e-4 for changing permutation.
    - Survivor paths carry anchors: a live observation on an unanchored
      track becomes its anchor (birth); ``death_frames`` > 0 un-anchors a
      track non-live that many frames in a row; ``anchor_refresh`` > 0
      moves an anchor at that rate toward a live observation within
      ``birth_cost`` of it.
    - The costs are shifted to a minimum of 0 every frame.
    - ``init_state`` (the 7-tuple ``return_state`` gives: cost (k!,),
      last geometry, last appearance, last liveness, anchors (k, Da),
      anchored (k,), misses (k,)) continues a previous window from its
      committed end state; otherwise track i is anchored to frame-0 slot i
      where that slot is live.
    """
    t_frames, k, _ = geom_seq.shape
    dev = geom_seq.device
    geom_seq = geom_seq.to(torch.float32)
    app_seq = app_seq.to(torch.float32)
    if scores_seq is None:
        scores_seq = torch.ones(t_frames, k, device=dev)
    perms = _permutations(k, dev)                             # (P, k)
    p_count = perms.shape[0]
    eps_stay = 1e-4

    def live_flags(s_t):
        return _live_flags(s_t, score_gate, gate_frac)

    def wmean(d2, w):
        """d2 (..., k, D) squared differences, w (..., k) → the weighted
        mean feature distance, 0 where nothing is live."""
        return (d2.mean(-1) * w).sum(-1) / (w.sum(-1) + 1e-8)

    if init_state is None:
        live_prev = live_flags(scores_seq[0])
        anchor0, anchored0 = app_seq[0], live_prev
        live0p = live_prev[perms]                              # (P, k)
        a0p = app_seq[0][perms]                                # (P, k, Da)
        d2_0 = ((a0p - anchor0[None]) ** 2).mean(-1)
        per0 = (anchored0[None] * d2_0
                + (1.0 - anchored0[None]) * birth_cost)
        cost = (w_anchor * (per0 * live0p).sum(-1)
                / (live0p.sum(-1) + 1e-8))
        prev_g, prev_a = geom_seq[0], app_seq[0]
        start = 1
        newly0 = (live0p > 0) & (anchored0[None] <= 0)
        anchor = torch.where(newly0[..., None], a0p,
                             anchor0[None].expand(p_count, *anchor0.shape))
        anchored = torch.maximum(anchored0[None].expand(p_count, k),
                                 newly0.to(torch.float32))
        miss = torch.zeros(p_count, k, device=dev)
    else:
        (cost, prev_g, prev_a, live_prev,
         anchor0, anchored0, miss0) = init_state
        start = 0
        anchor = anchor0[None].expand(p_count, *anchor0.shape)
        anchored = anchored0[None].expand(p_count, k)
        miss = miss0[None].expand(p_count, k)

    not_eye = 1.0 - torch.eye(p_count, device=dev)
    pg, pa, pl = prev_g, prev_a, live_prev
    backs = []
    for t in range(start, t_frames):
        g_t, a_t = geom_seq[t], app_seq[t]
        l_t = live_flags(scores_seq[t])
        gp, ap_, lp = g_t[perms], a_t[perms], l_t[perms]      # (P, k, ·)
        d2 = ((ap_[None] - anchor[:, None]) ** 2).mean(-1)     # (q, p, k)
        per = (anchored[:, None] * d2
               + (1.0 - anchored[:, None]) * birth_cost)
        node = (w_anchor * (per * lp[None]).sum(-1)
                / (lp.sum(-1)[None] + 1e-8))                  # (q, p)
        pgq, paq, plq = pg[perms], pa[perms], pl[perms]
        wqp = lp[None] * plq[:, None]                          # (q, p, k)
        edge = (wmean((gp[None] - pgq[:, None]) ** 2, wqp)
                + w_app * wmean((ap_[None] - paq[:, None]) ** 2, wqp)
                + eps_stay * not_eye)
        c = cost[:, None] + edge + node                        # (q, p)
        back = c.argmin(dim=0)                   # the first minimum
        new_cost = c.amin(dim=0)
        cost = new_cost - new_cost.min()
        backs.append(back)
        # Survivor paths: each state inherits its best predecessor's
        # anchors; ageing and death, refresh, then births.
        anc_p, anch_p, mis_p = anchor[back], anchored[back], miss[back]
        mis_new = torch.where(lp > 0, 0.0, mis_p + anch_p)
        if death_frames > 0:
            dead = (mis_new >= death_frames).to(torch.float32)
            anch_p = anch_p * (1.0 - dead)
            mis_new = mis_new * (1.0 - dead)
        newly = (lp > 0) & (anch_p <= 0)
        if anchor_refresh > 0.0:
            d2u = ((ap_ - anc_p) ** 2).mean(-1)                # (P, k)
            g_upd = anchor_refresh * ((lp > 0) & (anch_p > 0)
                                      & (d2u < birth_cost)).to(torch.float32)
            anc_p = anc_p * (1.0 - g_upd[..., None]) + ap_ * g_upd[..., None]
        anchor = torch.where(newly[..., None], ap_, anc_p)
        anchored = torch.maximum(anch_p, newly.to(torch.float32))
        miss = mis_new
        upd = l_t[:, None] > 0
        pg = torch.where(upd, g_t, pg)
        pa = torch.where(upd, a_t, pa)
        pl = torch.maximum(pl, l_t)

    s_last = cost.argmin().reshape(1)
    states, s = [], s_last
    for back in reversed(backs):
        states.append(s)
        s = back.index_select(0, s)
    if init_state is None:
        states.append(s)
    perm = perms.index_select(0, torch.cat(states[::-1])).to(torch.int32)
    if not return_state:
        return perm
    # Commit the chosen end state, so that the next window cannot change
    # this window's identities; its anchor set carries forward.
    committed = torch.where(torch.arange(p_count, device=dev) == s_last,
                            0.0, 1e6)
    return perm, (committed, pg, pa, pl, anchor.index_select(0, s_last)[0],
                  anchored.index_select(0, s_last)[0],
                  miss.index_select(0, s_last)[0])
