"""Reference-style oracle pipeline: the second implementation the parity
harness compares against (port of ``tpu_pose/parity/oracle.py``).

Built the way the reference lineage builds it, not the way
``tpu_pose_torch`` does:

- decode: host-side numpy hard argmax over session-output heatmaps;
- SMPL: the batch_smpl/batch_lbs-lineage equations in float64, with a
  loop-composed kinematic chain;
- fit: scipy L-BFGS driving the graph's value and gradient from a HOST
  loop with per-stage variable subsets (the TF1 ``ScipyOptimizerInterface``
  idiom);
- camera: weak-perspective or fixed-focal perspective, in raw pixels.

The JAX package writes this graph in TensorFlow. Here it is a float64
PyTorch transcription of that graph, op for op (but for the energy's
rest joints: the same linear map regrouped,
:meth:`OraclePipeline._joints`), with the gradient from
``torch.autograd`` where TensorFlow's is from ``tf.GradientTape``.
Every tensor is float64 on the CPU, whatever device the caller's arrays
came from: this is the reference lineage's host computation, not a CPU
fallback of the port's fit.

The energy mirrors ``fitting/energy.py``'s SMPLify form (GMoF
reprojection + GMM/L2 pose prior + angle prior + β L2) in PIXEL units;
with the fit's ``normalize_obs`` the two energies are exactly
proportional (E_norm = (2/S)²·E_px), so their minimizers coincide.

Nothing here imports the port's compute modules, so agreement with the
port's fit is evidence, not tautology.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

# CPM-14 → SMPL-24 correspondence (standard SMPLify-family table; a copy
# on purpose: the oracle must not import the port's compute modules).
_CPM_TO_SMPL = np.array(
    [15, 12, 17, 19, 21, 16, 18, 20, 2, 5, 8, 1, 4, 7], dtype=np.int64)
# SMPLify angle-prior components/signs (knees/elbows), as in the papers.
_ANGLE_IDX = np.array([55, 58, 12, 15], dtype=np.int64)
_ANGLE_SIGN = np.array([1.0, -1.0, -1.0, -1.0])

_F64 = torch.float64


def _host64(x) -> torch.Tensor:
    """A float64 CPU tensor of ``x`` (numpy, a list, or a tensor on any
    device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", _F64)
    return torch.from_numpy(np.array(x, np.float64))


@contextlib.contextmanager
def _one_torch_thread():
    """torch's intra-op threads set to one for the duration. The host
    loop alternates a few hundred tiny torch ops with scipy's L-BFGS-B,
    whose BLAS threads spin between its calls; a pool of torch threads
    beside them fights for the same cores (≈ 5× the time per evaluation
    on an 8-core host), and ops this small gain nothing from threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def decode_hard_argmax(heatmaps: np.ndarray, stride: int = 8):
    """The reference's decode: per-channel spatial argmax × stride, on
    host numpy (background channel dropped). (B,H,W,P+1) → (B,P,2),(B,P)."""
    hm = np.asarray(heatmaps)[..., :-1]
    b, h, w, p = hm.shape
    flat = hm.reshape(b, h * w, p)
    idx = flat.argmax(axis=1)
    ys = (idx // w).astype(np.float64) * stride
    xs = (idx % w).astype(np.float64) * stride
    return np.stack([xs, ys], axis=-1), flat.max(axis=1)


@dataclasses.dataclass(frozen=True)
class OracleStage:
    """One phase of the oracle's staged schedule (variable-subset idiom)."""
    opt_pose: bool = True
    opt_global: bool = True
    opt_shape: bool = True
    opt_cam: bool = True
    w_pose_prior: float = 4.0
    w_shape_prior: float = 5.0
    w_angle_prior: float = 15.0
    maxiter: int = 100


@dataclasses.dataclass(frozen=True)
class OracleConfig:
    """The oracle pipeline's constants — the harness treats these as the
    unknown reference constants to be matched by sweeping FitConfig."""
    stages: Sequence[OracleStage] = (
        OracleStage(opt_pose=False, opt_shape=False, w_pose_prior=0.0,
                    w_shape_prior=0.0, w_angle_prior=0.0, maxiter=60),
        OracleStage(maxiter=200),
    )
    camera_model: str = "weak_perspective"   # | "perspective"
    focal: float = 5000.0
    img_size: int = 368
    gmof_sigma: float = 100.0                # pixels
    stride: int = 8


class OraclePipeline:
    """decode → (staged scipy-L-BFGS SMPLify fit over a float64 graph).

    Args:
      model: dict of SMPL arrays (v_template, shapedirs, posedirs,
        J_regressor, weights, parents), numpy or tensors on any device —
        e.g. ``SMPLData.to_numpy()``.
      gmm: optional dict(means (K,69), precisions (K,69,69),
        log_consts (K,)) for the MaxMixture pose prior; None → L2-to-zero.
      cfg: the oracle's constants.
    """

    def __init__(self, model: dict, gmm: Optional[dict] = None,
                 cfg: OracleConfig = OracleConfig()):
        self.cfg = cfg
        self._v_template = _host64(model["v_template"])
        self._shapedirs = _host64(model["shapedirs"])
        self._posedirs = _host64(model["posedirs"])
        self._J_regressor = _host64(model["J_regressor"])
        self._weights = _host64(model["weights"])
        self._parents = np.asarray(model["parents"], np.int64)
        self._num_j = int(self._parents.shape[0])
        self._parent_idx = torch.from_numpy(self._parents)
        self._j_template = torch.matmul(self._J_regressor, self._v_template)
        self._j_shapedirs = torch.einsum("jv,vcb->jcb", self._J_regressor,
                                         self._shapedirs)
        # Energy evaluations so far (the host loop's unit of work).
        self.evaluations = 0
        self._gmm = (None if gmm is None else
                     {k: _host64(gmm[k])
                      for k in ("means", "precisions", "log_consts")})
        self._cpm_to_smpl = torch.from_numpy(_CPM_TO_SMPL)
        self._angle_idx = torch.from_numpy(_ANGLE_IDX)
        self._angle_sign = torch.from_numpy(_ANGLE_SIGN)

    # -- graph pieces (batch_smpl/batch_lbs-lineage math) ------------------

    def _rodrigues(self, theta):
        """(J, 3) axis-angle → (J, 3, 3), each joint's matrix as the TF
        graph's per-joint ``rodrigues`` builds it."""
        angle = torch.linalg.vector_norm(theta, dim=-1) + 1e-16
        k = theta / angle[:, None]
        zero = 0.0 * k[:, 0]
        K = torch.stack([
            torch.stack([zero, -k[:, 2], k[:, 1]], -1),
            torch.stack([k[:, 2], zero, -k[:, 0]], -1),
            torch.stack([-k[:, 1], k[:, 0], zero], -1),
        ], -2)
        eye = torch.eye(3, dtype=_F64)
        return (eye + torch.sin(angle)[:, None, None] * K
                + (1.0 - torch.cos(angle))[:, None, None]
                * torch.matmul(K, K))

    def _world(self, j_rest, theta):
        """(R, world (J, 4, 4)): rotations and the loop-composed kinematic
        chain over the rest joints."""
        R = self._rodrigues(theta.reshape(-1, 3))
        # Every joint's local rigid transform [R | t; 0 0 0 1] at once:
        # the root's translation is its rest joint, each other joint's its
        # offset from the parent. The products below compose them along
        # the kinematic tree, one joint at a time.
        t_local = torch.cat([j_rest[:1], j_rest[1:]
                             - j_rest[self._parent_idx[1:]]])
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=_F64)
        local = torch.cat([torch.cat([R, t_local[:, :, None]], dim=2),
                           bottom.expand(self._num_j, 1, 4)], dim=1)
        local = local.unbind(0)
        world = [local[0]]
        for k in range(1, self._num_j):
            world.append(torch.matmul(world[self._parents[k]], local[k]))
        return R, torch.stack(world)

    def _joints(self, beta, theta):
        """(J, 3) posed joints without the vertices: the rest joints
        J_regressor·(v_template + shapedirs·β) through the same linear
        map regrouped, J_regressor·v_template + (J_regressor·shapedirs)·β,
        both products taken once in float64."""
        j_rest = self._j_template + torch.einsum(
            "jcb,b->jc", self._j_shapedirs, beta)
        return self._world(j_rest, theta)[1][:, :3, 3]

    def _smpl_torch(self, beta, theta):
        """(vertices (V, 3), joints (J, 3)) of one body, float64."""
        v_shaped = self._v_template + torch.einsum(
            "vcb,b->vc", self._shapedirs, beta)
        j_rest = torch.matmul(self._J_regressor, v_shaped)
        R, world = self._world(j_rest, theta)
        pose_feat = (R[1:] - torch.eye(3, dtype=_F64)).reshape(-1)
        v_posed = v_shaped + torch.einsum("vcp,p->vc", self._posedirs,
                                          pose_feat)
        joints = world[:, :3, 3]
        j_h = torch.cat([j_rest, torch.zeros(self._num_j, 1, dtype=_F64)],
                        dim=1)
        corr = torch.einsum("jab,jb->ja", world, j_h)
        A = world - torch.nn.functional.pad(corr[:, :, None], (3, 0))
        T = torch.einsum("vj,jab->vab", self._weights, A)
        v_h = torch.cat([v_posed, torch.ones(v_posed.shape[0], 1,
                                             dtype=_F64)], dim=1)
        verts = torch.einsum("vab,vb->va", T, v_h)[:, :3]
        return verts, joints

    def _project(self, j3d, cam):
        if self.cfg.camera_model == "weak_perspective":
            # px = (s·xy + t + 1) · S/2  — same normalized frame the
            # port's fit uses, expressed in pixels.
            norm = cam[0] * j3d[:, :2] + cam[1:3][None, :]
            return (norm + 1.0) * (self.cfg.img_size / 2.0)
        z = torch.clamp(j3d[:, 2:3] + cam[2], min=1e-3)
        xy = (j3d[:, :2] + cam[None, :2])
        c = self.cfg.img_size / 2.0
        return self.cfg.focal * xy / z + c

    def _energy_torch(self, theta, beta, cam, j2d_obs, conf, lam):
        # Joints only: the energy never reads the skinned vertices (the
        # TF graph's pruning drops them the same way), so no term of it
        # grows with the vertex count.
        self.evaluations += 1
        joints = self._joints(beta, theta)
        j14 = joints[self._cpm_to_smpl]
        pred = self._project(j14, cam)
        res = pred - j2d_obs
        s2 = self.cfg.gmof_sigma ** 2
        sq = res * res
        e = torch.sum(conf[:, None] * s2 * sq / (sq + s2))
        body = theta[3:]
        if self._gmm is not None:
            d = body[None, :] - self._gmm["means"]
            maha = 0.5 * torch.einsum(
                "kd,kde,ke->k", d, self._gmm["precisions"], d)
            nll = -torch.max(self._gmm["log_consts"] - maha)
        else:
            nll = 0.5 * torch.sum(body * body)
        e = e + lam[0] * nll
        comps = theta[self._angle_idx] * self._angle_sign
        e = e + lam[2] * torch.sum(torch.exp(comps) ** 2)
        e = e + lam[1] * torch.sum(beta * beta)
        return e

    def _energy_and_grad(self, theta, beta, cam, j2d_obs, conf, lam):
        with torch.enable_grad():
            theta, beta, cam = (v.detach().requires_grad_()
                                for v in (theta, beta, cam))
            e = self._energy_torch(theta, beta, cam, j2d_obs, conf, lam)
            g = torch.autograd.grad(e, [theta, beta, cam])
        return e.detach(), g[0], g[1], g[2]

    # -- host-side staged fit (ScipyOptimizerInterface idiom) --------------

    def _init_params(self, j2d_px: np.ndarray, conf: np.ndarray):
        """Extent/centroid camera init on the rest pose (the reference
        lineage's torso heuristic, all-joint form)."""
        j_rest = (self._J_regressor.numpy()
                  @ self._v_template.numpy())[_CPM_TO_SMPL]
        half = self.cfg.img_size / 2.0
        obs = (np.asarray(j2d_px, np.float64) - half) / half  # [-1,1]
        w = conf / (conf.sum() + 1e-8)
        mean2d = (w[:, None] * obs).sum(0)
        mean3d = (w[:, None] * j_rest[:, :2]).sum(0)
        var2d = (w * ((obs - mean2d) ** 2).sum(-1)).sum()
        var3d = (w * ((j_rest[:, :2] - mean3d) ** 2).sum(-1)).sum()
        if self.cfg.camera_model == "weak_perspective":
            s = np.sqrt(var2d / (var3d + 1e-8))
            cam0 = np.concatenate([[s], mean2d - s * mean3d])
        else:
            spread2d_px = np.sqrt(
                (w * ((np.asarray(j2d_px) - (mean2d + 1) * half) ** 2)
                 .sum(-1)).sum() + 1e-8)
            mean3d_full = (w[:, None] * j_rest).sum(0)
            spread3d = np.sqrt(
                (w * ((j_rest - mean3d_full) ** 2).sum(-1)).sum() + 1e-8)
            tz = self.cfg.focal * spread3d / spread2d_px
            px_mean = (w[:, None] * np.asarray(j2d_px, np.float64)).sum(0)
            txy = ((px_mean - half) * tz / self.cfg.focal
                   - mean3d_full[:2])
            cam0 = np.concatenate([txy, [tz]])
        return (np.zeros(self._num_j * 3), np.zeros(10), cam0)

    def fit(self, joints2d_px: np.ndarray, conf: np.ndarray,
            init: Optional[dict] = None,
            scipy_options: Optional[dict] = None) -> dict:
        """Staged SMPLify fit for ONE frame (host loop, scipy L-BFGS-B).

        ``scipy_options`` merge into each stage's L-BFGS-B options (e.g.
        ``{"ftol": 1e-14, "gtol": 1e-10, "maxiter": 2000}`` for a
        high-precision polish). Returns dict(theta, beta, cam,
        joints3d (24,3), vertices, energy)."""
        j2d = _host64(joints2d_px)
        cf = _host64(conf)
        if init is None:
            theta, beta, cam = self._init_params(
                np.asarray(joints2d_px), np.asarray(conf, np.float64))
        else:
            theta = np.array(init["theta"], np.float64)
            beta = np.array(init["beta"], np.float64)
            cam = np.array(init["cam"], np.float64)
        with _one_torch_thread():
            theta, beta, cam = self._run_stages(j2d, cf, theta, beta, cam,
                                                scipy_options)
        t_theta, t_beta, t_cam = (torch.from_numpy(np.array(v))
                                  for v in (theta, beta, cam))
        with torch.no_grad():
            verts, joints = self._smpl_torch(t_beta, t_theta)
            last = self.cfg.stages[-1]
            lam_f = torch.tensor([last.w_pose_prior, last.w_shape_prior,
                                  last.w_angle_prior], dtype=_F64)
            e_final = self._energy_torch(t_theta, t_beta, t_cam, j2d, cf,
                                         lam_f)
        return {
            "theta": theta, "beta": beta, "cam": cam,
            "joints3d": joints.numpy(), "vertices": verts.numpy(),
            "energy": float(e_final),
        }

    def _run_stages(self, j2d, cf, theta, beta, cam, scipy_options):
        """The staged scipy L-BFGS-B loop from (θ, β, cam) → the fitted
        (θ, β, cam), numpy float64."""
        import scipy.optimize
        n_theta = self._num_j * 3
        for stage in self.cfg.stages:
            lam = torch.tensor([stage.w_pose_prior, stage.w_shape_prior,
                                stage.w_angle_prior], dtype=_F64)
            # Active-coordinate mask = the TF1 per-stage variable subsets.
            m_theta = np.zeros(n_theta)
            if stage.opt_global:
                m_theta[:3] = 1.0
            if stage.opt_pose:
                m_theta[3:] = 1.0
            m_beta = np.full(10, 1.0 if stage.opt_shape else 0.0)
            m_cam = np.full(cam.shape, 1.0 if stage.opt_cam else 0.0)
            mask = np.concatenate([m_theta, m_beta, m_cam])
            x0 = np.concatenate([theta, beta, cam])
            base = x0.copy()

            def fun(x):
                xe = torch.from_numpy(base * (1 - mask) + x * mask)
                e, gt, gb, gc = self._energy_and_grad(
                    xe[:n_theta], xe[n_theta:n_theta + 10],
                    xe[n_theta + 10:], j2d, cf, lam)
                g = torch.cat([gt, gb, gc]).numpy()
                return float(e), g * mask

            options = {"maxiter": stage.maxiter}
            options.update(scipy_options or {})
            res = scipy.optimize.minimize(
                fun, x0, jac=True, method="L-BFGS-B", options=options)
            x = base * (1 - mask) + res.x * mask
            theta = x[:n_theta]
            beta = x[n_theta:n_theta + 10]
            cam = x[n_theta + 10:]
        return theta, beta, cam

    def fit_batch(self, joints2d_px: np.ndarray, conf: np.ndarray,
                  init: Optional[dict] = None,
                  scipy_options: Optional[dict] = None) -> dict:
        """Sequential per-frame loop — the reference's video idiom.
        Stacks the per-frame dicts."""
        outs = []
        for i in range(len(joints2d_px)):
            ini = (None if init is None else
                   {k: np.asarray(v[i]) for k, v in init.items()})
            outs.append(self.fit(joints2d_px[i], conf[i], init=ini,
                                 scipy_options=scipy_options))
        return {k: np.stack([o[k] for o in outs]) for k in outs[0]}
