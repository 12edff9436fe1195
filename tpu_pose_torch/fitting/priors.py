"""Pose/shape priors for the SMPLify-style fit (port of
``tpu_pose/fitting/priors.py``): a GMM-8 over the 69-dim body pose, an
L2-to-mean fallback, and the SMPLify angle prior on knees and elbows.

Every prior evaluates a batch: ``body_pose`` is ``(..., 69)`` and the
result has the leading shape. Precision matrices are precomputed on the
host in float64 (numpy), so the construction is bit-identical to the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

from tpu_pose_torch.utils.device import full_f32_matmul, resolve_device

BODY_POSE_DIM = 69  # 23 non-root joints × 3


@dataclasses.dataclass(frozen=True)
class GMMPrior:
    """Gaussian-mixture pose prior over body pose (θ[3:]) in precision
    form: ``log_consts`` collects each component's mixture weight and
    normalizer."""
    means: torch.Tensor        # (K, 69)
    precisions: torch.Tensor   # (K, 69, 69)
    log_consts: torch.Tensor   # (K,) = log w_k + 0.5 log|P_k| - D/2 log(2π)

    def to(self, device) -> "GMMPrior":
        return GMMPrior(*(t.to(device) for t in dataclasses.astuple(self)))

    def neg_log_prob(self, body_pose: torch.Tensor,
                     mode: str = "max") -> torch.Tensor:
        """−log p(θ_body), ``(..., 69)`` → ``(...)``. ``mode='max'`` is the
        SMPLify MaxMixture approximation (min over components of the
        per-component NLL); ``'sum'`` is the exact logsumexp mixture."""
        d = body_pose.unsqueeze(-2) - self.means            # (..., K, 69)
        with full_f32_matmul():
            pd = torch.einsum("...kd,kde->...ke", d, self.precisions)
        maha = 0.5 * (pd * d).sum(-1)                       # (..., K)
        comp_ll = self.log_consts - maha
        if mode == "max":
            return -comp_ll.amax(-1)
        return -torch.logsumexp(comp_ll, -1)


def make_gmm_prior(means: np.ndarray, covs: np.ndarray,
                   weights: np.ndarray, device=None) -> GMMPrior:
    """Precompute the precision-form GMM from (means, covariances, weights)."""
    means = np.asarray(means, np.float64)
    covs = np.asarray(covs, np.float64)
    weights = np.asarray(weights, np.float64)
    precisions = np.stack([np.linalg.inv(c) for c in covs])
    _, logdets = np.linalg.slogdet(precisions)
    d = means.shape[1]
    log_consts = (np.log(weights) + 0.5 * logdets
                  - 0.5 * d * np.log(2.0 * np.pi))
    return gmm_prior_from_numpy(means, precisions, log_consts, device)


def gmm_prior_from_numpy(means, precisions, log_consts,
                         device=None) -> GMMPrior:
    """A precision-form prior from arrays (for example the JAX package's
    ``GMMPrior`` fields through ``np.asarray``), cast to float32."""
    device = resolve_device(device)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return GMMPrior(means=t(means), precisions=t(precisions),
                    log_consts=t(log_consts))


def load_gmm_pickle(path: str, device=None) -> GMMPrior:
    """Load the standard SMPLify ``gmm_08.pkl`` (license-gated, user-supplied;
    keys: means (8,69), covars (8,69,69), weights (8,))."""
    with open(path, "rb") as f:
        dd = pickle.load(f, encoding="latin1")
    dd = {(k.decode() if isinstance(k, bytes) else k): v
          for k, v in dd.items()}
    return make_gmm_prior(dd["means"], dd["covars"], dd["weights"], device)


def synthetic_gmm_prior(seed: int = 0, num_components: int = 8,
                        device=None) -> GMMPrior:
    """Deterministic stand-in GMM centered near the zero pose with mild
    anisotropy — the JAX package's construction, draw for draw."""
    rng = np.random.RandomState(seed)
    means = 0.1 * rng.randn(num_components, BODY_POSE_DIM)
    covs = []
    for _ in range(num_components):
        a = rng.randn(BODY_POSE_DIM, BODY_POSE_DIM) * 0.05
        covs.append(0.25 * np.eye(BODY_POSE_DIM) + a @ a.T)
    weights = rng.dirichlet(np.full(num_components, 5.0))
    return make_gmm_prior(means, np.stack(covs), weights, device)


def _log_gauss(x: np.ndarray, means: np.ndarray, precisions: np.ndarray,
               logdets: np.ndarray) -> np.ndarray:
    """Row-wise log N(x_n | mean_k, prec_k⁻¹) → (N, K), host numpy."""
    d = x[:, None, :] - means[None, :, :]                     # (N, K, D)
    maha = np.einsum("nkd,kde,nke->nk", d, precisions, d)
    dim = x.shape[1]
    return 0.5 * (logdets - dim * np.log(2.0 * np.pi) - maha)


def fit_gmm(samples: np.ndarray, num_components: int = 8,
            iters: int = 100, seed: int = 0, ridge: float = 1e-4,
            tol: float = 1e-6, device=None) -> GMMPrior:
    """Fit a full-covariance GMM to pose samples (N, D) by EM, host numpy
    in float64 — the JAX package's ``fit_gmm``, call for call, so the same
    samples and seed give the same prior. A few Lloyd iterations seed the
    means (without them EM collapses every mean onto the corpus mean);
    empty components are re-seeded from random samples; ``ridge`` keeps
    the covariances SPD. Returns the precision-form prior on ``device``."""
    x = np.asarray(samples, np.float64)
    n, dim = x.shape
    k = min(num_components, n)
    rng = np.random.RandomState(seed)

    means = x[rng.choice(n, k, replace=False)].copy()
    for _ in range(10):
        d2 = ((x[:, None, :] - means[None]) ** 2).sum(-1)     # (N, K)
        assign = d2.argmin(1)
        for j in range(k):
            sel = x[assign == j]
            means[j] = sel.mean(0) if len(sel) else x[rng.randint(n)]
    base_cov = np.cov(x, rowvar=False) + ridge * np.eye(dim)
    covs = np.tile(base_cov, (k, 1, 1))
    weights = np.full(k, 1.0 / k)

    prev_ll = -np.inf
    for _ in range(iters):
        precisions = np.linalg.inv(covs)
        _, logdets = np.linalg.slogdet(precisions)
        log_r = np.log(weights)[None, :] + _log_gauss(
            x, means, precisions, logdets)                    # (N, K)
        norm = np.logaddexp.reduce(log_r, axis=1)             # (N,)
        ll = float(norm.mean())
        resp = np.exp(log_r - norm[:, None])                  # (N, K)

        nk = resp.sum(0)                                      # (K,)
        for j in np.nonzero(nk < 1e-6)[0]:                    # dead comp.
            means[j] = x[rng.randint(n)]
            covs[j] = base_cov
            nk[j] = 1e-6
        weights = nk / nk.sum()
        means = (resp.T @ x) / nk[:, None]
        for j in range(k):
            d = x - means[j]
            covs[j] = ((resp[:, j, None] * d).T @ d) / nk[j] \
                + ridge * np.eye(dim)

        if ll - prev_ll < tol:
            break
        prev_ll = ll

    return make_gmm_prior(means, covs, weights, device)


def save_gmm_npz(path: str, prior: GMMPrior) -> None:
    """Save a (fitted) prior in precision form, the JAX package's npz
    keys: either package's ``load_gmm_npz`` reads it."""
    np.savez(path, **{f.name: getattr(prior, f.name).detach().cpu().numpy()
                      for f in dataclasses.fields(prior)})


def load_gmm_npz(path: str, device=None) -> GMMPrior:
    """Load a precision-form prior saved by either package's
    ``save_gmm_npz``."""
    with np.load(path) as z:
        return gmm_prior_from_numpy(z["means"], z["precisions"],
                                    z["log_consts"], device)


@dataclasses.dataclass(frozen=True)
class L2Prior:
    """L2-to-mean fallback prior."""
    mean: torch.Tensor  # (69,)

    def to(self, device) -> "L2Prior":
        return L2Prior(self.mean.to(device))

    def neg_log_prob(self, body_pose: torch.Tensor,
                     mode: str = "max") -> torch.Tensor:
        del mode
        return 0.5 * ((body_pose - self.mean) ** 2).sum(-1)


def l2_prior(mean: np.ndarray | None = None, device=None) -> L2Prior:
    if mean is None:
        mean = np.zeros(BODY_POSE_DIM)
    return L2Prior(mean=torch.as_tensor(np.asarray(mean, np.float32),
                                        device=resolve_device(device)))


def angle_prior(theta: torch.Tensor) -> torch.Tensor:
    """SMPLify angle prior, ``(..., 72)`` → ``(...)``: Σ exp(s·θ)² over the
    elbow y-rotations θ[55], θ[58] and knee x-rotations θ[12], θ[15] with
    signs (+1, −1, −1, −1). Built from slices so the fit loop copies no
    index tensor to the device."""
    comps = torch.stack([theta[..., 55], -theta[..., 58],
                         -theta[..., 12], -theta[..., 15]], dim=-1)
    return (torch.exp(comps) ** 2).sum(-1)
