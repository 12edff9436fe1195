"""The port's L-BFGS stage (tpu_pose_torch/fitting/lbfgs.py) against the
JAX package's ``_run_stage_lbfgs`` (optax.lbfgs(), optax's zoom
linesearch).

Bounds, and why:
- The linesearch alone, on analytic functions: step sizes, values and
  gradients within rtol 1e-5 of optax's, and the same iteration counts.
- The first 3 steps of each stage: the energies within 1e-5.
- Whole staged fits on clean observations (plain, multistart and the
  independent video mode): joints3d MPJPE ≤ 1 mm, θ, β, cam within 5e-3
  and energy within 0.5 % (the seed-6 body: 0.3 mm, its camera scale
  1.3e-3 apart). The schedule is short (10 + 10 steps) on purpose:
  L-BFGS on this objective amplifies float32 rounding, so over longer
  schedules the reference is not reproducible against itself. JAX's own
  20 + 60-step fit of tests/test_fit.py:142 ends 3–13 mm MPJPE away from
  itself when the observations move by one ulp, and 3–11 mm away between
  a batch of three and the same samples fitted one by one (ROADMAP.md §C).
- Batched samples are independent: bitwise equal when only another
  sample of the batch changes (even to NaN); each sample fitted alone
  within 1e-3 (a smaller batch sums in another order).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_pose.fitting import fit as jax_fit
from tpu_pose.fitting import priors as jax_priors
from tpu_pose.models import camera as jax_camera, joints as jax_joints
from tpu_pose.models import smpl as jax_smpl, smpl_data as jax_data
from tpu_pose.utils import config as jc
from tpu_pose_torch.fitting import fit as torch_fit, lbfgs
from tpu_pose_torch.fitting import priors as torch_priors, temporal
from tpu_pose_torch.models import smpl_data as torch_data
from tpu_pose_torch.utils import config as tc
from torch_threads import one_thread

one_thread()

STEP_TOL = dict(rtol=1e-5, atol=1e-5)
END_TOL = dict(rtol=0, atol=1e-3)
LBFGS_END_TOL = dict(rtol=0, atol=5e-3)
IMG = 368


@pytest.fixture(scope="module")
def assets():
    """tests/test_fit.py's model (500 vertices: the fit reads joints only)
    in both packages, and the synthetic GMM-8."""
    return (jax_data.synthetic_smpl(seed=3, num_verts=500),
            torch_data.synthetic_smpl(seed=3, num_verts=500, device="cpu"),
            jax_priors.synthetic_gmm_prior(0),
            torch_priors.synthetic_gmm_prior(0, device="cpu"))


def _clean_observations(jm, seeds):
    """tests/test_fit.py's make_observation for several seeds: pixel
    joints of known bodies under a known weak-perspective camera, no
    noise, confidence 1."""
    px = []
    for seed in seeds:
        rng = np.random.RandomState(seed)
        theta = jnp.asarray(rng.randn(72) * 0.25, jnp.float32)
        beta = jnp.asarray(rng.randn(10) * 0.3, jnp.float32)
        j3d = jax_joints.select_smpl_joints(
            jax_smpl.smpl_forward(jm, beta, theta).joints)
        cam = jnp.asarray([0.9, 0.05, -0.1], jnp.float32)
        px.append((jax_camera.weak_perspective_project(j3d, cam) + 1.0)
                  * (IMG / 2.0))
    px = np.asarray(jnp.stack(px), np.float32)
    return px, np.ones(px.shape[:2], np.float32)


def _cfg(cfg_mod, iters=(10, 10), w_interpenetration=0.0, **kw):
    """Camera and global orientation, then everything with the priors."""
    return cfg_mod.FitConfig(
        stages=(cfg_mod.StageConfig(iters=iters[0], lr=0.0, opt_pose=False,
                                    opt_shape=False, w_pose_prior=0.0,
                                    w_shape_prior=0.0, w_angle_prior=0.0),
                cfg_mod.StageConfig(iters=iters[1], lr=0.0, w_pose_prior=4.0,
                                    w_shape_prior=5.0, w_angle_prior=15.0,
                                    w_interpenetration=w_interpenetration)),
        img_size=IMG, optimizer="lbfgs", **kw)


@pytest.fixture(scope="module")
def jax_fit_with_init(assets):
    """JAX's staged fit with an explicit init, compiled once for the
    module's 4-row batches: its fit_smpl_batch without init is this with
    default_init, and its fit_smpl_multistart is this over the yaw
    hypotheses (a vmap of fit_smpl_single with each init)."""
    jm, _, jp, _ = assets
    fit = jax.jit(functools.partial(jax_fit.fit_smpl_batch,
                                    cfg=_cfg(jc, keep_history=True),
                                    prior=jp))
    init = jax.jit(jax.vmap(lambda o, c: jax_fit.default_init(
        jm, o, c, _cfg(jc))))

    def run(px, conf, init_params=None):
        px, conf = jnp.asarray(px), jnp.asarray(conf)
        if init_params is None:
            init_params = init(jax_fit._normalize_obs(px, _cfg(jc)), conf)
        return fit(jm, px, conf, init=init_params)
    return run


def _t(x):
    return torch.from_numpy(np.array(x))


def _mpjpe_mm(jm, a, b):
    """Per-sample joints3d MPJPE (mm) between two fits."""
    def joints(r):
        return jax_smpl.smpl_forward_batch(
            jm, jnp.asarray(np.asarray(r.beta).reshape(-1, 10)),
            jnp.asarray(np.asarray(r.theta).reshape(-1, 72))).joints
    return 1000.0 * np.linalg.norm(np.asarray(joints(a) - joints(b)),
                                   axis=-1).mean(-1)


# -- the zoom linesearch ------------------------------------------------------

def _quartic(x, c):
    return (c * x * x).sum(-1) + 0.25 * (x ** 4).sum(-1)


def test_zoom_linesearch_matches_optax():
    """Per sample: steepest descent that overshoots (the zoom's cubic and
    quadratic interpolation), a direction 100× too short (the interval
    search doubles), and an ascent direction (the search fails and falls
    back)."""
    rng = np.random.RandomState(0)
    b, d = 6, 5
    c = np.float32(rng.uniform(0.1, 10.0, (b, d)))
    x = np.float32(rng.randn(b, d))
    g = 2 * c * x + x ** 3
    scale = np.float32([[1.0], [1.0], [3.0], [0.01], [0.01], [-1.0]])
    u = -scale * g

    def one(x, u, c):
        fn = functools.partial(_quartic, c=c)
        ls = optax.scale_by_zoom_linesearch(max_linesearch_steps=20,
                                            initial_guess_strategy="one")
        v, grad = jax.value_and_grad(fn)(x)
        _, st = ls.update(u, ls.init(x), x, value=v, grad=grad, value_fn=fn)
        return (st.learning_rate, st.value, st.grad,
                st.info.num_linesearch_steps)

    want = jax.jit(jax.vmap(one))(x, u, c)

    ct = _t(c)

    def value_and_grad(xt):
        xt = xt.detach().requires_grad_(True)
        with torch.enable_grad():
            e = _quartic(xt, ct)
            (gt,) = torch.autograd.grad(e.sum(), xt)
        return e.detach(), gt

    lbfgs.reset_counts()
    v0, g0 = value_and_grad(_t(x))
    got = lbfgs.zoom_linesearch(value_and_grad, _t(x), _t(u), v0, g0)
    for w, gt in zip(want[:3], got):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    steps = np.asarray(want[3])
    assert lbfgs.COUNTS["evaluations"] == steps.sum()
    assert lbfgs.COUNTS["max_step_evaluations"] == steps.max() == 20
    # Interpolated step sizes are no powers of two.
    rates = np.asarray(want[0])
    assert (np.abs(np.log2(rates[:3]) % 1.0) > 1e-3).all()


# -- the fit ------------------------------------------------------------------

def test_first_steps_match_jax(assets, jax_fit_with_init, monkeypatch):
    """The first 3 steps of each stage (the camera stage, then the full
    stage with the priors) within 1e-5 in energy; the first step is scaled
    by min(1, 1/‖g‖) (no curvature pairs yet), and a linesearch
    interpolates."""
    jm, tm, _, tp = assets
    px, conf = _clean_observations(jm, [4, 5, 6, 7])
    want = np.asarray(jax_fit_with_init(px, conf).energy_history)
    calls = []
    zoom = lbfgs.zoom_linesearch

    def record(value_and_grad, x, updates, value, grad):
        out = zoom(value_and_grad, x, updates, value, grad)
        calls.append((updates, grad, out[0]))
        return out

    monkeypatch.setattr(lbfgs, "zoom_linesearch", record)
    got = torch_fit.fit_smpl_batch(tm, _t(px), _t(conf),
                                   _cfg(tc, keep_history=True), tp)
    first = [0, 1, 2, 3, 10, 11, 12, 13]     # before and after 3 steps
    np.testing.assert_allclose(got.energy_history[:, first].numpy(),
                               want[:, first], **STEP_TOL)
    updates, grad, _ = calls[0]
    scale = torch.clamp(1.0 / grad.norm(dim=-1, keepdim=True), max=1.0)
    torch.testing.assert_close(updates, -scale * grad, rtol=0, atol=0)
    rates = torch.stack([c[2] for c in calls[:3] + calls[10:13]])
    assert (torch.log2(rates).remainder(1.0) > 1e-3).any()


def _check_fit(jm, got, want):
    for k in ("theta", "beta", "cam"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)),
                                   **LBFGS_END_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=5e-3)
    assert (_mpjpe_mm(jm, got, want) <= 1.0).all()


def test_staged_fit_clean_observations_matches_jax(assets,
                                                   jax_fit_with_init):
    """tests/test_fit.py:142's pattern (clean observations of known
    bodies, a camera stage then a full stage), short enough that JAX
    reproduces itself (see the module docstring); the reprojection error
    falls for every body. The independent video mode is this fit."""
    jm, tm, _, tp = assets
    px, conf = _clean_observations(jm, [4, 5, 6, 7])
    want = jax_fit_with_init(px, conf)
    got = torch_fit.fit_smpl_batch(tm, _t(px), _t(conf), _cfg(tc), tp)
    _check_fit(jm, got, want)
    video = temporal.fit_video_independent(tm, _t(px), _t(conf), _cfg(tc),
                                           tp)
    for f in ("theta", "beta", "cam", "energy"):
        assert torch.equal(getattr(video, f), getattr(got, f)), f

    def reproj_px(res):
        pred = torch_fit.reproject(tm, res, _cfg(tc))
        return ((pred + 1.0) * IMG / 2 - _t(px)).norm(dim=-1).mean(-1)

    init = torch_fit.default_init(
        tm, torch_fit._normalize_obs(_t(px), _cfg(tc)), _t(conf), _cfg(tc))
    e0 = reproj_px(torch_fit.FitResult(init["theta"], init["beta"],
                                       init["cam"], None, None))
    assert (reproj_px(got) <= 0.6 * e0).all()


def test_fit_smpl_multistart_lbfgs_matches_jax(assets, jax_fit_with_init):
    """Two yaw hypotheses for each of two bodies, as JAX's multistart
    builds them (the limb-order yaw and the opposite facing), every
    hypothesis against JAX's; then the lowest energy wins."""
    jm, tm, _, tp = assets
    px, conf = _clean_observations(jm, [8, 9])
    obs = jax_fit._normalize_obs(jnp.asarray(px), _cfg(jc))
    base = [jax_fit.default_init(jm, o, jnp.asarray(c), _cfg(jc))
            for o, c in zip(obs, conf)]
    init = {k: jnp.stack([b[k] for b in base for _ in range(2)])
            for k in base[0]}
    init["theta"] = init["theta"].at[:, 1].add(jnp.asarray([0.0, jnp.pi]
                                                           * 2))
    want = jax_fit_with_init(np.repeat(px, 2, 0), np.repeat(conf, 2, 0),
                             init)
    every = torch_fit.fit_smpl_multistart(tm, _t(px), _t(conf), _cfg(tc),
                                          tp, restarts=2, return_all=True)
    _check_fit(jm, torch_fit.FitResult(*(f.flatten(0, 1) for f in every)),
               want)
    best = torch_fit.fit_smpl_multistart(tm, _t(px), _t(conf), _cfg(tc), tp,
                                         restarts=2)
    pick = np.asarray(want.energy).reshape(2, 2).argmin(-1)
    np.testing.assert_array_equal(every.energy.argmin(-1).numpy(), pick)
    torch.testing.assert_close(best.theta, every.theta[[0, 1], pick])


def test_batched_samples_are_independent(assets):
    jm, tm, _, tp = assets
    px, conf = _clean_observations(jm, [4, 5, 6])
    nan = px.copy()
    nan[2] = np.nan
    cfg = _cfg(tc)

    def fit(p, c):
        return torch_fit.fit_smpl_batch(tm, _t(p), _t(c), cfg, tp)

    ab = fit(px[:2], conf[:2])
    a_nan = fit(nan[[0, 2]], conf[[0, 2]])
    alone = fit(px[1:2], conf[1:2])
    assert not torch.isfinite(a_nan.theta[1]).all()
    for f in ("theta", "beta", "cam", "energy"):
        assert torch.equal(getattr(a_nan, f)[0], getattr(ab, f)[0]), f
        np.testing.assert_allclose(getattr(alone, f)[0].numpy(),
                                   getattr(ab, f)[1].numpy(),
                                   **(END_TOL if f != "energy"
                                      else dict(rtol=1e-3)), err_msg=f)


# -- the export form: a scan over the steps, a while_loop linesearch ----------

def _quartic_batch():
    """Five samples whose linesearches take different numbers of
    iterations (starting points from 0.3× to 10× apart), one coordinate
    frozen by the mask."""
    rng = np.random.RandomState(0)
    c = _t(np.float32(rng.uniform(0.1, 10.0, (5, 6))))
    x = _t(np.float32(rng.randn(5, 6)
                      * np.float32([[1.0], [3.0], [0.3], [10.0], [1.0]])))
    return x, c, torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 1.0])


def test_lbfgs_scan_matches_run_lbfgs_step_for_step():
    """lbfgs.lbfgs_scan (the replayed stage: the memory as (M, B, D)
    buffers, the linesearch a while_loop with the eager loop's exit) on
    the stage's traced gradient graph against run_lbfgs: x, value and
    gradient after 3 steps and the value before each step, bit for bit.
    Some samples finish their linesearch before others (the eager loop
    evaluates fewer than batch × iterations samples)."""
    x, c, mask = _quartic_batch()
    lbfgs.reset_counts()
    want_x, want_hist = lbfgs.run_lbfgs(_quartic, x, 3, mask, True, (c,))
    assert lbfgs.COUNTS["evaluations"] < (x.shape[0]
                                          * lbfgs.COUNTS["host_reads"])
    vg = lbfgs.value_and_grad_fn(_quartic, mask)

    def grad_fn(x, c):
        e, g = vg(x, c)
        return g, e

    gm, used, consts = torch_fit.FitExport._trace_gradient(
        grad_fn, (x,), (c,), True)
    got_x, got_v, got_g, got_hist = lbfgs.lbfgs_scan(
        lambda x, *inputs: gm(x, *inputs)[::-1], x, 3, True,
        tuple([c][i] for i in used) + tuple(consts))
    want_v, want_g = vg(want_x, c)
    assert torch.equal(got_x, want_x)
    assert torch.equal(got_v, want_v) and torch.equal(got_g, want_g)
    assert len(got_hist) == 3
    for g, w in zip(got_hist, want_hist):
        assert torch.equal(g, w)


class _LbfgsModule(torch.nn.Module):
    def forward(self, x, c, mask):
        return torch_fit._run_lbfgs(_quartic, x, 4, mask, True, (c,))


def test_lbfgs_stage_exports_and_matches_eager():
    """A stage through fit._run_lbfgs under FitExport: the export holds
    one scan with a while_loop inside (not unrolled steps), and the
    program at the traced batch and at another equals the eager stage bit
    for bit."""
    x, c, mask = _quartic_batch()
    module = _LbfgsModule()
    loops = torch_fit.FitExport()
    with loops.recording():
        want = module(x[:3], c[:3], mask)
    b = torch.export.Dim("b")
    with loops.replaying_calls(), torch.no_grad():
        prog = torch.export.export(module, (x[:3], c[:3], mask),
                                   dynamic_shapes=({0: b}, {0: b}, None),
                                   strict=False)
    loops.finish()
    loops_at_top = [n for n in prog.graph.nodes if n.op == "call_function"
                    and ("scan" in str(n.target)
                         or "while_loop" in str(n.target))]
    assert [str(n.target).rsplit(".", 1)[-1] for n in loops_at_top] == [
        "scan"]
    scan_body = next(m for name, m in prog.graph_module.named_children()
                     if name.startswith("scan_combine"))
    assert any("while_loop" in str(n.target) for n in scan_body.graph.nodes)
    for args, eager in (((x[:3], c[:3], mask), want),
                        ((x, c, mask), module(x, c, mask))):
        got = prog.module()(*args)
        assert torch.equal(got[0], eager[0])
        for g, w in zip(got[1], eager[1]):
            assert torch.equal(g, w)
