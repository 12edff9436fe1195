"""The port's CPM training (tpu_pose_torch/models/cpm_train.py, the train
state checkpoints, tools/train_cpm.py) against the JAX package's, on the
CPU at a small size with JAX's weights carried across: the painted
targets, the supervision loss and its gradients, optax's two optimizer
forms, the fake-quantized view, and resumed training."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pose.models import cpm_train as jax_train
from tpu_pose.ops import preprocess as jax_pre
from tpu_pose.tools import train_cpm as jax_train_cli
from tpu_pose.utils import tf_converter as jax_conv
from tpu_pose.utils.config import CPMConfig as JaxCPMConfig
from tpu_pose_torch.data import pipeline, synthetic
from tpu_pose_torch.models import cpm as cpm_lib
from tpu_pose_torch.models import cpm_train, smpl_data
from tpu_pose_torch.ops import preprocess as pre
from tpu_pose_torch.tools import train_cpm
from tpu_pose_torch.utils import checkpoint
from tpu_pose_torch.utils.config import CPMConfig
from torch_threads import one_thread

one_thread()

CFG_KW = dict(input_size=64, features=16, stage1_head_width=32,
              refine_width=16, num_stages=2)
F32 = CPMConfig(compute_dtype="float32", **CFG_KW)
JAX_F32 = JaxCPMConfig(compute_dtype="float32", **CFG_KW)

LOSS_TOL = dict(rtol=1e-5, atol=0)        # float32, same weights
GRAD_TOL = 1e-4                           # max |Δg| / max |g| per tensor
PARAM_TOL = dict(rtol=0, atol=1e-6)       # after optimizer updates
# numpy's float32 cos against XLA's: 2 ulps, or one ulp of the cosine
# term times the peak lr where 1 + cos cancels (the schedule's tail).
SCHEDULE_TOL = dict(rtol=2.5e-7, atol=1e-10)


def _port_name(layer: str, kind: str):
    return f"{layer}.{'weight' if kind == 'w' else 'bias'}"


def _to_port(tree) -> dict:
    """JAX {layer: {w: HWIO, b}} arrays → the port's {name: OIHW tensor}."""
    out = {}
    for layer, wb in tree.items():
        for kind, v in wb.items():
            v = np.asarray(v)
            if kind == "w":
                v = v.transpose(3, 2, 0, 1)
            out[_port_name(layer, kind)] = torch.from_numpy(
                np.ascontiguousarray(v))
    return out


@pytest.fixture(scope="module")
def jax_params():
    """He-initialized weights in the JAX package's layout, built once
    (numpy draws: no per-shape XLA compiles)."""
    return jax.tree.map(jnp.asarray, cpm_lib.cpm_params_to_numpy(
        cpm_lib.init_cpm_params(0, F32, device="cpu")))


@pytest.fixture(scope="module")
def batch():
    """Two synthetic frames (uint8 images), with a joint mask and separate
    stage-1 targets."""
    model = smpl_data.synthetic_smpl(seed=0, num_verts=300, device="cpu")
    b = next(synthetic.cpm_train_batches(model, 2, 1, F32, seed=0,
                                         raw_images=True))
    rng = np.random.RandomState(1)
    b["joint_mask"] = (rng.rand(2, 15) > 0.3).astype(np.float32)
    b["heatmaps_stage1"] = np.clip(
        b["heatmaps"] + 0.1 * rng.rand(*b["heatmaps"].shape), 0,
        1).astype(np.float32)
    return b


def _cpm(params, cfg=F32):
    return cpm_lib.cpm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         cfg, device="cpu")


@pytest.mark.parametrize("n_joints,channels", [(14, 15), (3, 15), (5, 6)])
def test_paint_heatmaps_matches_jax(n_joints, channels):
    joints = np.random.RandomState(n_joints).uniform(
        -5, 70, (n_joints, 2)).astype(np.float32)
    want = np.asarray(jax_pre.paint_heatmaps(jnp.asarray(joints), 64, 8,
                                             6.0, channels))
    got = pre.paint_heatmaps(torch.from_numpy(joints), 64, 8, 6.0, channels)
    assert got.shape == want.shape == (8, 8, channels)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _loss_args(b, variant, torch_side: bool):
    images = b["images"]
    if variant != "uint8":
        images = images.astype(np.float32) / 256.0 - 0.5
    conv = torch.from_numpy if torch_side else jnp.asarray
    kw = {}
    if variant == "mask":
        kw["joint_mask"] = conv(b["joint_mask"])
    if variant == "stage1":
        kw["stage1_heatmaps"] = conv(b["heatmaps_stage1"])
    return (conv(images), conv(b["center_maps"]), conv(b["heatmaps"])), kw


@pytest.mark.parametrize("variant", ["plain", "mask", "stage1", "uint8"])
def test_stage_supervision_loss_matches_jax(jax_params, batch, variant):
    args, kw = _loss_args(batch, variant, False)
    want = float(jax_train.stage_supervision_loss(jax_params, *args,
                                                  JAX_F32, **kw))
    args, kw = _loss_args(batch, variant, True)
    with torch.no_grad():
        got = cpm_train.stage_supervision_loss(_cpm(jax_params), *args, F32,
                                               **kw)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, **LOSS_TOL)


@pytest.mark.parametrize("fake_quant", [False, True])
def test_value_and_grad_match_jax(jax_params, batch, fake_quant):
    """The loss with a joint mask and stage-1 targets, and its gradient
    with respect to every parameter, against ``jax.value_and_grad``
    (through the straight-through view with ``fake_quant``)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        if fake_quant:
            p = jax_train.fake_quant_params(p)
        return jax_train.stage_supervision_loss(
            p, jb["images"], jb["center_maps"], jb["heatmaps"], JAX_F32,
            joint_mask=jb["joint_mask"],
            stage1_heatmaps=jb["heatmaps_stage1"])

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jax_params)
    cpm = _cpm(jax_params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    view = cpm_train.fake_quant_params(cpm) if fake_quant else None
    loss = cpm_train.stage_supervision_loss(
        cpm, tb["images"], tb["center_maps"], tb["heatmaps"], F32,
        joint_mask=tb["joint_mask"], stage1_heatmaps=tb["heatmaps_stage1"],
        params=view)
    grads = torch.autograd.grad(loss, list(cpm.parameters()))
    np.testing.assert_allclose(float(loss), float(want_loss), **LOSS_TOL)
    want = _to_port(want_grads)
    for (name, _), g in zip(cpm.named_parameters(), grads):
        w = want[name].numpy()
        err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err < GRAD_TOL, (name, err)


def test_fake_quant_params_matches_jax_and_serving_weights(jax_params):
    """The straight-through view equals JAX's (jitted, as its train step
    runs it) bit for bit, and equals the dequantized int8 serving weights
    of ``quantize_params`` bit for bit; its gradient is the identity."""
    want = _to_port(jax.jit(jax_train.fake_quant_params)(jax_params))
    cpm = _cpm(jax_params)
    view = cpm_train.fake_quant_params(cpm)
    assert set(view) == set(want)
    for name, v in view.items():
        np.testing.assert_array_equal(v.detach().numpy(), want[name].numpy(),
                                      err_msg=name)
    qcpm = cpm_lib.quantize_params(cpm)
    for name, layer in qcpm.named_children():
        deq = (layer.weight_hwio().float() * layer.w_scale).permute(3, 2, 0, 1)
        assert torch.equal(deq, view[f"{name}.weight"].detach()), name
        assert torch.equal(layer.b, view[f"{name}.bias"].detach())
    w = cpm.conv1_stage1.weight
    (g,) = torch.autograd.grad(cpm_train.fake_quant_params(cpm)
                               ["conv1_stage1.weight"].sum(), w)
    assert torch.equal(g, torch.ones_like(w))


@pytest.mark.parametrize("total_steps", [None, 30])
def test_optimizer_update_matches_optax(jax_params, total_steps,
                                        monkeypatch):
    """Both ``init_train_state`` forms, given the same gradients at each
    step, against optax's jitted update: the parameters after each of
    four steps. The first scheduled update has lr 0. (JAX's init draws
    no weights here: its initializer returns the module's weights.)"""
    import optax
    monkeypatch.setattr(jax_train.cpm_lib, "init_cpm_params",
                        lambda key, cfg: jax_params)
    opt = jax_train.init_train_state(jax.random.PRNGKey(0), JAX_F32,
                                     lr=1e-3, total_steps=total_steps)[2]

    @jax.jit
    def update(g, s, p):
        u, s = opt.update(g, s, p)
        return u, s, optax.apply_updates(p, u)

    params = jax_params
    opt_state = jax.jit(opt.init)(params)
    cpm = _cpm(params)
    topt = cpm_train.TrainOptimizer(1e-3, total_steps)
    state = topt.init(dict(cpm.named_parameters()))
    rng = np.random.RandomState(0)
    for step in range(4):
        grads = jax.tree.map(
            lambda x: rng.randn(*x.shape).astype(np.float32)
            * (0.3 if x.ndim == 4 else 0.05), params)
        upd, opt_state, params = update(grads, opt_state, params)
        state = topt.apply(dict(cpm.named_parameters()), _to_port(grads),
                           state)
        want = _to_port(params)
        for name, p in cpm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), **PARAM_TOL,
                                       err_msg=f"step {step} {name}")
        if step == 0 and total_steps is not None:
            assert topt.learning_rate(0) == 0.0
            assert all(np.array_equal(np.asarray(u), 0 * np.asarray(u))
                       for u in jax.tree.leaves(upd))
            for name, p in cpm.named_parameters():
                np.testing.assert_array_equal(p.detach().numpy(),
                                              _to_port(jax_params)[name])
    assert state["count"] == 4
    if total_steps is not None:
        sched = jax.jit(optax.warmup_cosine_decay_schedule(
            0.0, 1e-3, max(1, int(total_steps * 0.05)), total_steps,
            1e-3 / 50.0))
        np.testing.assert_allclose(
            [topt.learning_rate(c) for c in range(total_steps + 2)],
            [float(sched(c)) for c in range(total_steps + 2)],
            **SCHEDULE_TOL)


def _train(cpm, opt_state, opt, batches, fake_quant=False):
    step = cpm_train.make_train_step(F32, opt, fake_quant=fake_quant)
    losses = []
    for b in batches:
        cpm, opt_state, loss = step(cpm, opt_state, b)
        losses.append(float(loss))
    return cpm, opt_state, losses


def test_scheduled_training_reduces_the_loss():
    model = smpl_data.synthetic_smpl(seed=0, num_verts=300, device="cpu")
    b = next(synthetic.cpm_train_batches(model, 2, 1, F32, seed=0))
    cpm, opt_state, opt = cpm_train.init_train_state(
        0, F32, lr=1e-3, total_steps=30, device="cpu")
    _, _, losses = _train(cpm, opt_state, opt, [b] * 30)
    assert losses[1] == losses[0]          # the first step has lr 0
    assert losses[-1] < losses[2] * 0.8, losses[:3] + losses[-3:]


def test_train_resume_equals_uninterrupted(tmp_path):
    """4 QAT steps == 2 steps, save, restore into a fresh CPM, 2 steps:
    parameters, Adam moments and the count come back bit for bit."""
    model = smpl_data.synthetic_smpl(seed=0, num_verts=300, device="cpu")
    bs = list(synthetic.cpm_train_batches(model, 2, 4, F32, seed=3,
                                          raw_images=True))
    cpm, st, opt = cpm_train.init_train_state(0, F32, lr=1e-3,
                                              total_steps=8, device="cpu")
    full, full_state, full_losses = _train(cpm, st, opt, bs, True)

    cpm, st, opt = cpm_train.init_train_state(0, F32, lr=1e-3,
                                              total_steps=8, device="cpu")
    cpm, st, first = _train(cpm, st, opt, bs[:2], True)
    ckpt = str(tmp_path / "ckpt")
    assert checkpoint.latest_step(ckpt) is None
    checkpoint.save_train_state(ckpt, 2, cpm, st)
    checkpoint.save_train_state(ckpt, 2, cpm, st)     # replaces step 2
    assert checkpoint.latest_step(ckpt) == 2
    fresh = cpm_lib.init_cpm_params(1, F32, device="cpu")
    step, fresh, fresh_st = checkpoint.restore_train_state(ckpt, fresh)
    assert step == 2 and fresh_st["count"] == 2
    for (n, a), b in zip(cpm.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), n
    for k in ("mu", "nu"):
        for n, v in st[k].items():
            assert torch.equal(v, fresh_st[k][n]), (k, n)
    resumed, res_state, second = _train(fresh, fresh_st, opt, bs[2:], True)
    assert first + second == full_losses
    for (n, a), b in zip(full.named_parameters(), resumed.parameters()):
        assert torch.equal(a, b), n
    for n, v in full_state["nu"].items():
        assert torch.equal(v, res_state["nu"][n]), n
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_train_state(str(tmp_path / "none"), fresh)


# ---------------------------------------------------------------------------
# tools/train_cpm.py
# ---------------------------------------------------------------------------

def test_train_cli_synthetic_resume_and_export(tmp_path, capsys,
                                               monkeypatch):
    """The CLI at the small widths (its CPMConfig patched): train 2 steps
    with checkpoints, resume to 3 with QAT, export the npz."""
    import functools

    from tpu_pose_torch.utils import config
    small = functools.partial(CPMConfig, features=16, stage1_head_width=32,
                              refine_width=16, num_stages=2)
    monkeypatch.setattr(config, "CPMConfig", small)
    ckpt, export = str(tmp_path / "ckpt"), str(tmp_path / "w.npz")
    argv = ["--synthetic", "--input_size", "32", "--batch", "2",
            "--log_every", "1", "--ckpt_every", "1", "--ckpt_dir", ckpt,
            "--device", "cpu", "--lr", "1e-3"]
    train_cpm.main(argv + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "step 2: loss" in out and "done: 2 steps" in out
    assert checkpoint.latest_step(ckpt) == 2
    train_cpm.main(argv + ["--steps", "3", "--qat", "--export", export])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step 3: loss" in out
    assert "step 1:" not in out and checkpoint.latest_step(ckpt) == 3
    # The npz is the interchange: both packages load the trained weights.
    cfg = small(input_size=32)
    params = jax_conv.load_params_npz(export)
    est_cpm = cpm_lib.cpm_params_from_numpy(params, cfg, device="cpu")
    _, restored, _ = checkpoint.restore_train_state(
        ckpt, cpm_lib.init_cpm_params(5, cfg, device="cpu"))
    for (n, a), b in zip(restored.named_parameters(), est_cpm.parameters()):
        assert torch.equal(a, b), n
    with pytest.raises(SystemExit):
        train_cpm.main(["--device", "cpu"])


@pytest.fixture
def no_grain(monkeypatch):
    monkeypatch.setitem(sys.modules, "grain", None)
    monkeypatch.setitem(sys.modules, "grain.python", None)


def test_painted_batches_match_jax(tmp_path, no_grain):
    """Converter shards → painted targets, joint mask and flips, with the
    rotation and scale augmentation on, against the JAX CLI's (whose
    reader takes the numpy order here)."""
    rng = np.random.RandomState(0)
    n, size = 6, 64
    conf = (rng.rand(n, 14) > 0.2).astype(np.float32)
    pipeline.write_npz_shards(str(tmp_path), {
        "images": rng.randint(0, 255, (n, size, size, 3)).astype(np.uint8),
        "gt_joints2d": rng.uniform(5, 59, (n, 14, 2)).astype(np.float32),
        "conf": conf}, shard_size=4)
    kw = dict(flip_prob=0.5, sigma=2.0, rot_deg=30.0, scale_jit=0.25,
              seed=3)
    got = train_cpm._painted_batches(str(tmp_path), 2, F32, **kw)
    want = jax_train_cli._painted_batches(str(tmp_path), 2, JAX_F32, **kw)
    for _ in range(4):                      # past one epoch of 3 batches
        g, w = next(got), next(want)
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["joint_mask"], w["joint_mask"])
        np.testing.assert_allclose(g["heatmaps"], w["heatmaps"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(g["center_maps"], w["center_maps"],
                                   rtol=0, atol=1e-6)
