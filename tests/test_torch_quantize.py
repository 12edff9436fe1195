"""The port's int8 serving path against the JAX package's, on
tests/test_quantize.py's small CPM: weight quantization, the activation
quantizer (kernel B2's plain version), one int8 conv, calibration, the
whole int8 forward and estimate_and_fit, micro-chunks, the batch-size
precision policy and the quantized npz format. JAX weights are carried
across with from_numpy; inputs are made with numpy from a seed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pose.api import PoseEstimator as JaxEstimator
from tpu_pose.models import cpm as jax_cpm
from tpu_pose.ops import pallas_kernels
from tpu_pose.ops import preprocess as jax_pre
from tpu_pose.utils import config as jc
from tpu_pose.utils import tf_converter as jax_conv
from tpu_pose_torch.api import PoseEstimator
from tpu_pose_torch.models import cpm as torch_cpm
from tpu_pose_torch.ops import quantize as quant_lib
from tpu_pose_torch.utils import config as tc
from tpu_pose_torch.utils import tf_converter as torch_conv
from torch_threads import one_thread

one_thread()

# tests/test_quantize.py's CFG (float32 activations between layers).
SMALL = dict(input_size=64, features=16, stage1_head_width=32,
             refine_width=16, num_stages=3, compute_dtype="float32")
JCFG, TCFG = jc.CPMConfig(**SMALL), tc.CPMConfig(**SMALL)


def _np(tree):
    return {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def params():
    """(JAX float params, the port's CPM holding the same weights)."""
    p = jax_cpm.init_cpm_params(jax.random.PRNGKey(0), JCFG)
    return p, torch_cpm.cpm_params_from_numpy(_np(p), TCFG, "cpu")


def _inputs(b, seed):
    """Normalized images and the center map, as numpy (B, 64, 64, ·)."""
    x = np.random.RandomState(seed).rand(b, 64, 64, 3).astype(np.float32)
    cm = np.broadcast_to(np.asarray(jax_pre.gaussian_center_map(64, 21.0)),
                         (b, 64, 64, 1)).copy()
    return x - np.float32(0.5), cm


def test_quantize_params_bit_equal(params):
    """Same int8 weights and float32 scales as the JAX quantize_params."""
    jp, cpm = params
    want = jax_cpm.quantize_params(jp)
    got = torch_cpm.cpm_params_to_numpy(torch_cpm.quantize_params(cpm))
    assert set(got) == set(want)
    for name, p in want.items():
        assert got[name]["w_int8"].dtype == np.int8
        for kind in ("w_int8", "w_scale", "b"):
            np.testing.assert_array_equal(got[name][kind],
                                          np.asarray(p[kind]),
                                          err_msg=f"{name}.{kind}")


def _act(case):
    """(input, static scale or None) for a quantizer case."""
    rng = np.random.RandomState(1)
    if case == "halfway":
        # |x| / s = k + 0.5 exactly (s = 0.25): half to even decides.
        k = rng.randint(-120, 120, (6, 7, 11)).astype(np.float32)
        return (k + np.float32(0.5)) * np.float32(0.25), np.float32(0.25)
    if case == "zeros":
        return np.zeros((2, 5, 5, 3), np.float32), None
    x = (rng.randn(4, 9, 10, 13) * 3).astype(np.float32)   # odd count
    return x, (np.float32(0.05) if case == "static" else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["dynamic", "static", "halfway", "zeros"])
def test_quantize_act_matches_jax(dtype, case):
    """The plain quantizer equals JAX's _quantize_act (as called, eagerly)
    and, for dynamic scales, quantize_act_pallas in interpret mode, bit
    for bit: int8 values and the scale."""
    x, a_scale = _act(case)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = quant_lib.quantize_act(
        tx, None if a_scale is None else torch.tensor(a_scale))
    assert q.dtype == torch.int8 and q.shape == tx.shape and s.dim() == 0
    jq, js = jax_cpm._quantize_act(
        jx.astype(jnp.float32), None if a_scale is None else
        jnp.asarray(a_scale))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    if a_scale is None:
        pq, ps = pallas_kernels.quantize_act_pallas(jx, interpret=True)
        np.testing.assert_array_equal(q.numpy(), np.asarray(pq))
        assert s.item() == float(ps)
    if case == "halfway":
        k = np.round(x / a_scale - 0.5)
        np.testing.assert_array_equal(q.numpy(),
                                      np.where(k % 2 == 0, k, k + 1))
    if case == "zeros":
        assert s.item() == np.float32(1e-12) and not q.any()


def test_dynamic_scale_xla_reciprocal():
    """XLA rewrites the ``max|x| / 127.0`` of a jitted _quantize_act as a
    multiply by float32(1/127), which for some max|x| lands one float32
    ulp away from the division. The port divides, as the Pallas kernel
    and the eager JAX function do (ROADMAP.md §C)."""
    cand = np.arange(1, 4000, dtype=np.float32) * np.float32(0.37)
    recip = cand * (np.float32(1) / np.float32(127))
    amax = cand[recip != cand / np.float32(127)][0]
    x = np.full((4, 4), -amax / 3, np.float32)
    x[1, 2] = amax
    _, s_port = quant_lib.quantize_act(torch.from_numpy(x))
    _, s_jit = jax.jit(jax_cpm._quantize_act)(jnp.asarray(x), None)
    _, s_eager = jax_cpm._quantize_act(jnp.asarray(x), None)
    assert s_port.item() == float(s_eager) == amax / np.float32(127)
    assert float(s_jit) == amax * (np.float32(1) / np.float32(127))
    assert float(s_jit) != s_port.item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_q_single_layer(params, dtype):
    """One int8 conv (Mconv2, 11×11) on the same input: bit-equal with
    float32 activations; within one bf16 ulp with bf16 outputs (both round
    the same float32 epilogue, so in practice equal too)."""
    jp, cpm = params
    name = "Mconv2_stage2"
    scales = {name: 0.02}
    jq = jax_cpm.quantize_params({name: jp[name]}, scales)[name]
    layer = torch_cpm.quantize_params(cpm, scales)
    layer = getattr(layer, name)
    x = (np.random.RandomState(3).randn(2, 8, 8, 16) * 0.7).astype(
        np.float32)
    act = getattr(jnp, dtype)
    want = np.asarray(jax.jit(functools.partial(
        jax_cpm._conv_q, relu=True, act_dtype=act))(jnp.asarray(x), jq)
        .astype(jnp.float32))
    got = torch_cpm._conv_q(torch.from_numpy(x).permute(0, 3, 1, 2), layer,
                            True, getattr(torch, dtype))
    got = got.permute(0, 2, 3, 1).float().numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0)
    # A dynamic scale on the float32 images (conv1, K = 243 padded to
    # 248), held against JAX's conv at the scale its eager quantizer
    # computes (jitted, XLA would round the scale differently:
    # test_dynamic_scale_xla_reciprocal).
    name = "conv1_stage1"
    img, _ = _inputs(2, 4)
    _, s = jax_cpm._quantize_act(jnp.asarray(img), None)
    jq = jax_cpm.quantize_params({name: jp[name]}, {name: float(s)})[name]
    layer = getattr(torch_cpm.quantize_params(cpm), name)
    assert layer.a_scale is None
    want = np.asarray(jax.jit(functools.partial(
        jax_cpm._conv_q, relu=True, act_dtype=act))(jnp.asarray(img), jq)
        .astype(jnp.float32))
    got = torch_cpm._conv_q(torch.from_numpy(img).permute(0, 3, 1, 2),
                            layer, True, getattr(torch, dtype))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).float().numpy(),
                                  want)


def test_calibrate_act_scales_f32(params):
    """Same layers and scales within 1e-5 relative (float32 conv sums in
    another order)."""
    jp, cpm = params
    x, cm = _inputs(2, 5)
    want = jax_cpm.calibrate_act_scales(jp, jnp.asarray(x), jnp.asarray(cm),
                                        JCFG)
    got = torch_cpm.calibrate_act_scales(cpm, torch.from_numpy(x),
                                         torch.from_numpy(cm), TCFG)
    assert set(got) == set(want)
    for name in want:
        assert abs(got[name] - want[name]) <= 1e-5 * want[name], name


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_int8_cpm_forward_matches_jax(params, scales):
    """Every stage of the int8 forward on JAX's quantized params. Static
    scales: bit-equal — the int32 sums are exact, the epilogue is the
    same float32 operations in the same order, both divide. Dynamic
    scales: JAX's jitted abs-max scale is computed as ×float32(1/127)
    (test_dynamic_scale_xla_reciprocal), one ulp from the port's, so
    beliefs agree within 1e-4·max|b| like the float32 forward."""
    jp, _ = params
    x, cm = _inputs(2, 6)
    act = (jax_cpm.calibrate_act_scales(jp, jnp.asarray(x), jnp.asarray(cm),
                                        JCFG) if scales == "static" else None)
    jq = jax_cpm.quantize_params(jp, act)
    qcpm = torch_cpm.cpm_params_from_numpy(_np(jq), TCFG, "cpu")
    assert isinstance(qcpm, torch_cpm.QuantizedCPM)
    want = jax.jit(functools.partial(jax_cpm.cpm_forward, cfg=JCFG))(
        jq, jnp.asarray(x), jnp.asarray(cm))
    with torch.no_grad():
        got = torch_cpm.cpm_forward(qcpm, torch.from_numpy(x),
                                    torch.from_numpy(cm), TCFG)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (2, 8, 8, 15) and g.dtype == torch.float32
        if scales == "static":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())


def test_int8_forward_concat_is_float32(params):
    """As in JAX's _make_conv, an int8 CPM's beliefs and center hint enter
    the Mconv1 concat as float32, which promotes the bf16 features: the
    tap sees a float32 Mconv1 input and bf16 inputs elsewhere."""
    _, cpm = params
    cfg = tc.CPMConfig(**{**SMALL, "compute_dtype": "bfloat16"})
    seen = {}
    x, cm = _inputs(1, 7)
    with torch.no_grad():
        torch_cpm.cpm_forward(torch_cpm.quantize_params(cpm),
                              torch.from_numpy(x), torch.from_numpy(cm), cfg,
                              on_conv_input=lambda n, h: seen.update({n: h}))
    assert seen["conv1_stage1"].dtype == torch.float32
    assert seen["Mconv1_stage2"].dtype == torch.float32
    assert seen["conv2_stage1"].dtype == torch.bfloat16
    assert seen["Mconv2_stage2"].dtype == torch.bfloat16


def _cfgs(cfg_mod, dtype):
    """tests/test_api.py's SMALL_CPM / SMALL_FIT in either package."""
    cpm = cfg_mod.CPMConfig(input_size=64, features=16, stage1_head_width=32,
                            refine_width=16, num_stages=2,
                            compute_dtype=dtype)
    fit = cfg_mod.FitConfig(
        stages=(cfg_mod.StageConfig(iters=20, lr=0.05, opt_pose=False,
                                    opt_shape=False, w_pose_prior=0,
                                    w_shape_prior=0, w_angle_prior=0),
                cfg_mod.StageConfig(iters=40, lr=0.02, w_pose_prior=0.5,
                                    w_shape_prior=1.0)),
        img_size=64)
    return cpm, fit


def _frames(b, seed):
    return np.random.RandomState(seed).randint(0, 256, (b, 64, 64, 3)).astype(
        np.uint8)


def _mpjpe_mm(a, b):
    return 1000.0 * float(np.linalg.norm(a - b, axis=-1).mean())


def _port_estimator(jest, dtype, **kw):
    """The port's estimator on ``jest``'s CPM params (float or already
    quantized), SMPL model and prior."""
    smpl = {k: np.asarray(v) for k, v in jest.smpl_model._asdict().items()}
    prior = {k: np.asarray(getattr(jest.prior, k))
             for k in ("means", "precisions", "log_consts")}
    return PoseEstimator.from_numpy(_np(jest.cpm_params), smpl, prior,
                                    *_cfgs(tc, dtype), device="cpu", **kw)


@pytest.mark.parametrize("case", ["float32-carried", "float32-calibrated",
                                  "bfloat16-carried"])
def test_estimate_and_fit_int8_matches_jax(case):
    """JAX's PoseEstimator(quantize=True, int8_min_batch=0) against the
    port's on the same weights. "carried": JAX's quantized params (dynamic
    scales) used as they are; "calibrated": the port quantizes and
    calibrates the float weights itself on the same calibration frames.
    float32 activations: joints2d within 0.5 px and joints3d within 1 mm
    MPJPE (BASELINE.json's budget). bf16 activations: the bounds of
    tests/test_torch_api.py::test_estimate_and_fit_bf16 (8 px, 25 mm)."""
    dtype, how = case.split("-")
    cal = _frames(3, 11) if how == "calibrated" else None
    jcfg = _cfgs(jc, dtype)
    jest = JaxEstimator.create_synthetic(
        0, *jcfg, quantize=True, int8_min_batch=0,
        calibration_images=None if cal is None else jnp.asarray(cal))
    if how == "carried":
        test = _port_estimator(jest, dtype)
    else:
        test = _port_estimator(JaxEstimator.create_synthetic(0, *jcfg), dtype,
                               quantize=True, int8_min_batch=0,
                               calibration_images=cal)
    assert isinstance(test.cpm, torch_cpm.QuantizedCPM)
    assert test.cpm_bf16 is None
    imgs = _frames(2, 9)
    want = {k: np.asarray(v) for k, v in
            jest.estimate_and_fit(jnp.asarray(imgs))._asdict().items()}
    got = {k: v.numpy() for k, v in
           test.estimate_and_fit(imgs)._asdict().items()}
    for k in want:
        assert got[k].shape == want[k].shape and np.isfinite(got[k]).all(), k
    if dtype == "float32":
        np.testing.assert_allclose(got["joints2d"], want["joints2d"], rtol=0,
                                   atol=0.5)
        assert _mpjpe_mm(got["joints3d"], want["joints3d"]) <= 1.0
    else:
        np.testing.assert_allclose(got["joints2d"], want["joints2d"], rtol=0,
                                   atol=8)
        assert _mpjpe_mm(got["joints3d"], want["joints3d"]) <= 25.0


@pytest.mark.parametrize("quantized", [False, True])
def test_microbatch_uneven_equals_whole(params, quantized):
    """cpm_microbatch=2 on 5 frames (padded to 6 by repeating the last)
    gives the whole batch's heatmaps, joints and conf. The int8 CPM with
    static scales gives the same heatmaps exactly (integer sums,
    per-element epilogue); the float CPM within float32 conv-sum noise.
    Joints and conf within the decode's own tolerance (rtol 1e-5, atol
    1e-4: its sums vectorize by batch shape)."""
    jp, cpm = params
    imgs = torch.from_numpy(_frames(5, 12))
    if quantized:
        x, cm = _inputs(2, 13)
        cpm = torch_cpm.quantize_params(cpm, torch_cpm.calibrate_act_scales(
            cpm, torch.from_numpy(x), torch.from_numpy(cm), TCFG))
    with torch.no_grad():
        whole = torch_cpm.estimate_2d_microbatched(cpm, imgs, TCFG, chunk=0)
        parts = torch_cpm.estimate_2d_microbatched(cpm, imgs, TCFG, chunk=2)
    for w, p in zip(whole, parts):
        assert p.shape == w.shape and p.shape[0] == 5
    if quantized:
        assert torch.equal(parts[0], whole[0])
    for w, p in zip(whole, parts):
        torch.testing.assert_close(p, w, rtol=1e-5, atol=1e-4)
    # And JAX's micro-chunked path on the same float weights.
    if not quantized:
        hm, j, c = jax.jit(functools.partial(
            jax_cpm.estimate_2d_microbatched, cfg=JCFG, chunk=2))(
                jp, jnp.asarray(imgs.numpy()))
        np.testing.assert_allclose(parts[1].numpy(), np.asarray(j), rtol=0,
                                   atol=1e-2)


def test_precision_policy(params):
    """int8_min_batch: the float CPM below it, the int8 CPM at or above
    it; 0 or 1 keeps no float twin; an already-quantized CPM is used as
    it is, with quantize=True or not."""
    _, cpm = params
    from tpu_pose_torch.models import smpl_data
    model = smpl_data.synthetic_smpl(seed=0, device="cpu")
    est = PoseEstimator(cpm, model, None, TCFG, quantize=True,
                        int8_min_batch=4, device="cpu")
    assert est._params_for_batch(3) is cpm
    assert isinstance(est._params_for_batch(4), torch_cpm.QuantizedCPM)
    assert est._params_for_batch(9) is est.cpm
    imgs = _frames(2, 14)
    float_est = PoseEstimator(cpm, model, None, TCFG, device="cpu")
    torch.testing.assert_close(est.estimate_2d(imgs).heatmaps,
                               float_est.estimate_2d(imgs).heatmaps,
                               rtol=0, atol=0)
    for min_batch in (0, 1):
        est = PoseEstimator(cpm, model, None, TCFG, quantize=True,
                            int8_min_batch=min_batch, device="cpu")
        assert est.cpm_bf16 is None
        assert isinstance(est._params_for_batch(1), torch_cpm.QuantizedCPM)
    qcpm = torch_cpm.quantize_params(cpm)
    for quantize in (False, True):
        est = PoseEstimator(qcpm, model, None, TCFG, quantize=quantize,
                            device="cpu")
        assert est.cpm is qcpm and est.cpm_bf16 is None
        assert est._params_for_batch(1) is qcpm
    plain = PoseEstimator(cpm, model, None, TCFG, device="cpu")
    assert plain._params_for_batch(64) is cpm


def test_quantized_npz_round_trip(params, tmp_path):
    """A calibrated int8 npz written by the JAX package loads into the
    port (QuantizedCPM; PoseEstimator.from_files uses it as it is) with a
    bit-equal forward, and the port writes back the same arrays."""
    jp, _ = params
    x, cm = _inputs(2, 15)
    jq = jax_cpm.quantize_params(jp, jax_cpm.calibrate_act_scales(
        jp, jnp.asarray(x), jnp.asarray(cm), JCFG))
    path = str(tmp_path / "int8.npz")
    jax_conv.save_params_npz(path, jq)
    loaded = torch_conv.load_params_npz(path)
    qcpm = torch_cpm.cpm_params_from_numpy(loaded, TCFG, "cpu")
    assert isinstance(qcpm, torch_cpm.QuantizedCPM)
    back = torch_cpm.cpm_params_to_numpy(qcpm)
    for name, p in jq.items():
        assert set(back[name]) == {"w_int8", "w_scale", "b", "a_scale"}
        for kind, v in p.items():
            np.testing.assert_array_equal(back[name][kind], np.asarray(v))
    again = str(tmp_path / "again.npz")
    torch_conv.save_params_npz(again, back)
    reloaded = jax_conv.load_params_npz(again)
    want = jax.jit(functools.partial(jax_cpm.cpm_forward, cfg=JCFG))(
        reloaded, jnp.asarray(x), jnp.asarray(cm))[-1]
    with torch.no_grad():
        got = torch_cpm.cpm_forward(qcpm, torch.from_numpy(x),
                                    torch.from_numpy(cm), TCFG)[-1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bad = dict(loaded, conv1_stage1=dict(
        loaded["conv1_stage1"],
        w_int8=loaded["conv1_stage1"]["w_int8"].astype(np.int16)))
    with pytest.raises(ValueError, match="w_int8"):
        torch_cpm.cpm_params_from_numpy(bad, TCFG, "cpu")


def test_int8_conv_tiles_and_gemm_rules(monkeypatch):
    """Tiling over output rows (whole images, or runs of rows when one
    image exceeds the budget) gives the untiled result; K and N padding
    holds; int8_gemm refuses what torch._int_mm on CUDA refuses."""
    rng = np.random.RandomState(16)
    q = torch.from_numpy(rng.randint(-127, 128, (3, 7, 5, 3)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (16, 5, 5, 3)).astype(np.int8))
    w_gemm = torch.zeros(16, 80, dtype=torch.int8)
    w_gemm[:, :75] = w.reshape(16, 75)
    ref = torch.nn.functional.conv2d(
        q.permute(0, 3, 1, 2).double(), w.permute(0, 3, 1, 2).double(),
        padding=2).permute(0, 2, 3, 1)
    outs = []
    for budget in (2 ** 30, 5 * 100 * 3, 1):
        monkeypatch.setattr(quant_lib, "TILE_BYTES", budget)
        tiles = list(quant_lib._tiles(3, 7, 100))
        covered = sorted((b, h) for b0, b1, h0, h1 in tiles
                         for b in range(b0, b1) for h in range(h0, h1))
        assert covered == [(b, h) for b in range(3) for h in range(7)]
        outs.append(quant_lib.int8_conv(q, w_gemm.t(), 5, 15,
                                        lambda acc: acc.double(),
                                        torch.float64))
    for out in outs:
        torch.testing.assert_close(out, ref[..., :15], rtol=0, atol=0)
    a = torch.zeros(4, 12, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 8"):
        quant_lib.int8_gemm(a, torch.zeros(8, 12, dtype=torch.int8).t())
    with pytest.raises(ValueError, match="multiples of 8"):
        quant_lib.int8_gemm(torch.zeros(4, 8, dtype=torch.int8),
                            torch.zeros(8, 15, dtype=torch.int8))
    got = quant_lib.int8_gemm(torch.ones(3, 8, dtype=torch.int8),
                              torch.ones(8, 8, dtype=torch.int8).t())
    assert got.shape == (3, 8) and bool((got == 8).all())


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_int8_conv_grouped_matches_static_tiles(monkeypatch, scales):
    """The symbolic-batch form of int8_conv (the batch padded to whole
    groups, a scan over the groups, B2's functional gather) against the
    static tiles, bit for bit, at a batch (5) that is not a multiple of
    the group (2): a 5×5 gather with a static or a dynamic scale, a row
    run split of one image (a small tile budget) and a 1×1 conv of int8
    values (no gather)."""
    monkeypatch.setattr(quant_lib, "GROUP_IMAGES", 2)
    rng = np.random.RandomState(17)
    x = torch.from_numpy(rng.randn(5, 9, 7, 6).astype(np.float32))
    a_scale = (torch.tensor(0.02) if scales == "static"
               else quant_lib.act_scale(x))
    w = torch.from_numpy(rng.randint(-127, 128, (16, 5 * 5 * 6 + 2))
                         .astype(np.int8))
    w[:, 150:] = 0
    bias = torch.from_numpy(rng.randn(13).astype(np.float32))

    def epilogue(acc, scale, b):
        return torch.relu_(acc.float().mul_(scale).add_(b))

    args = (epilogue, torch.bfloat16, a_scale, (a_scale * 0.01, bias))
    want = quant_lib.int8_conv(x, w.t(), 5, 13, *args)
    got = quant_lib._int8_conv_grouped(x, w.t(), 5, 13, *args)
    assert torch.equal(got, want)
    monkeypatch.setattr(quant_lib, "TILE_BYTES", 3 * 7 * (152 + 8 * 16))
    g, tiles = quant_lib._group_tiles(9, 7 * (152 + 8 * 16))
    assert g == 1 and len(tiles) == 3 and tiles[0] == (0, 1, 0, 3)
    assert torch.equal(quant_lib._int8_conv_grouped(x, w.t(), 5, 13, *args),
                       want)
    q = torch.from_numpy(rng.randint(-127, 128, (5, 4, 3, 8)).astype(np.int8))
    w1 = torch.from_numpy(rng.randint(-127, 128, (8, 8)).astype(np.int8))
    one = (lambda acc: acc.double(), torch.float64)
    assert torch.equal(quant_lib._int8_conv_grouped(q, w1.t(), 1, 8, *one),
                       quant_lib.int8_conv(q, w1.t(), 1, 8, *one))
