"""The port's CUDA kernels against their plain PyTorch versions.

Imports no JAX, so it also runs on a GPU machine without it. There, from
the repository root (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda_kernels.py -q

The ``cuda`` tests skip where ``torch.cuda.is_available()`` is false: a
CUDA kernel has no CPU or interpret mode.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_pose_torch.models import cpm as cpm_lib
from tpu_pose_torch.ops import cuda_kernels, quantize, softargmax
from tpu_pose_torch.utils.config import CPMConfig
from torch_threads import one_thread

one_thread()

# The reference's own Pallas-vs-XLA tolerances (tests/test_pallas.py):
# float32 sums over 2116 cells taken in another order.
J_TOL = dict(rtol=1e-5, atol=1e-4)
C_TOL = dict(rtol=1e-6, atol=1e-6)


def _planted(batch, seed=0):
    """(B, 46, 46, 15) NHWC view of NCHW memory with one planted peak per
    part (``.contiguous()`` gives the CPM's NHWC layout)."""
    rng = np.random.RandomState(seed)
    hm = rng.rand(batch, 15, 46, 46).astype(np.float32)
    for b in range(batch):
        for j in range(14):
            hm[b, j, (7 * b + j) % 46, (3 * j + 5) % 46] = 3.0
    return torch.from_numpy(hm).permute(0, 2, 3, 1)


def _delta(layout="nhwc"):
    """A single 10.0 in part 0 of a zero map, NHWC-contiguous or as an
    NHWC view of NCHW memory: the decode must give exactly its cell."""
    hm = torch.zeros(1, 15, 46, 46)
    hm[0, 0, 20, 33] = 10.0
    hm = hm.permute(0, 2, 3, 1)
    return hm.contiguous() if layout == "nhwc" else hm


def _nan_map(layout):
    hm = _planted(2, 4)
    hm = hm.contiguous() if layout == "nhwc" else hm
    hm[1, 7, 9, 3] = float("nan")
    return hm


def test_wrapper_takes_plain_version_on_cpu():
    """On a CPU tensor the wrapper runs the plain version and counts no
    launch, whether called directly or through _decode with any impl;
    unknown impls raise."""
    hm = _planted(3)
    before = cuda_kernels.soft_argmax_cuda.launches
    j_w, c_w = cuda_kernels.soft_argmax_cuda(hm, beta=50.0, stride=8)
    j_p, c_p = softargmax.soft_argmax(hm, beta=50.0, stride=8)
    assert torch.equal(j_w, j_p) and torch.equal(c_w, c_p)
    for impl in ("auto", "cuda", "torch"):
        j_d, c_d = cpm_lib._decode(hm, CPMConfig(decode_impl=impl), 50.0)
        assert torch.equal(j_d, j_p) and torch.equal(c_d, c_p)
    assert cuda_kernels.soft_argmax_cuda.launches == before
    with pytest.raises(ValueError, match="unknown decode_impl"):
        cpm_lib._decode(hm, CPMConfig(decode_impl="pallas"), 50.0)


def test_build_dir_in_source_checkout():
    """In a source checkout kernels build under the repository's ignored
    build/ directory, never beside an installed package."""
    root = Path(__file__).resolve().parents[1]
    assert cuda_kernels.build_dir() == root / "build" / "tpu_pose_torch"


def test_quantize_wrapper_takes_plain_version_on_cpu():
    """On a CPU tensor the B2 wrappers (scale, quantize, fused gather) are
    their plain versions, static or dynamic, float32 or bf16, and count no
    launch."""
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 5, 7, 9)
                         .astype(np.float32))
    before = (cuda_kernels.quantize_act_cuda.launches,
              cuda_kernels.act_scale_cuda.launches,
              cuda_kernels.quantize_im2col_cuda.launches)
    for t in (x, x.bfloat16()):
        for a_scale in (None, torch.tensor(0.03)):
            q_w, s_w = cuda_kernels.quantize_act_cuda(t, a_scale)
            q_p, s_p = quantize.quantize_act(t, a_scale)
            assert torch.equal(q_w, q_p) and torch.equal(s_w, s_p)
            assert torch.equal(cuda_kernels.act_scale_cuda(t, a_scale), s_p)
            out_w, out_p = (torch.empty(3 * 5 * 7, 81, dtype=torch.int8)
                            for _ in range(2))
            cuda_kernels.quantize_im2col_cuda(t, s_p, 3, (0, 3, 0, 5), out_w)
            quantize.quantize_im2col(t, s_p, 3, (0, 3, 0, 5), out_p)
            assert torch.equal(out_w, out_p)
    assert (cuda_kernels.quantize_act_cuda.launches,
            cuda_kernels.act_scale_cuda.launches,
            cuda_kernels.quantize_im2col_cuda.launches) == before


def test_every_source_is_built():
    """build() with no names compiles every .cu under csrc/."""
    assert sorted(cuda_kernels.SOURCES) == sorted(
        p.stem for p in cuda_kernels.CSRC.glob("*.cu"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels have no "
                    "CPU or interpret mode")
    return torch.device("cuda")


CASES = {"b1": (lambda: _planted(1), 100.0),
         "b8": (lambda: _planted(8, 8), 100.0),
         "b128": (lambda: _planted(128, 128), 100.0),
         "odd_b3_beta50": (lambda: _planted(3, 3), 50.0),
         "nhwc_contiguous_b8": (lambda: _planted(8, 9).contiguous(), 100.0),
         "nhwc_contiguous_b128": (lambda: _planted(128, 7).contiguous(),
                                  100.0),
         "nhwc_sliced_b4": (lambda: torch.cat(
             [_planted(4, 6), torch.rand(4, 46, 46, 5)], -1)[..., :15], 100.0),
         "delta": (_delta, 100.0),
         "delta_nchw": (lambda: _delta("nchw"), 100.0),
         "nan_nhwc": (lambda: _nan_map("nhwc"), 100.0),
         "nan_nchw": (lambda: _nan_map("nchw"), 100.0),
         # The front end's geometry decode: stage-1 beliefs at β = 30.
         "stage1_beta30_b8": (lambda: _planted(8, 30).contiguous(), 30.0),
         "stage1_beta30_b48": (lambda: _planted(48, 31).contiguous(), 30.0),
         "stage1_beta30_nchw_b16": (lambda: _planted(16, 32), 30.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_soft_argmax_kernel_matches_plain(cuda_device, case):
    """NHWC memory (the CPM's layout), an NHWC view of NCHW memory and a
    channel slice, any batch, within the reference's tolerances; the
    delta peak exactly; a NaN in a map makes that part's joint and conf
    NaN, as the plain version."""
    make, beta = CASES[case]
    x = make().to(cuda_device)
    before = cuda_kernels.soft_argmax_cuda.launches
    j_k, c_k = cuda_kernels.soft_argmax_cuda(x, beta=beta, stride=8)
    torch.cuda.synchronize()
    assert cuda_kernels.soft_argmax_cuda.launches == before + 1
    j_p, c_p = softargmax.soft_argmax(x, beta=beta, stride=8)
    np.testing.assert_allclose(j_k.cpu().numpy(), j_p.cpu().numpy(), **J_TOL)
    np.testing.assert_allclose(c_k.cpu().numpy(), c_p.cpu().numpy(), **C_TOL)
    if case.startswith("delta"):
        assert j_k[0, 0].tolist() == [33 * 8, 20 * 8]
    if case.startswith("nan"):            # NaN propagates to that part only
        assert torch.isnan(c_k[1, 3]) and torch.isnan(j_k[1, 3]).all()
        assert int(torch.isnan(c_k).sum()) == 1


@pytest.mark.cuda
def test_decode_dispatch_on_cuda(cuda_device):
    """auto and cuda launch the kernel on a CUDA tensor; torch does not;
    the kernel refuses other dtypes and ranks."""
    x = _planted(2).to(cuda_device)
    for impl, launched in (("auto", 1), ("cuda", 1), ("torch", 0)):
        before = cuda_kernels.soft_argmax_cuda.launches
        cpm_lib._decode(x, CPMConfig(decode_impl=impl), 100.0)
        assert cuda_kernels.soft_argmax_cuda.launches == before + launched
    with pytest.raises(TypeError):
        cuda_kernels.soft_argmax_cuda(x.half())
    with pytest.raises(ValueError):
        cuda_kernels.soft_argmax_cuda(x[0])


@pytest.mark.cuda
def test_person_geometry_decodes_with_the_kernel(cuda_device):
    """estimate_person_geometry on stage-1 beliefs launches B1 once (β =
    30) and gives the CPU's centers and extents within 1e-3 px."""
    b1 = _planted(8, 33).contiguous()
    cfg = CPMConfig()
    want = cpm_lib.estimate_person_geometry(b1, cfg)
    before = cuda_kernels.soft_argmax_cuda.launches
    got = cpm_lib.estimate_person_geometry(b1.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert cuda_kernels.soft_argmax_cuda.launches == before + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0,
                                   atol=1e-3)


def _quant_case(case):
    """(input on the CPU, static scale or None) for a B2 kernel case."""
    rng = np.random.RandomState(5)
    if case == "halfway":           # x / s = k + 0.5 exactly: half to even
        k = rng.randint(-120, 120, (2, 46, 46, 32)).astype(np.float32)
        return torch.from_numpy((k + 0.5) * 0.25), torch.tensor(0.25)
    if case == "zeros":             # the 1e-12 floor
        return torch.zeros(2, 46, 46, 48), None
    if case == "odd_count":
        return torch.from_numpy(rng.randn(3, 37, 41, 5).astype(np.float32)
                                * 2), None
    dtype, scale = case.split("_")
    x = torch.from_numpy(rng.randn(4, 92, 92, 128).astype(np.float32) * 2)
    x = x.to(getattr(torch, dtype))
    return x, (torch.tensor(0.05) if scale == "static" else None)


QUANT_CASES = ["float32_dynamic", "float32_static", "bfloat16_dynamic",
               "bfloat16_static", "odd_count", "halfway", "zeros"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", QUANT_CASES)
def test_quantize_act_kernel_matches_plain(cuda_device, case):
    """B2 kernel against its plain version on the same CUDA tensor, bit
    for bit: int8 values and the scale; one quantize launch, plus one
    abs-max launch with a dynamic scale."""
    x, a_scale = _quant_case(case)
    x = x.to(cuda_device)
    a_scale = None if a_scale is None else a_scale.to(cuda_device)
    before = (cuda_kernels.quantize_act_cuda.launches,
              cuda_kernels.act_scale_cuda.launches)
    q_k, s_k = cuda_kernels.quantize_act_cuda(x, a_scale)
    torch.cuda.synchronize()
    assert (cuda_kernels.quantize_act_cuda.launches,
            cuda_kernels.act_scale_cuda.launches) == (
                before[0] + 1, before[1] + (a_scale is None))
    q_p, s_p = quantize.quantize_act(x, a_scale)
    assert q_k.dtype == torch.int8 and q_k.shape == x.shape
    assert torch.equal(q_k, q_p)
    assert s_k.item() == s_p.item()


@pytest.mark.cuda
def test_quantize_act_kernel_layouts_and_errors(cuda_device):
    """A non-contiguous view (an NCHW view of NHWC memory and its
    transpose) and a misaligned offset are quantized as their values;
    other dtypes and a non-scalar scale raise."""
    base = torch.randn(2, 46, 46, 33, device=cuda_device)
    for view in (base.permute(0, 3, 1, 2), base[..., 1:],
                 base.reshape(-1)[3:]):
        q_k, s_k = cuda_kernels.quantize_act_cuda(view)
        q_p, s_p = quantize.quantize_act(view)
        assert torch.equal(q_k, q_p) and s_k.item() == s_p.item()
    with pytest.raises(TypeError):
        cuda_kernels.quantize_act_cuda(base.half())
    with pytest.raises(ValueError):
        cuda_kernels.quantize_act_cuda(base, torch.ones(2, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("k,c,n,hw", [(9, 3, 128, 23), (11, 48, 128, 8),
                                      (1, 128, 15, 6), (1, 128, 15, 2)])
def test_int8_conv_cuda_matches_cpu(cuda_device, k, c, n, hw):
    """im2col + torch._int_mm on the card gives the CPU's int32 sums
    exactly: K padded (9·9·3 = 243 → 248), N padded (15 → 16), and an
    M of 8 (≤ 16) padded inside int8_gemm."""
    rng = np.random.RandomState(k + c)
    q = torch.from_numpy(rng.randint(-127, 128, (2, hw, hw, c)).astype(
        np.int8))
    layer = cpm_lib.QuantizedConv(k, c, n)
    layer.set_weights(torch.from_numpy(
        rng.randint(-127, 128, (k, k, c, n)).astype(np.int8)),
        torch.ones(n), torch.zeros(n))
    outs = [quantize.int8_conv(q.to(dev), layer.w_int8.to(dev).t(), k, n,
                               lambda acc: acc.double(), torch.float64)
            for dev in ("cpu", cuda_device)]
    assert torch.equal(outs[0], outs[1].cpu())


@pytest.mark.cuda
def test_int_mm_rules_on_the_card(cuda_device):
    """What torch._int_mm refuses on the card, and so what int8_gemm pads
    or raises on: M ≤ 16, K or N not a multiple of 8. Either layout of
    the right operand is taken."""
    def mm(m, k, n):
        return torch._int_mm(
            torch.ones(m, k, dtype=torch.int8, device=cuda_device),
            torch.ones(k, n, dtype=torch.int8, device=cuda_device))
    for shape in ((16, 256, 128), (32, 243, 128), (32, 248, 15)):
        with pytest.raises(RuntimeError):
            mm(*shape)
    assert bool((mm(17, 248, 16) == 248).all())
    got = quantize.int8_gemm(
        torch.ones(3, 248, dtype=torch.int8, device=cuda_device),
        torch.ones(16, 248, dtype=torch.int8, device=cuda_device).t())
    assert got.shape == (3, 16) and bool((got == 248).all())


# Every conv input with k > 1 on the int8 path (full width), at batch 2:
# (shape, dtype, k).
IM2COL_SHAPES = {
    "conv1_368x368x3_f32_k9": ((2, 368, 368, 3), torch.float32, 9),
    "trunk_184x184x128_bf16_k9": ((2, 184, 184, 128), torch.bfloat16, 9),
    "trunk_92x92x128_bf16_k9": ((2, 92, 92, 128), torch.bfloat16, 9),
    "conv4_46x46x128_bf16_k5": ((2, 46, 46, 128), torch.bfloat16, 5),
    "conv5_46x46x32_bf16_k9": ((2, 46, 46, 32), torch.bfloat16, 9),
    "mconv1_46x46x48_f32_k11": ((2, 46, 46, 48), torch.float32, 11),
    "mconv2_46x46x128_bf16_k11": ((2, 46, 46, 128), torch.bfloat16, 11),
    "odd_3x7x9x5_f32_k5": ((3, 7, 9, 5), torch.float32, 5),
}


def _im2col_pair(x, scale, k, tile):
    """(kernel rows, plain rows) of one tile, from the same CUDA input;
    the kernel's buffer starts as garbage (torch.empty after filling)."""
    b, h, w, c = x.shape
    m = (tile[1] - tile[0]) * (tile[3] - tile[2]) * w
    k_pad = -(-k * k * c // 8) * 8
    out_k = torch.full((m, k_pad), 99, dtype=torch.int8, device=x.device)
    out_p = torch.empty_like(out_k)
    before = cuda_kernels.quantize_im2col_cuda.launches
    cuda_kernels.quantize_im2col_cuda(x, scale, k, tile, out_k)
    torch.cuda.synchronize()
    assert cuda_kernels.quantize_im2col_cuda.launches == before + 1
    quantize.quantize_im2col(x, scale, k, tile, out_p)
    return out_k, out_p


@pytest.mark.cuda
@pytest.mark.parametrize("scales", ["static", "dynamic"])
@pytest.mark.parametrize("case", sorted(IM2COL_SHAPES))
def test_quantize_im2col_kernel_matches_plain(cuda_device, case, scales):
    """The fused quantize-and-gather against its plain version, bit for
    bit, at every int8-path conv shape (whole-batch tile and a tile of
    rows of one image), with the whole tensor's scale."""
    shape, dtype, k = IM2COL_SHAPES[case]
    g = torch.Generator(device=cuda_device).manual_seed(len(case))
    x = (2.0 * torch.randn(shape, generator=g, device=cuda_device)).to(dtype)
    a_scale = torch.tensor(0.05, device=cuda_device) \
        if scales == "static" else None
    scale = cuda_kernels.act_scale_cuda(x, a_scale)
    assert scale.item() == quantize.act_scale(x, a_scale).item()
    h = shape[1]
    for tile in ((0, shape[0], 0, h), (1, 2, h // 3, h // 3 + 5)):
        out_k, out_p = _im2col_pair(x, scale, k, tile)
        assert torch.equal(out_k, out_p), tile


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(IM2COL_SHAPES))
def test_quantize_im2col_tile_op_matches_in_place(cuda_device, case):
    """The functional form of the gather (the op
    tpu_pose_torch::quantize_im2col_tile, which returns a new buffer: the
    form an exported program's scan bodies call) against the in-place op
    and the plain version, bit for bit, at every int8-path conv shape;
    each call is one launch of the same kernel, counted with the in-place
    op's."""
    shape, dtype, k = IM2COL_SHAPES[case]
    g = torch.Generator(device=cuda_device).manual_seed(len(case) + 1)
    x = (2.0 * torch.randn(shape, generator=g, device=cuda_device)).to(dtype)
    scale = cuda_kernels.act_scale_cuda(x)
    h = shape[1]
    k_pad = -(-k * k * shape[3] // 8) * 8
    for tile in ((0, shape[0], 0, h), (1, 2, h // 3, h // 3 + 5)):
        out_k, out_p = _im2col_pair(x, scale, k, tile)
        before = cuda_kernels.quantize_im2col_cuda.launches
        got = cuda_kernels.quantize_im2col_tile_cuda(x, scale, k, tile,
                                                     k_pad)
        torch.cuda.synchronize()
        assert cuda_kernels.quantize_im2col_cuda.launches == before + 1
        assert got.shape == out_k.shape and got.dtype == torch.int8
        assert torch.equal(got, out_k) and torch.equal(got, out_p), tile


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["strided_view", "halfway_f32",
                                  "halfway_bf16", "zeros", "int8"])
def test_quantize_im2col_kernel_special_inputs(cuda_device, case):
    """A channels-last view with a row stride other than W·C and an
    unaligned start (scalar loads), values half-way between two steps,
    all zeros with the 1e-12 scale, and int8 values gathered as they
    are."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    scale = None
    if case == "strided_view":
        base = torch.randn(2, 23, 25, 40, generator=g, device=cuda_device)
        x = base.bfloat16()[..., 4:36]
    elif case.startswith("halfway"):
        k = torch.randint(-120, 120, (2, 23, 25, 32), generator=g,
                          device=cuda_device).float()
        x = ((k + 0.5) * 0.25).to(getattr(torch, {"f32": "float32",
                                                  "bf16": "bfloat16"}[
                                                      case[8:]]))
        scale = torch.tensor(0.25, device=cuda_device)
    elif case == "zeros":
        x = torch.zeros(2, 23, 25, 48, device=cuda_device)
    else:
        x = torch.randint(-127, 128, (2, 23, 25, 48), generator=g,
                          device=cuda_device).to(torch.int8)
    if x.dtype != torch.int8 and scale is None:
        scale = cuda_kernels.act_scale_cuda(x)
    if case == "zeros":
        assert scale.item() == np.float32(1e-12)
    for tile in ((0, 2, 0, 23), (1, 2, 0, 4), (0, 1, 20, 23)):
        out_k, out_p = _im2col_pair(x, scale, 11 if case == "int8" else 5,
                                    tile)
        assert torch.equal(out_k, out_p), tile


@pytest.mark.cuda
def test_quantize_im2col_wrapper_raises(cuda_device):
    """The wrapper refuses what the kernel does not take, instead of
    copying or falling back: a channel stride other than 1 (NCHW memory),
    float16, a float input without a scale, a wrong buffer, a tile
    outside the tensor."""
    x = torch.randn(2, 9, 9, 16, device=cuda_device)
    s = torch.tensor(0.1, device=cuda_device)
    out = torch.empty(2 * 9 * 9, 400, dtype=torch.int8, device=cuda_device)
    ok = cuda_kernels.quantize_im2col_cuda(x, s, 5, (0, 2, 0, 9), out)
    assert ok is out
    nchw = torch.randn(2, 16, 9, 9, device=cuda_device).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="unit channel stride"):
        cuda_kernels.quantize_im2col_cuda(nchw, s, 5, (0, 2, 0, 9), out)
    with pytest.raises(TypeError):
        cuda_kernels.quantize_im2col_cuda(x.half(), s, 5, (0, 2, 0, 9), out)
    with pytest.raises(ValueError, match="scale"):
        cuda_kernels.quantize_im2col_cuda(x, None, 5, (0, 2, 0, 9), out)
    with pytest.raises(ValueError, match="out must be"):
        cuda_kernels.quantize_im2col_cuda(x, s, 5, (0, 2, 0, 9), out[:, :392])
    with pytest.raises(ValueError, match="does not fit"):
        cuda_kernels.quantize_im2col_cuda(x, s, 5, (0, 3, 0, 9), out)


@pytest.mark.cuda
@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_int8_conv_float_route_cuda_matches_cpu(cuda_device, monkeypatch,
                                                scales):
    """int8_conv on float input with the whole tensor's scale: the card's
    int32 sums equal the CPU's, with one fused gather per tile and no
    standalone quantize."""
    monkeypatch.setattr(quantize, "TILE_BYTES", 23 * 2000)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(3, 23, 23, 48).astype(np.float32))
    layer = cpm_lib.QuantizedConv(11, 48, 16)
    layer.set_weights(torch.from_numpy(
        rng.randint(-127, 128, (11, 11, 48, 16)).astype(np.int8)),
        torch.ones(16), torch.zeros(16))
    tiles = len(list(quantize._tiles(3, 23, 23 * (5808 + 8 * 16))))
    outs = []
    for dev in ("cpu", cuda_device):
        xd = x.to(dev)
        a = None if scales == "dynamic" else torch.tensor(0.02, device=dev)
        before = (cuda_kernels.quantize_im2col_cuda.launches,
                  cuda_kernels.quantize_act_cuda.launches)
        outs.append(quantize.int8_conv(
            xd, layer.w_int8.to(dev).t(), 11, 16, lambda acc: acc.double(),
            torch.float64, cuda_kernels.act_scale_cuda(xd, a)))
        launched = (cuda_kernels.quantize_im2col_cuda.launches - before[0],
                    cuda_kernels.quantize_act_cuda.launches - before[1])
        assert launched == ((tiles, 0) if dev != "cpu" else (0, 0))
    assert tiles > 3
    assert torch.equal(outs[0], outs[1].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("people", [2, 3])
def test_soft_argmax_on_the_multi_person_fold(cuda_device, people):
    """The multi-person decode's input: heatmaps of the B·k hypothesis fold
    (``repeat_interleave`` of NHWC memory, as ``models/cpm._fold`` builds
    the refinement stages' inputs) and a slot-wise ``torch.where`` of two
    such batches (the selective hint-centered crop): the kernel matches
    the plain version, and repeated hypotheses decode identically."""
    hm = _planted(8, 40 + people).contiguous().to(cuda_device)
    folded = hm.repeat_interleave(people, dim=0)
    other = _planted(8 * people, 50).contiguous().to(cuda_device)
    pick = (torch.arange(8 * people, device=cuda_device) % 3) == 1
    mixed = torch.where(pick[:, None, None, None], other, folded)
    for x in (folded, mixed):
        assert x.is_contiguous()
        j_k, c_k = cuda_kernels.soft_argmax_cuda(x, beta=100.0, stride=8)
        torch.cuda.synchronize()
        j_p, c_p = softargmax.soft_argmax(x, beta=100.0, stride=8)
        np.testing.assert_allclose(j_k.cpu().numpy(), j_p.cpu().numpy(),
                                   **J_TOL)
        np.testing.assert_allclose(c_k.cpu().numpy(), c_p.cpu().numpy(),
                                   **C_TOL)
    j_k, _ = cuda_kernels.soft_argmax_cuda(folded, beta=100.0, stride=8)
    assert torch.equal(j_k[0::people], j_k[people - 1::people])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_im2col_on_the_folded_mconv1_input(cuda_device, dtype):
    """The first refinement stage's Mconv1 input on the multi-person path:
    the stage's features at B·k, the stage-1 beliefs folded from B
    (``models/cpm._fold``) and per-hypothesis center hints, concatenated as
    NHWC memory (``_cat_channels``). The gather reads it in place (unit
    channel stride), bit for bit against its plain version on every tile
    ``int8_conv`` cuts."""
    b, k = 4, 2
    g = torch.Generator(device=cuda_device).manual_seed(9)
    feat = torch.randn(b * k, 46, 46, 32, generator=g, device=cuda_device)
    b1 = torch.randn(b, 46, 46, 15, generator=g, device=cuda_device)
    hint = torch.rand(b * k, 1, 46, 46, generator=g, device=cuda_device)
    parts = [feat.to(dtype).permute(0, 3, 1, 2).float(),
             cpm_lib._fold(b1.permute(0, 3, 1, 2), k), hint]
    x = cpm_lib._cat_channels(parts).permute(0, 2, 3, 1)
    assert x.is_contiguous() and x.shape == (b * k, 46, 46, 48)
    scale = cuda_kernels.act_scale_cuda(x)
    n_pad = 128
    for tile in quantize._tiles(b * k, 46, 46 * (11 * 11 * 48 + 8 * n_pad)):
        out_k, out_p = _im2col_pair(x, scale, 11, tile)
        assert torch.equal(out_k, out_p), tile
