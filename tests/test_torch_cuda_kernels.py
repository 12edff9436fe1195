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

torch.set_num_threads(2)

# The reference's own Pallas-vs-XLA tolerances (tests/test_pallas.py):
# float32 sums over 2116 cells taken in another order.
J_TOL = dict(rtol=1e-5, atol=1e-4)
C_TOL = dict(rtol=1e-6, atol=1e-6)


def _planted(batch, seed=0):
    """(B, 46, 46, 15) NHWC view of NCHW memory (the CPM's output layout)
    with one planted peak per part."""
    rng = np.random.RandomState(seed)
    hm = rng.rand(batch, 15, 46, 46).astype(np.float32)
    for b in range(batch):
        for j in range(14):
            hm[b, j, (7 * b + j) % 46, (3 * j + 5) % 46] = 3.0
    return torch.from_numpy(hm).permute(0, 2, 3, 1)


def _delta():
    hm = torch.zeros(1, 46, 46, 15)
    hm[0, 20, 33, 0] = 10.0
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
    """On a CPU tensor the B2 wrapper is the plain quantizer, static or
    dynamic, float32 or bf16, and counts no launch."""
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 5, 7, 9)
                         .astype(np.float32))
    before = (cuda_kernels.quantize_act_cuda.launches,
              cuda_kernels.quantize_act_cuda.absmax_launches)
    for t in (x, x.bfloat16()):
        for a_scale in (None, torch.tensor(0.03)):
            q_w, s_w = cuda_kernels.quantize_act_cuda(t, a_scale)
            q_p, s_p = quantize.quantize_act(t, a_scale)
            assert torch.equal(q_w, q_p) and torch.equal(s_w, s_p)
    assert (cuda_kernels.quantize_act_cuda.launches,
            cuda_kernels.quantize_act_cuda.absmax_launches) == before


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
         "delta": (_delta, 100.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_soft_argmax_kernel_matches_plain(cuda_device, case):
    make, beta = CASES[case]
    x = make().to(cuda_device)
    before = cuda_kernels.soft_argmax_cuda.launches
    j_k, c_k = cuda_kernels.soft_argmax_cuda(x, beta=beta, stride=8)
    torch.cuda.synchronize()
    assert cuda_kernels.soft_argmax_cuda.launches == before + 1
    j_p, c_p = softargmax.soft_argmax(x, beta=beta, stride=8)
    np.testing.assert_allclose(j_k.cpu().numpy(), j_p.cpu().numpy(), **J_TOL)
    np.testing.assert_allclose(c_k.cpu().numpy(), c_p.cpu().numpy(), **C_TOL)
    if case == "delta":
        np.testing.assert_allclose(j_k.cpu().numpy()[0, 0],
                                   [33 * 8, 20 * 8], atol=1e-3)


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
              cuda_kernels.quantize_act_cuda.absmax_launches)
    q_k, s_k = cuda_kernels.quantize_act_cuda(x, a_scale)
    torch.cuda.synchronize()
    assert (cuda_kernels.quantize_act_cuda.launches,
            cuda_kernels.quantize_act_cuda.absmax_launches) == (
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
