"""Port soft-argmax decode vs the JAX package: the plain PyTorch version
against ``tpu_pose.ops.softargmax`` and against the Pallas kernel in
interpret mode, on tests/test_pallas.py's cases. The CUDA kernel is held
against this plain version in tests/test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pose.ops import pallas_kernels, softargmax as jax_sa
from tpu_pose_torch.ops import softargmax as torch_sa
from torch_threads import one_thread

one_thread()

# The reference's own Pallas-vs-XLA tolerances (tests/test_pallas.py):
# float32 sums over 2116 cells taken in another order.
J_TOL = dict(rtol=1e-5, atol=1e-4)
C_TOL = dict(rtol=1e-6, atol=1e-6)


def _planted(batch):
    rng = np.random.RandomState(0)
    hm = rng.rand(batch, 46, 46, 15).astype(np.float32)
    for b in range(batch):
        for j in range(14):
            hm[b, (7 * b + j) % 46, (3 * j + 5) % 46, j] = 3.0
    return hm


def _delta():
    hm = np.zeros((1, 46, 46, 15), np.float32)
    hm[0, 20, 33, 0] = 10.0
    return hm


CASES = {"planted3": (_planted(3), 50.0), "planted3_b100": (_planted(3), 100.0),
         "odd_batch1": (_planted(3)[:1], 50.0), "delta": (_delta(), 100.0)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_soft_argmax_matches_jax_and_pallas(case):
    hm, beta = CASES[case]
    j_t, c_t = torch_sa.soft_argmax(torch.from_numpy(hm), beta=beta, stride=8)
    j_x, c_x = jax_sa.soft_argmax(jnp.asarray(hm), beta=beta, stride=8)
    j_p, c_p = pallas_kernels.soft_argmax_pallas(
        jnp.asarray(hm), beta=beta, stride=8, interpret=True)
    for j_ref, c_ref in ((j_x, c_x), (j_p, c_p)):
        np.testing.assert_allclose(j_t.numpy(), np.asarray(j_ref), **J_TOL)
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_ref), **C_TOL)
    if case == "delta":
        # Golden value: a delta peak decodes to its exact cell corner.
        np.testing.assert_allclose(j_t.numpy()[0, 0], [33 * 8, 20 * 8],
                                   atol=1e-3)
        assert c_t.numpy()[0, 0] == 10.0


def test_hard_argmax_matches_jax():
    hm = _planted(3)
    j_t, c_t = torch_sa.hard_argmax(torch.from_numpy(hm), stride=8)
    j_x, c_x = jax_sa.hard_argmax(jnp.asarray(hm), stride=8)
    np.testing.assert_array_equal(j_t.numpy(), np.asarray(j_x))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_x))
