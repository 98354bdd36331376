"""The port's linear-recurrence scan plain version (the CPU dispatch of
`repro_torch.kernels.rglru_scan.ops.rglru_scan`, and the oracle the CUDA
kernel is held to bitwise on the card) against the JAX package's
`rglru_scan_ref` and its Pallas kernel in interpret mode, on the same
numpy inputs.

Tolerances: 1e-5 in f32 (XLA may contract a*h + b into an FMA, the port
rounds the product); in bf16 inputs (cast to f32 by both) the
reference's own 2e-2 (tests/test_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan import rglru_scan as jscan
from repro.kernels.rglru_scan import rglru_scan_ref as jscan_ref
from repro_torch.bridge import array_to_tensor
from repro_torch.kernels.rglru_scan import ops, ref

DTYPES = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, B, S, D, dtype):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (B, S, D)).astype(np.float32)
    b = (0.1 * rng.standard_normal((B, S, D))).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    j = [jnp.asarray(x, dtype) for x in (h0, a, b)]
    return j, [array_to_tensor(np.asarray(x)) for x in j]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,D", [(2, 256, 128), (1, 100, 128),
                                   (3, 37, 256), (1, 7, 128), (2, 1, 64)])
def test_plain_matches_jax(B, S, D, dtype):
    (jh0, ja, jb), (h0, a, b) = _inputs(B * S + D, B, S, D, dtype)
    want = np.asarray(jscan_ref(jh0, ja, jb))
    states, final = ops.rglru_scan(h0, a, b)
    assert states.dtype == final.dtype == torch.float32
    tol = DTYPES[dtype]
    np.testing.assert_allclose(states.numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(final.numpy(), want[:, -1], atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,D", [(2, 256, 128), (1, 100, 128)])
def test_plain_matches_pallas_interpret(B, S, D, dtype):
    (jh0, ja, jb), (h0, a, b) = _inputs(B + S + D, B, S, D, dtype)
    want, want_final = jscan(jh0, ja, jb, interpret=True)
    states, final = ops.rglru_scan(h0, a, b)
    tol = DTYPES[dtype]
    np.testing.assert_allclose(states.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(final.numpy(), np.asarray(want_final),
                               atol=tol, rtol=tol)


def test_plain_is_the_sequential_rounding():
    """Each step is a rounded multiply, then a rounded add (the rule the
    CUDA kernel follows with __fmul_rn / __fadd_rn)."""
    (_, _, _), (h0, a, b) = _inputs(3, 2, 50, 64, "float32")
    got = ref.rglru_scan_ref(h0, a, b).numpy()
    h = h0.numpy().astype(np.float32)
    for t in range(50):
        h = (a.numpy()[:, t] * h).astype(np.float32) + b.numpy()[:, t]
        np.testing.assert_array_equal(got[:, t], h)


def test_final_state_is_a_copy_and_gradient_raises():
    (_, _, _), (h0, a, b) = _inputs(4, 1, 9, 64, "float32")
    states, final = ops.rglru_scan(h0, a, b)
    assert final.data_ptr() != states[:, -1].data_ptr()
    torch.testing.assert_close(final, states[:, -1], rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.rglru_scan(h0, a.requires_grad_(), b)
