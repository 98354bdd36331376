"""The port's wire_agg plain version against the JAX ref.

Tolerances: `median` is bitwise. `mean`, `sum` and `trimmed_mean` sum in
a fixed order in the port (worker order; sorted order) where XLA picks
its own reduction order, so they agree to SUM_RTOL * sum|terms| — a
few f32 roundings over at most C terms.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wire_agg import ops as jops
from repro.kernels.wire_agg import ref as jref
from repro_torch.kernels.quant_pack import ref as qref
from repro_torch.kernels.wire_agg import ops, ref

SUM_RTOL = 2.0 ** -21          # 8 ulp of f32 relative to sum|terms|


def _fleet(C, bits, rows=256, seed=0, lost=None):
    rng = np.random.default_rng(seed + C + bits)
    x = (0.02 * rng.standard_normal((C, rows, 128))).astype(np.float32)
    x *= rng.uniform(0.5, 2.0, size=(C, 1, 1)).astype(np.float32)
    seeds = rng.integers(0, 2**31 - 1, size=C, dtype=np.int32)
    packed, scales = qref.quant_pack_ref(torch.from_numpy(x),
                                         torch.from_numpy(seeds), bits=bits)
    mask = (rng.uniform(size=C) > 0.3).astype(np.float32)
    if lost == "all":
        mask[:] = 0.0
    elif lost == "none":
        mask[:] = 1.0
    weights = rng.uniform(0.2, 1.5, size=C).astype(np.float32)
    return packed, scales, mask, weights


def _bound(packed, scales, weights, bits):
    d = qref.dequant_unpack_ref(packed, scales, bits=bits).numpy()
    return SUM_RTOL * (np.abs(d) * np.abs(weights)[:, None, None]).sum(0)


_CASES = ([(C, "some") for C in (1, 7, 50, 70)]
          + [(50, "none"), (7, "all")])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("C,lost", _CASES)
@pytest.mark.parametrize("agg", ["mean", "sum", "median", "trimmed_mean"])
def test_against_jax_ref(bits, C, lost, agg):
    packed, scales, mask, weights = _fleet(C, bits, lost=lost)
    got = ref.wire_agg_ref(packed, scales, torch.from_numpy(mask),
                           torch.from_numpy(weights), bits=bits,
                           aggregator=agg, trim_ratio=0.2).numpy()
    want = np.asarray(jref.wire_agg_ref(
        jnp.asarray(packed.numpy()), jnp.asarray(scales.numpy()),
        jnp.asarray(mask[:, None]), jnp.asarray(weights[:, None]),
        bits=bits, aggregator=agg, trim_ratio=0.2))
    if agg == "median" or lost == "all":
        np.testing.assert_array_equal(got, want)
        return
    tol = _bound(packed, scales, weights, bits)
    if agg == "mean":
        tol = tol / max(float((mask * weights).sum()), 1.0)
    assert np.all(np.abs(got - want) <= tol + 1e-30), \
        np.max(np.abs(got - want) - tol)


@pytest.mark.parametrize("C", [50, 70])
@pytest.mark.parametrize("bits", [8, 4])
def test_wire_aggregate_leaf_against_jax_ops(C, bits):
    """Leaf level, unit weights (the engine route). At C = 70 the JAX ops
    take the two-stage tree mean (chunks of 64); the port's single pass
    differs from it only in summation order."""
    packed, scales, mask, _ = _fleet(C, bits, seed=3)
    shape = (784, 32)
    got = ops.wire_aggregate(packed, scales, torch.from_numpy(mask),
                             shape=shape, bits=bits).numpy()
    want = np.asarray(jops.wire_aggregate(
        jnp.asarray(packed.numpy()), jnp.asarray(scales.numpy()),
        jnp.asarray(mask), shape=shape, bits=bits, interpret=True))
    assert got.shape == shape
    tol = (_bound(packed, scales, np.ones(C, np.float32), bits)
           .reshape(-1)[:784 * 32].reshape(shape)
           / max(float(mask.sum()), 1.0))
    assert np.all(np.abs(got - want) <= tol)


def test_robust_modes_equal_on_duplicates():
    """Ties among equal values: any sort meets the contract."""
    C, bits = 9, 8
    packed, scales, mask, weights = _fleet(C, bits, lost="none")
    packed = packed[:1].repeat(C, 1, 1)
    scales = scales[:1].repeat(C, 1)
    for agg in ("median", "trimmed_mean"):
        got = ref.wire_agg_ref(packed, scales, torch.from_numpy(mask),
                               torch.ones(C), bits=bits, aggregator=agg)
        one = qref.dequant_unpack_ref(packed[:1], scales[:1], bits=bits)[0]
        assert torch.allclose(got, one, rtol=1e-6, atol=0)
