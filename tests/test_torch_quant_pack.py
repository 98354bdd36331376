"""The port's quantize-pack plain versions against the JAX refs.

Tolerances: payloads and scales are bitwise; the error-feedback residual
is within 1 ulp of |acc| (the JAX ref's multiply-subtract is FMA-
contracted by XLA, the port rounds acc - q*scale once from f64).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_pack import quant_pack as jqp
from repro.kernels.quant_pack import ops as jops
from repro.kernels.quant_pack import ref as jref
from repro_torch.kernels.quant_pack import ops, ref


def _x(seed, C, rows, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((C, rows, 128))).astype(np.float32)


def _seeds(seed, C):
    rng = np.random.default_rng(seed + 1000)
    return rng.integers(0, np.iinfo(np.int32).max, size=C, dtype=np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**31 - 2, 123456789])
@pytest.mark.parametrize("block", [0, 1, 7, 1000, 2**20 + 3])
def test_block_uniform_bitwise(seed, block):
    want = np.asarray(jqp.block_uniform(jnp.int32(seed), jnp.int32(block),
                                        (256, 128)))
    got = ref.block_uniform(torch.tensor([seed], dtype=torch.int32),
                            block)[0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("C,rows", [(1, 256), (3, 512), (5, 768)])
def test_quant_pack_bitwise(bits, C, rows):
    x = _x(bits + C, C, rows)
    seeds = _seeds(rows, C)
    p, s = ref.quant_pack_ref(torch.from_numpy(x), torch.from_numpy(seeds),
                              bits=bits)
    for c in range(C):
        jp, js = jref.quant_pack_ref(jnp.asarray(x[c]), jnp.int32(seeds[c]),
                                     bits=bits)
        np.testing.assert_array_equal(p[c].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(s[c].numpy(), np.asarray(js))


def _ulp_ok(got, want, acc):
    ulp = np.spacing(np.abs(acc).astype(np.float32))
    assert np.all(np.abs(got.astype(np.float64) - want) <= ulp), \
        np.max(np.abs(got - want) / ulp)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("C,rows", [(1, 256), (4, 512)])
def test_quant_pack_ef_against_jax(bits, C, rows):
    x = _x(10 + bits, C, rows, 0.01)
    r = _x(20 + bits, C, rows, 0.001)
    x[0, :256] = 0.0           # a block whose acc is only residual
    if C > 1:
        x[1, :256], r[1, :256] = 0.0, 0.0   # an all-zero block: scale 1
    seeds = _seeds(bits, C)
    p, s, res = ref.quant_pack_ef_ref(torch.from_numpy(x),
                                      torch.from_numpy(r),
                                      torch.from_numpy(seeds), bits=bits)
    for c in range(C):
        jp, js, jres = jref.quant_pack_ef_ref(
            jnp.asarray(x[c]), jnp.asarray(r[c]), jnp.int32(seeds[c]),
            bits=bits)
        np.testing.assert_array_equal(p[c].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(s[c].numpy(), np.asarray(js))
        _ulp_ok(res[c].numpy(), np.asarray(jres), x[c] + r[c])


@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_unpack_bitwise(bits):
    C, rows = 3, 512
    x = _x(bits, C, rows)
    seeds = _seeds(7, C)
    p, s = ref.quant_pack_ref(torch.from_numpy(x), torch.from_numpy(seeds),
                              bits=bits)
    out = ref.dequant_unpack_ref(p, s, bits=bits)
    for c in range(C):
        want = jref.dequant_unpack_ref(jnp.asarray(p[c].numpy()),
                                       jnp.asarray(s[c].numpy()), bits=bits)
        np.testing.assert_array_equal(out[c].numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(3, 3, 1, 8), (10,), (784, 32),
                                   (300, 300)])
def test_ops_padding_on_leaf_shapes(bits, shape):
    """Leaf-level wrappers pad each worker's leaf to whole blocks and
    unpad on the way out, exactly like the JAX ops."""
    C = 3
    rng = np.random.default_rng(len(shape) + bits)
    x = (0.05 * rng.standard_normal((C,) + shape)).astype(np.float32)
    r = (0.005 * rng.standard_normal((C,) + shape)).astype(np.float32)
    seeds = _seeds(bits, C)
    tx, tr, ts = map(torch.from_numpy, (x, r, seeds))
    p, s, res = ops.quantize_pack_ef(tx, tr, ts, bits=bits)
    qd = ops.quant_dequant(tx, ts, bits=bits)
    assert res.shape == (C,) + shape and qd.shape == (C,) + shape
    for c in range(C):
        jp, js, jres = jops.quantize_pack_ef(jnp.asarray(x[c]),
                                             jnp.asarray(r[c]),
                                             jnp.int32(seeds[c]), bits=bits,
                                             interpret=True)
        np.testing.assert_array_equal(p[c].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(s[c].numpy(), np.asarray(js))
        _ulp_ok(res[c].numpy(), np.asarray(jres), x[c] + r[c])
        jqd = jops.quant_dequant(jnp.asarray(x[c]), jnp.int32(seeds[c]),
                                 bits=bits, interpret=True)
        np.testing.assert_array_equal(qd[c].numpy(), np.asarray(jqd))
    # the decode of the payload is what the residual left out
    back = ops.dequantize_unpack(p, s, shape, bits=bits)
    assert torch.allclose(back, tx + tr - res, atol=1e-6)


def test_wrapper_rejects_other_devices():
    x = torch.zeros((1, 256, 128), device="meta")
    with pytest.raises(ValueError):
        ops.quant_pack_2d(x, torch.zeros(1, dtype=torch.int32, device="meta"))
