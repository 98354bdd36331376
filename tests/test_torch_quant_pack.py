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
    """Meta tensors get the operator's shape rule (no launch); the
    kernel's launch itself takes CUDA tensors only."""
    x = torch.zeros((1, 256, 128), device="meta")
    seeds = torch.zeros(1, dtype=torch.int32, device="meta")
    packed, scales = ops.quant_pack_2d(x, seeds, bits=4)
    assert packed.shape == (1, 128, 128) and packed.dtype == torch.uint8
    assert scales.shape == (1, 1) and scales.device.type == "meta"
    with pytest.raises(ValueError):
        ops._launch_quant_pack(x, None, seeds, 8, "quant_pack")


# -- the quantize-pack launch plan (kernels/quant_pack/ops.py `_plan`: a
# tile split over a cluster of 8 CTAs) and a plain emulation of the kernel
# that walks it. Which rows a CTA owns is decided in the kernel alone, by
# `vec_index` in csrc/quant_pack.cu; `_vec_index` below transcribes it, so
# these tests check the split as written there, and chip_smoke.py checks
# the compiled kernel's bits on the card. ----------------------------------

# (C, rows): the downlink, the uplink, the large leaf, a reduced fleet
PLAN_SHAPES = [(1, 256), (50, 256), (50, 8192), (4, 512)]
THREADS, VECS = 256, 4          # the kernel's kThreads and kVecs


def _vec_index(bits, k, j, t):
    """csrc/quant_pack.cu `vec_index`: the float4 index within the tile
    of vector j of thread t in cluster rank k."""
    row_vecs = 128 // 4
    if bits == 8:
        return (k * 32 + j * 8) * row_vecs + t
    return ((j & 1) * 8 + k * 16 + (j >> 1) * 128) * row_vecs + t


def _cta_vecs(bits, k):
    """(VECS, THREADS) float4 indices CTA rank k loads, in the kernel's
    order: under int4, vectors j and j + 2 share their output bytes."""
    return torch.tensor([[_vec_index(bits, k, j, t) for t in range(THREADS)]
                         for j in range(VECS)])


def _cta(plan, x, y):
    """(worker, tile within its leaf, cluster rank) of CTA (x, y): the
    kernel's blockIdx.y, blockIdx.x / kCluster, blockIdx.x % kCluster."""
    return y, x // plan.cluster, x % plan.cluster


@pytest.mark.parametrize("bits", [8, 4])
def test_plan_rows_partition_the_tile(bits):
    plan = ops._plan(1, 256, bits)
    vecs = [_cta_vecs(bits, k) for k in range(plan.cluster)]
    flat = torch.cat([v.flatten() for v in vecs])
    assert torch.equal(flat.sort().values, torch.arange(256 * 128 // 4))
    for v in vecs:
        rows = set((v.flatten() // 32).tolist())
        assert len(rows) == plan.cta_rows == 32
        # every thread holds 16 elements: 4 float4 vectors
        assert plan.cta_rows * 128 == THREADS * VECS * 4
        if bits == 4:
            # both nibbles of every output byte (rows r and r + 128) in
            # one CTA, and in one thread: vector j and vector j + 2
            assert torch.equal(v[2:], v[:2] + 128 * 32)
            low = {r for r in rows if r < 128}
            assert {r + 128 for r in low} == rows - low
            assert len(low) == 16


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("C,rows", PLAN_SHAPES)
def test_plan_grid_covers_every_tile_once(C, rows, bits):
    plan = ops._plan(C, rows, bits)
    assert plan.grid == (8 * rows // 256, C)
    assert plan.cluster == 8 and plan.cta_rows == 32
    seen = {}
    for y in range(plan.grid[1]):
        for x in range(plan.grid[0]):
            key = _cta(plan, x, y)
            seen[key] = seen.get(key, 0) + 1
    assert len(seen) == C * (rows // 256) * 8
    assert set(seen.values()) == {1}


@pytest.mark.parametrize("args,match", [
    ((1, 100, 8), "multiple of 256"),
    ((1, 0, 8), "multiple of 256"),
    ((1, 256, 3), "bits"),
    ((70000, 256, 8), "65535"),
])
def test_plan_rejects_what_the_kernel_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        ops._plan(*args)


def _emulate_quant_pack(plan, bits, x, residual, seeds):
    """The kernel's cluster walk in plain PyTorch: each CTA loads its
    float4 vectors (`_vec_index`) and reduces |acc| over them, the cluster
    takes the max of the 8 CTA maxima, and each CTA quantizes, packs and
    (under EF) forms the residual of its own vectors. Returns what
    quant_pack_ref / quant_pack_ef_ref return, and the per-CTA maxima."""
    C, rows, _ = x.shape
    qmax = ref.QMAX[bits]
    inv = torch.tensor(np.float32(1.0 / qmax))
    prow = rows if bits == 8 else rows // 2
    packed = torch.zeros((C, prow, 128),
                         dtype=torch.int8 if bits == 8 else torch.uint8)
    scales = torch.zeros((C, rows // 256))
    res = None if residual is None else torch.zeros_like(x)
    cta_max = torch.zeros((C, rows // 256, plan.cluster))
    for y in range(plan.grid[1]):
        for x_ in range(0, plan.grid[0], plan.cluster):
            _, tile, _ = _cta(plan, x_, y)
            sl = slice(tile * 256, (tile + 1) * 256)
            acc = x[y, sl] if residual is None else x[y, sl] + residual[y, sl]
            acc4 = acc.reshape(-1, 4)
            vecs = [_cta_vecs(bits, k) for k in range(plan.cluster)]
            for k, v in enumerate(vecs):
                cta_max[y, tile, k] = acc4[v].abs().max()
            amax = cta_max[y, tile].max()
            scale = amax * inv if amax > 0 else torch.tensor(1.0)
            scales[y, tile] = scale                 # rank 0 writes it
            u4 = ref.block_uniform(seeds[y:y + 1], tile)[0].reshape(-1, 4)
            p4 = packed[y].reshape(-1, 4)
            r4 = None if res is None else res[y, sl].reshape(-1, 4)
            for v in vecs:
                q = torch.floor(acc4[v] / scale + u4[v]).clamp(-qmax, qmax)
                off = tile * 256 * 32 if bits == 8 else tile * 128 * 32
                if bits == 8:
                    p4[off + v] = q.to(torch.int8)
                else:                     # vector j low, j + 2 high
                    byte = ((q[:2] + 8).to(torch.int32)
                            | ((q[2:] + 8).to(torch.int32) << 4))
                    p4[off + v[:2]] = byte.to(torch.uint8)
                if r4 is not None:
                    r4[v] = (acc4[v].double()
                             - q.double() * scale.double()).float()
    out = (packed, scales) if res is None else (packed, scales, res)
    return out, cta_max


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("C,rows", [(1, 256), (3, 512)])
def test_cluster_emulation_is_bitwise_the_plain_version(C, rows, bits, ef):
    x = _x(30 + bits + C, C, rows, 0.01)
    r = _x(40 + bits + C, C, rows, 0.001)
    if C > 1:
        x[0, :256] = 0.0                           # acc is only residual
        x[1, :256], r[1, :256] = 0.0, 0.0          # an all-zero tile
    seeds = torch.from_numpy(_seeds(rows + bits, C))
    tx, tr = torch.from_numpy(x), torch.from_numpy(r)
    plan = ops._plan(C, rows, bits)
    got, cta_max = _emulate_quant_pack(plan, bits, tx, tr if ef else None,
                                       seeds)
    want = (ref.quant_pack_ef_ref(tx, tr, seeds, bits=bits) if ef
            else ref.quant_pack_ref(tx, seeds, bits=bits))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the cluster's max is what the scale needs: a CTA's own max alone
    # would give another scale in most tiles
    nonzero = cta_max.amax(-1) > 0
    assert bool((cta_max.amin(-1) < cta_max.amax(-1))[nonzero].any())


# -- the decode's launch plan (kernels/quant_pack/ops.py `_dequant_plan`,
# csrc/quant_pack.cu dequant_kernel): a 2D grid of (parts x tiles, C)
# CTAs of 8 warps; warp w of part p of a tile takes the 512-byte
# payload chunk p * 8 + w, a 16-byte vector a lane, and
# after the exchange through shared memory lane l stores the values of
# the chunk's words l, l + 32, l + 64, l + 96 (int4: low nibbles to row
# r, high to row r + 128)

def _dequant_words(plan, rows):
    """(worker, tile, first byte within the tile) of every 4-byte word a
    lane stores, over the whole grid, as the kernel indexes them."""
    x = torch.arange(plan.grid[0])[:, None, None, None, None]
    y = torch.arange(plan.grid[1])[None, :, None, None, None]
    warp = torch.arange(plan.threads // 32)[None, None, :, None, None]
    i = torch.arange(4)[None, None, None, :, None]
    lane = torch.arange(32)[None, None, None, None, :]
    tile, part = x // plan.parts, x % plan.parts
    chunk = part * (plan.threads // 32) + warp
    b = chunk * 512 + 128 * i + 4 * lane
    full = torch.broadcast_tensors(y, tile, b)
    return [t.reshape(-1) for t in full]


def _emulate_dequant(plan, packed, scales, bits):
    C, prow, _ = packed.shape
    rows = prow * (2 if bits == 4 else 1)
    y, tile, b = _dequant_words(plan, rows)
    tile_bytes = 256 * 128 // (8 // bits)
    j = torch.arange(4)
    src = packed.view(torch.uint8).reshape(C, -1)[
        y[:, None], tile[:, None] * tile_bytes + b[:, None] + j]
    sc = scales[y, tile][:, None]
    out = torch.full((C, rows // 256, 256 * 128), float("nan"))
    if bits == 8:
        out[y[:, None], tile[:, None], b[:, None] + j] = \
            src.view(torch.int8).float() * sc
    else:
        first = ((b >> 7) * 128 + (b & 127))[:, None] + j
        v = src.to(torch.int32)
        out[y[:, None], tile[:, None], first] = ((v & 0xF) - 8).float() * sc
        out[y[:, None], tile[:, None], first + 128 * 128] = \
            ((v >> 4) - 8).float() * sc
    return out.reshape(C, rows, 128)


@pytest.mark.parametrize("C,rows", [(1, 256), (50, 256), (65, 512),
                                    (300, 256), (2, 8192)])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_emulation_is_bitwise_the_plain_version(C, rows, bits):
    rng = np.random.default_rng(C + rows + bits)
    x = torch.from_numpy((0.05 * rng.standard_normal((C, rows, 128)))
                         .astype(np.float32))
    seeds = torch.from_numpy(rng.integers(0, 2**31 - 1, C, dtype=np.int32))
    packed, scales = ref.quant_pack_ref(x, seeds, bits=bits)
    got = _emulate_dequant(ops._dequant_plan(C, rows, bits), packed, scales,
                           bits)
    assert torch.equal(got, ref.dequant_unpack_ref(packed, scales,
                                                   bits=bits))


@pytest.mark.parametrize("C,rows", [(1, 256), (50, 256), (300, 256),
                                    (50, 8192), (3, 65536)])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_plan_covers_every_output_once(C, rows, bits):
    plan = ops._dequant_plan(C, rows, bits)
    assert plan.threads == ops.DQ_THREADS
    assert plan.grid == (plan.parts * rows // 256, C)
    tile_bytes = 256 * 128 // (8 // bits)
    # the parts of a tile and their warps cover its 512-byte chunks
    assert plan.parts * (plan.threads // 32) * 512 == tile_bytes
    y, tile, b = _dequant_words(plan, rows)
    word = (y * (rows // 256) + tile) * (tile_bytes // 4) + b // 4
    n = C * rows // 256 * tile_bytes // 4
    assert torch.equal(torch.bincount(word, minlength=n),
                       torch.ones(n, dtype=torch.int64))
