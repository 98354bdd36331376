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


# -- the kernel's launch plan (kernels/rglru_scan/ops.py `_plan`) and a
# plain emulation of the staged, TMA-fed kernel that walks it ---------------

# (B, S, D): the RecurrentGemma-9B prefill, the ragged chip cases, and the
# reduced config's width
PLAN_SHAPES = [(4, 4096, 4096), (3, 1000, 1000), (2, 1, 128),
               (1, 4097, 4096), (2, 96, 128)]


def _lanes(plan, cta, D):
    """The channels CTA (x, y) scans in batch y: csrc/rglru_scan.cu's
    d0 = blockIdx.x * kTile, clipped to D by the TMA box."""
    return range(cta[0] * plan.tile, min(D, (cta[0] + 1) * plan.tile))


def _steps(plan, S):
    """The stages a CTA walks: the kernel's nk = ceil(S / kStageRows)."""
    return -(-S // plan.stage_rows)


@pytest.mark.parametrize("B,S,D", PLAN_SHAPES)
def test_plan_owns_every_lane_once(B, S, D):
    plan = ops._plan(B, S, D)
    owners = np.zeros((B, D), dtype=int)
    for y in range(plan.grid[1]):
        for x in range(plan.grid[0]):
            lanes = _lanes(plan, (x, y), D)
            assert len(lanes) > 0
            owners[y, lanes.start:lanes.stop] += 1
    assert (owners == 1).all()
    # the stages cover the sequence, the last one partly
    steps = _steps(plan, S)
    assert (steps - 1) * plan.stage_rows < S <= steps * plan.stage_rows


@pytest.mark.parametrize("B,S,D", PLAN_SHAPES)
def test_plan_within_the_cards_limits(B, S, D):
    plan = ops._plan(B, S, D)
    assert plan.smem + ops.STATIC_SMEM <= ops.SMEM_MAX == 232_448
    assert plan.tile <= ops.BOX_MAX and plan.stage_rows <= ops.BOX_MAX
    assert plan.threads == plan.tile + 32 and plan.threads % 32 == 0
    assert plan.grid == (-(-D // plan.tile), B)
    # the input ring, the output stages and the alignment slack
    stage = plan.stage_rows * plan.tile * 4
    assert plan.smem == (2 * plan.stages + ops.OUT_STAGES) * stage + 1024
    if (B, D) == (4, 4096):
        assert plan.grid == (32, 4)        # 128 CTAs: one an SM


@pytest.mark.parametrize("shape,match", [
    ((2, 64, 130), "multiple of 4"),
    ((2, 0, 128), "empty"),
    ((0, 64, 128), "empty"),
    ((70000, 64, 128), "65535"),
])
def test_plan_rejects_what_the_kernel_does_not_take(shape, match):
    with pytest.raises(ValueError, match=match):
        ops._plan(*shape)


def _emulate_scan(plan, h0, a, b):
    """The kernel's staged walk in plain PyTorch: each CTA loads boxes of
    (stage_rows, tile) with zeros past S and D, carries h per lane across
    the stages (a rounded multiply, then a rounded add), and stores each
    output box clipped to the tensor. Returns (states, h after the last
    stage)."""
    B, S, D = a.shape
    T, R = plan.tile, plan.stage_rows
    out = torch.full((B, S, D), float("nan"))
    after = torch.full((B, D), float("nan"))
    for y in range(plan.grid[1]):
        for x in range(plan.grid[0]):
            lanes = _lanes(plan, (x, y), D)
            cols = slice(lanes.start, lanes.stop)
            n = len(lanes)
            h = torch.zeros(T)
            h[:n] = h0[y, cols]
            for k in range(_steps(plan, S)):
                rows = slice(k * R, min(S, (k + 1) * R))
                m = rows.stop - rows.start
                box_a, box_b = torch.zeros(R, T), torch.zeros(R, T)
                box_a[:m, :n], box_b[:m, :n] = a[y, rows, cols], b[y, rows,
                                                                    cols]
                stage = torch.empty(R, T)
                for t in range(R):
                    h = box_a[t] * h + box_b[t]
                    stage[t] = h
                out[y, rows, cols] = stage[:m, :n]
            after[y, cols] = h[:n]
    return out, after


@pytest.mark.parametrize("B,S,D", [(3, 100, 260), (2, 1, 128), (1, 65, 64),
                                   (2, 64, 256), (1, 33, 4), (2, 200, 132)])
def test_staged_emulation_is_bitwise_the_plain_scan(B, S, D):
    (_, _, _), (h0, a, b) = _inputs(S + D, B, S, D, "float32")
    plan = ops._plan(B, S, D)
    got, after = _emulate_scan(plan, h0, a, b)
    want = ref.rglru_scan_ref(h0, a, b)
    assert torch.equal(got, want)
    states, final = ops.rglru_scan(h0, a, b)
    assert torch.equal(final, got[:, S - 1])
    if S % plan.stage_rows:
        # past S the zero-filled steps drive h to 0: the final state is
        # the states' row S - 1, not h after the last stage
        assert (after == 0).all() and not torch.equal(after, final)
    else:
        assert torch.equal(after, final)
