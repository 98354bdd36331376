"""The port's linear-recurrence scan plain version (the CPU dispatch of
`repro_torch.kernels.rglru_scan.ops.rglru_scan`, and the oracle the CUDA
kernel is held to bitwise on the card) against the JAX package's
`rglru_scan_ref` and its Pallas kernel in interpret mode, on the same
numpy inputs; then the scan's backward (`rglru_scan_bwd_ref`, the
oracle of csrc/rglru_scan_bwd.cu) against autograd of the plain loop and
`jax.grad` of the reference's scans, its launch plan and a plain
emulation of the kernel's reverse staged walk.

Tolerances: 1e-5 in f32 (XLA may contract a*h + b into an FMA, the port
rounds the product); in bf16 inputs (cast to f32 by both) the
reference's own 2e-2 (tests/test_kernels.py). The backward: bitwise
against autograd of the plain loop (the same rounded products and sums
in the same order); against `jax.grad`, 1e-5 of the largest |gradient|
(XLA may contract into FMAs, and the associative scan's gradient sums in
a tree order).
"""
import jax
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
    """The final state is a copy of the states' last row, and a gradient
    flows through both (the scan once raised under grad): the final
    state's gradient reaches the backward through the states."""
    (_, _, _), (h0, a, b) = _inputs(4, 1, 9, 64, "float32")
    states, final = ops.rglru_scan(h0, a, b)
    assert final.data_ptr() != states[:, -1].data_ptr()
    torch.testing.assert_close(final, states[:, -1], rtol=0, atol=0)
    rng = np.random.default_rng(5)
    gs, gf = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((1, 9, 64), (1, 64)))
    leaves = [t.clone().requires_grad_() for t in (h0, a, b)]
    states, final = ops.rglru_scan(*leaves)
    got = torch.autograd.grad((states * gs).sum() + (final * gf).sum(),
                              leaves)
    g = gs.clone()
    g[:, -1] += gf
    want = ref.rglru_scan_bwd_ref(h0, a, states.detach(), g)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


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


# -- the backward: its plain version, its plan and its staged walk ----------

def _bwd_inputs(seed, B, S, D):
    (_, _, _), (h0, a, b) = _inputs(seed, B, S, D, "float32")
    g = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (B, S, D)).astype(np.float32))
    return h0, a, b, g


BWD_SHAPES = [(2, 256, 128), (3, 37, 132), (2, 1, 64), (1, 65, 4)]


@pytest.mark.parametrize("B,S,D", BWD_SHAPES)
def test_bwd_plain_is_autograd_of_the_plain_loop(B, S, D):
    """Bitwise: the reverse loop rounds the same products and sums, in
    the same order, as autograd of `rglru_scan_ref`."""
    h0, a, b, g = _bwd_inputs(B + S + D, B, S, D)
    leaves = [t.clone().requires_grad_() for t in (h0, a, b)]
    states = ref.rglru_scan_ref(*leaves)
    want = torch.autograd.grad(states, leaves, g)
    got = ref.rglru_scan_bwd_ref(h0, a, states.detach(), g)
    for x, y, what in zip(got, want, ("dh0", "da", "db")):
        assert x.dtype == torch.float32 and torch.equal(x, y), what


def _jax_assoc_scan(h0, a, b):
    """The reference's RG-LRU scan as `repro/models/recurrent.py:112-119`
    writes it: h0 folded into b[:, 0], then the associative scan."""
    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, a2 * b1 + b2
    b = b.at[:, 0].add(a[:, 0] * h0)
    _, states = jax.lax.associative_scan(combine, (a, b), axis=1)
    return states


@pytest.mark.parametrize("scan", ["associative", "sequential"])
@pytest.mark.parametrize("B,S,D", BWD_SHAPES)
def test_bwd_matches_jax_grad(B, S, D, scan):
    h0, a, b, g = _bwd_inputs(2 * S + D, B, S, D)
    fn = _jax_assoc_scan if scan == "associative" else jscan_ref
    jg = jnp.asarray(g.numpy())
    want = jax.grad(lambda *x: jnp.sum(fn(*x) * jg), argnums=(0, 1, 2))(
        *(jnp.asarray(t.numpy()) for t in (h0, a, b)))
    got = ops.rglru_scan_bwd_raw(h0, a, ref.rglru_scan_ref(h0, a, b), g)
    for x, y, what in zip(got, want, ("dh0", "da", "db")):
        y = np.asarray(y)
        tol = 1e-5 * float(np.abs(y).max())
        np.testing.assert_allclose(x.numpy(), y, rtol=0, atol=tol,
                                   err_msg=what)


@pytest.mark.parametrize("B,S,D", PLAN_SHAPES + [(2, 2048, 4096)])
def test_bwd_plan_owns_every_lane_once_within_the_cards_limits(B, S, D):
    plan = ops._bwd_plan(B, S, D)
    owners = np.zeros((B, D), dtype=int)
    for y in range(plan.grid[1]):
        for x in range(plan.grid[0]):
            lanes = _lanes(plan, (x, y), D)
            assert len(lanes) > 0
            owners[y, lanes.start:lanes.stop] += 1
    assert (owners == 1).all()
    steps = _steps(plan, S)
    assert (steps - 1) * plan.stage_rows < S <= steps * plan.stage_rows
    assert plan.smem + ops.BWD_STATIC_SMEM <= ops.SMEM_MAX == 232_448
    assert plan.tile <= ops.BOX_MAX and plan.stage_rows <= ops.BOX_MAX
    assert plan.threads == plan.tile + 32 and plan.threads % 32 == 0
    # the input ring (g, a, states), the output stages (da, db), the slack
    stage = plan.stage_rows * plan.tile * 4
    assert plan.smem == (3 * plan.stages + 2 * ops.OUT_STAGES) * stage + 1024
    assert plan.grid == ops._plan(B, S, D).grid
    if (B, S, D) == (2, 2048, 4096):
        assert plan.grid == (32, 2)        # 64 CTAs on 132 SMs


@pytest.mark.parametrize("shape,match", [
    ((2, 64, 130), "multiple of 4"),
    ((2, 0, 128), "empty"),
    ((0, 64, 128), "empty"),
    ((70000, 64, 128), "65535"),
])
def test_bwd_plan_rejects_what_the_kernel_does_not_take(shape, match):
    with pytest.raises(ValueError, match=match):
        ops._bwd_plan(*shape)


def _emulate_bwd(plan, h0, a, states, g):
    """The backward kernel's reverse staged walk in plain PyTorch: each
    CTA loads boxes of (stage_rows, tile) of g and a at rows k * R and of
    the states at rows k * R - 1 (zeros outside the tensor, row -1
    included), from the last stage to the first; carries dh and a_{t+1}
    per lane (rounded products and sums); takes h0 at t = 0; stores each
    output box clipped to the tensor; writes dh0 = a_0 dh_0."""
    B, S, D = a.shape
    T, R = plan.tile, plan.stage_rows

    def box(x, y, r0, cols):
        out = torch.zeros(R, T)
        lo, hi = max(r0, 0), min(S, r0 + R)
        if hi > lo:
            out[lo - r0:hi - r0, :cols.stop - cols.start] = x[y, lo:hi, cols]
        return out

    da = torch.full((B, S, D), float("nan"))
    db = torch.full((B, S, D), float("nan"))
    dh0 = torch.full((B, D), float("nan"))
    for y in range(plan.grid[1]):
        for x in range(plan.grid[0]):
            lanes = _lanes(plan, (x, y), D)
            cols = slice(lanes.start, lanes.stop)
            n = len(lanes)
            hinit = torch.zeros(T)
            hinit[:n] = h0[y, cols]
            dh, a_next = torch.zeros(T), torch.zeros(T)
            for k in range(_steps(plan, S) - 1, -1, -1):
                bg, ba = box(g, y, k * R, cols), box(a, y, k * R, cols)
                bh = box(states, y, k * R - 1, cols)
                oa, ob = torch.empty(R, T), torch.empty(R, T)
                for r in range(R - 1, -1, -1):
                    dh = bg[r] + a_next * dh
                    hp = hinit if (k == 0 and r == 0) else bh[r]
                    ob[r], oa[r] = dh, dh * hp
                    a_next = ba[r]
                m = min(S, (k + 1) * R) - k * R
                da[y, k * R:k * R + m, cols] = oa[:m, :n]
                db[y, k * R:k * R + m, cols] = ob[:m, :n]
            dh0[y, cols] = (a_next * dh)[:n]
    return dh0, da, db


@pytest.mark.parametrize("B,S,D", [(3, 100, 260), (2, 1, 128), (1, 65, 64),
                                   (2, 64, 256), (1, 33, 4), (2, 200, 132)])
def test_bwd_staged_emulation_is_bitwise_the_plain_backward(B, S, D):
    """Both ends at S % 32 != 0: the zero-filled rows past S come first
    and leave dh exactly 0; the states' box at row -1 reads zeros and
    t = 0 takes h0."""
    h0, a, b, g = _bwd_inputs(S * D, B, S, D)
    states = ref.rglru_scan_ref(h0, a, b)
    got = _emulate_bwd(ops._bwd_plan(B, S, D), h0, a, states, g)
    want = ref.rglru_scan_bwd_ref(h0, a, states, g)
    for x, y, what in zip(got, want, ("dh0", "da", "db")):
        assert torch.equal(x, y), what
