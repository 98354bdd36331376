"""The gradient of the port's attention — the plain backward
`attention_bwd_ref` (the oracle of csrc/flash_attention_bwd.cu) and the
`FlashAttention` autograd Function on CPU tensors (plain forward with
the log-sum-exp, plain backward) — against `jax.vjp` of the JAX
package's train-mode attention, `repro.models.layers.chunked_attention`
(kv heads repeated as the reference's attention layer repeats them), in
f32 on the same numpy inputs and output cotangent.

Tolerance: GRAD_RTOL x the largest |gradient| of each of dq, dk, dv
(f32 sums in other orders: XLA's chunked online softmax against the
port's dense one). Rows with no valid key get exactly zero gradient.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.models.layers import chunked_attention
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import ops, ref

GRAD_RTOL = 1e-5

# (B, Sq, Sk, H, K, hd, causal, window, q_offset, kv_len)
CASES = {
    "causal-gqa3": (2, 64, 64, 6, 2, 32, True, 0, 0, None),
    "window": (1, 96, 96, 3, 1, 64, True, 16, 0, None),
    "ragged-offset": (2, 40, 100, 6, 2, 32, True, 0, 60, None),
    # rows at q_pos >= 87 (i >= 23) see no key: keys > q_pos - 8 and < 80
    "fully-masked-rows": (1, 48, 96, 3, 3, 32, True, 8, 64, 80),
    "window-no-causal": (1, 40, 90, 4, 2, 32, False, 24, 50, None),
}


def _inputs(seed, B, Sq, Sk, H, K, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd), (B, Sq, H, hd))]


def _jax_grads(q, k, v, do, H, K, causal, window, q_offset, kv_len):
    def f(q, k, v):
        g = H // K
        return chunked_attention(q, jnp.repeat(k, g, axis=2),
                                 jnp.repeat(v, g, axis=2), causal=causal,
                                 window=window, q_offset=q_offset,
                                 kv_len=kv_len, q_chunk=16, kv_chunk=32)
    out, vjp = jax.vjp(f, q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want, what):
    want = np.asarray(want)
    tol = GRAD_RTOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_jax_grad(name):
    B, Sq, Sk, H, K, hd, causal, window, q_offset, kv_len = CASES[name]
    q, k, v, do = _inputs(sum(CASES[name][:6]), B, Sq, Sk, H, K, hd)
    jout, jgrads = _jax_grads(q, k, v, do, H, K, causal, window, q_offset,
                              kv_len)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_len=kv_len)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))

    # the plain backward, from the plain forward's output and lse
    out, lse = ref.attention_ref(tq, tk, tv, return_lse=True, **kw)
    _close(out, jout, f"{name} forward")
    plain = ref.attention_bwd_ref(tq, tk, tv, out, tdo, lse, **kw)

    # the autograd Function, as the train-mode attention layer calls it
    xs = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    got = ops.flash_attention(*xs, **kw)
    auto = torch.autograd.grad(got, xs, tdo)
    for label, grads in (("attention_bwd_ref", plain),
                         ("FlashAttention", auto)):
        for n, g, want in zip("qkv", grads, jgrads):
            assert g.shape == want.shape and g.dtype == torch.float32
            assert bool(torch.isfinite(g).all())
            _close(g, want, f"{name} {label} d{n}")

    if kv_len is not None:          # rows with no valid key: zero gradient
        pos = q_offset + np.arange(Sq)
        empty = (pos - window >= kv_len - 1) if window else pos < 0
        assert empty.any()
        assert torch.count_nonzero(auto[0][:, empty]) == 0
        assert np.count_nonzero(jgrads[0][:, empty]) == 0


def test_backward_under_checkpoint_uses_the_recompute():
    """Under non-reentrant activation checkpointing (the transformer's
    remat) the Function's forward runs again in the backward; the
    gradients equal the plain autograd ones."""
    B, Sq, Sk, H, K, hd = 2, 48, 48, 6, 2, 32
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(5, B, Sq, Sk, H, K, hd))
    w = torch.randn((hd, hd), generator=torch.Generator().manual_seed(0))

    def block(q, k, v, w):
        return ops.flash_attention(q @ w, k @ w, v, causal=True) @ w

    xs = [x.clone().requires_grad_() for x in (q, k, v, w)]
    want = torch.autograd.grad(block(*xs), xs, do)
    ys = [x.clone().requires_grad_() for x in (q, k, v, w)]
    out = checkpoint(block, *ys, use_reentrant=False)
    got = torch.autograd.grad(out, ys, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_unsupported_backward_head_dim_raises(monkeypatch):
    """The backward wrapper asks the kernel's library which head dims it
    is built for (a stub here, built for 64 only) and raises, naming the
    head dim, on any other; off the CPU without a card it raises rather
    than falling back to the plain backward."""
    def args(hd):
        return ([torch.zeros((1, 4, 2, hd), device="meta")
                 for _ in range(5)] + [torch.zeros((1, 2, 4), device="meta")])

    stub = type("Lib", (), {"fa_bwd_supports_head_dim":
                            staticmethod(lambda hd: int(hd == 64))})
    monkeypatch.setattr(ops, "_bwd_lib", lambda: stub)
    masks = (True, 0, None, None)
    ops.require_bwd_head_dim(64)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops._bwd_cuda(*args(64), *masks)
    monkeypatch.setattr(ops, "_require_cuda", lambda q, what: None)
    for hd in (128, 256):
        with pytest.raises(ValueError, match=f"head_dim {hd}"):
            ops._bwd_cuda(*args(hd), *masks)
    # through the wrapper, meta tensors get the operator's shape rule
    assert [g.shape for g in ops.flash_attention_bwd(*args(128))] == [
        (1, 4, 2, 128)] * 3


def test_bf16_backward_routes_to_the_tensor_cores(monkeypatch):
    """On the card the bf16 backward at hd 33-256 (hd 256 and 200 in the
    256 build among them) launches the tensor-core kernels and counts as
    `flash_attention_bwd`; f32 and bf16 at hd <= 32 launch the CUDA-core
    ones (`flash_attention_bwd_f32`). Meta tensors and a stub library,
    which answers as csrc/flash_attention_bwd.cu's entry points do, stand
    in for the card, through the operator's CUDA implementation."""
    calls = []

    def entry(name):
        return staticmethod(lambda *a: calls.append((name, a[15])) or 0)

    def tc(hd):
        return int(32 < hd <= 256 and hd % 8 == 0)

    stub = type("Lib", (), {
        "fa_bwd_supports_head_dim":
            staticmethod(lambda hd: int(0 < hd <= 256 and hd % 8 == 0)),
        "fa_bwd_tc_supports_head_dim": staticmethod(tc),
        "fa_bwd_tc_build_head_dim": staticmethod(
            lambda hd: (64 if hd <= 64 else 80 if hd <= 80 else
                        128 if hd <= 128 else 256) if tc(hd) else 0),
        "fa_bwd_tc_scratch_floats": staticmethod(lambda *a: 1024),
        "fa_flash_attention_bwd_tc": entry("tc"),
        "fa_flash_attention_bwd": entry("cuda cores")})
    monkeypatch.setattr(ops, "_bwd_lib", lambda: stub)
    monkeypatch.setattr(ops, "_require_cuda", lambda q, what: None)
    monkeypatch.setattr(runtime, "stream_ptr", lambda t: 0)
    for hd, dtype, want in ((256, torch.bfloat16, "tc"),
                            (200, torch.bfloat16, "tc"),
                            (80, torch.bfloat16, "tc"),
                            (72, torch.bfloat16, "tc"),
                            (32, torch.bfloat16, "cuda cores"),
                            (256, torch.float32, "cuda cores")):
        q, out, do = (torch.empty((1, 4, 2, hd), device="meta", dtype=dtype)
                      for _ in range(3))
        k, v = (torch.empty((1, 4, 1, hd), device="meta", dtype=dtype)
                for _ in range(2))
        lse = torch.empty((1, 2, 4), device="meta")
        calls.clear()
        runtime.reset_counts()
        grads = ops._bwd_cuda(q, k, v, out, do, lse, True, 0, None, None)
        assert calls == [(want, hd)]
        assert runtime.counts() == {"flash_attention_bwd" if want == "tc"
                                    else "flash_attention_bwd_f32": 1}
        assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
        # the build the library reports for a bf16 head dim: the wrappers'
        # rule (hd 72 and 80 in the 80 build), none at hd <= 32
        if dtype == torch.bfloat16:
            assert stub.fa_bwd_tc_build_head_dim(hd) == (
                ops.tc_head_dim(hd) if want == "tc" else 0)
    runtime.reset_counts()


@pytest.mark.parametrize("hd,built", [(40, 64), (72, 80), (80, 80),
                                      (88, 128), (200, 256)])
def test_tc_backward_head_dim(hd, built):
    """The bf16 tensor-core backward is built for 64, 80, 128 and 256, by
    the forward's rule (csrc/flash_wgmma.cuh `tc_head_dim`, the
    library's `fa_bwd_tc_build_head_dim`): hd 72 and 80 run in the 80
    build, not the 128 one; hd <= 32 has no tensor-core build."""
    assert ops.tc_head_dim(hd) == built
    assert ops.tc_head_dim(hd) <= ops.padded_head_dim(hd)
    with pytest.raises(ValueError, match="CUDA cores"):
        ops.tc_head_dim(32)


# -- the tensor-core kernels' arithmetic, emulated in plain PyTorch ------
#
# csrc/flash_attention_bwd.cu's bf16 kernels compute S and dP from bf16
# operands in f32, P = exp(S * scale - lse) and dS = P * (dP - dsum) in
# f32, and each of dV += P^T.dO, dK += dS^T.Q, dQ += dS.K per tile of 64
# rows with P or dS split into bf16 terms (each the rounded remainder of
# the ones before) into a fresh f32 accumulator, added to the sum in
# f32. The card's check (chip_smoke.py) holds the gradients to the plain
# backward within 2 bf16 ulps, the ulp floored at 2^-12 of the largest
# gradient. These tests hold the same arithmetic, with exact f32 adds,
# to that rule: two terms pass, one does not.

def _bf16_ulp(x):
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


def _misses(got, want, floor_exp=-12):
    """Elements more than 2 bf16 ulps from `want`, the ulp taken at no
    less than 2^floor_exp of the largest |want| (chip_smoke.py's rule)."""
    want = want.float()
    floor = torch.full_like(want, 2.0 ** floor_exp * float(want.abs().max()))
    tol = 2 * _bf16_ulp(torch.maximum(want.abs(), floor))
    return int(((got.float() - want).abs() > tol).sum())


def _split_product(a, b, terms, tile=64):
    """a @ b with a (f32) split into `terms` bf16 terms, one fresh f32
    partial per tile of 64 along the reduction, the partials summed in
    f32: the kernels' second products."""
    acc = 0.0
    for c0 in range(0, a.shape[-1], tile):
        rest, part = a[..., c0:c0 + tile], 0.0
        for _ in range(terms):
            t = rest.to(torch.bfloat16).float()
            part = part + t @ b[..., c0:c0 + tile, :]
            rest = rest - t
        acc = acc + part
    return acc


def _tc_operands(q, k, v, out, do, lse, *, causal, window, q_offset):
    """The kernels' f32 operands, zero-padded to the tensor-core build's
    head dim (`ops.tc_head_dim`), with P and dS from S and dP at the true
    scale 1/sqrt(hd): (scale, qf, kf, dof, p, ds)."""
    Sq, hd = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    scale = 1.0 / np.sqrt(hd)
    hdp = ops.tc_head_dim(hd)
    q, k, v, out, do = (_pad(x, hdp) for x in (q, k, v, out, do))
    qf, kf, vf = ref._heads_f32(q, k, v)
    dof = do.float().transpose(1, 2)
    dsum = (dof * out.float().transpose(1, 2)).sum(-1, keepdim=True)
    mask = ref.attention_mask(Sq, Sk, causal=causal, window=window,
                              q_offset=q_offset, kv_len=Sk, device="cpu")
    s = (qf @ kf.transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.tensor(0.0))
    ds = p * (dof @ vf.transpose(-1, -2) - dsum)
    return scale, qf, kf, dof, p, ds


def _grads_out(q, k, dq, dk, dv):
    """(B, H, S, hdp) f32 sums -> dq (B, Sq, H, hd) and dk, dv summed over
    the query heads of each kv head (unless they come as (B, K, Sk, hdp)
    sums already), in q's dtype, padding dropped."""
    B, _, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]

    def per_kv_head(x):
        if x.shape[1] != K:
            x = x.reshape(B, K, H // K, Sk, -1).sum(2)
        return x.transpose(1, 2)

    return tuple(x[..., :hd].contiguous().to(q.dtype) for x in (
        dq.transpose(1, 2), per_kv_head(dk), per_kv_head(dv)))


def _emulate_tc_backward(q, k, v, out, do, lse, *, causal, window,
                         q_offset, terms):
    scale, qf, kf, dof, p, ds = _tc_operands(
        q, k, v, out, do, lse, causal=causal, window=window,
        q_offset=q_offset)
    dv = _split_product(p.transpose(-1, -2), dof, terms)
    dk = _split_product(ds.transpose(-1, -2), qf, terms) * scale
    dq = _split_product(ds, kf, terms) * scale
    return _grads_out(q, k, dq, dk, dv)


def _emulate_two_pass_backward(q, k, v, out, do, lse, *, causal, window,
                               q_offset):
    """The hd-256 build's order: a dV pass (S^T, P^T, dV += P^T.dO) and a
    dK pass (S^T and dP^T, dS^T, dK += dS^T.Q) over separate blocks, and
    dQ over 64-row blocks; in each, the two consumers take 128 columns of
    the product each. Two bf16 terms, a fresh f32 partial a tile."""
    scale, qf, kf, dof, p, ds = _tc_operands(
        q, k, v, out, do, lse, causal=causal, window=window,
        q_offset=q_offset)
    half = qf.shape[-1] // 2

    def by_halves(a, b):
        return torch.cat([_split_product(a, b[..., c:c + half], 2)
                          for c in (0, half)], -1)

    dv = by_halves(p.transpose(-1, -2), dof)             # pass 0
    dk = by_halves(ds.transpose(-1, -2), qf) * scale     # pass 1
    dq = by_halves(ds, kf) * scale
    return _grads_out(q, k, dq, dk, dv)


def _head_groups(B, Sk, H, K, two_pass, sms=132):
    """csrc/flash_attention_bwd.cu `head_groups` on a card of `sms` SMs:
    the fewest divisor of G = H / K that gives the dkdv grid two blocks an
    SM, else G."""
    blocks = K * B * -(-Sk // 64) * (2 if two_pass else 1)
    G = H // K
    return next((ns for ns in range(1, G)
                 if G % ns == 0 and blocks * ns >= 2 * sms), G)


def _query_tiles(k_first, Sq, Sk, causal, window, q_offset):
    """The query tiles [t_begin, t_end) of 64 rows that the dkdv block of
    keys k_first .. k_first + 63 walks (dkdv_tc_kernel's range)."""
    key_hi = min(k_first + 64, Sk) - 1
    i_begin, i_end = 0, Sq if key_hi >= k_first else 0
    if causal:
        i_begin = max(i_begin, k_first - q_offset)
    if window > 0:
        i_end = min(i_end, key_hi + window - q_offset)
    return (i_begin // 64, -(-i_end // 64)) if i_end > i_begin else (0, 0)


def _tile_partials(a, b, tile=64):
    """The fresh f32 partial of each tile of 64 along the reduction of
    a @ b, a in two bf16 terms: (..., tiles, rows, cols)."""
    parts = []
    for c0 in range(0, a.shape[-1], tile):
        rest, part = a[..., c0:c0 + tile], 0.0
        for _ in range(2):
            t = rest.to(torch.bfloat16).float()
            part = part + t @ b[..., c0:c0 + tile, :]
            rest = rest - t
        parts.append(part)
    return torch.stack(parts, -3)


def _emulate_alternate_backward(q, k, v, out, do, lse, *, causal, window,
                                q_offset):
    """The hd-64 and hd-80 builds' dK/dV order: a dkdv block (64 keys, one
    head group of a kv head, `_head_groups`) walks its (query head, query
    tile) pairs in order, its two consumers taking alternate pairs, each
    adding the pairs' fresh f32 partials in order; the second consumer's
    sums are added to the first's, the groups' sums in group order
    (reduce_kernel), and dK is scaled last. dQ as in the one-pass
    emulation (a consumer walks its kv tiles in order)."""
    scale, qf, kf, dof, p, ds = _tc_operands(
        q, k, v, out, do, lse, causal=causal, window=window,
        q_offset=q_offset)
    B, H, Sq, hdp = qf.shape
    Sk, K = k.shape[1], k.shape[2]
    ns = _head_groups(B, Sk, H, K, False)
    Gb = H // K // ns

    def by_blocks(parts):
        parts = parts.reshape(B, K, ns, Gb, *parts.shape[2:])
        grad = torch.zeros((B, K, Sk, hdp))
        for k0 in range(0, Sk, 64):
            t0, t1 = _query_tiles(k0, Sq, Sk, causal, window, q_offset)
            keys = slice(k0, k0 + 64)
            for grp in range(ns):
                acc = [torch.zeros_like(grad[:, :, keys]) for _ in range(2)]
                for n in range(Gb * (t1 - t0)):
                    g, t = divmod(n, t1 - t0)
                    acc[n % 2] = acc[n % 2] + parts[:, :, grp, g, t0 + t, keys]
                grad[:, :, keys] = (acc[0] + acc[1] if grp == 0 else
                                    grad[:, :, keys] + (acc[0] + acc[1]))
        return grad

    dv = by_blocks(_tile_partials(p.transpose(-1, -2), dof))
    dk = by_blocks(_tile_partials(ds.transpose(-1, -2), qf)) * scale
    dq = _split_product(ds, kf, 2) * scale
    return _grads_out(q, k, dq, dk, dv)


# (B, Sq, Sk, H, K, hd, causal, window): hd 64 (SmolLM's) and 128, causal
# and windowed, GQA; hd 256 (RecurrentGemma's) windowed over 2 and 4
# query heads a kv head, and hd 200 in the 256 build; hd 80 (StableLM-
# 3B's) causal, MHA, and windowed over 2 query heads a kv head, and hd 72,
# both in the 80 build
TC_CASES = [
    (1, 1024, 1024, 3, 1, 64, True, 0),
    (1, 768, 768, 4, 2, 128, True, 200),
    (1, 1024, 1024, 2, 1, 256, True, 512),
    (1, 1024, 1024, 4, 1, 256, True, 1024),
    (1, 512, 512, 2, 1, 200, True, 128),
    (1, 1024, 1024, 2, 2, 80, True, 0),
    (1, 768, 768, 4, 2, 80, True, 200),
    (1, 512, 512, 2, 2, 72, True, 0),
]


def _bf16_case(case):
    B, Sq, Sk, H, K, hd, causal, window = case
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to(torch.bfloat16) for s in
                   ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd),
                    (B, Sq, H, hd)))
    kw = dict(causal=causal, window=window, q_offset=Sk - Sq)
    out, lse = ref.attention_ref(q, k, v, return_lse=True, **kw)
    return q, k, v, out, do, lse, kw


@pytest.mark.parametrize("case", TC_CASES, ids=str)
def test_tensor_core_backward_arithmetic_within_rule(case):
    """P and dS in two bf16 terms, per-tile f32 partials: every gradient
    within 2 bf16 ulps of the plain backward."""
    q, k, v, out, do, lse, kw = _bf16_case(case)
    want = ref.attention_bwd_ref(q, k, v, out, do, lse, **kw)
    got = _emulate_tc_backward(q, k, v, out, do, lse, terms=2, **kw)
    for a, b in zip(got, want):
        assert a.shape == b.shape and _misses(a, b) == 0


@pytest.mark.parametrize("case", [c for c in TC_CASES
                                  if ops.padded_head_dim(c[5]) == 256],
                         ids=str)
def test_two_pass_backward_arithmetic_within_rule(case):
    """The hd-256 build's two passes (dV and dK in separate blocks, each
    consumer on 128 columns): every gradient within 2 bf16 ulps of the
    plain backward and of the one-pass emulation."""
    q, k, v, out, do, lse, kw = _bf16_case(case)
    want = ref.attention_bwd_ref(q, k, v, out, do, lse, **kw)
    got = _emulate_two_pass_backward(q, k, v, out, do, lse, **kw)
    one = _emulate_tc_backward(q, k, v, out, do, lse, terms=2, **kw)
    for a, b, c in zip(got, want, one):
        assert a.shape == b.shape and _misses(a, b) == 0
        assert _misses(a, c) == 0


@pytest.mark.parametrize("case", [c for c in TC_CASES
                                  if ops.tc_head_dim(c[5]) in (64, 80)],
                         ids=str)
def test_alternate_backward_arithmetic_within_rule(case):
    """The hd-64 and hd-80 builds' dK/dV order (the consumers on alternate
    (head, query tile) pairs, their sums added at the end; head groups
    added in order): every gradient within 2 bf16 ulps of the plain
    backward and of the one-pass emulation."""
    q, k, v, out, do, lse, kw = _bf16_case(case)
    want = ref.attention_bwd_ref(q, k, v, out, do, lse, **kw)
    got = _emulate_alternate_backward(q, k, v, out, do, lse, **kw)
    one = _emulate_tc_backward(q, k, v, out, do, lse, terms=2, **kw)
    for a, b, c in zip(got, want, one):
        assert a.shape == b.shape and _misses(a, b) == 0
        assert _misses(a, c) == 0


def test_one_bf16_term_of_p_and_ds_fails_the_rule():
    """P and dS rounded once to bf16 miss the rule in every gradient: why
    the kernels split them."""
    q, k, v, out, do, lse, kw = _bf16_case(TC_CASES[0])
    want = ref.attention_bwd_ref(q, k, v, out, do, lse, **kw)
    got = _emulate_tc_backward(q, k, v, out, do, lse, terms=1, **kw)
    assert all(_misses(a, b) > 100 for a, b in zip(got, want))


def test_one_bf16_term_fails_the_rule_at_hd80():
    """At hd 80 too, P and dS rounded once to bf16 miss the rule in every
    gradient, while two terms pass
    (test_tensor_core_backward_arithmetic_within_rule): the 80 build
    keeps the two terms."""
    case = next(c for c in TC_CASES if c[5] == 80)
    q, k, v, out, do, lse, kw = _bf16_case(case)
    want = ref.attention_bwd_ref(q, k, v, out, do, lse, **kw)
    got = _emulate_tc_backward(q, k, v, out, do, lse, terms=1, **kw)
    assert all(_misses(a, b) > 100 for a, b in zip(got, want))


# -- head dims the kernels are not built for ------------------------------
#
# The kernels run hd % 8 == 0 up to 256 in the next built head dim (32,
# 64, 128, 256; `ops.padded_head_dim`) with the columns past hd zero and
# the scale 1/sqrt(hd). That padding happens inside the kernels (TMA's
# zero fill, guarded loads), so it is checked only on the card
# (chip_smoke.py's hd-80 and hd-256 cases). Here it is written with the
# plain versions on zero-padded inputs, to show that the zero columns
# change nothing: the result must be the unpadded answer, and the
# reference's `chunked_attention` and its gradient, at StableLM-3B's hd
# 80 and at other head dims that are not built.


def _pad(x, hdp):
    return torch.nn.functional.pad(x, (0, hdp - x.shape[-1]))


def _attention_padded(q, k, v, **kw):
    """q, k, v zero-padded to `padded_head_dim`, the plain forward at the
    true scale 1/sqrt(hd), the padded output columns dropped."""
    hd = q.shape[-1]
    hdp = ops.padded_head_dim(hd)
    out, lse = ref.attention_ref(_pad(q, hdp), _pad(k, hdp), _pad(v, hdp),
                                 scale=1.0 / math.sqrt(hd), return_lse=True,
                                 **kw)
    return out[..., :hd].contiguous(), lse


def _attention_bwd_padded(q, k, v, out, dout, lse, **kw):
    """Every (.., hd) input zero-padded, the plain backward at the true
    scale, the padded columns of dq, dk and dv dropped."""
    hd = q.shape[-1]
    hdp = ops.padded_head_dim(hd)
    grads = ref.attention_bwd_ref(
        *(_pad(x, hdp) for x in (q, k, v, out, dout)), lse,
        scale=1.0 / math.sqrt(hd), **kw)
    return tuple(g[..., :hd].contiguous() for g in grads)


# (B, Sq, Sk, H, K, hd, causal, window, q_offset)
PADDED_CASES = {
    80: (1, 48, 48, 4, 4, 80, True, 0, 0),        # StableLM-3B's head dim
    40: (2, 40, 64, 4, 2, 40, True, 16, 24),      # windowed, ragged, GQA
    96: (1, 33, 33, 3, 1, 96, True, 0, 0),
    200: (1, 40, 40, 2, 1, 200, True, 0, 0),      # runs in the 256 build
}


@pytest.mark.parametrize("hd", sorted(PADDED_CASES))
def test_padded_head_dim_matches_unpadded_and_jax(hd):
    B, Sq, Sk, H, K, hd, causal, window, q_offset = PADDED_CASES[hd]
    assert ops.padded_head_dim(hd) > hd
    q, k, v, do = _inputs(hd, B, Sq, Sk, H, K, hd)
    jout, jgrads = _jax_grads(q, k, v, do, H, K, causal, window, q_offset,
                              None)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = _attention_padded(tq, tk, tv, **kw)
    want, want_lse = ref.attention_ref(tq, tk, tv, return_lse=True, **kw)
    assert out.shape == tq.shape
    _close(out, want.numpy(), f"hd {hd} forward vs unpadded")
    _close(out, jout, f"hd {hd} forward vs chunked_attention")
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    grads = _attention_bwd_padded(tq, tk, tv, out, tdo, lse, **kw)
    plain = ref.attention_bwd_ref(tq, tk, tv, want, tdo, want_lse, **kw)
    for n, g, p, j in zip("qkv", grads, plain, jgrads):
        assert g.shape == p.shape
        _close(g, p.numpy(), f"hd {hd} d{n} vs unpadded")
        _close(g, j, f"hd {hd} d{n} vs jax.vjp of chunked_attention")
