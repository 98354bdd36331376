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
    ops.require_bwd_head_dim(64)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention_bwd(*args(64))
    monkeypatch.setattr(ops, "_require_cuda", lambda q, what: None)
    for hd in (128, 256):
        with pytest.raises(ValueError, match=f"head_dim {hd}"):
            ops.flash_attention_bwd(*args(hd))


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


def _emulate_tc_backward(q, k, v, out, do, lse, *, causal, window,
                         q_offset, terms):
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    scale = 1.0 / np.sqrt(hd)
    qf, kf, vf = ref._heads_f32(q, k, v)
    dof = do.float().transpose(1, 2)
    dsum = (dof * out.float().transpose(1, 2)).sum(-1, keepdim=True)
    mask = ref.attention_mask(Sq, Sk, causal=causal, window=window,
                              q_offset=q_offset, kv_len=Sk, device="cpu")
    s = (qf @ kf.transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.tensor(0.0))
    ds = p * (dof @ vf.transpose(-1, -2) - dsum)
    dv = _split_product(p.transpose(-1, -2), dof, terms)
    dk = _split_product(ds.transpose(-1, -2), qf, terms) * scale
    dq = _split_product(ds, kf, terms) * scale

    def per_kv_head(x):
        return x.reshape(B, K, H // K, Sk, hd).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype), per_kv_head(dk).to(q.dtype),
            per_kv_head(dv).to(q.dtype))


# (B, Sq, Sk, H, K, hd, causal, window): hd 64 (SmolLM's) and 128, causal
# and windowed, GQA
TC_CASES = [
    (1, 1024, 1024, 3, 1, 64, True, 0),
    (1, 768, 768, 4, 2, 128, True, 200),
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


def test_one_bf16_term_of_p_and_ds_fails_the_rule():
    """P and dS rounded once to bf16 miss the rule in every gradient: why
    the kernels split them."""
    q, k, v, out, do, lse, kw = _bf16_case(TC_CASES[0])
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
