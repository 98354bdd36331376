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
