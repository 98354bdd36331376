"""The port's flash-attention plain version (the CPU dispatch of
`repro_torch.kernels.flash_attention.ops.flash_attention`, and the
oracle the CUDA kernel is held to on the card) against the JAX
package's `attention_ref` and its Pallas kernel in interpret mode, on
the same numpy inputs.

Tolerances: 1e-5 max abs in f32 (different summation orders); in bf16
the reference's own 2e-2 (tests/test_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jattention_ref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention.flash_attention import flash_attention_bh
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.bridge import array_to_tensor

DTYPES = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(seed, B, Sq, Sk, H, K, hd, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd)))
    j = [jnp.asarray(a, dtype) for a in (q, k, v)]
    return j, [array_to_tensor(np.asarray(a)) for a in j]


def _bh(x, g=1):
    """(B, S, N, hd) -> (B*N*g, S, hd) with each head repeated g times."""
    B, S, N, hd = x.shape
    x = jnp.repeat(x.transpose(0, 2, 1, 3), g, axis=1)
    return x.reshape(B * N * g, S, hd)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


# (B, Sq, Sk, H, K, hd, causal, window): tests/test_kernels.py's shapes
CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),       # GQA
    (2, 100, 100, 3, 1, 64, True, 0),       # ragged, MQA, odd head count
    (1, 64, 256, 2, 2, 128, True, 0),       # suffix alignment q_offset 192
    (1, 256, 256, 2, 2, 64, True, 16),      # sliding window
    (2, 100, 100, 3, 1, 64, True, 200),     # window wider than the prompt
    (1, 40, 90, 4, 2, 32, False, 24),       # window without causal
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_matches_jax_ref(case, dtype):
    B, Sq, Sk, H, K, hd, causal, window = case
    (jq, jk, jv), (q, k, v) = _qkv(sum(case[:6]), B, Sq, Sk, H, K, hd, dtype)
    g = H // K

    @jax.jit
    def reference(q, k, v):
        out = jattention_ref(_bh(q), _bh(k, g), _bh(v, g), causal=causal,
                             window=window, q_offset=Sk - Sq)
        return out.reshape(B, H, Sq, hd).transpose(0, 2, 1, 3)
    want = reference(jq, jk, jv)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, DTYPES[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES[:4], ids=str)
def test_plain_matches_pallas_interpret(case, dtype):
    B, Sq, Sk, H, K, hd, causal, window = case
    (jq, jk, jv), (q, k, v) = _qkv(sum(case[:6]) + 1, B, Sq, Sk, H, K, hd,
                                   dtype)
    want = jflash(jq, jk, jv, causal=causal, window=window, interpret=True)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    _close(got, want, DTYPES[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kv_len_and_fully_masked_rows(dtype):
    """kv_len < Sk masks the right end; with window 16 and q_offset 64,
    query rows at positions >= 115 (keys > 99 and < 100) see no valid key
    and give 0."""
    B, Sq, Sk, H, hd = 1, 64, 128, 2, 64
    (jq, jk, jv), (q, k, v) = _qkv(9, B, Sq, Sk, H, H, hd, dtype)
    want = flash_attention_bh(_bh(jq), _bh(jk), _bh(jv), causal=True,
                              window=16, q_offset=64, kv_len=100,
                              block_q=64, block_k=64, interpret=True)
    want = want.reshape(B, H, Sq, hd).transpose(0, 2, 1, 3)
    got = ops.flash_attention(q, k, v, causal=True, window=16, q_offset=64,
                              kv_len=100)
    _close(got, want, DTYPES[dtype])
    first_empty = 115 - 64
    assert torch.count_nonzero(got[:, first_empty:]) == 0
    assert torch.count_nonzero(got[:, :first_empty].float().abs().sum(-1)) \
        == first_empty * H


def test_mask_matches_kernel_rule():
    m = ref.attention_mask(4, 10, causal=True, window=3, q_offset=6,
                           kv_len=8, device="cpu")
    want = np.zeros((4, 10), bool)
    for i in range(4):
        for j in range(10):
            want[i, j] = j < 8 and j <= 6 + i and j > 6 + i - 3
    np.testing.assert_array_equal(m.numpy(), want)


def test_gradient_raises(monkeypatch):
    """A gradient flows on CPU tensors, through the autograd Function's
    plain backward (held to the reference in
    tests/test_torch_flash_attention_bwd.py). Off the CPU, asking for a
    gradient at a head dim the backward library is not built for raises
    in the wrapper before any forward runs; meta tensors and a stub
    library stand in for the card, the stub built for head dim 64 only."""
    q = torch.zeros((1, 4, 2, 32), requires_grad=True)
    k = torch.zeros((1, 4, 1, 32))
    out = ops.flash_attention(q, k, k)
    assert out.requires_grad
    (g,) = torch.autograd.grad(out.sum(), q)
    assert g.shape == q.shape and bool(torch.isfinite(g).all())
    with torch.no_grad():
        assert ops.flash_attention(q, k, k).shape == q.shape

    stub = type("Lib", (), {"fa_bwd_supports_head_dim":
                            staticmethod(lambda hd: int(hd == 64))})
    monkeypatch.setattr(ops, "_bwd_lib", lambda: stub)
    for hd in (32, 256):
        qm = torch.zeros((1, 4, 2, hd), device="meta", requires_grad=True)
        km = torch.zeros((1, 4, 1, hd), device="meta")
        with pytest.raises(ValueError, match=f"head_dim {hd}"):
            ops.flash_attention(qm, km, km)
    # a supported head dim passes the check and reaches the forward,
    # which launches its kernel or raises: it never falls back
    qm = torch.zeros((1, 4, 2, 64), device="meta", requires_grad=True)
    km = torch.zeros((1, 4, 1, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.flash_attention(qm, km, km)
