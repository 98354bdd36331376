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


@pytest.mark.parametrize("hd,built", [(8, 32), (32, 32), (40, 64),
                                      (64, 64), (80, 128), (96, 128),
                                      (128, 128), (136, 256), (200, 256),
                                      (256, 256)])
def test_padded_head_dim(hd, built):
    """Every hd % 8 == 0 up to 256 runs in the next built head dim (as
    csrc/flash_wgmma.cuh `padded_head_dim`); nothing else has a kernel."""
    assert ops.padded_head_dim(hd) == built


@pytest.mark.parametrize("hd,built", [(40, 64), (64, 64), (72, 80),
                                      (80, 80), (88, 128), (128, 128),
                                      (136, 256), (256, 256)])
def test_tc_forward_head_dim(hd, built):
    """The bf16 tensor-core forward is also built for 80: hd 72 and 80 run
    there, the rest in the next of 64, 128, 256 (as csrc/flash_wgmma.cuh
    `tc_head_dim`); hd <= 32 has no tensor-core build."""
    assert ops.tc_head_dim(hd) == built
    with pytest.raises(ValueError, match="CUDA cores"):
        ops.tc_head_dim(32)


@pytest.mark.parametrize("hd", [0, 4, 84, 260, 512])
def test_head_dim_without_kernel_raises(hd):
    with pytest.raises(ValueError, match=f"head_dim {hd}"):
        ops.padded_head_dim(hd)


def test_gradient_raises(monkeypatch):
    """A gradient flows on CPU tensors, through the autograd Function's
    plain backward (held to the reference in
    tests/test_torch_flash_attention_bwd.py). Off the CPU, asking for a
    gradient at a head dim the backward library is not built for raises
    in the forward's launch before the kernel runs; meta tensors and a
    stub library stand in for the card, the stub built for head dim 64
    only."""
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
    # the forward's launch with the log-sum-exp (what the autograd
    # Function calls on a card) checks the backward's head dim first
    for hd in (32, 256):
        qm = torch.zeros((1, 4, 2, hd), device="meta", requires_grad=True)
        km = torch.zeros((1, 4, 1, hd), device="meta")
        with pytest.raises(ValueError, match=f"head_dim {hd}"):
            ops._forward_cuda(qm, km, km, True, 0, None, None, True)
    # a supported head dim passes the check and reaches the forward,
    # which launches its kernel or raises: it never falls back
    qm = torch.zeros((1, 4, 2, 64), device="meta", requires_grad=True)
    km = torch.zeros((1, 4, 1, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops._forward_cuda(qm, km, km, True, 0, None, None, True)
    # meta tensors through the wrapper get the operators' shape rules
    out = ops.flash_attention(qm, km, km)
    assert out.device.type == "meta" and out.shape == qm.shape
    (gm,) = torch.autograd.grad(out.sum(), qm)
    assert gm.shape == qm.shape


# -- the tensor-core kernel's arithmetic, emulated in plain PyTorch ------
#
# csrc/flash_attention.cu's bf16 kernel computes S = Q.K^T from bf16 q, k
# in f32, the online max and sum in f32 per kv tile of 64 keys, and each
# tile's P.V with P split into bf16 terms (each the rounded remainder of
# the ones before) into a fresh f32 accumulator, added as
# O = O * alpha + P.V. The card's check (chip_smoke.py) holds its output
# to the plain one within 2 bf16 ulps, the ulp floored at 2^-16 of the
# largest output. These tests hold the same arithmetic, with exact f32
# adds, to that rule: three terms pass, one term does not.

def _bf16_ulp(x):
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


def _misses(got, want, floor_exp):
    """Elements of `got` more than 2 bf16 ulps from `want`, the ulp taken
    at no less than 2^floor_exp of the largest |want| (chip_smoke.py's
    rule)."""
    want = want.float()
    floor = torch.full_like(want, 2.0 ** floor_exp * float(want.abs().max()))
    tol = 2 * _bf16_ulp(torch.maximum(want.abs(), floor))
    return int(((got.float() - want).abs() > tol).sum())


def _split_terms(x, terms):
    """x (f32) as `terms` bf16 values (in f32) that sum to x within
    2^-8 terms relative: each the bf16 rounding of what the ones before
    it left."""
    out = []
    for _ in range(terms):
        t = x.to(torch.bfloat16).float()
        out.append(t)
        x = x - t
    return out


def _emulate_tc_forward(q, k, v, *, causal, window, q_offset, terms,
                        tile=64):
    Sq, Sk, hd = q.shape[1], k.shape[1], q.shape[3]
    qf, kf, vf = ref._heads_f32(q, k, v)
    mask = ref.attention_mask(Sq, Sk, causal=causal, window=window,
                              q_offset=q_offset, kv_len=Sk, device="cpu")
    scale = 1.0 / np.sqrt(hd)
    m = torch.full(qf.shape[:3] + (1,), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qf)
    for k0 in range(0, Sk, tile):
        ok = mask[:, k0:k0 + tile]
        s = (qf @ kf[..., k0:k0 + tile, :].transpose(-1, -2)) * scale
        s = torch.where(ok, s, torch.tensor(-1e30))
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - mx)
        p = torch.where(ok, torch.exp(s - mx), torch.tensor(0.0))
        l = alpha * l + p.sum(-1, keepdim=True)
        pv = sum(t @ vf[..., k0:k0 + tile, :] for t in _split_terms(p, terms))
        o = o * alpha + pv
        m = mx
    out = o / l.clamp_min(1e-30)
    return out.transpose(1, 2).contiguous().to(q.dtype)


# (B, Sq, Sk, H, K, hd, causal, window): hd 64 and 256, causal and
# windowed (RecurrentGemma's hd with a window), suffix-aligned GQA; hd 80
# (StableLM-3B's, the 80 build), causal
TC_CASES = [
    (1, 1024, 1024, 2, 1, 64, True, 0),
    (1, 1024, 1024, 2, 1, 256, True, 512),
    (1, 512, 1024, 4, 2, 256, True, 0),
    (1, 768, 768, 3, 3, 64, True, 100),
    (1, 1024, 1024, 2, 2, 80, True, 0),
]
HD80_CASE = TC_CASES[-1]


def _bf16_qkv(seed, B, Sq, Sk, H, K, hd):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16)
            for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd))]


@pytest.mark.parametrize("case", TC_CASES, ids=str)
def test_tensor_core_forward_arithmetic_within_rule(case):
    """P in three bf16 terms, per-tile f32 partials: every output within
    2 bf16 ulps of the plain forward."""
    B, Sq, Sk, H, K, hd, causal, window = case
    q, k, v = _bf16_qkv(sum(case[:6]), B, Sq, Sk, H, K, hd)
    want = ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=Sk - Sq)
    got = _emulate_tc_forward(q, k, v, causal=causal, window=window,
                              q_offset=Sk - Sq, terms=3)
    assert _misses(got, want, -16) == 0


def test_one_bf16_term_of_p_fails_the_rule():
    """P rounded once to bf16 (one wgmma for P.V) misses the rule: why the
    kernel splits it."""
    B, Sq, Sk, H, K, hd, causal, window = TC_CASES[0]
    q, k, v = _bf16_qkv(sum(TC_CASES[0][:6]), B, Sq, Sk, H, K, hd)
    want = ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=0)
    got = _emulate_tc_forward(q, k, v, causal=causal, window=window,
                              q_offset=0, terms=1)
    assert _misses(got, want, -16) > 1000


def test_two_bf16_terms_of_p_fail_the_rule_at_hd80():
    """At hd 80 P in two bf16 terms still misses the rule (1 element of
    163,840 on this case), three do not
    (test_tensor_core_forward_arithmetic_within_rule): why the hd-80 build
    keeps three terms."""
    B, Sq, Sk, H, K, hd, causal, window = HD80_CASE
    q, k, v = _bf16_qkv(sum(HD80_CASE[:6]), B, Sq, Sk, H, K, hd)
    want = ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=0)
    got = _emulate_tc_forward(q, k, v, causal=causal, window=window,
                              q_offset=0, terms=2)
    assert _misses(got, want, -16) > 0
