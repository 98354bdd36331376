"""The port's xLSTM blocks (`repro_torch.models.recurrent`: mLSTM and
sLSTM) against the JAX package's on the CPU, from the same numpy inputs
and params, in f32.

Tolerances and why:
  * the recurrences alone (`mlstm_sequential`, `mlstm_chunked`): 2e-5
    max abs on outputs and states of magnitude ~1-10 (the two frameworks
    sum the einsums and the cumsum in other orders);
  * the blocks (`mlstm_block_apply`, `slstm_apply`) in train, prefill
    and decode: 2e-5 max abs, as the port's other layers
    (tests/test_torch_serve.py);
  * gradients of a block's summed, weighted output: 1e-4 of the largest
    |gradient| of each leaf (an f32 backward through the chunk's
    exponentials and cumsums, rounded in other orders);
  * the chunked form against the sequential one in the port: the
    reference's own 2e-4 (tests/test_recurrent.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models import recurrent as jrec
from repro_torch import bridge
from repro_torch.configs.base import ArchConfig
from repro_torch.models import recurrent
from repro_torch.pytree import tree_flatten, tree_unflatten
from test_torch_figures import _two_threads  # noqa: F401

TOL = 2e-5
GRAD_RTOL = 1e-4


def _cfgs():
    """(JAX cfg, port cfg): reduced xlstm-350m in f32 (d_model 128, 4
    heads: mLSTM hd 64, sLSTM hd 32)."""
    j = dataclasses.replace(jget_arch("xlstm-350m").reduced(),
                            dtype="float32")
    return j, ArchConfig(**dataclasses.asdict(j))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=0, err_msg=what)


def _mlstm_inputs(seed, B, S, H, hd):
    """q, k, v, log_i, log_f and a nonzero carry (C0, n0, m0), as numpy,
    the gates as tests/test_recurrent.py draws them."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, k, v = n(B, S, H, hd), n(B, S, H, hd) / np.sqrt(hd), n(B, S, H, hd)
    log_i = n(B, S, H)
    log_f = np.asarray(jax.nn.log_sigmoid(n(B, S, H) + 2.0))
    C0, n0, m0 = 0.1 * n(B, H, hd, hd), 0.1 * n(B, H, hd), 0.5 * n(B, H)
    return q, k, v, log_i, log_f, C0, n0, m0


# ---------------------------------------------------------------------------
# the mLSTM recurrences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,chunk", [(2, 40, 16),    # S > chunk, pad 8
                                       (1, 17, 8),     # pad 7
                                       (2, 32, 16),    # no pad
                                       (1, 5, 16)])    # one short chunk
def test_mlstm_chunked_matches_reference(B, S, chunk):
    args = _mlstm_inputs(S + chunk, B, S, 2, 8)
    want = jrec.mlstm_chunked(*map(jnp.asarray, args), chunk=chunk)
    got = recurrent.mlstm_chunked(*map(_t, args), chunk=chunk)
    for g, w, what in zip(got, want, ("h", "C", "n", "m")):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        _close(g, w, TOL, what)


@pytest.mark.parametrize("B,S", [(2, 1), (1, 9)])
def test_mlstm_sequential_matches_reference(B, S):
    args = _mlstm_inputs(B * S, B, S, 2, 8)
    want = jrec.mlstm_sequential(*map(jnp.asarray, args))
    got = recurrent.mlstm_sequential(*map(_t, args))
    for g, w, what in zip(got, want, ("h", "C", "n", "m")):
        _close(g, w, TOL, what)


def test_mlstm_chunked_equals_sequential_in_the_port():
    args = list(map(_t, _mlstm_inputs(5, 2, 37, 2, 8)))
    h_s, C_s, n_s, m_s = recurrent.mlstm_sequential(*args)
    h_c, C_c, n_c, m_c = recurrent.mlstm_chunked(*args, chunk=16)
    for g, w in ((h_c, h_s), (C_c, C_s), (n_c, n_s), (m_c, m_s)):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the blocks: train, prefill and decode, with the caches' continuity
# ---------------------------------------------------------------------------

BLOCKS = {
    "mlstm": (jrec.mlstm_init, jrec.mlstm_block_apply,
              lambda c, B: jrec.init_mlstm_cache(c, B),
              recurrent.mlstm_block_apply,
              lambda c, B: recurrent.init_mlstm_cache(c, B, "cpu")),
    "slstm": (jrec.slstm_init, jrec.slstm_apply,
              lambda c, B: jrec.init_slstm_cache(c, B),
              recurrent.slstm_apply,
              lambda c, B: recurrent.init_slstm_cache(c, B, "cpu")),
}


def _block(kind, seed=0):
    cj, ct = _cfgs()
    jinit, japply, jcache, tapply, tcache = BLOCKS[kind]
    pj = _np(jinit(jax.random.PRNGKey(seed), cj))
    return cj, ct, pj, bridge.tree_from_numpy(pj), japply, jcache, tapply, \
        tcache


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_params_are_the_references(kind):
    """The port's own init gives the reference's tree: paths, shapes and
    dtypes, f32 gate biases of the same values, in f32 and in bf16."""
    for dtype in ("float32", "bfloat16"):
        cj, ct = _cfgs()
        cj = dataclasses.replace(cj, dtype=dtype)
        ct = dataclasses.replace(ct, dtype=dtype)
        init = recurrent.mlstm_init if kind == "mlstm" else \
            recurrent.slstm_init
        want = BLOCKS[kind][0](jax.random.PRNGKey(0), cj)
        got = init(torch.Generator().manual_seed(0), ct, "cpu")
        wl, _ = jax.tree_util.tree_flatten_with_path(want)
        gl, _ = tree_flatten(got)
        assert len(gl) == len(wl)
        for (path, w), g in zip(wl, gl):
            assert tuple(g.shape) == w.shape, path
            assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        bias = "b_if" if kind == "mlstm" else "b"
        np.testing.assert_array_equal(got[bias].numpy(), np.asarray(
            want[bias]))


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_train_prefill_decode(kind):
    cj, ct, pj, pt, japply, jcache, tapply, tcache = _block(kind)
    B, S, G = 2, 21, 4
    x = (0.5 * np.random.default_rng(6).standard_normal(
        (B, S + G, cj.d_model))).astype(np.float32)

    def jrun(mode):
        return jax.jit(lambda p, x, c: japply(p, x, cj, mode=mode,
                                              layer_cache=c))

    want, _ = jrun("train")(pj, jnp.asarray(x), None)
    got, cache = tapply(pt, _t(x), ct, mode="train")
    assert cache is None
    _close(got, want, TOL, "train")
    jc, tc = jcache(cj, B), tcache(ct, B)
    want, jc = jrun("prefill")(pj, jnp.asarray(x[:, :S]), jc)
    got, tc = tapply(pt, _t(x[:, :S]), ct, mode="prefill", layer_cache=tc)
    _close(got, want, TOL, "prefill")
    outs = [got]
    for t in range(S, S + G):
        want, jc = jrun("decode")(pj, jnp.asarray(x[:, t:t + 1]), jc)
        got, tc = tapply(pt, _t(x[:, t:t + 1]), ct, mode="decode",
                         layer_cache=tc)
        _close(got, want, TOL, f"decode t={t}")
        outs.append(got)
    assert set(tc) == set(jc)
    for k in tc:
        _close(tc[k], jc[k], TOL, f"cache {k}")
    # continuity: prefill then decode is the one-pass train output
    full, _ = tapply(pt, _t(x), ct, mode="train")
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=2e-4,
                               atol=2e-4)


def test_mlstm_block_past_one_chunk():
    """A prefill longer than the block's chunk of 256 (a ragged second
    chunk), against the reference."""
    cj, ct, pj, pt, japply, jcache, tapply, tcache = _block("mlstm", 1)
    x = (0.5 * np.random.default_rng(7).standard_normal(
        (1, 300, cj.d_model))).astype(np.float32)
    jc = jcache(cj, 1)
    want, jc = japply(pj, jnp.asarray(x), cj, mode="prefill", layer_cache=jc)
    got, tc = tapply(pt, _t(x), ct, mode="prefill",
                     layer_cache=tcache(ct, 1))
    _close(got, want, TOL, "prefill out")
    for k in tc:
        _close(tc[k], jc[k], 1e-4, f"cache {k}")


def test_slstm_state_starts_at_ones():
    cj, ct = _cfgs()
    tc = recurrent.init_slstm_cache(ct, 3, "cpu")
    assert bool((tc["n"] == 1).all()) and bool((tc["c"] == 0).all())
    np.testing.assert_array_equal(tc["n"].numpy(),
                                  np.asarray(jrec.init_slstm_cache(cj, 3)["n"]))


# ---------------------------------------------------------------------------
# gradients: jax.grad against torch.autograd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_grad_matches_reference(kind):
    cj, ct, pj, pt, japply, _, tapply, _ = _block(kind, 2)
    B, S = 2, 40
    rng = np.random.default_rng(8)
    x = (0.5 * rng.standard_normal((B, S, cj.d_model))).astype(np.float32)
    w = rng.standard_normal((B, S, cj.d_model)).astype(np.float32)

    def jloss(p, x):
        y, _ = japply(p, x, cj, mode="train")
        return jnp.sum(y * w)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(pj, jnp.asarray(x))
    leaves, treedef = tree_flatten(pt)
    leaves = [t.clone().requires_grad_() for t in leaves]
    xt = _t(x).requires_grad_()
    y, _ = tapply(tree_unflatten(treedef, leaves), xt, ct, mode="train")
    grads = torch.autograd.grad((y * _t(w)).sum(), leaves + [xt])
    want = jax.tree.leaves(_np(jg)) + [np.asarray(jgx)]
    assert len(grads) == len(want)
    for i, (g, wv) in enumerate(zip(grads, want)):
        scale = float(np.abs(wv).max())
        assert scale > 0, f"leaf {i}: zero gradient"
        _close(g, wv, GRAD_RTOL * scale, f"{kind} grad leaf {i}")


def test_mlstm_chunked_grad_matches_reference():
    """The gradient through several chunks, a pad and a carry in."""
    args = _mlstm_inputs(11, 2, 40, 2, 8)
    wt = np.random.default_rng(12).standard_normal((2, 40, 2, 8)).astype(
        np.float32)

    def jloss(*a):
        h, C, n, m = jrec.mlstm_chunked(*a, chunk=16)
        return jnp.sum(h * wt) + jnp.sum(C) + jnp.sum(n) + jnp.sum(m)

    want = jax.grad(jloss, argnums=tuple(range(8)))(*map(jnp.asarray, args))
    ts = [_t(a).requires_grad_() for a in args]
    h, C, n, m = recurrent.mlstm_chunked(*ts, chunk=16)
    loss = (h * _t(wt)).sum() + C.sum() + n.sum() + m.sum()
    got = torch.autograd.grad(loss, ts)
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(np.abs(np.asarray(w)).max())
        _close(g, w, GRAD_RTOL * scale, f"mlstm_chunked grad arg {i}")


def test_xlstm_model_loss_and_grad_bf16():
    """Reduced xlstm-350m in bf16 (the working dtype at full width), a
    sequence past one mLSTM chunk: the loss within 1e-3 and each leaf's
    gradient within 3% of its largest |gradient| (about 8 bf16 ulps: the
    two frameworks round the matmul outputs to bf16 at other places, and
    the backward carries those differences through 2 layers)."""
    from repro.models.transformer import Transformer as JTransformer
    from repro_torch.models.transformer import Transformer
    cj, ct = _cfgs()
    cj = dataclasses.replace(cj, dtype="bfloat16")
    ct = dataclasses.replace(ct, dtype="bfloat16")
    jm = JTransformer(cj)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(3))
    tp = bridge.transformer_params_from_numpy(ct, _np(jp))
    toks = np.random.default_rng(9).integers(0, cj.vocab_size, (2, 300))
    b = {"tokens": toks, "labels": np.roll(toks, -1, -1)}
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    leaves, treedef = tree_flatten(tp)
    leaves = [t.clone().requires_grad_() for t in leaves]
    tl = Transformer(ct).loss(tree_unflatten(treedef, leaves),
                              {k: _t(v) for k, v in b.items()})
    grads = torch.autograd.grad(tl, leaves)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-3
    want = jax.tree.leaves(jg)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.dtype == leaves[i].dtype
        w = np.asarray(w, np.float32)
        _close(g, w, 0.03 * float(np.abs(w).max()), f"bf16 grad leaf {i}")


def test_mlstm_grad_splits_ties_as_the_reference():
    """log_f = 0 and a constant log_i make every A[t, s] of a chunk equal
    and m0 equal to them: `torch.amax` and `torch.maximum` must split the
    gradient among the ties as `A.max` and `jnp.maximum` do (a
    `Tensor.max(dim)` would send it all to one index)."""
    B, S, H, hd = 1, 12, 2, 4
    q, k, v, _, _, C0, n0, _ = _mlstm_inputs(13, B, S, H, hd)
    log_i = np.full((B, S, H), 0.5, np.float32)
    log_f = np.zeros((B, S, H), np.float32)
    m0 = np.full((B, H), 0.5, np.float32)
    args = (q, k, v, log_i, log_f, C0, n0, m0)

    def jloss(*a):
        h, C, n, m = jrec.mlstm_chunked(*a, chunk=4)
        return jnp.sum(h) + jnp.sum(m)

    want = jax.grad(jloss, argnums=(3, 4, 7))(*map(jnp.asarray, args))
    ts = [_t(a).requires_grad_() for a in args]
    h, C, n, m = recurrent.mlstm_chunked(*ts, chunk=4)
    got = torch.autograd.grad(h.sum() + m.sum(), [ts[3], ts[4], ts[7]])
    for g, w, what in zip(got, want, ("log_i", "log_f", "m0")):
        _close(g, w, 1e-5, what)
