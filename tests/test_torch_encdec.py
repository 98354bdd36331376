"""The port's model families of the MoE, encoder-decoder and prefix-input
slice against the JAX package on the CPU: attention in mode "encode"
and cross-attention (`memory_kv`), then `Transformer` forward (logits
and the MoE aux), loss and gradients for reduced qwen3-moe-30b-a3b,
arctic-480b, seamless-m4t-large-v2, llava-next-34b and smollm-360m
overridden to input_mode "embeddings"; the port's prefill + decode
against its own teacher forcing; and `serve` against the reference's
`serve` from the same params and request (tokens, prefix, frames); and
one mesh round of each family through `experiments`' mesh driver.
Reduced configs in f32, params from the reference's init through the
bridge, inputs from numpy seeds.

Tolerances (f32; the frameworks sum matmuls in other orders): layers
within 2e-5 max abs; logits, the aux, the loss and every gradient leaf
within 5e-4 max abs (the serve tests' logit rule); prefill + decode
within 2e-4 of teacher forcing (the reference's own rule, dropless MoE:
decode's capacity drops are the reference's semantics and differ from
a full-sequence forward by design); greedy tokens equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models.transformer import Transformer as JTransformer
from repro_torch import bridge
from repro_torch.configs.base import ArchConfig
from repro_torch.experiments import build, get_scenario, override
from repro_torch.experiments import run_prepared
from repro_torch.launch import serve as tserve
from repro_torch.models import layers
from repro_torch.models.transformer import Transformer
from repro_torch.pytree import tree_flatten, tree_unflatten

LAYER_TOL = 2e-5
LOGIT_TOL = 5e-4
DECODE_TOL = 2e-4
B, S = 2, 12

# name -> (arch, overrides)
MODELS = {
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}),
    "arctic-480b": ("arctic-480b", {}),
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2", {}),
    "llava-next-34b": ("llava-next-34b", {}),
    "smollm-embeddings": ("smollm-360m", {"input_mode": "embeddings"}),
}


def _cfgs(arch, **kw):
    j = dataclasses.replace(jget_arch(arch).reduced(), dtype="float32", **kw)
    return j, ArchConfig(**dataclasses.asdict(j))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=0,
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _model(name, dropless=False):
    arch, kw = MODELS[name]
    cj, ct = _cfgs(arch, **kw)
    if dropless and cj.num_experts:
        cf = float(cj.num_experts) / cj.experts_per_token
        cj = dataclasses.replace(cj, moe_capacity_factor=cf)
        ct = dataclasses.replace(ct, moe_capacity_factor=cf)
    jm = JTransformer(cj)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = bridge.transformer_params_from_numpy(ct, _np(jp), "cpu")
    return cj, jm, jp, ct, Transformer(ct), tp


def _batch(cfg, seed, s=S):
    """Numpy inputs of one batch: tokens and labels (some masked), and
    the prefix, frames or embeddings the config takes."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=-1)
    labels[0, 3:5] = -1
    out = {"tokens": toks, "labels": labels}
    if cfg.input_mode == "tokens+prefix":
        out["prefix"] = _x(seed + 1, (B, cfg.prefix_len, cfg.d_model), 0.1)
    if cfg.input_mode == "embeddings":
        out["embeddings"] = _x(seed + 1, (B, s, cfg.d_model))
    if cfg.encoder_layers:
        out["frames"] = _x(seed + 2, (B, cfg.encoder_memory_len, cfg.d_model),
                           0.1)
    return out


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: _t(v).to(torch.int64) if v.dtype.kind == "i" else _t(v)
            for k, v in b.items()}


# ---------------------------------------------------------------------------
# attention: "encode" and cross-attention
# ---------------------------------------------------------------------------

def _attn(cj, seed=0):
    p = _np(jlayers.attention_init(jax.random.PRNGKey(seed), cj))
    return p, bridge.tree_from_numpy(p)


def test_attention_encode_matches_reference():
    cj, ct = _cfgs("seamless-m4t-large-v2", num_kv_heads=2)
    pj, pt = _attn(cj)
    x = _x(3, (B, 13, cj.d_model))
    want, _ = jax.jit(lambda p, x: jlayers.attention_apply(
        p, x, cj, mode="encode"))(pj, jnp.asarray(x))
    got, cache = layers.attention_apply(pt, _t(x), ct, mode="encode")
    assert cache is None
    _close(got, want, LAYER_TOL)
    causal, _ = layers.attention_apply(pt, _t(x), ct, mode="train")
    assert float((causal - got).abs().max()) > 1e-3    # not causal


@pytest.mark.parametrize("mode,s", [("train", 13), ("prefill", 13),
                                    ("decode", 1)])
def test_cross_attention_matches_reference(mode, s):
    """q from x, no RoPE; the memory's k and v (GQA, M = 40) given."""
    cj, ct = _cfgs("seamless-m4t-large-v2", num_kv_heads=2)
    pj, pt = _attn(cj, seed=1)
    x = _x(4, (B, s, cj.d_model))
    hd = cj.resolved_head_dim
    k = _x(5, (B, 40, 2, hd))
    v = _x(6, (B, 40, 2, hd))
    want, _ = jax.jit(lambda p, x, k, v: jlayers.attention_apply(
        p, x, cj, mode=mode, memory_kv=(k, v)))(
        pj, jnp.asarray(x), jnp.asarray(k), jnp.asarray(v))
    got, cache = layers.attention_apply(pt, _t(x), ct, mode=mode,
                                        memory_kv=(_t(k), _t(v)))
    assert cache is None
    _close(got, want, LAYER_TOL)


# ---------------------------------------------------------------------------
# the model: forward, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_loss_and_grads_match_reference(name):
    cj, jm, jp, ct, tm, tp = _model(name)
    b = _batch(cj, 7)
    want, want_aux = jax.jit(jm.forward)(jp, _jax(b))
    got, aux = tm.forward(tp, _torch(b))
    off = cj.prefix_len if cj.input_mode == "tokens+prefix" else 0
    assert tuple(got.shape) == (B, off + S, cj.vocab_size)
    _close(got, want, LOGIT_TOL, "logits")
    _close(aux, want_aux, LOGIT_TOL, "aux")
    assert (float(aux) > 0) == bool(cj.num_experts)

    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, _jax(b))
    leaves, treedef = tree_flatten(tp)
    leaves = [x.clone().requires_grad_() for x in leaves]
    assert tm.cfg.remat
    tl = tm.loss(tree_unflatten(treedef, leaves), _torch(b))
    grads = torch.autograd.grad(tl, leaves)
    _close(tl, jl, LOGIT_TOL, "loss")
    want_g = jax.tree.leaves(jg)
    assert len(want_g) == len(grads)
    for i, (g, w) in enumerate(zip(grads, want_g)):
        _close(g, w, LOGIT_TOL, f"grad leaf {i}")


# ---------------------------------------------------------------------------
# prefill + decode against teacher forcing (the port's own)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "arctic-480b",
                                  "seamless-m4t-large-v2", "llava-next-34b"])
def test_decode_matches_teacher_forcing(name):
    _, _, _, ct, tm, tp = _model(name, dropless=True)
    s, P = 20, 6
    b = _torch(_batch(ct, 8, s))
    off = ct.prefix_len if ct.input_mode == "tokens+prefix" else 0
    with torch.no_grad():
        full, _ = tm.forward(tp, b)
        memory = tm.encode(tp, b["frames"]) if ct.encoder_layers else None
        cache = tm.init_cache(B, s + off, "cpu", memory=memory, params=tp)
        if ct.cross_attention:
            assert tuple(cache["cross_kv"]["b0"].shape) == (
                ct.num_layers, 2, B, ct.encoder_memory_len, ct.num_kv_heads,
                ct.resolved_head_dim)
        pre = dict(b, tokens=b["tokens"][:, :P])
        lg, cache = tm.prefill(tp, pre, cache)
        _close(lg[:, 0], full[:, off + P - 1], DECODE_TOL, "prefill")
        for t in range(P, s):
            lg, cache = tm.decode_step(tp, b["tokens"][:, t:t + 1], cache)
            _close(lg[:, 0], full[:, off + t], DECODE_TOL, f"decode t={t}")


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "seamless-m4t-large-v2", "llava-next-34b"])
def test_serve_matches_reference(arch, monkeypatch):
    """Both `serve`s on the same params and request (the reference's
    own draw of tokens, prefix and frames); qwen3 at cf 1.25, so decode
    drops picks on both sides."""
    P, G = 10, 6

    def f32_arch(name):
        return dataclasses.replace(jget_arch(name), dtype="float32")
    monkeypatch.setattr(jserve, "get_arch", f32_arch)
    monkeypatch.setattr(tserve, "get_arch", lambda name: ArchConfig(
        **dataclasses.asdict(f32_arch(name))))
    cj, _, jp, _, _, tp = _model(arch)
    _, k_req, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    req = {k: _t(v) for k, v in _np(jserve.make_request_batch(
        k_req, cj, B, P)).items() if k != "labels"}
    want = jserve.serve(arch, batch=B, prompt_len=P, gen_len=G, params=jp,
                        verbose=False)
    got = tserve.serve(arch, batch=B, prompt_len=P, gen_len=G, params=tp,
                       device="cpu", verbose=False, **req)
    assert got["output_shape"] == want["output_shape"] == [B, G]
    assert got["output_sample"] == want["output_sample"]
    assert got["logits_finite"]
    if len(req) == 1:
        return
    with pytest.raises(ValueError, match="expected"):     # prefix/frames
        tserve.serve(arch, batch=B, prompt_len=P, gen_len=G, params=tp,
                     device="cpu", verbose=False, tokens=req["tokens"])


# ---------------------------------------------------------------------------
# the mesh driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "arctic-480b",
                                  "seamless-m4t-large-v2", "llava-next-34b"])
def test_mesh_run_on_the_new_families(arch):
    """`experiments.run`'s mesh driver on each family, reduced, on the
    CPU: its batches carry the zero prefix and N(0, 1) frames the config
    takes (as the reference's), and a round trains to finite losses."""
    spec = override(get_scenario("mesh/smollm-smoke"), f"model.name={arch}",
                    "run.rounds=1", "model.seq_len=16")
    prep = build(spec, device="cpu")
    cfg = prep.aux["arch_cfg"]
    wb = prep.draw(prep.state)[0]
    W, Bw = spec.data.num_workers, spec.model.per_worker_batch
    want = {"tokens", "labels"}
    if cfg.input_mode == "tokens+prefix":
        want.add("prefix")
        assert tuple(wb["prefix"].shape) == (W, Bw, cfg.prefix_len,
                                             cfg.d_model)
        assert not bool(wb["prefix"].any())
    if cfg.encoder_layers:
        want.add("frames")
        assert tuple(wb["frames"].shape) == (W, Bw, cfg.encoder_memory_len,
                                             cfg.d_model)
        assert 0.5 < float(wb["frames"].float().std()) < 1.5
    assert set(wb) == want
    rec = run_prepared(prep, verbose=False).record
    assert len(rec["global_loss"]) == 1
    assert all(np.isfinite(rec["global_loss"]))
