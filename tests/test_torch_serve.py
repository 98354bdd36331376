"""The port's serve path (layers, RG-LRU, the Transformer with its
xLSTM blocks too, serve) against the JAX package on the CPU, on reduced
configs in f32 from the same params (JAX init -> numpy ->
`bridge.transformer_params_from_numpy`).

Tolerances: layers within 2e-5 max abs (f32, the two frameworks sum
matmuls in different orders); model logits within 5e-4 max abs and
greedy tokens equal; one bf16 forward within 3e-2 max abs on logits of
magnitude ~0.3 (a few bf16 ulps: both round every matmul output to bf16,
at different places in the causal conv and gelu).
"""
import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import list_archs
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import recurrent as jrec
from repro.models.transformer import Transformer as JTransformer
from repro_torch import bridge
from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.launch import serve as tserve
from repro_torch.models import layers, recurrent
from repro_torch.models.transformer import Transformer
from repro_torch.pytree import tree_leaves_with_path

LAYER_TOL = 2e-5
LOGIT_TOL = 5e-4


def _cfgs(arch, **kw):
    """(JAX cfg, port cfg): the reduced config in f32, plus overrides."""
    j = dataclasses.replace(jget_arch(arch).reduced(), dtype="float32", **kw)
    return j, ArchConfig(**dataclasses.asdict(j))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=0, err_msg=what)


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    x = _x(0, (2, 5, 48), 3.0)
    scale = _x(1, (48,)) + 1.0
    jx = jnp.asarray(x, dtype)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6)
    got = layers.rmsnorm({"scale": _t(scale)},
                         bridge.array_to_tensor(np.asarray(jx)), 1e-6)
    assert str(got.dtype) == f"torch.{dtype}"
    _close(got, np.asarray(want, np.float32),
           LAYER_TOL if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("offset", [0, 37, 4095])
def test_rope(offset):
    x = _x(2, (2, 7, 3, 16))
    pos = offset + np.arange(7)[None, :]
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = layers.rope(_t(x), _t(pos), 10_000.0)
    _close(got, want, LAYER_TOL)


def _attn_params(cfg_j, seed=0):
    p = _np(jlayers.attention_init(jax.random.PRNGKey(seed), cfg_j))
    return p, bridge.tree_from_numpy(p)


@pytest.mark.parametrize("window", [0, 6])
def test_attention_train(window):
    cj, ct = _cfgs("smollm-360m")
    pj, pt = _attn_params(cj)
    x = _x(3, (2, 13, cj.d_model))
    want, _ = jax.jit(lambda p, x: jlayers.attention_apply(
        p, x, cj, mode="train", window=window))(pj, jnp.asarray(x))
    got, cache = layers.attention_apply(pt, _t(x), ct, mode="train",
                                        window=window)
    assert cache is None
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("window,cache_len,S", [
    (0, 24, 10),      # full cache, no ring
    (8, 24, 5),       # ring larger than the prompt
    (8, 24, 19),      # prompt longer than the ring: last 8 kept
])
def test_attention_prefill_and_decode(window, cache_len, S):
    cj, ct = _cfgs("starcoder2-7b", window_size=window or 4096)
    pj, pt = _attn_params(cj, seed=1)
    B = 2
    x = _x(4, (B, S + 12, cj.d_model))
    jc = jlayers.init_attention_cache(cj, B, cache_len, window, jnp.float32)
    tc = layers.init_attention_cache(ct, B, cache_len, window, torch.float32,
                                     "cpu")
    assert tuple(tc["k"].shape) == jc["k"].shape
    def japply(mode):
        return jax.jit(lambda p, x, c: jlayers.attention_apply(
            p, x, cj, mode=mode, layer_cache=c, window=window))
    want, jc = japply("prefill")(pj, jnp.asarray(x[:, :S]), jc)
    got, tc = layers.attention_apply(pt, _t(x[:, :S]), ct, mode="prefill",
                                     layer_cache=tc, window=window)
    _close(got, want, LAYER_TOL, "prefill out")
    _close(tc["k"], jc["k"], LAYER_TOL, "prefill cache k")
    _close(tc["v"], jc["v"], LAYER_TOL, "prefill cache v")
    assert tc["pos"] == int(jc["pos"]) == S
    jdecode = japply("decode")
    for t in range(S, S + 12):       # the ring wraps on the way
        want, jc = jdecode(pj, jnp.asarray(x[:, t:t + 1]), jc)
        got, tc = layers.attention_apply(pt, _t(x[:, t:t + 1]), ct,
                                         mode="decode", layer_cache=tc,
                                         window=window)
        _close(got, want, LAYER_TOL, f"decode out t={t}")
    _close(tc["k"], jc["k"], LAYER_TOL, "decode cache k")
    assert tc["pos"] == int(jc["pos"])


def test_mlp():
    cj, ct = _cfgs("smollm-360m")
    pj = _np(jlayers.mlp_init(jax.random.PRNGKey(2), cj.d_model, cj.d_ff, cj))
    x = _x(5, (2, 9, cj.d_model))
    want = jax.jit(lambda p, x: jlayers.mlp_apply(p, x, cj))(
        pj, jnp.asarray(x))
    got = layers.mlp_apply(bridge.tree_from_numpy(pj), _t(x), ct)
    _close(got, want, LAYER_TOL)


def test_rglru_train_and_decode():
    cj, ct = _cfgs("recurrentgemma-9b")
    pj = _np(jrec.rglru_init(jax.random.PRNGKey(3), cj))
    pt = bridge.tree_from_numpy(pj)
    B, S = 2, 11
    x = _x(6, (B, S + 5, cj.d_model))
    def japply(mode):
        return jax.jit(lambda p, x, c: jrec.rglru_apply(
            p, x, cj, mode=mode, layer_cache=c))
    want, _ = japply("train")(pj, jnp.asarray(x), None)
    got, _ = recurrent.rglru_apply(pt, _t(x), ct, mode="train")
    _close(got, want, LAYER_TOL, "train")
    jc = jrec.init_rglru_cache(cj, B, jnp.float32)
    tc = recurrent.init_rglru_cache(ct, B, torch.float32, "cpu")
    want, jc = japply("prefill")(pj, jnp.asarray(x[:, :S]), jc)
    got, tc = recurrent.rglru_apply(pt, _t(x[:, :S]), ct, mode="prefill",
                                    layer_cache=tc)
    _close(got, want, LAYER_TOL, "prefill")
    jdecode = japply("decode")
    for t in range(S, S + 5):
        want, jc = jdecode(pj, jnp.asarray(x[:, t:t + 1]), jc)
        got, tc = recurrent.rglru_apply(pt, _t(x[:, t:t + 1]), ct,
                                        mode="decode", layer_cache=tc)
        _close(got, want, LAYER_TOL, f"decode t={t}")
    _close(tc["h"], jc["h"], LAYER_TOL, "state h")
    _close(tc["conv"], jc["conv"], LAYER_TOL, "conv state")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

MODELS = {
    "recurrentgemma-9b": {},
    "smollm-360m": {},
    # hd 80 as at full width (d_model 2560 over 32 heads), which the
    # flash kernels run in their 128 build
    "stablelm-3b": {"head_dim": 80},
    "starcoder2-7b": {"window_size": 8},     # ring wraps several times
    "xlstm-350m": {},                        # mlstm, slstm
}


@functools.lru_cache(maxsize=None)
def _model(arch, dtype="float32", **kw):
    """Both models on the same params: the reference's init from
    PRNGKey(0), carried across through the bridge."""
    cj, ct = _cfgs(arch, **kw)
    if dtype != "float32":
        cj = dataclasses.replace(cj, dtype=dtype)
        ct = dataclasses.replace(ct, dtype=dtype)
    jm = JTransformer(cj)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = bridge.transformer_params_from_numpy(ct, _np(jp), "cpu")
    return cj, jm, jp, ct, Transformer(ct), tp


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_model_forward_prefill_decode(arch):
    cj, jm, jp, ct, tm, tp = _model(arch, **MODELS[arch])
    B, P, S = 2, 12, 30
    tokens = np.random.default_rng(7).integers(0, cj.vocab_size, (B, S))
    batch = {"tokens": jnp.asarray(tokens)}
    want, want_aux = jax.jit(jm.forward)(jp, batch)
    got, aux = tm.forward(tp, {"tokens": _t(tokens)})
    _close(got, want, LOGIT_TOL, "forward")
    assert float(aux) == float(want_aux) == 0.0         # no MoE

    jc = jm.init_cache(B, S)
    tc = tm.init_cache(B, S, "cpu")
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    jl, jc = prefill(jp, {"tokens": jnp.asarray(tokens[:, :P])}, jc)
    tl, tc = tm.prefill(tp, {"tokens": _t(tokens[:, :P])}, tc)
    _close(tl, jl, LOGIT_TOL, "prefill")
    jtok = np.asarray(jnp.argmax(jl[:, -1], -1))
    np.testing.assert_array_equal(torch.argmax(tl[:, -1], -1).numpy(), jtok)
    for t in range(P, S):
        jl, jc = decode(jp, jnp.asarray(jtok[:, None]), jc)
        tl, tc = tm.decode_step(tp, _t(jtok[:, None]), tc)
        _close(tl, jl, LOGIT_TOL, f"decode t={t}")
        jtok = np.asarray(jnp.argmax(jl[:, -1], -1))
        np.testing.assert_array_equal(torch.argmax(tl[:, -1], -1).numpy(),
                                      jtok)


def test_model_forward_bf16():
    cj, jm, jp, ct, tm, tp = _model("recurrentgemma-9b", dtype="bfloat16")
    tokens = np.random.default_rng(8).integers(0, cj.vocab_size, (2, 20))
    want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tokens)})
    got, _ = tm.forward(tp, {"tokens": _t(tokens)})
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), 3e-2)


def test_bridge_checks_paths_shapes_dtypes():
    cj, _, jp, ct, _, _ = _model("recurrentgemma-9b")
    jp = _np(jp)
    bad = dict(jp, extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="keys"):
        bridge.transformer_params_from_numpy(ct, bad)
    bad = dict(jp, final_norm={"scale": np.zeros(5, np.float32)})
    with pytest.raises(ValueError, match="final_norm/scale"):
        bridge.transformer_params_from_numpy(ct, bad)
    bf = _np(_model("recurrentgemma-9b", dtype="bfloat16")[2])
    with pytest.raises(ValueError, match="bfloat16"):
        bridge.transformer_params_from_numpy(ct, bf)
    tbl = bf["embed"]["table"]
    got = bridge.array_to_tensor(tbl)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  tbl.view(np.int16))


@pytest.mark.parametrize("arch", list_archs())
def test_meta_init_matches_reference(arch):
    """Every config builds in the port, full and reduced: its meta init
    is the reference's tree leaf for leaf (paths, shapes, dtypes; from
    `jax.eval_shape`, nothing allocated) and its analytic param count
    the reference's (qwen3-moe-30b-a3b: 30,220,746,752)."""
    for reduce in (False, True):
        cj = jget_arch(arch).reduced() if reduce else jget_arch(arch)
        ct = get_arch(arch).reduced() if reduce else get_arch(arch)
        assert ct.param_count() == cj.param_count()
        want = jax.eval_shape(JTransformer(cj).init, jax.random.PRNGKey(0))
        got = Transformer(ct).init(None, "meta")
        wl = jax.tree.leaves_with_path(want)
        gl = tree_leaves_with_path(got)
        assert len(gl) == len(wl)
        for (wp, w), (gp, g) in zip(wl, gl):
            assert "/".join(gp) == "/".join(k.key for k in wp)
            assert tuple(g.shape) == tuple(w.shape), gp
            assert str(g.dtype).split(".")[1] == str(w.dtype), gp
            assert g.device.type == "meta"
    assert get_arch("qwen3-moe-30b-a3b").param_count() == 30_220_746_752


@pytest.mark.parametrize("leaf", ["dense", "embedding"])
def test_chunked_init_draws_the_same_law(leaf, monkeypatch):
    """`normal_init` draws a leaf larger than DRAW_ELEMENTS in blocks of
    whole rows: a stacked `dense_init` leaf keeps its shape, dtype and
    N(0, 1/fan_in) law, an embedding table N(0, 0.01^2), whatever the
    block; every row is written."""
    lead, shape, fan_in = (3,), (5, 64, 40), 64
    full = lead + shape
    n = math.prod(full)
    scale = 1.0 / math.sqrt(fan_in) if leaf == "dense" else 0.01
    dtype = torch.bfloat16 if leaf == "dense" else torch.float32

    def draw(block):
        monkeypatch.setattr(layers, "DRAW_ELEMENTS", block)
        gen = torch.Generator().manual_seed(0)
        if leaf == "dense":
            return layers.dense_init(gen, shape, fan_in, dtype, "cpu", lead)
        return layers.normal_init(gen, full, scale, dtype, "cpu")

    for block in (1, 40 * 7, 10_000, n):
        got = draw(block)
        assert got.shape == full and got.dtype == dtype
        z = got.float() / scale
        assert abs(float(z.mean())) < 0.02
        assert abs(float(z.std()) - 1.0) < 0.02
        # every row drawn: no zero row left unwritten
        assert bool((z.reshape(-1, 40).abs().sum(-1) > 0).all())
    meta = layers.normal_init(None, full, scale, dtype, "meta")
    assert meta.shape == full and meta.device.type == "meta"


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def test_serve_matches_reference(monkeypatch):
    """The same params and request through both `serve`s (reduced
    recurrentgemma in f32, prompt past the window of 64)."""
    arch, B, P, G = "recurrentgemma-9b", 2, 72, 6

    def f32_arch(name):
        return dataclasses.replace(jget_arch(name), dtype="float32")
    monkeypatch.setattr(jserve, "get_arch", f32_arch)
    monkeypatch.setattr(tserve, "get_arch", lambda name: ArchConfig(
        **dataclasses.asdict(f32_arch(name))))
    cj, _, jp, _, _, tp = _model(arch)
    _, k_req, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    tokens = np.asarray(jserve.make_request_batch(k_req, cj, B, P)["tokens"])
    want = jserve.serve(arch, batch=B, prompt_len=P, gen_len=G, params=jp,
                        verbose=False)
    got = tserve.serve(arch, batch=B, prompt_len=P, gen_len=G, params=tp,
                       device="cpu", tokens=_t(tokens), verbose=False)
    assert set(want) <= set(got)
    assert got["output_shape"] == want["output_shape"] == [B, G]
    assert got["output_sample"] == want["output_sample"]
    assert got["logits_finite"]
    assert got["launches"] == {"prefill": {}, "decode": {}}   # plain, CPU


def test_serve_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve("smollm-360m", batch=1, prompt_len=4, gen_len=2,
                     verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "smollm-360m", "--batch", "1",
                     "--prompt-len", "4", "--gen-len", "2"])


def test_serve_cli_on_cpu(tmp_path):
    out = tmp_path / "rec.json"
    tserve.main(["--arch", "recurrentgemma-9b", "--batch", "2",
                 "--prompt-len", "70", "--gen-len", "3", "--device", "cpu",
                 "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["output_shape"] == [2, 3] and rec["logits_finite"]
