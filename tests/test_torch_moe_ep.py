"""The port's expert-parallel MoE dispatch (`models/moe_ep.py`) against
the dense dispatch, dropless, on the CPU in f32.

- `_pack` is bitwise the reference's `_pack` (buffers and slots) for its
  round-trip, overflow and valid-mask cases.
- The EP stages driven for n virtual shards in one process (n = 2 and 4;
  the exchange is a tiled all-to-all: `buf.view(n, n, cap, D)
  .transpose(0, 1)`) equal the port's `moe_apply` and the JAX
  `moe_apply` on the reference's EP test config (reduced
  qwen3-moe-30b-a3b, E 8, K 2, cf 4 = E / K: dropless), as that test
  compares EP with the dense dispatch.
- A 2-rank gloo group runs `moe_apply` on DTensors under EP rules, so
  through `moe_apply_ep` and real `all_to_all_single`, to the same
  result and gradients.

Tolerances (f32; the EP path sums the aux's statistics per shard and the
dense one over all tokens, and the products in other groupings): y
within 1e-5 max abs, the aux within 1e-6 (equal up to that summation
order), gradients of sum(y r) + aux within 1e-5 x max(1, the leaf's
largest |g|) (ROADMAP's MoE rule: the norm scale's and the experts'
gradients reach |g| of a few units); the two-rank run against the
virtual shards within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.moe_ep import _pack as jpack
from repro_torch import bridge
from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe, moe_ep
from repro_torch.models.layers import rmsnorm
from torch_mesh_worker import moe_cfg, spawn

Y_TOL, AUX_TOL, GRAD_TOL = 1e-5, 1e-6, 1e-5
B, S = 8, 16


# --- _pack ------------------------------------------------------------------

PACK_CASES = {
    "roundtrip": ([2, 0, 1, 2, 0, 1, 1, 3], 4, 3, None),
    "overflow": ([0, 0, 0, 0, 0], 2, 2, None),
    "valid": ([0, 1, 0, 1], 2, 2, [True, False, True, True]),
}


@pytest.mark.parametrize("name", sorted(PACK_CASES))
def test_pack_matches_reference_bitwise(name):
    ids, n_bins, cap, valid = PACK_CASES[name]
    M = len(ids)
    vals = (np.arange(M, dtype=np.float32)[:, None]
            * np.arange(1, 4, dtype=np.float32))
    jb, js = jpack(jnp.array(ids), n_bins, cap, {"x": jnp.asarray(vals)},
                   valid=None if valid is None else jnp.array(valid))
    pb, pslot = moe_ep._pack(torch.tensor(ids), n_bins, cap,
                             {"x": torch.from_numpy(vals)},
                             valid=None if valid is None
                             else torch.tensor(valid))
    np.testing.assert_array_equal(pslot.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pb["x"].numpy(), np.asarray(jb["x"]))
    if name == "roundtrip":                       # full inversion
        flat = torch.cat([pb["x"].reshape(-1, 3), torch.zeros(1, 3)])
        np.testing.assert_array_equal(flat[pslot].numpy(), vals)
    if name == "overflow":
        assert int((pslot == n_bins * cap).sum()) == 3


# --- the stages over n virtual shards ---------------------------------------

def ep_virtual(params, h, cfg, n):
    """moe_apply_ep's arithmetic for n shards in one process: each stage
    per shard, the exchanges as a tiled all-to-all."""
    Bh, Sh, D = h.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    El, T = E // n, Bh * Sh
    cap_send, cap_local = moe_ep.capacities(T, cfg, n)
    hs = [x.reshape(-1, D) for x in h.chunk(n)]
    routes = [moe_ep.route(x, params["router"], K) for x in hs]
    aux = moe_ep.aux_loss(sum(moe_ep.aux_stats(p, i, E) for p, _, i in
                              routes), T, cfg)
    packs = [moe_ep.pack_send(x, i, El, n, cap_send)
             for x, (_, _, i) in zip(hs, routes)]

    def exchange(bufs):                     # [src] (n, cap, ...) -> [dst]
        st = torch.stack(bufs)
        return list(st.view((n, n) + tuple(st.shape[2:])).transpose(0, 1))

    rx, re, rv = (exchange([p[k] for p, _ in packs]) for k in "xev")
    w = {k: params[k].chunk(n) for k in ("wi", "wu", "wo")}
    backs = [moe_ep.expert_ffn(rx[s].reshape(n * cap_send, D),
                               re[s].reshape(-1), rv[s].reshape(-1), s, El,
                               cap_local, w["wi"][s], w["wu"][s], w["wo"][s])
             for s in range(n)]
    origin = exchange([b.view(n, cap_send, D) for b in backs])
    ys = [moe_ep.combine(origin[s].reshape(n * cap_send, D), packs[s][1],
                         routes[s][1], h.dtype) for s in range(n)]
    return torch.cat(ys).view(Bh, Sh, D), aux


def _setup():
    pc = moe_cfg()
    import dataclasses
    jc = dataclasses.replace(
        __import__("repro.configs.base", fromlist=["get_arch"])
        .get_arch("qwen3-moe-30b-a3b").reduced(), dtype="float32",
        num_experts=8, experts_per_token=2, moe_capacity_factor=4.0)
    assert ArchConfig(**dataclasses.asdict(jc)) == pc
    pj = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(1)
    x = (0.1 * rng.standard_normal((B, S, pc.d_model))).astype(np.float32)
    r = rng.standard_normal((B, S, pc.d_model)).astype(np.float32)
    return jc, pc, pj, x, r


def _leaves(p, x):
    return [x, p["router"], p["wi"], p["wu"], p["wo"], p["norm"]["scale"]]


def _grads(fn, p, x, r):
    """(y, aux, gradients of sum(y r) + aux w.r.t. _leaves)."""
    xs = [t.detach().clone().requires_grad_() for t in _leaves(p, x)]
    q = dict(p, router=xs[1], wi=xs[2], wu=xs[3], wo=xs[4],
             norm={"scale": xs[5]})
    y, aux = fn(q, xs[0])
    g = torch.autograd.grad((y * r).sum() + aux, xs)
    return y.detach(), aux.detach(), [t.numpy() for t in g]


def _ep_fn(cfg, n):
    def fn(p, x):
        h = rmsnorm(p["norm"], x, cfg.norm_eps)
        return ep_virtual(p, h, cfg, n)
    return fn


def _check_grads(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        tol = GRAD_TOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=f"{what} leaf {i}")


@pytest.fixture(scope="module")
def setup():
    return _setup()


@pytest.mark.parametrize("n", [2, 4])
def test_virtual_shards_match_dense_dispatch(setup, n):
    jc, pc, pj, x, r = setup
    p = bridge.tree_from_numpy(pj)
    xt, rt = torch.from_numpy(x), torch.from_numpy(r)
    y, aux, g = _grads(_ep_fn(pc, n), p, xt, rt)
    yd, auxd, gd = _grads(lambda q, v: moe.moe_apply(q, v, pc), p, xt, rt)
    np.testing.assert_allclose(y.numpy(), yd.numpy(), rtol=0, atol=Y_TOL)
    assert abs(float(aux) - float(auxd)) <= AUX_TOL
    _check_grads(g, gd, f"port dense, n {n}")

    def jloss(q, v):
        yy, a = jmoe.moe_apply(q, v, jc)
        return (yy * r).sum() + a, (yy, a)
    (_, (yj, auxj)), gj = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jax.tree.map(jnp.asarray, pj), jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=0, atol=Y_TOL)
    assert abs(float(aux) - float(auxj)) <= AUX_TOL
    gq, gx = gj
    _check_grads(g, [np.asarray(t) for t in (
        gx, gq["router"], gq["wi"], gq["wu"], gq["wo"],
        gq["norm"]["scale"])], f"reference dense, n {n}")


def test_two_ranks_all_to_all_match_virtual_shards(setup, tmp_path):
    """Two gloo ranks, `moe_apply` on DTensors under EP rules: the real
    all-to-all gives the virtual shards' y, aux and gradients."""
    jc, pc, pj, x, r = setup
    inputs = str(tmp_path / "in.npz")
    np.savez(inputs, x=x, r=r, p_router=pj["router"], p_wi=pj["wi"],
             p_wu=pj["wu"], p_wo=pj["wo"], p_norm=pj["norm"]["scale"])
    got = spawn("moe_ep", (2,), ("data",), str(tmp_path / "out.npz"),
                inputs, timeout_s=90)
    p = bridge.tree_from_numpy(pj)
    y, aux, g = _grads(_ep_fn(pc, 2), p, torch.from_numpy(x),
                       torch.from_numpy(r))
    np.testing.assert_allclose(got["y"], y.numpy(), rtol=0, atol=1e-6)
    assert abs(float(got["aux"]) - float(aux)) <= 1e-6
    names = ["x", "router", "wi", "wu", "wo", "norm"]
    for k, want in zip(names, g):
        tol = 1e-6 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got[f"g_{k}"], want, rtol=0, atol=tol,
                                   err_msg=k)


def test_capacities_and_applicability():
    """Both capacities as the reference's (moe_ep.py:85-86), and when the
    dispatch applies."""
    import math
    from repro_torch.sharding.rules import ShardingRules

    class M:
        shape = {"data": 4, "model": 2}
        axis_names = ("data", "model")
    cfg = moe_cfg(cf=1.25)
    T, n = 128, 4
    assert moe_ep.capacities(T, cfg, n) == (
        max(int(math.ceil(T // n * 2 / n * 1.25)), 1),
        max(int(math.ceil(T * 2 / 8 * 1.25)), 1))
    on = ShardingRules(expert="data", moe_ep=True)
    assert moe_ep.ep_applicable(cfg, M(), on) == "data"
    assert moe_ep.ep_applicable(cfg, M(), ShardingRules(on, moe_ep=False)
                                ) is None
    assert moe_ep.ep_applicable(cfg, M(), ShardingRules(on, expert="model")
                                ) == "model"
    assert moe_ep.ep_applicable(moe_cfg(E=6, K=2), M(), on) is None
    assert moe_ep.ep_applicable(cfg, None, on) is None
