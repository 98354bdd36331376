"""The port's MoE channel mixer (`models/moe.py`) against the JAX
package's `models/moe.py` on the CPU, in f32 from the same params (JAX
init -> numpy -> `bridge.tree_from_numpy`) and the same inputs.

Cases: reduced qwen3-moe-30b-a3b (4 experts, top 2) at the default
capacity factor 1.25 (the reference drops picks there; the test asserts
it), dropless (cf = E / K), at a decode-like T where the capacity is 1,
with Arctic's dense residual, and with a router that sends every token
to one expert (most picks dropped: the stable sort decides which).

Tolerances (f32; the two frameworks sum the matmuls and the k-sum in
other orders): y within 2e-5 max abs, the aux loss within 1e-6, and the
gradients of sum(y * r) + aux within 1e-5 x max(1, the leaf's largest
|gradient|) max abs (the norm scale's and the experts' gradients sum
hundreds of products per element and reach |g| ~ 4-10 here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe
from repro_torch.pytree import tree_flatten, tree_unflatten

Y_TOL = 2e-5
AUX_TOL = 1e-6
GRAD_TOL = 1e-5


def _cfgs(arch, **kw):
    j = dataclasses.replace(jget_arch(arch).reduced(), dtype="float32", **kw)
    return j, ArchConfig(**dataclasses.asdict(j))


def _params(cj, seed=0):
    pj = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed), cj))
    return pj, bridge.tree_from_numpy(pj)


def _x(seed, shape, scale=1.0, shift=0.0):
    return (shift + scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0, err_msg=what)


def _dropped(cj, pj, x):
    """Picks the reference drops at this input (its own arithmetic)."""
    B, S, D = x.shape
    T, E, K = B * S, cj.num_experts, cj.experts_per_token
    h = jmoe.rmsnorm(pj["norm"], jnp.asarray(x), cj.norm_eps).reshape(T, D)
    probs = jax.nn.softmax(h @ pj["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    counts = np.bincount(np.asarray(idx).reshape(-1), minlength=E)
    return int(np.maximum(counts - moe.capacity(T, cj), 0).sum())


CASES = {
    # (arch, overrides, (B, S), x shift): cf 1.25 drops picks
    "qwen3-cf1.25": ("qwen3-moe-30b-a3b", {}, (2, 4), 0.0),
    "qwen3-dropless": ("qwen3-moe-30b-a3b", {"moe_capacity_factor": 2.0},
                       (2, 24), 0.0),
    # one decode step at batch 4 over 16 experts top 2: capacity 1
    "qwen3-cap1": ("qwen3-moe-30b-a3b", {"num_experts": 16}, (4, 1), 0.0),
    "arctic-dense": ("arctic-480b", {}, (2, 24), 0.0),
    # every token routes to expert 0 (see _skew): most picks dropped
    "skewed": ("qwen3-moe-30b-a3b", {}, (3, 40), 1.0),
}


def _case(name):
    arch, kw, (B, S), shift = CASES[name]
    cj, ct = _cfgs(arch, **kw)
    pj, pt = _params(cj)
    if shift:
        pj = _skew(pj)
        pt = bridge.tree_from_numpy(pj)
    x = _x(1, (B, S, cj.d_model), 0.1 if shift else 1.0, shift)
    return cj, ct, pj, pt, x


def _skew(pj):
    """A router whose expert 0 scores ~0.5 x sum(h) for every token: with
    x ~ 1 + 0.1 N(0, 1) that is ~d / 2, far above the others."""
    router = np.array(pj["router"])
    router[:, 0] = 0.5
    return dict(pj, router=router)


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_apply_matches_reference(name):
    cj, ct, pj, pt, x = _case(name)
    want_y, want_aux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, cj))(
        pj, jnp.asarray(x))
    got_y, got_aux = moe.moe_apply(pt, torch.from_numpy(x), ct)
    assert got_y.shape == x.shape and got_y.dtype == torch.float32
    _close(got_y, want_y, Y_TOL, "y")
    _close(got_aux, want_aux, AUX_TOL, "aux")
    T = x.shape[0] * x.shape[1]
    dropped = _dropped(cj, pj, x)
    if name in ("qwen3-cf1.25", "skewed"):
        assert dropped > 0, "the reference drops no pick at cf 1.25"
    if name == "skewed":
        assert dropped >= T - moe.capacity(T, cj)
    if name == "qwen3-dropless":
        assert dropped == 0
    if name == "qwen3-cap1":
        assert moe.capacity(T, cj) == 1


@pytest.mark.parametrize("name", ["qwen3-cf1.25", "arctic-dense", "skewed"])
def test_moe_gradients_match_reference(name):
    cj, ct, pj, pt, x = _case(name)
    r = _x(2, x.shape)

    def jf(p, x):
        y, aux = jmoe.moe_apply(p, x, cj)
        return jnp.sum(y * r) + aux

    jg, jgx = jax.jit(jax.grad(jf, argnums=(0, 1)))(pj, jnp.asarray(x))
    leaves, treedef = tree_flatten(pt)
    leaves = [t.clone().requires_grad_() for t in leaves]
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_apply(tree_unflatten(treedef, leaves), xt, ct)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux,
                                leaves + [xt])
    want = jax.tree.leaves(jg)
    assert len(want) == len(leaves)
    for i, (g, w) in enumerate(zip(grads, want + [jgx])):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        _close(g, w, GRAD_TOL * scale, f"grad leaf {i} (x last)")


def test_capacity_is_the_reference_rule():
    cj, _ = _cfgs("qwen3-moe-30b-a3b")
    full = jget_arch("qwen3-moe-30b-a3b")
    # Qwen3 at full width: prefill (4 x 4096 tokens) and one decode step
    assert moe.capacity(4 * 4096, full) == 1280
    assert moe.capacity(4, full) == 1
    assert moe.capacity(2, cj) == 2        # ceil(2 x 2 / 4 x 1.25)
    arctic = jget_arch("arctic-480b")
    assert moe.capacity(4, arctic) == 1


def test_moe_init_shapes_and_dtypes():
    """The port's init is the reference's leaf for leaf (router f32,
    experts and Arctic's dense MLP in the config dtype)."""
    for arch in ("qwen3-moe-30b-a3b", "arctic-480b"):
        j = jget_arch(arch).reduced()
        want = jax.eval_shape(lambda k: jmoe.moe_init(k, j),
                              jax.random.PRNGKey(0))
        got = moe.moe_init(torch.Generator().manual_seed(0),
                           ArchConfig(**dataclasses.asdict(j)), "cpu",
                           (3,))
        wl = jax.tree.leaves_with_path(want)
        gl, _ = tree_flatten(got)
        assert len(gl) == len(wl)
        for (path, w), g in zip(wl, gl):
            assert tuple(g.shape) == (3,) + tuple(w.shape), path
            assert str(g.dtype).split(".")[1] == str(w.dtype), path
