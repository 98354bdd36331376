"""Stage-level parity of the port against the JAX package on the same
inputs (numpy, seeded), random draws injected.

Tolerances: F32 = 1e-6 absolute for elementwise f32 math in another
order; CONV = 2e-5 for convolution/matmul outputs and their gradients;
integer results (masks, bytes, payloads) exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import budget as jbudget
from repro.comm import channel as jchannel
from repro.comm import compress as jcompress
from repro.comm import phy as jphy
from repro.core import losses as jlosses
from repro.core import noniid as jnoniid
from repro.core import pso as jpso
from repro.core import selection as jselection
from repro.data import synthetic as jsynthetic
from repro.kernels.pso_update.ref import pso_update_ref
from repro.models import cnn as jcnn
from repro_torch import bridge
from repro_torch.comm import budget as pbudget
from repro_torch.comm import channel as pchannel
from repro_torch.comm import compress as pcompress
from repro_torch.comm import phy as pphy
from repro_torch.core import losses as plosses
from repro_torch.core import noniid as pnoniid
from repro_torch.core import pso as ppso
from repro_torch.core import selection as pselection
from repro_torch.data import synthetic as psynthetic
from repro_torch.models import cnn as pcnn

F32 = 1e-6
CONV = 2e-5
RNG = np.random.default_rng(0)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@functools.partial(jax.jit, static_argnums=1)
def _worker_seeds(key, n_leaves):
    imax = jnp.iinfo(jnp.int32).max
    return jnp.stack([jax.random.randint(jax.random.fold_in(key, i), (), 0,
                                         imax) for i in range(n_leaves)])


def _leaf_seeds(keys, n_leaves):
    """compress.py's per-leaf seeds of each worker key, (C, L) int32."""
    return np.asarray(jax.vmap(lambda k: _worker_seeds(k, n_leaves))(keys),
                      np.int32)


def _np_params(model):
    """Params of the reference model's shapes, drawn with numpy (an eager
    JAX init compiles one sampler per leaf shape)."""
    def draw(s):   # He scale for weights, as the models' init
        std = (np.sqrt(2.0 / np.prod(s.shape[:-1])) if len(s.shape) > 1
               else 0.1)
        return (std * RNG.standard_normal(s.shape)).astype(np.float32)

    return jax.tree.map(draw, jax.eval_shape(model.init,
                                             jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------------
# losses, Eq. 2, Eqs. 5-10
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rmse", "xent"])
def test_losses(name):
    logits = RNG.standard_normal((64, 10)).astype(np.float32)
    labels = RNG.integers(0, 10, 64).astype(np.int32)
    want = jlosses.LOSSES[name](jnp.asarray(logits), jnp.asarray(labels), 10)
    got = plosses.LOSSES[name](_t(logits), _t(labels).long(), 10)
    _close(got, want, F32)
    _close(plosses.accuracy(_t(logits), _t(labels).long()),
           jlosses.accuracy(jnp.asarray(logits), jnp.asarray(labels)), 0)


@pytest.mark.parametrize("coeffs", [jnoniid.MNIST_COEFFS,
                                    jnoniid.CIFAR10_COEFFS])
def test_eta_degrees(coeffs):
    alphas = [0.1, 0.5, 1.0, 10.0, 0.3, 100.0]
    labels = np.stack([RNG.choice(10, 128, p=RNG.dirichlet(np.full(10, a)))
                       for a in alphas]).astype(np.int32)
    glob = RNG.integers(0, 10, 512).astype(np.int32)
    want = jnoniid.noniid_degree_from_labels(jnp.asarray(labels),
                                             jnp.asarray(glob), 10, coeffs)
    got = pnoniid.noniid_degree_from_labels(
        _t(labels).long(), _t(glob).long(), 10,
        pnoniid.EtaCoefficients(*coeffs))
    _close(got, want, F32)


@pytest.mark.parametrize("prev", [np.inf, 0.3, -1.0])
def test_selection_eq5_eq6_eq7(prev):
    C = 7
    losses = RNG.uniform(0.1, 0.9, C).astype(np.float32)
    eta = RNG.uniform(0, 1, C).astype(np.float32)
    jt = jselection.tradeoff_scores(jnp.asarray(losses), jnp.asarray(eta))
    pt = pselection.tradeoff_scores(_t(losses), _t(eta))
    _close(pt, jt, F32)
    jm, js = jselection.select_workers(
        jt, jselection.SelectionState(jnp.float32(prev)))
    pm, ps = pselection.select_workers(
        pt, pselection.SelectionState(torch.tensor(prev,
                                                   dtype=torch.float32)))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    _close(ps.prev_theta_mean, js.prev_theta_mean, F32)
    g = {"w": RNG.standard_normal((3, 4)).astype(np.float32)}
    w = {"w": RNG.standard_normal((C, 3, 4)).astype(np.float32)}
    w0 = {"w": RNG.standard_normal((C, 3, 4)).astype(np.float32)}
    want = jselection.aggregate_global(g, w, w0, jm)
    got = pselection.aggregate_global(bridge.tree_from_numpy(g),
                                      bridge.tree_from_numpy(w),
                                      bridge.tree_from_numpy(w0), pm)
    _close(got["w"], want["w"], F32)


@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_eq8_velocity_per_worker(clip):
    C, shape = 5, (6, 128)
    w, v, wl, d = (RNG.standard_normal((C,) + shape).astype(np.float32) * s
                   for s in (1.0, 0.1, 1.0, 0.01))
    wg = RNG.standard_normal(shape).astype(np.float32)
    co = RNG.standard_normal((C, 3)).astype(np.float32)
    got = ppso.velocity_update(_t(w), _t(v), _t(wl), _t(wg), _t(d),
                               ppso.coefficients(_t(co)), clip)
    for c in range(C):
        coefs = jnp.asarray([co[c, 0], co[c, 1], co[c, 2], clip],
                            jnp.float32)
        _, want = pso_update_ref(coefs, w[c], v[c], wl[c], wg, d[c])
        _close(got[c], want, F32)


def test_eq9_eq10_best_tracking():
    C = 4
    params = {"a": RNG.standard_normal((C, 3)).astype(np.float32)}
    state = jax.vmap(jpso.init_worker_state)(params)
    state = state._replace(best_loss=jnp.asarray([0.5, 0.1, 0.3, 0.2]))
    losses = np.array([0.4, 0.2, 0.3, 0.1], np.float32)
    want = jax.vmap(jpso.update_local_best)(state, jnp.asarray(losses))
    pstate = ppso.WorkerState(*bridge.tree_from_numpy(
        tuple(jax.tree.map(np.asarray, state))))
    got = ppso.update_local_best(pstate, _t(losses))
    _close(got.best_loss, want.best_loss, 0)
    _close(got.best_params["a"], want.best_params["a"], 0)
    gb = jpso.init_global_best({"a": jnp.zeros(3)})
    jg = jpso.update_global_best(gb, {"a": jnp.ones(3)}, jnp.float32(0.7))
    pg = ppso.update_global_best(ppso.init_global_best({"a": torch.zeros(3)}),
                                 {"a": torch.ones(3)}, torch.tensor(0.7))
    _close(pg.params["a"], jg.params["a"], 0)
    _close(pg.loss, jg.loss, 0)


def test_decayed_lr():
    hp = jpso.PsoHyperParams(learning_rate=0.01, lr_decay=0.5,
                             lr_decay_every=10)
    for t in (0, 9, 10, 25, 99):
        want = float(jpso.decayed_lr(hp, jnp.int32(t)))
        assert ppso.decayed_lr(ppso.PsoHyperParams(*hp), t) == want


# ---------------------------------------------------------------------------
# data and models
# ---------------------------------------------------------------------------

def test_prototype_blur_and_standardize():
    spec = jsynthetic.MNIST_LIKE
    key = jax.random.PRNGKey(3)
    want = jsynthetic.make_class_prototypes(key, spec)
    raw = jax.random.normal(key, (spec.num_classes, spec.height, spec.width,
                                  spec.channels))
    got = psynthetic.blur_and_standardize(_t(raw),
                                          psynthetic.SyntheticImageSpec(
                                              *spec))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("kind,width", [("cnn5", 8), ("resnet", 2)])
def test_model_logits_and_grads(kind, width):
    h, w, ch = (28, 28, 1) if kind == "cnn5" else (32, 32, 3)
    make_j = jcnn.make_cnn5 if kind == "cnn5" else jcnn.make_resnet
    make_p = pcnn.make_cnn5 if kind == "cnn5" else pcnn.make_resnet
    jm, pm = (make_j(h, w, ch, 10, width),
              make_p(h, w, ch, 10, width, device="cpu"))
    params = _np_params(jm)
    x = RNG.standard_normal((16, h, w, ch)).astype(np.float32)
    y = RNG.integers(0, 10, 16).astype(np.int32)
    pp = bridge.tree_from_numpy(params)

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(x))
        return jlosses.cross_entropy_loss(logits, jnp.asarray(y), 10), logits

    def ploss(p):
        return plosses.cross_entropy_loss(pm.apply(p, _t(x)), _t(y).long(),
                                          10)

    jg, jlogits = jax.jit(jax.grad(jloss, has_aux=True))(params)
    _close(pm.apply(pp, _t(x)).detach(), jlogits, CONV)
    pg = torch.func.grad(ploss)(pp)
    for a, b in zip(jax.tree.leaves(bridge.tree_to_numpy(pg)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jg))):
        _close(a, b, CONV)


# ---------------------------------------------------------------------------
# comm: budget, phy, compress, channel
# ---------------------------------------------------------------------------

_CFGS = [dict(compressor="int4", downlink_compressor="int8"),
         dict(compressor="topk", topk_ratio=0.05),
         dict(compressor="int8", adaptive_bits=True, num_tiers=3),
         dict(channel="awgn", snr_db=10.0, fading="rayleigh",
              pathloss_spread_db=6.0)]


def _params(width=2):
    return _np_params(jcnn.make_cnn5(28, 28, 1, 10, width))


@pytest.mark.parametrize("kw", _CFGS)
def test_budget_bytes_and_airtime(kw):
    jc, pc = jbudget.CommConfig(**kw), pbudget.CommConfig(**kw)
    params = _params()
    pparams = bridge.tree_from_numpy(jax.tree.map(np.asarray, params))
    assert pbudget.payload_bytes(pc, pparams) == \
        jbudget.payload_bytes(jc, params)
    assert pbudget.dense_bytes(pparams) == jbudget.dense_bytes(params)
    C = 6
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    meff = np.array([1, 0, 0, 1, 0, 1], np.float32)
    snr = RNG.uniform(0, 20, C).astype(np.float32)
    tier = np.array([0, 1, 2, 0, 1, 2], np.int32) if jc.adaptive_bits \
        else None
    want = jbudget.round_record(jc, params, C, jnp.asarray(mask),
                                jnp.asarray(meff),
                                None if tier is None else jnp.asarray(tier),
                                jnp.asarray(snr))
    got = pbudget.round_record(pc, pparams, C, _t(mask), _t(meff),
                               None if tier is None else _t(tier), _t(snr))
    for f in want._fields:
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(want, f)), rtol=1e-6)


def test_phy_fading_and_delivery():
    cfg = dict(channel="composite", drop_prob=0.3, snr_db=10.0,
               fading="rayleigh", doppler_rho=0.9, outage_snr_db=5.0)
    jc, pc = jphy.CommConfig(**cfg), pbudget.CommConfig(**cfg)
    C = 8
    js = jphy.init_state(jc, C)
    ps = pphy.init_state(pc, C)
    key = jax.random.PRNGKey(5)
    kr, ki = jax.random.split(key)
    normals = np.stack([np.asarray(jax.random.normal(k, (C,)))
                        for k in (kr, ki)])
    js = jphy.evolve(jc, js, key)
    ps = pphy.evolve(pc, ps, _t(normals))
    for f in ("h_re", "h_im", "snr_db"):
        _close(getattr(ps, f), getattr(js, f), 1e-5)
    mask = jnp.ones(C)
    ekey = jax.random.PRNGKey(9)
    keep = np.asarray(jax.random.bernoulli(ekey, 0.7, (C,)), np.float32)
    want = jphy.delivery_mask(jc, mask, ekey, snr_db=js.snr_db)
    got = pphy.delivery_mask(pc, torch.ones(C), _t(keep), snr_db=ps.snr_db)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        pphy.advance_age(ps, got).age.numpy(),
        np.asarray(jphy.advance_age(js, want).age))


@pytest.mark.parametrize("comp", ["identity", "topk", "int8", "int4"])
def test_compress_with_ef_on_injected_seeds(comp):
    cfg = dict(compressor=comp, topk_ratio=0.1)
    jc, pc = jbudget.CommConfig(**cfg), pbudget.CommConfig(**cfg)
    C = 3
    params = _params()
    delta = jax.tree.map(lambda p: (0.01 * RNG.standard_normal(
        (C,) + p.shape)).astype(np.float32), params)
    res = jax.tree.map(lambda d: (0.1 * d).astype(np.float32), delta)
    keys = jax.random.split(jax.random.PRNGKey(2), C)
    wire, new_res = jax.jit(jax.vmap(lambda d, r, k: jcompress.compress_with_ef(
        jc, d, r, k)))(delta, res, keys)
    seeds = _t(_leaf_seeds(keys, len(jax.tree.leaves(params))))
    pwire, pres = pcompress.compress_with_ef(
        pc, bridge.tree_from_numpy(delta), bridge.tree_from_numpy(res),
        seeds)
    for a, b in zip(jax.tree.leaves(bridge.tree_to_numpy(pwire)),
                    jax.tree.leaves(jax.tree.map(np.asarray, wire))):
        np.testing.assert_array_equal(a, b)
    # the residual to within 1 ulp of acc (XLA may FMA-contract a - w)
    acc = jax.tree.map(lambda d, r: d + r, delta, res)
    for a, b, c in zip(jax.tree.leaves(bridge.tree_to_numpy(pres)),
                       jax.tree.leaves(jax.tree.map(np.asarray, new_res)),
                       jax.tree.leaves(acc)):
        assert np.all(np.abs(a - b) <= np.spacing(np.abs(c)))


@pytest.mark.parametrize("kw", [
    dict(channel="erasure", drop_prob=0.4),
    dict(channel="awgn", snr_db=10.0),
    dict(channel="awgn", snr_db=10.0, fading="rayleigh"),
    dict(aggregator="trimmed_mean", trim_ratio=0.2, channel="awgn"),
])
def test_receive_on_injected_draws(kw):
    jc, pc = jbudget.CommConfig(**kw), pbudget.CommConfig(**kw)
    C = 7
    params = _params()
    wire = jax.tree.map(lambda p: (0.01 * RNG.standard_normal(
        (C,) + p.shape)).astype(np.float32), params)
    mask = np.array([1, 1, 0, 1, 1, 1, 0], np.float32)
    snr = (RNG.uniform(5, 15, C).astype(np.float32)
           if jc.fading != "none" else None)
    key = jax.random.PRNGKey(4)
    ekey, nkey = jax.random.split(key)
    keep = (np.asarray(jax.random.bernoulli(ekey, 1 - jc.drop_prob, (C,)),
                       np.float32) if "drop_prob" in kw else None)
    shapes = pchannel.noise_shapes(pc, bridge.tree_from_numpy(params), C)

    @jax.jit
    def reference(params, wire, mask, snr):
        noise = ([] if shapes is None else
                 [jax.random.normal(jax.random.fold_in(nkey, i), s)
                  for i, s in enumerate(shapes)])
        return jchannel.receive(jc, params, wire, mask, key, snr), noise

    (want, jmeff), jnoise = reference(
        params, wire, jnp.asarray(mask),
        None if snr is None else jnp.asarray(snr))
    noise = [_t(n) for n in jnoise] if shapes else None
    got, pmeff = pchannel.receive(pc, bridge.tree_from_numpy(params),
                                  bridge.tree_from_numpy(wire), _t(mask),
                                  keep=None if keep is None else _t(keep),
                                  noise=noise,
                                  snr_db=None if snr is None else _t(snr))
    np.testing.assert_array_equal(pmeff.numpy(), np.asarray(jmeff))
    for a, b in zip(jax.tree.leaves(bridge.tree_to_numpy(got)),
                    jax.tree.leaves(jax.tree.map(np.asarray, want))):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("agg", ["mean", "median", "trimmed_mean"])
def test_receive_packed_equals_dense_receive(agg):
    """The packed route and the dense route agree in the port, as they do
    in the JAX package (survivor masks exact, aggregates to summation
    order)."""
    kw = dict(compressor="int4", aggregator=agg, trim_ratio=0.2,
              channel="erasure", drop_prob=0.3)
    pc = pbudget.CommConfig(**kw)
    C = 6
    params = bridge.tree_from_numpy(_params())
    delta = {k: {kk: 0.01 * torch.randn((C,) + v.shape) for kk, v in
                 sub.items()} for k, sub in params.items()}
    res = pcompress.init_residual(delta)
    seeds = torch.randint(0, 2**31 - 1, (C, 10), dtype=torch.int32)
    keep = torch.tensor([1, 0, 1, 1, 1, 0], dtype=torch.float32)
    mask = torch.ones(C)
    pw, _ = pcompress.compress_with_ef_packed(pc, delta, res, seeds)
    dw, _ = pcompress.compress_with_ef(pc, delta, res, seeds)
    a, ma = pchannel.receive_packed(pc, params, pw, mask, keep=keep)
    b, mb = pchannel.receive(pc, params, dw, mask, keep=keep)
    assert torch.equal(ma, mb)
    for x, y in zip(jax.tree.leaves(bridge.tree_to_numpy(a)),
                    jax.tree.leaves(bridge.tree_to_numpy(b))):
        _close(x, y, 1e-6)


def test_fit_eta_coefficients():
    ratios = RNG.uniform(0.2, 1.0, 40)
    wds = RNG.uniform(0.0, 3.0, 40)
    acc = 0.3 * ratios - 0.05 * wds + 0.5 + 0.01 * RNG.standard_normal(40)
    want = jnoniid.fit_eta_coefficients(ratios, wds, acc)
    got = pnoniid.fit_eta_coefficients(ratios, wds, acc)
    assert tuple(got[0]) == tuple(want[0]) and got[1:] == want[1:]
