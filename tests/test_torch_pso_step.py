"""Per-step Eq. 8 (`MdslConfig.pso_every_step`, `core/pso.pso_step`) of the
port against the JAX package's, on the same numpy inputs and the
reference's own permutation and coefficient draws.

Tolerances (f32):
  * `pso_step` against the reference's `pso.pso_step`, vmapped over the
    workers: within 2 ulps of the sum of the update's term magnitudes
    (XLA may contract a product and a sum into an FMA where the port
    rounds both, as tests/test_torch_pso_update.py measures);
  * the per-step LocalUpdate against the reference's `_local_update`:
    LOCAL_ATOL, the f32 convolution in another order of operations, as
    tests/test_torch_round.py holds one epoch. Eq. 8 a step multiplies a
    difference in w by up to c0 + |1 - c1 - c2| (4.3 for the worst of
    these N(0,1) draws), so two correct f32 runs drift apart
    geometrically with the steps: the test takes 4 steps (n_local 40,
    batch 16, 2 epochs: the one permutation a worker wraps around
    mid-epoch, as the reference's `jnp.resize` does), where the
    compounded difference stays under LOCAL_ATOL;
  * a whole round through `mdsl_round` with the reference's draws:
    selection and delivery masks exact, params and losses LOCAL_ATOL.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import paper_cnn as jpaper_cnn
from repro.core import losses as jlosses
from repro.core import mdsl as jmdsl
from repro.core import pso as jpso
from repro_torch import bridge
from repro_torch.configs.paper_cnn import paper_cnn
from repro_torch.core import losses, mdsl, pso
from repro_torch.kernels import runtime
from test_torch_figures import _two_threads  # noqa: F401  (torch on 2 threads)

LOCAL_ATOL = 2e-5
C, N, BS, E = 4, 40, 16, 2
HP = dict(learning_rate=0.05, velocity_clip=0.1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _workers(seed):
    """A stacked WorkerState (numpy) with distinct params, velocities and
    bests, and a global best, around a CNN5 w2 init."""
    rng = np.random.default_rng(seed)
    p0 = _np(jpaper_cnn(width_mult=2).init(jax.random.PRNGKey(seed)))

    def jitter(scale):
        return jax.tree.map(lambda x: (x[None] + scale * rng.standard_normal(
            (C,) + x.shape)).astype(np.float32), p0)

    params = jitter(0.01)
    ws = jpso.WorkerState(params=params, velocity=jitter(0.0),
                          best_params=jitter(0.02),
                          best_loss=np.full(C, 1.0, np.float32),
                          prev_loss=np.full(C, 1.0, np.float32))
    ws = ws._replace(velocity=jax.tree.map(
        lambda x: (0.01 * rng.standard_normal(x.shape)).astype(np.float32),
        params))
    gbest = jax.tree.map(lambda x: x + (0.01 * rng.standard_normal(
        x.shape)).astype(np.float32), p0)
    return ws, gbest


def _coeffs(seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    co = jax.vmap(jpso.sample_coefficients)(keys)
    return co, pso.PsoCoefficients(*(torch.as_tensor(np.asarray(c))
                                     for c in co))


def _port_workers(ws):
    return pso.WorkerState(*(bridge.tree_from_numpy(x) if isinstance(x, dict)
                             else torch.as_tensor(x) for x in ws))


def _term_scale(co, w, v, wl, wg, g, lr):
    b = lambda c: np.asarray(c).reshape((-1,) + (1,) * (w.ndim - 1))  # noqa
    return (np.abs(b(co.c0) * v) + np.abs(b(co.c1) * (wl - w))
            + np.abs(b(co.c2) * (wg[None] - w)) + np.abs(lr * g))


@pytest.mark.parametrize("clip", [0.0, 0.1])
def test_pso_step_matches_reference(clip):
    ws, gbest = _workers(0)
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), ws.params)
    jco, pco = _coeffs(2)
    hp_j = jpso.PsoHyperParams(learning_rate=0.05, velocity_clip=clip)
    hp_p = pso.PsoHyperParams(learning_rate=0.05, velocity_clip=clip)
    lr = np.float32(0.05)
    want = jax.vmap(lambda s, g, c: jpso.pso_step(s, gbest, g, c, lr, hp_j))(
        jax.tree.map(jnp.asarray, ws), jax.tree.map(jnp.asarray, grads),
        jco)
    runtime.reset_counts()
    got = pso.pso_step(_port_workers(ws), bridge.tree_from_numpy(gbest),
                       bridge.tree_from_numpy(grads), pco, float(lr), hp_p)
    assert runtime.counts() == {}            # CPU: the plain version
    for name in ("velocity", "params"):
        for g_, w_, w0, v0, wl, wg, gr in zip(
                jax.tree.leaves(bridge.tree_to_numpy(getattr(got, name))),
                jax.tree.leaves(_np(getattr(want, name))),
                *(jax.tree.leaves(t) for t in (ws.params, ws.velocity,
                                               ws.best_params, gbest,
                                               grads))):
            scale = _term_scale(jco, w0, v0, wl, wg, gr, lr)
            if name == "params":
                scale = scale + np.abs(w0)
            ulp = np.spacing(scale.astype(np.float32))
            assert np.all(np.abs(g_ - w_) <= 2 * ulp), name


def _data(seed):
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((10, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, (C, N)).astype(np.int32)
    x = (protos[y] + 0.6 * rng.standard_normal(y.shape + (28, 28, 1))
         ).astype(np.float32)
    return x, y


def test_per_step_local_update_matches_reference():
    ws, gbest = _workers(3)
    x, y = _data(4)
    jco, pco = _coeffs(5)
    keys = jax.random.split(jax.random.PRNGKey(6), C)
    jmodel = jpaper_cnn(width_mult=2)
    jloss = lambda p, a, b: jlosses.cross_entropy_loss(  # noqa: E731
        jmodel.apply(p, a), b, 10)
    jcfg = jmdsl.MdslConfig(algorithm="mdsl", local_epochs=E, batch_size=BS,
                            hp=jpso.PsoHyperParams(**HP),
                            pso_every_step=True)
    lr = np.float32(HP["learning_rate"])
    local = functools.partial(jmdsl._local_update, loss_fn=jloss, lr=lr,
                              cfg=jcfg, use_pso=True)
    want = jax.jit(jax.vmap(lambda s, a, b, k, c: local(
        s, gbest, a, b, key=k, coeffs=c)))(
        jax.tree.map(jnp.asarray, ws), jnp.asarray(x), jnp.asarray(y), keys,
        jco)

    model = paper_cnn(width_mult=2)
    loss = lambda p, a, b: losses.cross_entropy_loss(  # noqa: E731
        model.apply(p, a), b.long(), 10)
    cfg = mdsl.MdslConfig(algorithm="mdsl", local_epochs=E, batch_size=BS,
                          hp=pso.PsoHyperParams(**HP), pso_every_step=True)
    # the reference's one permutation a worker, as the port's (C, 1, n)
    perms = torch.as_tensor(np.stack([np.asarray(
        jax.random.permutation(k, N)) for k in keys]))[:, None].long()
    got = mdsl.local_update(_port_workers(ws), bridge.tree_from_numpy(gbest),
                            torch.as_tensor(x), torch.as_tensor(y), loss,
                            pco, float(lr), cfg, perms)
    for name in ("params", "velocity"):
        for g_, w_ in zip(
                jax.tree.leaves(bridge.tree_to_numpy(getattr(got, name))),
                jax.tree.leaves(_np(getattr(want, name)))):
            np.testing.assert_allclose(g_, w_, rtol=0, atol=LOCAL_ATOL)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(_np(want.params)), jax.tree.leaves(ws.params)))
    assert moved > 10 * LOCAL_ATOL          # the steps did move the params


@pytest.mark.parametrize("algorithm,shape", [("mdsl", (C, 1, N)),
                                             ("fedavg", (C, E, N))])
def test_draws_have_one_permutation_a_worker(algorithm, shape):
    cfg = mdsl.MdslConfig(algorithm=algorithm, local_epochs=E,
                          pso_every_step=True)
    params = paper_cnn(width_mult=2).init(torch.Generator().manual_seed(0))
    d = mdsl.sample_round_draws(torch.Generator().manual_seed(1), cfg,
                                params, C, N, "cpu", round_idx=0)
    assert tuple(d.perms.shape) == shape
    assert all(sorted(p.tolist()) == list(range(N))
               for p in d.perms.reshape(-1, N))


def test_per_step_round_through_the_runner_tracks_reference():
    """One `low-bandwidth-int4` round with `algo.pso_every_step=true` in
    the port, fed the reference round's draws, against the reference's
    `mdsl_round` with `MdslConfig(pso_every_step=True)`."""
    from repro.experiments import get_scenario as jget
    from repro.experiments import override as joverride
    from repro.experiments import runner as jrunner
    from repro_torch.experiments import runner as prunner
    from repro_torch.experiments import spec as pspec
    from tests.test_torch_round import _np_data, jax_round_draws

    cut = ["data.num_workers=4", "model.width_mult=2", "data.n_local=64",
           "algo.local_epochs=1", "run.rounds=1"]
    jspec = joverride(jget("low-bandwidth-int4"), *cut)
    data = _np_data()
    jdata = jax.tree.map(jnp.asarray, data)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrunner, "make_case_data",
                   lambda *a, **k: (jdata, jrunner.IMAGE_SPECS["mnist_like"]))
        jprep = jrunner.build(jspec)
    jcfg = jprep.aux["cfg"]._replace(pso_every_step=True)
    jmodel = jpaper_cnn(width_mult=2)
    _, rkey = jax.random.split(jprep.key)
    jnext, jtel = jmdsl.mdsl_round(
        jprep.state, jdata.x, jdata.y, jdata.global_x, jdata.global_y, rkey,
        loss_fn=lambda p, a, b: jlosses.cross_entropy_loss(
            jmodel.apply(p, a), b, 10),
        eval_fn=lambda p, a, b: jlosses.rmse_loss(jmodel.apply(p, a), b, 10),
        cfg=jcfg, n_params=jprep.n_params)

    pspec_ = pspec.from_dict(jrunner.to_dict(jspec))
    pspec_ = pspec.override(pspec_, "algo.pso_every_step=true")
    pprep = prunner.build(pspec_, device="cpu", data=data,
                          init_params=_np(jprep.state.global_params))
    draws = jax_round_draws(rkey, jcfg, jprep.state.global_params, 4, 64)
    _, tkey, *_ = jax.random.split(rkey, 5)
    perms = np.stack([np.asarray(jax.random.permutation(k, 64))
                      for k in jax.random.split(tkey, 4)])
    draws = draws._replace(perms=torch.as_tensor(perms)[:, None].long())
    pnext, ptel = pprep.step(pprep.state, draws)
    np.testing.assert_array_equal(ptel.mask.numpy(), np.asarray(jtel.mask))
    assert float(ptel.delivered) == float(jtel.delivered)
    np.testing.assert_allclose(ptel.losses.numpy(), np.asarray(jtel.losses),
                               atol=LOCAL_ATOL)
    for g_, w_ in zip(
            jax.tree.leaves(bridge.tree_to_numpy(pnext.workers.params)),
            jax.tree.leaves(_np(jnext.workers.params))):
        np.testing.assert_allclose(g_, w_, rtol=0, atol=LOCAL_ATOL)
