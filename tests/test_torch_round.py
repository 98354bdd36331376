"""One M-DSL round, and a 2-round run, of the port against the JAX package.

Both engines get the same data and initial params (numpy), and the port
gets the JAX key chain's draws through `jax_round_draws` — the port does
not reproduce jax.random, every draw of a round is an input.

Tolerances:
  * LocalUpdate params and the D_g losses: LOCAL_ATOL — f32 convolution
    and SGD in another order of operations, over one epoch;
  * selection masks, delivery masks and uplink payloads/scales: exact;
  * global params after the wire: one uplink quantization level over the
    delivered count plus one downlink level (a 1e-7 difference in a
    delta can flip one stochastic rounding), and a mean |diff| <= 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import phy as jphy
from repro.configs import paper_cnn as jpaper_cnn
from repro.configs.paper_cnn import paper_cnn
from repro.core import pso as jpso
from repro.core import rounds as jrounds
from repro.data.partition import FederatedData as JaxData
from repro.data.synthetic import MNIST_LIKE
from repro.experiments import get_scenario, override, to_dict
from repro.experiments import runner as jrunner
from repro_torch import bridge
from repro_torch.core import rounds as prounds
from repro_torch.core.mdsl import RoundDraws
from repro_torch.experiments import runner as prunner
from repro_torch.experiments import spec as pspec

LOCAL_ATOL = 2e-5
C, N_LOCAL, N_EVAL = 4, 64, 256


def jax_round_draws(key, cfg, params, num_workers, n_local):
    """The draws `repro.core.mdsl.mdsl_round(key=key)` consumes, in the
    port's RoundDraws form (mdsl.py key split, compress.py per-leaf
    seeds, rounds.py _DOWNLINK_SALT, phy.py PHY_SALT)."""
    comm = cfg.comm
    ckey, tkey, bkey, qkey, wkey = jax.random.split(key, 5)
    co = jax.vmap(jpso.sample_coefficients)(
        jax.random.split(ckey, num_workers))
    coeffs = np.stack([np.asarray(co.c0), np.asarray(co.c1),
                       np.asarray(co.c2)], axis=1)
    perms = np.stack([
        np.stack([np.asarray(jax.random.permutation(ek, n_local))
                  for ek in jax.random.split(tk, cfg.local_epochs)])
        for tk in jax.random.split(tkey, num_workers)])
    leaves = jax.tree.leaves(params)
    imax = jnp.iinfo(jnp.int32).max

    def seed(k, i):
        return int(jax.random.randint(jax.random.fold_in(k, i), (), 0, imax))

    up = np.array([[seed(qk, i) for i in range(len(leaves))]
                   for qk in jax.random.split(qkey, num_workers)], np.int32)
    dkey = jax.random.fold_in(qkey, jrounds._DOWNLINK_SALT)
    down = np.array([seed(dkey, i) for i in range(len(leaves))], np.int32)
    link = jphy.link_model(comm)
    ekey, nkey = jax.random.split(wkey)
    keep = fade = noise = byz = None
    if link.drop_prob > 0:
        keep = np.asarray(jax.random.bernoulli(
            ekey, 1.0 - link.drop_prob, (num_workers,)), np.float32)
    if comm.fading != "none":
        kr, ki = jax.random.split(jax.random.fold_in(wkey, jphy.PHY_SALT))
        fade = np.stack([np.asarray(jax.random.normal(k, (num_workers,)))
                         for k in (kr, ki)])
    if link.awgn:
        per_upload = comm.aggregator != "mean" or link.per_worker
        noise = [np.asarray(jax.random.normal(
            jax.random.fold_in(nkey, i),
            ((num_workers,) if per_upload else ()) + x.shape))
            for i, x in enumerate(leaves)]
    if comm.byzantine and comm.byzantine_mode == "gaussian":
        byz = [np.asarray(jax.random.normal(jax.random.fold_in(bkey, i),
                                            (num_workers,) + x.shape))
               for i, x in enumerate(leaves)]

    def t(a):
        return None if a is None else torch.as_tensor(a)

    return RoundDraws(coeffs=t(coeffs), perms=t(perms).to(torch.int64),
                      up_seeds=t(up), down_seeds=t(down), keep=t(keep),
                      fade=t(fade),
                      noise=None if noise is None else [t(n) for n in noise],
                      byz_noise=None if byz is None else [t(b) for b in byz])


def _np_data(seed=0):
    """A small learnable fleet (class prototypes + noise, Dirichlet label
    skew) made with numpy, handed to both engines."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((10, 28, 28, 1)).astype(np.float32)

    def images(labels):
        return (protos[labels] + 0.6 * rng.standard_normal(
            labels.shape + (28, 28, 1))).astype(np.float32)

    props = rng.dirichlet(np.full(10, 0.5), size=C)
    y = np.stack([rng.choice(10, N_LOCAL, p=p) for p in props]).astype(
        np.int32)
    gy = rng.integers(0, 10, N_EVAL).astype(np.int32)
    ty = rng.integers(0, 10, N_EVAL).astype(np.int32)
    return JaxData(x=images(y), y=y, global_x=images(gy), global_y=gy,
                   test_x=images(ty), test_y=ty,
                   alphas=np.full(C, 0.5, np.float32))


def _spec(algorithm):
    return override(get_scenario("low-bandwidth-int4"),
                    f"data.num_workers={C}", "model.width_mult=2",
                    f"data.n_local={N_LOCAL}", "algo.local_epochs=1",
                    "run.rounds=2", f"algo.algorithm={algorithm}")


def _prepare(spec, data):
    """The JAX build on the shared data, and the port's build with the
    JAX data and init injected (spec carried over as JSON)."""
    jdata = jax.tree.map(jnp.asarray, data)

    def jitted_init_cnn(*a, **k):     # same params, one compile
        m = paper_cnn(*a, **k)
        return m._replace(init=jax.jit(m.init))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrunner, "make_case_data",
                   lambda *a, **k: (jdata, MNIST_LIKE))
        mp.setattr(jpaper_cnn, "paper_cnn", jitted_init_cnn)
        jprep = jrunner.build(spec)
    params0 = jax.tree.map(np.asarray, jprep.state.global_params)
    pprep = prunner.build(pspec.from_dict(to_dict(spec)), device="cpu",
                          data=data, init_params=params0)
    return jprep, pprep


@pytest.fixture(scope="module")
def preps():
    """One build per algorithm, shared by the tests of this module (each
    JAX build compiles its own round)."""
    data = _np_data()
    cache = {}

    def get(algorithm):
        if algorithm not in cache:
            cache[algorithm] = _prepare(_spec(algorithm), data)
        return cache[algorithm]

    return get


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves_close(got, want, atol):
    for g, w in zip(jax.tree.leaves(bridge.tree_to_numpy(got)),
                    jax.tree.leaves(_np(want))):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def _wire_tolerance(delta, delivered, down_delta):
    """Per-leaf bound: one int4 uplink level over the delivered count
    plus one int8 downlink level."""
    out = []
    for d, dd in zip(jax.tree.leaves(delta), jax.tree.leaves(down_delta)):
        up = np.abs(d).max() / 7.0 / max(delivered, 1.0)
        down = np.abs(dd).max() / 127.0
        out.append(up + down + 1e-6)
    return out


@pytest.mark.parametrize("algorithm", ["fedavg", "dsl", "multi_dsl", "mdsl"])
def test_round_matches_jax_stage_by_stage(algorithm, preps):
    jprep, pprep = preps(algorithm)
    np.testing.assert_allclose(pprep.aux["eta"].numpy(),
                               np.asarray(jprep.aux["eta"]), atol=1e-6)
    jstate0 = jprep.state
    _, rkey = jax.random.split(jprep.key)
    draws = jax_round_draws(rkey, jprep.aux["cfg"], jstate0.global_params, C,
                            N_LOCAL)
    jnext, jtel, _ = jprep.step(jstate0, jprep.key)
    pstate0 = bridge.train_state_from_numpy(_np(jstate0))
    pnext, ptel = pprep.step(pstate0, draws)

    # LocalUpdate: trained + PSO-displaced params, F on D_g
    _leaves_close(pnext.workers.params, jnext.workers.params, LOCAL_ATOL)
    _leaves_close(pnext.workers.velocity, jnext.workers.velocity, LOCAL_ATOL)
    np.testing.assert_allclose(ptel.losses.numpy(), np.asarray(jtel.losses),
                               atol=LOCAL_ATOL)
    # ScoreSelect
    np.testing.assert_allclose(ptel.theta.numpy(), np.asarray(jtel.theta),
                               atol=LOCAL_ATOL)
    np.testing.assert_array_equal(ptel.mask.numpy(), np.asarray(jtel.mask))
    # Uplink -> Aggregate -> Downlink
    assert float(ptel.delivered) == float(jtel.delivered)
    for f in ("bytes_up", "bytes_down", "compression_ratio", "airtime_s",
              "energy_j", "mean_snr_db", "selected_count",
              "uploaded_params"):
        np.testing.assert_allclose(float(getattr(ptel, f)),
                                   float(getattr(jtel, f)), rtol=1e-6)
    delta = jax.tree.map(lambda a, b: a - b, _np(jnext.workers.params),
                         _np(jstate0.workers.params))
    down_delta = jax.tree.map(lambda a, b: a - b, _np(jnext.global_params),
                              _np(jstate0.global_params))
    tols = _wire_tolerance(delta, float(jtel.delivered), down_delta)
    gots = jax.tree.leaves(bridge.tree_to_numpy(pnext.global_params))
    wants = jax.tree.leaves(_np(jnext.global_params))
    diffs = [np.abs(g - w) for g, w in zip(gots, wants)]
    for dif, tol in zip(diffs, tols):
        assert dif.max() <= tol, (dif.max(), tol)
    assert np.concatenate([d.ravel() for d in diffs]).mean() <= 1e-5
    # BestTracking
    np.testing.assert_allclose(float(ptel.global_loss),
                               float(jtel.global_loss), atol=LOCAL_ATOL)
    assert pnext.round_idx == int(jnext.round_idx) == 1


def test_wire_stages_bitwise_on_reference_inputs(preps):
    """Uplink, Aggregate and Downlink fed the JAX round's own delta:
    payloads, scales and survivor masks are bitwise, the residual within
    1 ulp, the aggregate within summation order, the broadcast exact."""
    jprep, _ = preps("mdsl")
    comm = jprep.spec.comm
    jstate0 = jprep.state
    _, rkey = jax.random.split(jprep.key)
    ckey, tkey, bkey, qkey, wkey = jax.random.split(rkey, 5)
    draws = jax_round_draws(rkey, jprep.aux["cfg"], jstate0.global_params, C,
                            N_LOCAL)
    jnext, _, _ = jprep.step(jstate0, jprep.key)
    delta = jax.tree.map(lambda a, b: a - b, jnext.workers.params,
                         jstate0.workers.params)
    mask = jnp.array([1.0, 0.0, 1.0, 1.0], jnp.float32)

    jwire, jres = jrounds.uplink_packed(comm, delta, jstate0.residual, mask,
                                        qkey)
    pwire, pres = prounds.uplink_packed(
        comm, bridge.tree_from_numpy(_np(delta)),
        bridge.tree_from_numpy(_np(jstate0.residual)), torch.as_tensor(
            np.asarray(mask)), draws.up_seeds)
    for a, b in zip(pwire.packed, jwire.packed):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(pwire.scales, jwire.scales):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for g, w, d in zip(jax.tree.leaves(bridge.tree_to_numpy(pres)),
                       jax.tree.leaves(_np(jres)),
                       jax.tree.leaves(_np(delta))):
        assert np.all(np.abs(g - w) <= np.spacing(np.abs(d)))

    from repro.comm import channel as jchannel
    from repro_torch.comm import channel as pchannel
    gp = jstate0.global_params
    jagg, jmeff = jchannel.receive_packed(comm, gp, jwire, mask, wkey)
    pagg, pmeff = pchannel.receive_packed(
        comm, bridge.tree_from_numpy(_np(gp)), pwire,
        torch.as_tensor(np.asarray(mask)), keep=draws.keep)
    np.testing.assert_array_equal(pmeff.numpy(), np.asarray(jmeff))
    _leaves_close(pagg, jagg, 1e-7)

    jb, jpr = jrounds.downlink(comm, jagg, gp, jstate0.ps_residual,
                               jax.random.fold_in(qkey,
                                                  jrounds._DOWNLINK_SALT))
    pb, ppr = prounds.downlink(comm, bridge.tree_from_numpy(_np(jagg)),
                               bridge.tree_from_numpy(_np(gp)),
                               bridge.tree_from_numpy(
                                   _np(jstate0.ps_residual)),
                               draws.down_seeds)
    _leaves_close(pb, jb, 0.0)
    _leaves_close(ppr, jpr, 0.0)


# the paper presets whose 2-round runs are held to the reference's: the
# fleet cut to C workers (the Byzantine ones to one attacker, and the
# trimmed mean to 0.25 so it still trims one a side)
RUN_PRESETS = ("low-bandwidth-int4", "low-bandwidth-topk", "byzantine-median",
               "byzantine-trimmed", "adaptive-tiers", "lossy-uplink-erasure",
               "noisy-uplink-awgn", "rayleigh-uplink", "rayleigh-outage",
               "snr-tiered-bits", "energy-budget", "paper/fig3-noniid1")


@pytest.fixture
def two_threads():
    """torch on two threads: beside the suite's other workers, a thread a
    core multiplies the small ops' cost many times."""
    from test_torch_figures import torch_threads
    with torch_threads(2):
        yield


def _preset_spec(name):
    cut = [f"data.num_workers={C}", "model.width_mult=2",
           f"data.n_local={N_LOCAL}", "algo.local_epochs=1", "run.rounds=2"]
    spec = get_scenario(name)
    if spec.comm.byzantine:
        cut.append("comm.byzantine=1")
    if spec.comm.aggregator == "trimmed_mean":
        cut.append("comm.trim_ratio=0.25")
    return override(spec, *cut)


@pytest.mark.parametrize("preset", RUN_PRESETS)
def test_two_round_run_tracks_reference(preset, preps, two_threads):
    """Selected, delivered and uplink bytes equal; losses within 1e-4;
    global params within the int4 wire's bound below (a bound for every
    preset: the dense and top-k wires quantize less)."""
    jprep, pprep = (preps("mdsl") if preset == "low-bandwidth-int4"
                    else _prepare(_preset_spec(preset), _np_data()))
    jrecord = jrunner._run_paper(jprep, verbose=False)
    state, key, draws = jprep.state, jprep.key, []
    for _ in range(2):
        _, rkey = jax.random.split(key)
        draws.append(jax_round_draws(rkey, jprep.aux["cfg"],
                                     state.global_params, C, N_LOCAL))
        state, _, key = jprep.step(state, key)
    result = prunner.run_prepared(
        pprep._replace(draw=lambda s: draws[s.round_idx]), verbose=False)
    prec = result.record
    assert set(prec) == set(jrecord)
    assert prec["selected"] == jrecord["selected"]
    assert prec["delivered"] == jrecord["delivered"]
    assert prec["bytes_up"] == jrecord["bytes_up"]
    np.testing.assert_allclose(prec["global_loss"], jrecord["global_loss"],
                               atol=1e-4)
    gots = jax.tree.leaves(bridge.tree_to_numpy(result.state.global_params))
    wants = jax.tree.leaves(_np(state.global_params))
    start = jax.tree.leaves(_np(jprep.state.global_params))
    diffs = []
    for g, w, s in zip(gots, wants, start):
        # one int4 level of the largest per-round move over the
        # delivered count, per round, plus the downlink levels
        level = np.abs(w - s).max() * (1 / 7.0 + 2 / 127.0)
        assert np.abs(g - w).max() <= 2 * level + 1e-6
        diffs.append(np.abs(g - w).ravel())
    assert np.concatenate(diffs).mean() <= 1e-5
