"""The port's population engine (`core/population`, the runner's
`_wrap_population`) against the JAX package on the CPU, with the
reference's draws (Gumbel noise, catch-up normals, the engine's round
draws) injected.

Tolerances:
  * cohort ids and their order, scattered tables, ages and round
    markers: exact;
  * gather_phy's caught-up rows: 2e-7 absolute (|h| < 5); its lag-0 rows
    bitwise;
  * lazy_fading_coeffs: within 1e-6 relative (XLA's f32 pow and torch's
    differ by up to 3 ulps), and below the smallest normal f32, where
    XLA flushes denormals to zero; residual_norms 1e-6 relative;
  * the 3-round P = 1000 run: cohorts exact a round, losses within 1e-4
    and accuracy within one test sample, as tests/test_torch_round.py;
  * P == K under the uniform policy against the unwrapped port engine:
    bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import phy as jphy
from repro.comm.budget import CommConfig as JComm
from repro.core import population as jpop
from repro.experiments import get_scenario, override
from repro_torch import bridge
from repro_torch.comm import phy as pphy
from repro_torch.comm.budget import CommConfig
from repro_torch.core import population as ppop
from repro_torch.experiments import get_scenario as pget_scenario
from repro_torch.experiments import override as poverride
from repro_torch.experiments import runner as prunner
from repro_torch.pytree import tree_leaves, tree_map
from test_torch_straggler import jax_round_draws, np_fleet, prepare_pair

KEY = jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _table(P, comm, seed=0, seen=True):
    """A reference table with random last-known state: scores, SNRs,
    ages and round markers."""
    rng = np.random.default_rng(seed)
    t = jpop.init_table(comm, P)
    last = rng.integers(-1, 5, P).astype(np.int32) if seen else \
        np.full(P, -1, np.int32)
    phy = t.phy._replace(
        h_re=jnp.asarray(rng.standard_normal(P).astype(np.float32)),
        h_im=jnp.asarray(rng.standard_normal(P).astype(np.float32)),
        snr_db=jnp.asarray(rng.uniform(-10, 30, P).astype(np.float32)),
        age=jnp.asarray(rng.integers(0, 4, P).astype(np.int32)))
    return t._replace(
        phy=phy, score=jnp.asarray(rng.uniform(0, 2, P).astype(np.float32)),
        ef_norm=jnp.asarray(rng.uniform(0, 1, P).astype(np.float32)),
        last_seen=jnp.asarray(last), last_evolved=jnp.asarray(last))


def _ptable(jtable):
    return bridge.population_table_from_numpy(_np(jtable))


@pytest.mark.parametrize("seen", [True, False])
@pytest.mark.parametrize("policy", jpop.COHORT_POLICIES)
def test_sample_cohort_matches_reference(policy, seen):
    P, K = 300, 12
    jt = _table(P, JComm(), seed=1, seen=seen)
    for s in range(4):
        key = jax.random.fold_in(KEY, s)
        want = np.asarray(jpop.sample_cohort(jt, K, policy, key))
        gumbel = _t(np.asarray(jax.random.gumbel(key, (P,), jnp.float32)))
        got = ppop.sample_cohort(_ptable(jt), K, policy, gumbel)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)   # ids and order


def test_sample_cohort_degenerate_identity_no_draw():
    t = ppop.init_table(CommConfig(), 16)
    np.testing.assert_array_equal(
        ppop.sample_cohort(t, 16, "uniform", None).numpy(), np.arange(16))
    assert not ppop.needs_gumbel(16, 16, "uniform")
    assert ppop.needs_gumbel(16, 16, "snr_aware")
    d = ppop.population_draws(torch.Generator().manual_seed(0), CommConfig(),
                              16, 16, "uniform", "cpu")
    assert d.gumbel is None and d.normals is None


@pytest.mark.parametrize("fading", ["rayleigh", "none"])
def test_gather_phy_matches_reference(fading):
    kw = dict(fading=fading, doppler_rho=0.9, pathloss_spread_db=4.0)
    jc, pc = JComm(**kw), CommConfig(**kw)
    P, t = 64, 6
    jt = _table(P, jc, seed=2)
    # three devices entering at lag 0 (last evolved in round t - 1)
    jt = jt._replace(last_evolved=jt.last_evolved.at[jnp.asarray(
        [3, 10, 40])].set(t - 1))
    idx = jnp.asarray([3, 17, 40, 8, 10, 63, 0, 29], jnp.int32)
    key = jax.random.PRNGKey(5)
    want = jpop.gather_phy(jc, jt, idx, jnp.int32(t), key)
    normals = None
    if fading != "none":
        normals = _t(np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(key, int(i)), (2,), jnp.float32))
            for i in np.asarray(idx)]))
    got = ppop.gather_phy(pc, _ptable(jt), _t(idx), t, normals)
    for f in ("h_re", "h_im", "pathloss_db", "snr_db"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=2e-7 if f != "snr_db" else 2e-5)
    np.testing.assert_array_equal(got.age.numpy(), np.asarray(want.age))
    lag0 = np.isin(np.asarray(idx), [3, 10, 40])
    for f in ("h_re", "h_im", "snr_db"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy()[lag0],
            np.asarray(getattr(jt.phy, f))[np.asarray(idx)[lag0]])


def test_lazy_fading_coeffs_match_reference():
    for rho in (0.9, 0.8, 0.37, 1.0, 0.0):
        steps = np.arange(0, 600, dtype=np.int32)
        want = jphy.lazy_fading_coeffs(JComm(doppler_rho=rho),
                                       jnp.asarray(steps))
        got = pphy.lazy_fading_coeffs(CommConfig(doppler_rho=rho),
                                      _t(steps))
        assert float(got[0][0]) == 1.0 and float(got[1][0]) == 0.0
        for g, w in zip(got, want):
            # XLA flushes f32 denormals to zero, torch keeps them
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=np.finfo(np.float32).tiny)


def test_scatter_round_matches_reference():
    comm = JComm(fading="rayleigh", doppler_rho=0.8)
    P, K = 32, 4
    jt = _table(P, comm, seed=3)
    rng = np.random.default_rng(4)
    idx = np.array([3, 17, 8, 29], np.int32)
    phy = jphy.PhyState(
        h_re=jnp.asarray(rng.standard_normal(K).astype(np.float32)),
        h_im=jnp.asarray(rng.standard_normal(K).astype(np.float32)),
        pathloss_db=jt.phy.pathloss_db[idx],
        snr_db=jnp.asarray([1.0, 2.0, 3.0, 4.0], jnp.float32),
        age=jnp.asarray([0, 1, 0, 2], jnp.int32))
    theta = rng.uniform(0, 1, K).astype(np.float32)
    efn = rng.uniform(0, 1, K).astype(np.float32)
    want = jpop.scatter_round(jt, jnp.asarray(idx), phy, jnp.asarray(theta),
                              jnp.asarray(efn), jnp.int32(3))
    before = _ptable(jt)
    got = ppop.scatter_round(before, _t(idx),
                             bridge.phy_state_from_numpy(_np(phy)),
                             _t(theta), _t(efn), 3)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # out of place: the table scattered from is unchanged
    for g, w in zip(tree_leaves(before), jax.tree.leaves(jt)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_residual_norms_match_reference():
    rng = np.random.default_rng(5)
    res = {"w": rng.standard_normal((6, 5, 3)).astype(np.float32),
           "b": rng.standard_normal((6, 7)).astype(np.float32)}
    want = np.asarray(jpop.residual_norms(_np(res)))
    got = ppop.residual_norms(bridge.tree_from_numpy(res)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    exact = {"w": np.array([[3.0, 4.0], [0.0, 0.0]], np.float32),
             "b": np.array([[0.0], [12.0]], np.float32)}
    np.testing.assert_array_equal(
        ppop.residual_norms(bridge.tree_from_numpy(exact)).numpy(),
        [5.0, 12.0])


@pytest.mark.parametrize("P", [128, 1_000_000])
def test_table_bytes_is_36_per_device(P):
    t = ppop.init_table(CommConfig(), P)
    assert ppop.table_bytes(t) == 36 * P
    assert len(tree_leaves(t)) == 9
    assert all(x.shape == (P,) for x in tree_leaves(t))
    jt = jpop.init_table(JComm(), 128)
    if P == 128:
        assert ppop.table_bytes(_ptable(jt)) == jpop.table_bytes(jt)
        for g, w in zip(tree_leaves(t), jax.tree.leaves(jt)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the degenerate anchor: P == K under the uniform policy, port against port
# ---------------------------------------------------------------------------

_EXACT_KEYS = ("acc", "global_loss", "selected", "delivered",
               "uploaded_params", "bytes_up", "bytes_down", "airtime_s",
               "energy_j", "mean_snr_db")


@pytest.mark.parametrize("case", ["quickstart", "phy-heavy", "straggler"])
def test_full_fleet_population_is_bit_identical(case):
    spec = {"quickstart": lambda: poverride(
                pget_scenario("quickstart"), "data.n_local=64",
                "run.rounds=2"),
            "phy-heavy": lambda: poverride(
                pget_scenario("rayleigh-outage"), "data.num_workers=4",
                "data.n_local=64", "model.width_mult=2",
                "algo.local_epochs=1", "run.rounds=2",
                "comm.compressor=int8"),
            "straggler": lambda: poverride(
                pget_scenario("faults/churn"), "data.num_workers=4",
                "data.n_local=64", "run.rounds=3", "comm.quorum=2",
                "comm.fault_prob=0.3")}[case]()
    K = spec.data.num_workers
    legacy = prunner.run(spec, verbose=False, device="cpu")
    wrapped = prunner.run(poverride(spec, f"fleet.population={K}",
                                    f"fleet.cohort_size={K}"),
                          verbose=False, device="cpu")
    for k in _EXACT_KEYS + tuple(
            k for k in ("late", "drained", "buffered", "held", "transmitted")
            if k in legacy.record):
        assert legacy.record[k] == wrapped.record[k], k
    assert wrapped.record["cohort"] == [list(range(K))] * spec.run.rounds
    assert "cohort" not in legacy.record
    for a, b in zip(tree_leaves(legacy.state.global_params),
                    tree_leaves(wrapped.state.global_params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# a P = 1000, K = 8 run against the reference's
# ---------------------------------------------------------------------------

K8, N_LOCAL, P1000 = 8, 64, 1000


def test_population_run_tracks_reference():
    from repro.experiments import runner as jrunner
    spec = override(get_scenario("quickstart"), f"data.n_local={N_LOCAL}",
                    "run.rounds=3", f"fleet.population={P1000}",
                    f"fleet.cohort_size={K8}",
                    "fleet.cohort_policy=score_weighted",
                    "comm.fading=rayleigh", "comm.doppler_rho=0.9")
    jprep, pprep = prepare_pair(spec, np_fleet(K8, N_LOCAL, seed=2))
    jrecord = jrunner._run_paper(jprep, verbose=False)
    # the reference's draws, round by round: the population's from
    # fold_in(key, POP_SALT), the engine's from the same key chain
    state, key, draws = jprep.state, jprep.key, []
    for t in range(spec.run.rounds):
        pkey = jax.random.fold_in(key, jpop.POP_SALT)
        skey, ckey = jax.random.split(pkey)
        idx, _ = jpop.schedule(state.table, jnp.int32(t), pkey,
                               comm=spec.comm, cohort_size=K8,
                               policy="score_weighted")
        normals = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(ckey, int(i)), (2,), jnp.float32))
            for i in np.asarray(idx)])
        _, rkey = jax.random.split(key)
        draws.append((ppop.PopulationDraws(
            gumbel=_t(np.asarray(jax.random.gumbel(skey, (P1000,),
                                                   jnp.float32))),
            normals=_t(normals)),
            jax_round_draws(rkey, jprep.aux["cfg"],
                            state.inner.global_params, K8, N_LOCAL,
                            round_idx=t)))
        state, _, key = jprep.step(state, key)
    result = prunner.run_prepared(
        pprep._replace(draw=lambda s: draws[s.t]), verbose=False)
    prec = result.record
    assert set(prec) == set(jrecord)
    assert prec["cohort"] == jrecord["cohort"]
    assert len({tuple(c) for c in prec["cohort"]}) == spec.run.rounds
    for k in ("population", "cohort_size", "cohort_policy", "selected",
              "delivered", "bytes_up"):
        assert prec[k] == jrecord[k], k
    np.testing.assert_allclose(prec["global_loss"], jrecord["global_loss"],
                               atol=1e-4)
    np.testing.assert_allclose(prec["acc"], jrecord["acc"], atol=1.0 / 256)
    t = result.state.table
    np.testing.assert_array_equal(t.last_seen.numpy(),
                                  np.asarray(state.table.last_seen))
    np.testing.assert_array_equal(t.phy.age.numpy(),
                                  np.asarray(state.table.phy.age))
    np.testing.assert_allclose(t.phy.h_re.numpy(),
                               np.asarray(state.table.phy.h_re), atol=2e-7)
    np.testing.assert_allclose(t.score.numpy(), np.asarray(state.table.score),
                               atol=1e-4)


def test_build_exposes_table():
    spec = poverride(pget_scenario("quickstart"), "fleet.population=64",
                     "fleet.cohort_size=8")
    prep = prunner.build(spec, device="cpu")
    assert prep.aux["population"] == 64
    assert prep.aux["table_bytes"] == 64 * 36
    assert prep.state.table.score.shape == (64,)
    np.testing.assert_array_equal(prep.state.cohort.numpy(), np.arange(8))


def test_reseat_clears_a_reseated_slots_state_only():
    """A slot whose device changed starts from the global model with zero
    velocity, reset bests, a zero EF residual and no parked delta; a kept
    slot keeps its state bitwise."""
    spec = poverride(pget_scenario("straggler/fedbuff"), "data.num_workers=4",
                     "model.width_mult=2", "data.n_local=64",
                     "algo.local_epochs=1", "run.rounds=1")
    prep = prunner.build(spec, device="cpu")
    inner, _ = prep.step(prep.state, prep.draw(prep.state))
    inner = inner._replace(
        residual=tree_map(torch.ones_like, inner.residual),
        buffer=inner.buffer._replace(
            delta=tree_map(torch.ones_like, inner.buffer.delta),
            age=torch.tensor([1, 2, 0, 3], dtype=torch.int32)))
    changed = torch.tensor([False, True, False, True])
    phy = pphy.init_state(spec.comm, 4)
    out = prunner._reseat(inner, changed, phy)
    assert out.phy is phy
    np.testing.assert_array_equal(out.buffer.age.numpy(), [1, 0, 0, 0])
    w_new, w_old = out.workers, inner.workers
    for g, p_new, p_old, v_new, v_old, b_new, r_new, r_old, d_new, d_old in \
            zip(*(tree_leaves(x) for x in (
                inner.global_params, w_new.params, w_old.params,
                w_new.velocity, w_old.velocity, w_new.best_params,
                out.residual, inner.residual, out.buffer.delta,
                inner.buffer.delta))):
        for slot in range(4):
            if changed[slot]:
                assert torch.equal(p_new[slot], g)
                assert torch.equal(b_new[slot], g)
                assert not v_new[slot].any()
                assert not r_new[slot].any() and not d_new[slot].any()
            else:
                for a, b in ((p_new, p_old), (v_new, v_old), (r_new, r_old),
                             (d_new, d_old)):
                    assert torch.equal(a[slot], b[slot])
    assert torch.isinf(w_new.best_loss[changed]).all()
    assert torch.equal(w_new.best_loss[~changed], w_old.best_loss[~changed])
