"""The port's straggler engine (`comm/straggler`, the straggler route of
`core/rounds.wire_round`, the runner's straggler and churn rows) against
the JAX package on the CPU. Inputs are made from a numpy seed; the port
takes the reference's draws (erasure keep, AWGN noise, fading normals,
the fault schedule's crash rows) as explicit inputs.

Tolerances:
  * late and alive masks, fresh masks, buffer ages, held flags and the
    records' late / drained / buffered / held / transmitted rows: exact;
  * staleness weights: bitwise at gamma 0 and 1; elsewhere within 1e-6
    relative (XLA's f32 pow is not correctly rounded: at gamma 2.3 it is
    up to 4 ulps from the f64 value rounded to f32, torch's 3 ulps from
    XLA's);
  * aggregate_and_drain, f32: AGG_TOL absolute on deltas of |x| < 5 (the
    2C-row sums run in another order);
  * the quorum hold: bitwise;
  * runs: the paper run as tests/test_torch_round.py (losses within
    1e-4, LocalUpdate within LOCAL_ATOL; accuracy within one test
    sample), the mesh rounds as tests/test_torch_swarm_dist.py (losses
    LOSS_TOL, params PARAM_TOL).

No case here reuses a golden of the JAX package, so none needs
`jax_threefry_partitionable` set to False.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import phy as jphy
from repro.comm import straggler as jst
from repro.comm.budget import CommConfig as JComm
from repro.configs import paper_cnn as jpaper_cnn
from repro.configs.paper_cnn import paper_cnn
from repro.core import pso as jpso
from repro.core import rounds as jrounds
from repro.core import swarm_dist as jswarm
from repro.data.partition import FederatedData as JaxData
from repro.data.synthetic import MNIST_LIKE
from repro.experiments import get_scenario, override, to_dict
from repro.experiments import run as jrun
from repro.experiments import runner as jrunner
from repro_torch import bridge
from repro_torch.comm import budget as pbudget
from repro_torch.comm import phy as pphy
from repro_torch.comm import straggler as pst
from repro_torch.comm.budget import CommConfig
from repro_torch.core import swarm_dist
from repro_torch.core.mdsl import RoundDraws
from repro_torch.experiments import runner as prunner
from repro_torch.experiments import spec as pspec
from repro_torch.pytree import tree_leaves

AGG_TOL = 2e-7
LOCAL_ATOL = 2e-5
KEY = jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# shared helpers (tests/test_torch_population.py imports them)
# ---------------------------------------------------------------------------

def jax_crash_rows(comm, round_idx, num_workers):
    """The (R, C) crash rows `repro.comm.straggler.alive_mask` reads at
    `round_idx` (rows of rounds before 0 zero)."""
    stream = jax.random.fold_in(jax.random.PRNGKey(comm.fault_seed),
                                jst.FAULT_SALT)
    rows = np.zeros((comm.fault_rounds, num_workers), bool)
    for r in range(comm.fault_rounds):
        if round_idx - r >= 0:
            rows[r] = np.asarray(jax.random.bernoulli(
                jax.random.fold_in(stream, round_idx - r), comm.fault_prob,
                (num_workers,)))
    return rows


def jax_round_draws(key, cfg, params, num_workers, n_local, round_idx=0):
    """The draws `repro.core.mdsl.mdsl_round(key=key)` consumes, in the
    port's RoundDraws form (mdsl.py's key split, compress.py's per-leaf
    seeds, rounds.py's _DOWNLINK_SALT, phy.py's PHY_SALT, the straggler
    route's per-upload noise and the fault schedule's crash rows)."""
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
    keep = fade = noise = byz = crash = None
    if link.drop_prob > 0:
        keep = np.asarray(jax.random.bernoulli(
            ekey, 1.0 - link.drop_prob, (num_workers,)), np.float32)
    if comm.fading != "none":
        kr, ki = jax.random.split(jax.random.fold_in(wkey, jphy.PHY_SALT))
        fade = np.stack([np.asarray(jax.random.normal(k, (num_workers,)))
                         for k in (kr, ki)])
    if link.awgn:
        per_upload = (comm.aggregator != "mean" or link.per_worker
                      or comm.round_deadline_s is not None)
        noise = [np.asarray(jax.random.normal(
            jax.random.fold_in(nkey, i),
            ((num_workers,) if per_upload else ()) + x.shape))
            for i, x in enumerate(leaves)]
    if comm.byzantine and comm.byzantine_mode == "gaussian":
        byz = [np.asarray(jax.random.normal(jax.random.fold_in(bkey, i),
                                            (num_workers,) + x.shape))
               for i, x in enumerate(leaves)]
    if comm.fault_prob > 0:
        crash = jax_crash_rows(comm, round_idx, num_workers)

    def t(a):
        return None if a is None else torch.as_tensor(a)

    return RoundDraws(coeffs=t(coeffs), perms=t(perms).to(torch.int64),
                      up_seeds=t(up), down_seeds=t(down), keep=t(keep),
                      fade=t(fade),
                      noise=None if noise is None else [t(n) for n in noise],
                      byz_noise=None if byz is None else [t(b) for b in byz],
                      crash=t(crash))


def np_fleet(C, n_local, n_eval=256, seed=0):
    """A small learnable fleet (class prototypes + noise, Dirichlet label
    skew) made with numpy, handed to both engines."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((10, 28, 28, 1)).astype(np.float32)

    def images(labels):
        return (protos[labels] + 0.6 * rng.standard_normal(
            labels.shape + (28, 28, 1))).astype(np.float32)

    props = rng.dirichlet(np.full(10, 0.5), size=C)
    y = np.stack([rng.choice(10, n_local, p=p) for p in props]).astype(
        np.int32)
    gy = rng.integers(0, 10, n_eval).astype(np.int32)
    ty = rng.integers(0, 10, n_eval).astype(np.int32)
    return JaxData(x=images(y), y=y, global_x=images(gy), global_y=gy,
                   test_x=images(ty), test_y=ty,
                   alphas=np.full(C, 0.5, np.float32))


def prepare_pair(spec, data):
    """The JAX build on `data`, and the port's build (CPU) with the JAX
    data and init injected; the spec crosses as JSON."""
    jdata = jax.tree.map(jnp.asarray, data)

    def jitted_init_cnn(*a, **k):     # same params, one compile
        m = paper_cnn(*a, **k)
        return m._replace(init=jax.jit(m.init))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrunner, "make_case_data",
                   lambda *a, **k: (jdata, MNIST_LIKE))
        mp.setattr(jpaper_cnn, "paper_cnn", jitted_init_cnn)
        jprep = jrunner.build(spec)
    params0 = jax.tree.map(np.asarray, jprep.state.global_params
                           if not spec.fleet.population
                           else jprep.state.inner.global_params)
    pprep = prunner.build(pspec.from_dict(to_dict(spec)), device="cpu",
                          data=data, init_params=params0)
    return jprep, pprep


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def _tree(rng, C, shapes=((4,), (3, 2), (5, 7))):
    return {f"p{i}": rng.standard_normal((C,) + s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _global(tree, rng=None):
    if rng is None:
        return {k: np.zeros(v.shape[1:], np.float32) for k, v in tree.items()}
    return {k: rng.standard_normal(v.shape[1:]).astype(np.float32)
            for k, v in tree.items()}


def _comms(**kw):
    """The same wire config in both packages."""
    kw.setdefault("round_deadline_s", 1.0)
    return JComm(**kw), CommConfig(**kw)


def _eq_tree(got, want, tol=0.0):
    for g, w in zip(tree_leaves(bridge.tree_to_numpy(got)),
                    jax.tree.leaves(_np(want))):
        if tol == 0.0:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)


@pytest.mark.parametrize("deadline", [1e9, 1e-12, "mid"])
def test_late_mask_matches_reference(deadline):
    rng = np.random.default_rng(1)
    tree = _tree(rng, 5)
    g = _global(tree)
    mask = np.array([1.0, 0.0, 1.0, 1.0, 1.0], np.float32)
    snr = np.array([20.0, 20.0, -10.0, 5.0, 12.0], np.float32)
    jc, pc = _comms()
    if deadline == "mid":
        wb = pbudget.worker_payload_bytes(pc, bridge.tree_from_numpy(g), 5)
        air = pbudget.worker_airtime_s(pc, wb, _t(snr)).numpy()
        deadline = float(np.median(air))
    jc, pc = jc._replace(round_deadline_s=deadline), pc._replace(
        round_deadline_s=deadline)
    for s in (None, snr):
        want = np.asarray(jst.late_mask(jc, g, jnp.asarray(mask),
                                        snr_db=None if s is None
                                        else jnp.asarray(s)))
        got = pst.late_mask(pc, bridge.tree_from_numpy(g), _t(mask),
                            snr_db=None if s is None else _t(s)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gamma", [0.0, 0.5, 1.0, 2.3])
def test_staleness_weights_match_reference(gamma):
    age = np.arange(0, 50, dtype=np.int32)
    jc, pc = _comms(staleness_gamma=gamma)
    want = np.asarray(jst.staleness_weights(jc, jnp.asarray(age)))
    got = pst.staleness_weights(pc, _t(age)).numpy()
    assert got[0] == want[0] == 0.0
    if gamma in (0.0, 1.0):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("rounds_", [1, 3])
def test_alive_mask_from_injected_crash_rows_matches_reference(rounds_):
    C = 32
    jc, pc = _comms(fault_prob=0.3, fault_rounds=rounds_, fault_seed=3)
    for t in range(8):
        want = np.asarray(jst.alive_mask(jc, jnp.int32(t), C))
        got = pst.alive_mask(_t(jax_crash_rows(jc, t, C))).numpy()
        np.testing.assert_array_equal(got, want)


def test_port_fault_schedule_is_replayable_and_lasts_r_rounds():
    """The port's own schedule: a pure function of (fault_seed, t), an
    outage lasting exactly R rounds, no draw of any other stream."""
    C, R = 32, 3
    _, pc = _comms(fault_prob=0.3, fault_rounds=R, fault_seed=3)
    crash = {t: pst.crash_draws(pc, t, C)[0] for t in range(10)}
    for t in range(10):
        rows = pst.crash_draws(pc, t, C)
        np.testing.assert_array_equal(rows, pst.crash_draws(pc, t, C))
        want = np.zeros((C,), bool)
        for r in range(R):
            if t - r >= 0:
                np.testing.assert_array_equal(rows[r], crash[t - r])
                want |= crash[t - r]
            else:
                assert not rows[r].any()
        np.testing.assert_array_equal(
            pst.alive_mask(torch.from_numpy(rows)).numpy(),
            (~want).astype(np.float32))
    assert 0 < sum(c.sum() for c in crash.values()) < 10 * C
    other = pst.crash_draws(pc._replace(fault_seed=4), 5, C)
    assert not np.array_equal(other, pst.crash_draws(pc, 5, C))


@pytest.mark.parametrize("case", ["buffered", "legacy", "delivery_wins"])
def test_advance_age_matches_reference(case):
    jc, pc = _comms()
    js, ps = jphy.init_state(jc, 3), pphy.init_state(pc, 3)
    seq = {"buffered": [([1.0, 0.0, 0.0], [0, 1, 0]),
                        ([0.0, 0.0, 0.0], [0, 1, 0])],
           "legacy": [([1.0, 0.0, 1.0], None), ([0.0, 0.0, 1.0], None)],
           "delivery_wins": [([1.0, 1.0, 0.0], [1, 1, 0])]}[case]
    for m, b in seq:
        js = jphy.advance_age(js, jnp.asarray(m, jnp.float32),
                              buffered=None if b is None
                              else jnp.asarray(b, jnp.int32))
        ps = pphy.advance_age(ps, torch.tensor(m),
                              buffered=None if b is None
                              else torch.tensor(b, dtype=torch.int32))
        np.testing.assert_array_equal(ps.age.numpy(), np.asarray(js.age))
        assert ps.age.dtype == torch.int32


def _drain_draws(comm, key, tree):
    """The keep draw and per-upload noise the reference's
    aggregate_and_drain takes from `key` (ekey, nkey = split(key))."""
    link = jphy.link_model(comm)
    ekey, nkey = jax.random.split(key)
    C = jax.tree.leaves(tree)[0].shape[0]
    keep = noise = None
    if link.drop_prob > 0:
        keep = _t(np.asarray(jax.random.bernoulli(
            ekey, 1.0 - link.drop_prob, (C,)), np.float32))
    if link.awgn:
        noise = [_t(np.asarray(jax.random.normal(
            jax.random.fold_in(nkey, i), x.shape)))
            for i, x in enumerate(jax.tree.leaves(tree))]
    return keep, noise


@pytest.mark.parametrize("channel", ["ideal", "composite"])
@pytest.mark.parametrize("aggregator", ["mean", "median", "trimmed_mean"])
def test_aggregate_and_drain_matches_reference(aggregator, channel):
    C = 6
    rng = np.random.default_rng(2)
    tree = _tree(rng, C)
    g = _global(tree, rng)
    parked = _tree(rng, C)
    age = np.array([0, 0, 1, 2, 0, 3], np.int32)
    mask = np.array([1, 1, 1, 0, 1, 1], np.float32)
    late = np.array([0, 1, 0, 0, 0, 1], np.float32)
    kw = dict(aggregator=aggregator, trim_ratio=0.2, staleness_gamma=0.5)
    if channel == "composite":
        kw.update(channel="composite", drop_prob=0.3, snr_db=10.0,
                  fading="rayleigh")
    jc, pc = _comms(**kw)
    snr = rng.uniform(0.0, 20.0, C).astype(np.float32)
    key = jax.random.PRNGKey(7)
    keep, noise = _drain_draws(jc, key, tree)
    jbuf = jst.StragglerBuffer(delta=jax.tree.map(jnp.asarray, parked),
                               age=jnp.asarray(age))
    jout, jfresh, jnew, jstats = jst.aggregate_and_drain(
        jc, g, tree, jnp.asarray(mask), jnp.asarray(late), key,
        jnp.asarray(snr), jbuf)
    pbuf = pst.StragglerBuffer(delta=bridge.tree_from_numpy(parked),
                               age=_t(age))
    pout, pfresh, pnew, pstats = pst.aggregate_and_drain(
        pc, bridge.tree_from_numpy(g), bridge.tree_from_numpy(tree),
        _t(mask), _t(late), _t(snr), pbuf, keep=keep, noise=noise)
    np.testing.assert_array_equal(pfresh.numpy(), np.asarray(jfresh))
    np.testing.assert_array_equal(pnew.age.numpy(), np.asarray(jnew.age))
    assert pnew.age.dtype == torch.int32
    for f in pst.StragglerStats._fields:
        assert float(getattr(pstats, f)) == float(getattr(jstats, f)), f
    _eq_tree(pout, jout, AGG_TOL)
    _eq_tree(pnew.delta, jnew.delta, AGG_TOL)
    assert all(x.dtype == torch.float32 for x in tree_leaves(pnew.delta))


def test_quorum_hold_is_bitwise():
    C = 4
    rng = np.random.default_rng(3)
    tree = _tree(rng, C)
    g = _global(tree, rng)
    jc, pc = _comms(quorum=C + 5)
    pg = bridge.tree_from_numpy(g)
    pout, _, pnew, pstats = pst.aggregate_and_drain(
        pc, pg, bridge.tree_from_numpy(tree), torch.ones(C),
        torch.zeros(C), None, pst.init_buffer(pc, bridge.tree_from_numpy(
            tree)))
    jout, _, jnew, jstats = jst.aggregate_and_drain(
        jc, g, tree, jnp.ones((C,)), jnp.zeros((C,)), KEY, None,
        jst.init_buffer(jc, tree))
    for a, b in zip(tree_leaves(pg), tree_leaves(pout)):
        assert torch.equal(a, b)
    _eq_tree(pout, jout)
    assert float(pstats.held) == float(jstats.held) == 1.0
    assert float(pstats.drained) == 0.0
    # fresh arrivals on a held round park instead of vanishing
    np.testing.assert_array_equal(pnew.age.numpy(), np.asarray(jnew.age))
    np.testing.assert_array_equal(pnew.age.numpy(), 1)


def test_held_round_ages_parked_slots():
    C = 3
    rng = np.random.default_rng(4)
    tree = _tree(rng, C)
    _, pc = _comms(quorum=C + 5)
    zeros = {k: np.zeros_like(v) for k, v in tree.items()}
    buf = pst.StragglerBuffer(delta=bridge.tree_from_numpy(tree),
                              age=torch.tensor([2, 1, 0], dtype=torch.int32))
    _, _, new, stats = pst.aggregate_and_drain(
        pc, bridge.tree_from_numpy(_global(tree)),
        bridge.tree_from_numpy(zeros), torch.zeros(C), torch.zeros(C), None,
        buf)
    np.testing.assert_array_equal(new.age.numpy(), [3, 2, 0])
    assert float(stats.held) == 1.0


@pytest.mark.parametrize("C", [2, 5])
def test_gamma_zero_drain_telescopes(C):
    """gamma = 0: a delta parked one round and then drained lands in the
    aggregate as an on-time one would, in the port and the reference."""
    rng = np.random.default_rng(C)
    tree = _tree(rng, C)
    g = _global(tree)
    zeros = {k: np.zeros_like(v) for k, v in tree.items()}
    jc, pc = _comms(staleness_gamma=0.0)
    pt, pz, pg = (bridge.tree_from_numpy(x) for x in (tree, zeros, g))
    on_time, _, _, _ = pst.aggregate_and_drain(
        pc, pg, pt, torch.ones(C), torch.zeros(C), None,
        pst.init_buffer(pc, pt))
    parked = pst.StragglerBuffer(delta=pt,
                                 age=torch.ones(C, dtype=torch.int32))
    drained, _, new, stats = pst.aggregate_and_drain(
        pc, pg, pz, torch.zeros(C), torch.zeros(C), None, parked)
    for a, b in zip(tree_leaves(on_time), tree_leaves(drained)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    assert float(stats.drained) == C and float(stats.buffered) == 0
    jdrained, _, _, _ = jst.aggregate_and_drain(
        jc, g, zeros, jnp.zeros((C,)), jnp.zeros((C,)), KEY, None,
        jst.StragglerBuffer(delta=tree, age=jnp.ones((C,), jnp.int32)))
    _eq_tree(drained, jdrained, AGG_TOL)


def test_init_buffer_none_when_deadline_off_and_f32_otherwise():
    stacked = {"w": torch.zeros((3, 4), dtype=torch.bfloat16)}
    assert pst.init_buffer(CommConfig(), stacked) is None
    assert jst.init_buffer(JComm(), {"w": jnp.zeros((3, 4))}) is None
    buf = pst.init_buffer(CommConfig(round_deadline_s=0.5), stacked)
    assert buf.delta["w"].dtype == torch.float32
    assert buf.delta["w"].shape == (3, 4)
    assert buf.age.dtype == torch.int32 and buf.age.shape == (3,)


# ---------------------------------------------------------------------------
# the paper engine: a 3-round straggler run against the reference's
# ---------------------------------------------------------------------------

C8, N_LOCAL = 8, 64


def _paper_spec(name, *extra):
    return override(get_scenario(name), f"data.num_workers={C8}",
                    "model.width_mult=2", f"data.n_local={N_LOCAL}",
                    "algo.local_epochs=1", "run.rounds=3", *extra)


def _run_both(spec, data):
    """The reference's record and per-round states, and the port's record
    and final state on the reference's draws."""
    jprep, pprep = prepare_pair(spec, data)
    jrecord = jrunner._run_paper(jprep, verbose=False)
    state, key, draws = jprep.state, jprep.key, []
    for t in range(spec.run.rounds):
        _, rkey = jax.random.split(key)
        draws.append(jax_round_draws(rkey, jprep.aux["cfg"],
                                     state.global_params, C8, N_LOCAL,
                                     round_idx=t))
        state, _, key = jprep.step(state, key)
    held_params = []

    def step(s, d):
        s2, m = pprep.step(s, d)
        held_params.append((s.global_params, s2.global_params))
        return s2, m

    result = prunner.run_prepared(
        pprep._replace(draw=lambda s: draws[s.round_idx], step=step),
        verbose=False)
    return jrecord, state, result, held_params


@pytest.fixture(scope="module")
def straggler_runs():
    """The deadline lowered to the dense payload's airtime at the fleet's
    middle SNR (17 dB), so that faded and far workers go late, and a
    quorum that holds a round."""
    from repro_torch.configs.paper_cnn import paper_cnn as ppaper_cnn
    from repro_torch.data.synthetic import MNIST_LIKE as PMNIST
    params = ppaper_cnn(PMNIST, 2, device="cpu").init(
        torch.Generator().manual_seed(0))
    pc = CommConfig()
    rate = pbudget.rate_bps(pc, torch.tensor(17.0)).item()
    deadline = 8.0 * pbudget.dense_bytes(params) / rate
    spec = _paper_spec("straggler/deadline-tight",
                       f"comm.round_deadline_s={deadline}", "comm.quorum=5")
    return spec, _run_both(spec, np_fleet(C8, N_LOCAL))


def test_paper_straggler_run_tracks_reference(straggler_runs):
    spec, (jrec, jstate, result, held_params) = straggler_runs
    prec = result.record
    assert set(prec) == set(jrec)
    for k in ("selected", "delivered", "late", "drained", "buffered",
              "held", "bytes_up", "bytes_down"):
        assert prec[k] == jrec[k], (k, prec[k], jrec[k])
    assert sum(prec["late"]) > 0 and sum(prec["drained"]) > 0
    assert sum(prec["held"]) > 0       # the quorum held a round
    np.testing.assert_allclose(prec["global_loss"], jrec["global_loss"],
                               atol=1e-4)
    np.testing.assert_allclose(prec["acc"], jrec["acc"], atol=1.0 / 256)
    _eq_tree(result.state.global_params, jstate.global_params, LOCAL_ATOL)
    np.testing.assert_array_equal(result.state.buffer.age.numpy(),
                                  np.asarray(jstate.buffer.age))
    _eq_tree(result.state.buffer.delta, jstate.buffer.delta, LOCAL_ATOL)
    np.testing.assert_array_equal(result.state.phy.age.numpy(),
                                  np.asarray(jstate.phy.age))
    # a held round leaves the global params bitwise
    for t, (before, after) in enumerate(held_params):
        if prec["held"][t]:
            for a, b in zip(tree_leaves(before), tree_leaves(after)):
                assert torch.equal(a, b), t


def test_paper_churn_run_tracks_reference():
    spec = _paper_spec("faults/churn", "comm.fault_prob=0.3",
                       "comm.quorum=2")
    jrec, jstate, result, _ = _run_both(spec, np_fleet(C8, N_LOCAL, seed=1))
    prec = result.record
    assert set(prec) == set(jrec)
    for k in ("selected", "transmitted", "delivered", "late", "drained",
              "buffered", "held", "bytes_up"):
        assert prec[k] == jrec[k], (k, prec[k], jrec[k])
    assert all(isinstance(v, int) for v in prec["transmitted"])
    assert any(t < s for t, s in zip(prec["transmitted"], prec["selected"]))
    np.testing.assert_allclose(prec["global_loss"], jrec["global_loss"],
                               atol=1e-4)
    _eq_tree(result.state.global_params, jstate.global_params, LOCAL_ATOL)


# ---------------------------------------------------------------------------
# the mesh engine: two straggler rounds on reduced smollm-360m in f32
# ---------------------------------------------------------------------------

def test_mesh_straggler_rounds_match_reference():
    from test_torch_swarm_dist import (ARCH, LOSS_TOL, PARAM_TOL, W,
                                       _batches, _f32_arch, _torch_batch,
                                       jax_dist_draws)
    from repro.models.transformer import Transformer as JTransformer
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.transformer import Transformer

    cj = _f32_arch(ARCH).reduced()
    jm = JTransformer(cj)
    jp = jm.init(jax.random.PRNGKey(0))
    ct = ArchConfig(**dataclasses.asdict(cj))
    tm = Transformer(ct)
    tp = bridge.transformer_params_from_numpy(ct, _np(jp))
    # pathloss puts worker 1 6 dB below worker 0; the deadline sits
    # between their airtimes, so worker 1 goes late whenever selected
    kw = dict(pathloss_spread_db=6.0, staleness_gamma=0.5)
    pc = CommConfig(**kw)
    snr = pphy.init_state(pc, W).snr_db
    air = pbudget.worker_airtime_s(
        pc, pbudget.worker_payload_bytes(pc, tp, W), snr).numpy()
    deadline = float(np.sqrt(air[0] * air[1]))
    jcfg = jswarm.DistSwarmConfig(worker_axes=(), num_spatial=W,
                                  comm=JComm(round_deadline_s=deadline, **kw))
    tcfg = swarm_dist.DistSwarmConfig(
        num_spatial=W, comm=CommConfig(round_deadline_s=deadline, **kw))
    jstep = jax.jit(jswarm.build_train_step(jm.loss, jcfg))
    tstep = swarm_dist.build_train_step(tm.loss, tcfg)
    js, ts = jswarm.init_state(jp, jcfg), swarm_dist.init_state(tp, tcfg)
    lates, drains = [], []
    for r in range(2):
        key = jax.random.PRNGKey(200 + r)
        b, e = (_batches(30 + 2 * r, jm.cfg.vocab_size, (W,)),
                _batches(31 + 2 * r, jm.cfg.vocab_size, ()))
        js, ji = jstep(js, {k: jnp.asarray(v) for k, v in b.items()},
                       {k: jnp.asarray(v) for k, v in e.items()}, key)
        ts, ti = tstep(ts, _torch_batch(b), _torch_batch(e),
                       jax_dist_draws(key, jcfg.comm, jp, W, "mdsl"))
        what = f"mesh straggler round {r + 1}"
        np.testing.assert_array_equal(ti.mask.numpy(), np.asarray(ji.mask))
        for f in ("late", "drained", "buffered", "held", "delivered",
                  "bytes_up"):
            assert float(getattr(ti, f)) == float(getattr(ji, f)), (what, f)
        np.testing.assert_allclose(ti.losses.numpy(), np.asarray(ji.losses),
                                   rtol=0, atol=LOSS_TOL)
        np.testing.assert_allclose(float(ti.global_loss),
                                   float(ji.global_loss), rtol=0,
                                   atol=LOSS_TOL)
        _eq_tree(ts.global_params, js.global_params, PARAM_TOL)
        _eq_tree(ts.buffer.delta, js.buffer.delta, PARAM_TOL)
        np.testing.assert_array_equal(ts.buffer.age.numpy(),
                                      np.asarray(js.buffer.age))
        lates.append(float(ti.late))
        drains.append(float(ti.drained))
    assert lates[0] == 1.0 and drains[1] == 1.0


# ---------------------------------------------------------------------------
# record keys: the port's run records have the reference's keys
# ---------------------------------------------------------------------------

# what the port's records add to the reference's, by engine
PORT_EXTRAS = {"paper": set(), "mesh": {"device", "launches"}}


@pytest.mark.parametrize("case", [
    ("straggler/deadline-tight", ("data.num_workers=4", "model.width_mult=2",
                                  "data.n_local=64", "algo.local_epochs=1",
                                  "comm.quorum=2")),
    ("faults/churn", ("data.num_workers=4", "data.n_local=64",
                      "comm.quorum=2")),
    ("quickstart", ("data.num_workers=4", "data.n_local=64",
                    "fleet.population=64", "fleet.cohort_size=4")),
    ("mesh/smollm-smoke", ("model.seq_len=16",
                           "comm.round_deadline_s=1e-9",
                           "comm.fault_prob=0.2")),
], ids=["straggler", "churn", "population", "mesh-straggler"])
def test_record_keys_match_reference(case):
    name, sets = case
    spec = override(get_scenario(name), "run.rounds=2", *sets)
    want = jrun(spec, verbose=False).record
    got = prunner.run(pspec.from_dict(to_dict(spec)), verbose=False,
                      device="cpu").record
    engine = "mesh" if spec.model.kind == "mesh" else "paper"
    assert set(got) - set(want) == PORT_EXTRAS[engine]
    assert set(want) <= set(got)
    for k in ("transmitted", "late", "drained", "buffered", "held",
              "cohort"):
        if k in want:
            assert type(got[k][0]) is type(want[k][0]), k
