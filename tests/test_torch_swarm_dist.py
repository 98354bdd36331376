"""The port's mesh engine (`core/swarm_dist`, `Transformer.loss`, the
mesh driver of `experiments.run`, `launch.train --set`) against the JAX
package on the CPU, on reduced smollm-360m in f32 with W = 2 workers.

Both sides start from the same params (JAX init -> numpy -> bridge) and
see the same batches; the port takes the JAX key chain's draws (PSO
coefficients, wire seeds) as explicit inputs.

Tolerances (f32; the two frameworks sum the transformer's matmuls, the
softmax and the cross-entropy in other orders):
  * losses, theta, the global loss and the best losses: LOSS_TOL
    (measured up to 9.5e-7 on losses of ~6.2);
  * params, velocity, best and global params after a round: PARAM_TOL
    (measured up to 4.5e-8 on params of |x| <= 2.1 and velocities of
    |v| <= 5.7e-4); the loss gradient: PARAM_TOL / lr, the scale an SGD
    step at lr 3e-3 turns into a param difference;
  * selection masks, delivered counts and bytes: exact;
  * the 3-round run's global and worker losses: LOSS_TOL per round.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import phy as jphy
from repro.configs.base import get_arch as jget_arch
from repro.core import pso as jpso
from repro.core import rounds as jrounds
from repro.core import swarm_dist as jswarm
from repro.experiments import get_scenario as jget_scenario
from repro.experiments import override as joverride
from repro.experiments import run as jrun
from repro.models.transformer import Transformer as JTransformer
from repro_torch import bridge
from repro_torch.configs.base import ArchConfig
from repro_torch.core import rounds as prounds
from repro_torch.core import swarm_dist
from repro_torch.core.mdsl import RoundDraws
from repro_torch.experiments import build, get_scenario, override
from repro_torch.experiments import run_prepared
from repro_torch.experiments import runner as prunner
from repro_torch.kernels import runtime
from repro_torch.launch import train
from repro_torch.models.transformer import Transformer
from repro_torch.pytree import tree_flatten, tree_leaves, tree_unflatten

W, B, S = 2, 2, 32
LOSS_TOL = 5e-6
PARAM_TOL = 2e-7
ARCH = "smollm-360m"


def _f32_arch(name):
    return dataclasses.replace(jget_arch(name), dtype="float32")


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, port model, port params) of reduced
    smollm-360m in f32."""
    cj = _f32_arch(ARCH).reduced()
    jm = JTransformer(cj)
    jp = jm.init(jax.random.PRNGKey(0))
    ct = ArchConfig(**dataclasses.asdict(cj))
    tp = bridge.transformer_params_from_numpy(ct, jax.tree.map(np.asarray,
                                                               jp))
    return jm, jp, Transformer(ct), tp


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batches(seed, vocab, lead):
    toks = np.random.default_rng(seed).integers(0, vocab, lead + (B, S))
    toks = toks.astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=-1)}


def _torch_batch(b):
    return {k: _t(v).to(torch.int64) for k, v in b.items()}


def jax_dist_draws(key, comm, params, num_workers, algorithm):
    """The draws `repro.core.swarm_dist`'s train step consumes from
    `key`, in the port's RoundDraws form (its key split; the wire's
    per-leaf seeds, downlink salt and phy stream as rounds.py draws
    them)."""
    if algorithm == "fedavg":
        bkey, qkey, wkey = jax.random.split(key, 3)
        coeffs = np.zeros((num_workers, 3), np.float32)
    else:
        ckey, bkey, qkey, wkey = jax.random.split(key, 4)
        co = jax.vmap(jpso.sample_coefficients)(
            jax.random.split(ckey, num_workers))
        coeffs = np.stack([np.asarray(co.c0), np.asarray(co.c1),
                           np.asarray(co.c2)], axis=1)
    leaves = jax.tree.leaves(params)
    imax = jnp.iinfo(jnp.int32).max

    def seed(k, i):
        return int(jax.random.randint(jax.random.fold_in(k, i), (), 0, imax))

    up = np.array([[seed(qk, i) for i in range(len(leaves))]
                   for qk in jax.random.split(qkey, num_workers)], np.int32)
    dkey = jax.random.fold_in(qkey, jrounds._DOWNLINK_SALT)
    down = np.array([seed(dkey, i) for i in range(len(leaves))], np.int32)
    link = jphy.link_model(comm)
    ekey, _ = jax.random.split(wkey)
    keep = fade = byz = None
    if link.drop_prob > 0:
        keep = np.asarray(jax.random.bernoulli(
            ekey, 1.0 - link.drop_prob, (num_workers,)), np.float32)
    if comm.fading != "none":
        kr, ki = jax.random.split(jax.random.fold_in(wkey, jphy.PHY_SALT))
        fade = np.stack([np.asarray(jax.random.normal(k, (num_workers,)))
                         for k in (kr, ki)])
    assert not link.awgn, "AWGN draws are not carried across here"
    if comm.byzantine and comm.byzantine_mode == "gaussian":
        byz = [np.asarray(jax.random.normal(jax.random.fold_in(bkey, i),
                                            (num_workers,) + x.shape))
               for i, x in enumerate(leaves)]

    def t(a):
        return None if a is None else torch.as_tensor(a)

    return RoundDraws(coeffs=t(coeffs), perms=torch.zeros((num_workers, 0, 0),
                                                           dtype=torch.int64),
                      up_seeds=t(up), down_seeds=t(down), keep=t(keep),
                      fade=t(fade), noise=None,
                      byz_noise=None if byz is None else [t(b) for b in byz])


def _close_tree(got, want, tol, what):
    gl = tree_leaves(bridge.tree_to_numpy(got))
    wl = jax.tree.leaves(_np(want))
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert g.shape == w.shape, f"{what} leaf {i}"
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=f"{what} leaf {i}")


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got.detach().cpu(), np.float32),
                               np.asarray(want, np.float32), rtol=0, atol=tol,
                               err_msg=what)


def _check_telemetry(ti, ji, what):
    _close(ti.losses, ji.losses, LOSS_TOL, f"{what} losses")
    _close(ti.theta, ji.theta, LOSS_TOL, f"{what} theta")
    np.testing.assert_array_equal(ti.mask.numpy(), np.asarray(ji.mask))
    _close(ti.global_loss, ji.global_loss, LOSS_TOL, f"{what} global loss")
    assert float(ti.bytes_up) == float(ji.bytes_up)
    assert float(ti.delivered) == float(ji.delivered)


# ---------------------------------------------------------------------------
# the loss and its gradient (with remat)
# ---------------------------------------------------------------------------

def test_transformer_loss_and_grad_match_reference(models):
    jm, jp, tm, tp = models
    b = _batches(1, jm.cfg.vocab_size, ())
    b["labels"][0, 5:9] = -1                       # masked targets
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    xs = bridge.tree_from_numpy(bridge.tree_to_numpy(tp))
    leaves, treedef = tree_flatten(xs)
    leaves = [x.requires_grad_() for x in leaves]
    assert tm.cfg.remat
    tl = tm.loss(tree_unflatten(treedef, leaves), _torch_batch(b))
    grads = torch.autograd.grad(tl, leaves)
    _close(tl, jl, LOSS_TOL, "loss")
    _close_tree(tree_unflatten(treedef, list(grads)), jg, PARAM_TOL / 3e-3,
                "grads")


# ---------------------------------------------------------------------------
# one M-DSL round (two, so that Eq. 8's wl - w and wg - w are live) and
# one FedAvg round
# ---------------------------------------------------------------------------

def test_mdsl_rounds_match_reference(models):
    jm, jp, tm, tp = models
    jcfg = jswarm.DistSwarmConfig(worker_axes=(), num_spatial=W)
    tcfg = swarm_dist.DistSwarmConfig(num_spatial=W)
    jstep = jax.jit(jswarm.build_train_step(jm.loss, jcfg))
    tstep = swarm_dist.build_train_step(tm.loss, tcfg)
    js, ts = jswarm.init_state(jp, jcfg), swarm_dist.init_state(tp, tcfg)
    for r in range(2):
        key = jax.random.PRNGKey(100 + r)
        b, e = (_batches(10 + 2 * r, jm.cfg.vocab_size, (W,)),
                _batches(11 + 2 * r, jm.cfg.vocab_size, ()))
        js, ji = jstep(js, {k: jnp.asarray(v) for k, v in b.items()},
                       {k: jnp.asarray(v) for k, v in e.items()}, key)
        ts, ti = tstep(ts, _torch_batch(b), _torch_batch(e),
                       jax_dist_draws(key, jcfg.comm, jp, W, "mdsl"))
        what = f"round {r + 1}"
        _check_telemetry(ti, ji, what)
        for field in ("params", "velocity", "best_params", "global_params",
                      "gbest_params"):
            _close_tree(getattr(ts, field), getattr(js, field), PARAM_TOL,
                        f"{what} {field}")
        for field in ("best_loss", "gbest_loss", "prev_theta_mean"):
            _close(getattr(ts, field), getattr(js, field), LOSS_TOL,
                   f"{what} {field}")
        assert ts.round_idx == int(js.round_idx) == r + 1


def test_fedavg_round_matches_reference(models):
    jm, jp, tm, tp = models
    jcfg = jswarm.DistSwarmConfig(worker_axes=(), num_spatial=W)
    tcfg = swarm_dist.DistSwarmConfig(num_spatial=W)
    key = jax.random.PRNGKey(7)
    b, e = (_batches(20, jm.cfg.vocab_size, (W,)),
            _batches(21, jm.cfg.vocab_size, ()))
    js, ji = jax.jit(jswarm.fedavg_train_step(jm.loss, jcfg))(
        jswarm.init_state(jp, jcfg), {k: jnp.asarray(v) for k, v in
                                      b.items()},
        {k: jnp.asarray(v) for k, v in e.items()}, key)
    runtime.reset_counts()
    ts, ti = swarm_dist.fedavg_train_step(tm.loss, tcfg)(
        swarm_dist.init_state(tp, tcfg), _torch_batch(b), _torch_batch(e),
        jax_dist_draws(key, jcfg.comm, jp, W, "fedavg"))
    assert runtime.counts() == {}                    # plain versions, CPU
    _check_telemetry(ti, ji, "fedavg")
    assert float(ti.mask.sum()) == W
    _close_tree(ts.global_params, js.global_params, PARAM_TOL,
                "fedavg global params")
    assert ts.round_idx == 1


# ---------------------------------------------------------------------------
# the mesh driver: a 3-round run against the reference's
# ---------------------------------------------------------------------------

def test_three_round_run_tracks_reference(monkeypatch):
    import repro.configs.base as jbase
    monkeypatch.setattr(jbase, "get_arch", _f32_arch)
    monkeypatch.setattr(prunner, "get_arch", lambda name: ArchConfig(
        **dataclasses.asdict(_f32_arch(name))))
    sets = ("run.rounds=3", f"model.seq_len={S}", "run.seed=3")
    want = jrun(joverride(jget_scenario("mesh/smollm-smoke"), *sets),
                verbose=False).record

    # the reference runner's key chain: params from PRNGKey(seed), then
    # per round (key, k1, k2, k3) = split(key, 4) for the worker
    # batches, the eval batch and the step's draws
    cj = _f32_arch(ARCH).reduced()
    key = jax.random.PRNGKey(3)
    jp = JTransformer(cj).init(key)
    prep = build(override(get_scenario("mesh/smollm-smoke"), *sets),
                 device="cpu", init_params=_np(jp))
    chain = [key]

    def batch_for(k, lead):
        toks = jax.random.randint(k, lead + (B, S), 0, cj.vocab_size)
        return _torch_batch({"tokens": np.asarray(toks),
                             "labels": np.roll(np.asarray(toks), -1, -1)})

    def draw(state):
        chain[0], k1, k2, k3 = jax.random.split(chain[0], 4)
        return (batch_for(k1, (W,)), batch_for(k2, ()),
                jax_dist_draws(k3, prep.aux["dcfg"].comm, jp, W, "mdsl"))

    got = run_prepared(prep._replace(draw=draw), verbose=False).record
    assert set(want) <= set(got)
    assert got["device"] == "cpu"
    assert got["launches"] == [{}, {}, {}]          # plain versions, CPU
    np.testing.assert_allclose(got["global_loss"], want["global_loss"],
                               rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(got["worker_losses"], want["worker_losses"],
                               rtol=0, atol=LOSS_TOL)
    for k in ("selected", "delivered", "bytes_up", "bytes_down",
              "payload_bytes_per_worker", "downlink_bytes_per_worker",
              "steps", "arch", "reduced"):
        assert got[k] == want[k], k


# ---------------------------------------------------------------------------
# stage helpers
# ---------------------------------------------------------------------------

def test_best_tracking_matches_reference():
    rng = np.random.default_rng(0)
    best = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((3, 2, 2)).astype(np.float32)}}
    new = jax.tree.map(lambda x: x + 1.0, best)
    best_loss = np.array([1.0, np.inf, 0.5], np.float32)
    losses = np.array([0.7, 2.0, 0.9], np.float32)
    jb, jl = jrounds.track_local_best(best, best_loss, new, losses)
    tb, tl = prounds.track_local_best(bridge.tree_from_numpy(best),
                                      _t(best_loss),
                                      bridge.tree_from_numpy(new), _t(losses))
    _close_tree(tb, jb, 0.0, "local best")
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    g = jax.tree.map(lambda x: x[0], best)
    gn = jax.tree.map(lambda x: x[1], best)
    for loss in (0.3, 0.9):
        jg, jgl = jrounds.track_global_best(g, np.float32(0.5), gn,
                                            np.float32(loss))
        tg, tgl = prounds.track_global_best(
            bridge.tree_from_numpy(g), torch.tensor(0.5),
            bridge.tree_from_numpy(gn), torch.tensor(loss))
        _close_tree(tg, jg, 0.0, f"global best at {loss}")
        assert float(tgl) == float(jgl)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_accumulated_grad_matches_reference(microbatches):
    rng = np.random.default_rng(microbatches)
    p = {"w": rng.standard_normal((5, 3)).astype(np.float32),
         "b": rng.standard_normal((3,)).astype(np.float32)}
    batch = {"x": rng.standard_normal((4, 5)).astype(np.float32),
             "y": rng.standard_normal((4, 3)).astype(np.float32)}

    def jloss(p, b):
        return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    def tloss(p, b):
        return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    want = jrounds.accumulated_grad(jax.value_and_grad(jloss), p, batch,
                                    microbatches)
    got = prounds.accumulated_grad(swarm_dist._grad_fn(tloss),
                                   bridge.tree_from_numpy(p),
                                   bridge.tree_from_numpy(batch),
                                   microbatches)
    _close_tree(got, want, 1e-6, f"k={microbatches}")
    assert all(g.dtype == torch.float32 for g in got.values())


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_build_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(override(get_scenario("mesh/smollm-smoke"), "run.rounds=1"))


def test_ckpt_dir_with_obs_on_the_mesh_engine(tmp_path):
    """What chip_smoke.py's checkpoint phase runs, reduced: two rounds
    with run.ckpt_dir and the obs stream, the latest checkpoint restoring
    bitwise into the live params, the stream ending in the final loss."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.obs import read_events
    spec = override(get_scenario("mesh/smollm-smoke"), "run.rounds=2",
                    "model.seq_len=16", f"run.ckpt_dir={tmp_path / 'ck'}",
                    "run.obs.enabled=true", f"run.obs.dir={tmp_path}")
    res = run_prepared(build(spec, device="cpu"), verbose=False)
    assert res.record["ckpt_steps"] == [0, 1]
    live = res.state.global_params
    step, back = CheckpointManager(tmp_path / "ck").restore(like=live)
    assert step == 1
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(tree_leaves(back), tree_leaves(live)))
    evs = read_events(res.events_path)
    assert [e.round for e in evs if e.kind == "round"] == [0, 1]
    assert evs[-1].kind == "run_end" and evs[-1].status == "ok"
    assert evs[-1].totals["final_loss"] == res.record["global_loss"][-1]


def test_set_cli_runs_on_cpu(tmp_path):
    out = tmp_path / "mesh.json"
    train.main(["--scenario", "mesh/smollm-smoke", "--steps", "2",
                "--set", "model.seq_len=16", "--set", "algo.tau=0.5",
                "--device", "cpu", "--out", str(out)])
    res = json.loads(out.read_text())
    assert res["spec"]["model"]["seq_len"] == 16
    assert res["spec"]["algo"]["tau"] == 0.5
    rec = res["metrics"]
    assert rec["steps"] == 2 and len(rec["global_loss"]) == 2
    assert all(np.isfinite(rec["global_loss"]))
    with pytest.raises(SystemExit):
        train.main(["--scenario", "mesh/smollm-smoke", "--set",
                    "model.no_such_field=1", "--device", "cpu"])
