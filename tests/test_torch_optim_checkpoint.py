"""The port's optim/ and checkpoint/ against the JAX package's, on the
CPU, from the same numpy inputs.

Tolerances (f32): the optimizers' params after a few steps and the
clipped tree within OPT_RTOL relative (+ OPT_ATOL absolute): XLA and
torch round the same f32 expressions, but may contract or order them
differently; the schedules within SCHED_RTOL (XLA's f32 cos and pow
against torch's). `pso_hybrid` runs on the reference's coefficient
draws (`jax.random.fold_in(PRNGKey(seed), step)`), injected. Checkpoints
are exact: keys and bytes, bf16 included.
"""
from typing import NamedTuple

import hypothesis as hp
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.checkpoint import npz as jnpz
from repro.configs.base import get_arch as jget_arch
from repro.core import pso as jpso
from repro.models.transformer import Transformer as JTransformer
from repro.optim import pso_optimizer as jpso_opt
from repro.optim import schedules as jschedules
from repro_torch import bridge, optim
from repro_torch.checkpoint import (CheckpointManager, read_metadata,
                                    restore_pytree, save_pytree)
from repro_torch.core.pso import PsoCoefficients
from repro_torch.experiments import get_scenario, override, run
from repro_torch.optim import pso_optimizer, schedules
from repro_torch.pytree import tree_leaves

OPT_RTOL, OPT_ATOL = 2e-6, 1e-7
SCHED_RTOL = 1e-6
STEPS = 6


def _tree(rng) -> dict:
    return {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal((3,)).astype(np.float32)}


def _close(got, want, rtol=OPT_RTOL, atol=OPT_ATOL):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd_wd": lambda m: m.sgd(0.1, weight_decay=0.01),
    "momentum": lambda m: m.momentum_sgd(0.05, beta=0.9),
    "nesterov": lambda m: m.momentum_sgd(0.05, beta=0.9, nesterov=True),
    "adamw": lambda m: m.adamw(0.1),
    "adamw_wd_decay": lambda m: m.adamw(m.step_decay(0.1, 0.5, 2),
                                        weight_decay=0.1),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    rng = np.random.default_rng(7)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(STEPS)]
    jopt, topt = OPTIMIZERS[name](joptim), OPTIMIZERS[name](optim)
    jp, tp = jax.tree.map(jnp.asarray, p0), bridge.tree_from_numpy(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for step, g in enumerate(grads):
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, step)
        tu, ts = topt.update(bridge.tree_from_numpy(g), ts, tp, step)
        _close(tu, ju)
        jp, tp = joptim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
    _close(tp, jp)
    assert all(t.dtype == torch.float32 for t in tree_leaves(tp))


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    t = _tree(np.random.default_rng(3))
    want = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, t), max_norm)
    got = optim.clip_by_global_norm(bridge.tree_from_numpy(t), max_norm)
    _close(got, want)
    np.testing.assert_allclose(
        float(optim.global_norm(bridge.tree_from_numpy(t))),
        float(joptim.global_norm(jax.tree.map(jnp.asarray, t))),
        rtol=OPT_RTOL)
    assert float(optim.global_norm(got)) <= max_norm * (1 + 1e-5)


@pytest.mark.parametrize("make", [
    lambda: optim.sgd(0.1),
    lambda: optim.momentum_sgd(0.05, beta=0.9),
    lambda: optim.adamw(0.1),
])
def test_converges_on_quadratic(make):
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(8)
                              .astype(np.float32))
    p, opt = {"w": torch.zeros(8)}, make()
    state = opt.init(p)
    for step in range(200):
        upd, state = opt.update({"w": 2 * (p["w"] - target)}, state, p, step)
        p = optim.apply_updates(p, upd)
    assert float(((p["w"] - target) ** 2).sum()) < 1e-2


SCHEDULES = {
    "constant": lambda m: m.constant(0.03),
    "step_decay": lambda m: m.step_decay(0.01, gamma=0.5, every=10),
    "cosine": lambda m: m.cosine_decay(1.0, total_steps=100),
    "warmup_cosine": lambda m: m.warmup_cosine(1.0, warmup_steps=10,
                                               total_steps=100),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    jfn, tfn = SCHEDULES[name](jschedules), SCHEDULES[name](schedules)
    for step in (0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 150):
        got, want = tfn(step), jfn(jnp.asarray(step))
        assert got.dtype == torch.float32 and got.ndim == 0
        np.testing.assert_allclose(float(got), float(want), rtol=SCHED_RTOL,
                                   atol=1e-12, err_msg=f"step {step}")


# ---------------------------------------------------------------------------
# the PSO-hybrid optimizer
# ---------------------------------------------------------------------------

def _ref_coeffs(seed: int, step: int) -> PsoCoefficients:
    c = jpso.sample_coefficients(
        jax.random.fold_in(jax.random.PRNGKey(seed), step))
    return PsoCoefficients(*(torch.tensor(float(v)) for v in c))


@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_pso_hybrid_and_observe_match_reference(clip):
    """update / observe alternate for a few steps on the reference's
    coefficient draws; losses come from the same quadratic on both."""
    rng = np.random.default_rng(11)
    p0, target = _tree(rng), _tree(rng)
    jopt = joptim.pso_hybrid(0.05, velocity_clip=clip, seed=3)
    topt = optim.pso_hybrid(0.05, velocity_clip=clip, seed=3)
    jp, tp = jax.tree.map(jnp.asarray, p0), bridge.tree_from_numpy(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    jt, tt = jax.tree.map(jnp.asarray, target), bridge.tree_from_numpy(target)
    for step in range(STEPS):
        jg = jax.tree.map(lambda a, b: 2 * (a - b), jp, jt)
        tg = {k: 2 * (tp[k] - tt[k]) for k in tp}
        ju, js = jopt.update(jg, js, jp, step)
        tu, ts = topt.update(tg, ts, tp, step,
                             coeffs=_ref_coeffs(3, step))
        _close(tu, ju)
        jp, tp = joptim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        jl = sum(jnp.sum((jp[k] - jt[k]) ** 2) for k in jp)
        tl = sum(torch.sum((tp[k] - tt[k]) ** 2) for k in tp)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        # the global view: the current params at twice the loss, so the
        # global best moves only on some steps
        js = jpso_opt.observe(js, jp, jl, jp, 2 * jl)
        ts = pso_optimizer.observe(ts, tp, tl, tp, 2 * tl)
        _close(ts.best_params, js.best_params)
        _close(ts.gbest_params, js.gbest_params)
        np.testing.assert_allclose(float(ts.best_loss), float(js.best_loss),
                                   rtol=1e-5)
    _close(ts.velocity, js.velocity)


def test_pso_hybrid_draws_from_its_generator():
    p = {"w": torch.zeros(4)}
    g = {"w": torch.ones(4)}

    def first_update(seed):
        opt = optim.pso_hybrid(0.1, seed=seed)
        st_ = opt.init(p)._replace(best_params={"w": torch.ones(4)})
        return opt.update(g, st_, p, 0)[0]["w"]

    assert torch.equal(first_update(0), first_update(0))
    assert not torch.equal(first_update(0), first_update(1))


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

class _Pair(NamedTuple):
    a: object
    b: object


def _mixed_tree(rng):
    """numpy leaves of every dtype a run saves, bf16 included, under
    dict, list, tuple and NamedTuple nodes."""
    x = rng.standard_normal((6, 4)).astype(np.float32)
    return {"layer": {"w": x, "b": np.zeros(4, np.float32),
                      "emb": np.asarray(jnp.asarray(x, jnp.bfloat16))},
            "stack": [np.arange(3, dtype=np.int32),
                      (np.asarray(jnp.asarray(x[0], jnp.bfloat16)),)],
            "pair": _Pair(np.float32(2.5), np.array([True, False])),
            "step": np.asarray(7, np.int32)}


def _port_tree(tree):
    """The same tree with tensor leaves (the NamedTuple kept)."""
    return {"layer": bridge.tree_from_numpy(tree["layer"]),
            "stack": [bridge.array_to_tensor(tree["stack"][0]),
                      (bridge.array_to_tensor(tree["stack"][1][0]),)],
            "pair": _Pair(*(bridge.array_to_tensor(v) for v in tree["pair"])),
            "step": bridge.array_to_tensor(tree["step"])}


def _flat_bytes(nested, prefix=""):
    out = {}
    for k, v in nested.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat_bytes(v, key + "/"))
        else:
            out[key] = (v.dtype.str, v.shape, v.tobytes())
    return out


def test_reference_file_restores_in_the_port_bit_for_bit(tmp_path):
    tree = _mixed_tree(np.random.default_rng(0))
    p = tmp_path / "ref.npz"
    jnpz.save_pytree(p, jax.tree.map(jnp.asarray, tree),
                     metadata={"note": "ref"})
    like = _port_tree(tree)
    back = restore_pytree(p, like=like)
    assert isinstance(back["pair"], _Pair)
    for got, want in zip(tree_leaves(back), tree_leaves(like)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert bytes(bridge.tensor_to_array(got).tobytes()) == \
            bytes(bridge.tensor_to_array(want).tobytes())
    assert back["layer"]["emb"].dtype == torch.bfloat16
    assert read_metadata(p) == jnpz.read_metadata(p) == {"note": "ref"}
    # without a template: the reference's own nested dict, byte for byte
    assert _flat_bytes(restore_pytree(p)) == _flat_bytes(
        jnpz.restore_pytree(p))


def test_port_file_loads_in_the_reference(tmp_path):
    tree = _mixed_tree(np.random.default_rng(1))
    mine, ref = tmp_path / "port.npz", tmp_path / "ref.npz"
    save_pytree(mine, _port_tree(tree), metadata={"arch": "x"})
    jnpz.save_pytree(ref, jax.tree.map(jnp.asarray, tree),
                     metadata={"arch": "x"})
    got, want = jnpz.restore_pytree(mine), jnpz.restore_pytree(ref)
    assert _flat_bytes(got) == _flat_bytes(want)
    assert _flat_bytes(got)["layer/emb"][0] == "|V2"
    with np.load(mine) as a, np.load(ref) as b:
        assert a.files == b.files
        assert bytes(a["__meta__"]) == bytes(b["__meta__"])


def test_restore_into_template_casts_dtype(tmp_path):
    save_pytree(tmp_path / "ck.npz", {"w": torch.ones(4)})
    back = restore_pytree(tmp_path / "ck.npz",
                          like={"w": torch.zeros(4, dtype=torch.bfloat16)})
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].float(), torch.ones(4))


def test_template_mismatch_raises(tmp_path):
    save_pytree(tmp_path / "ck.npz", {"w": torch.ones(3)})
    with pytest.raises(ValueError, match="mismatch"):
        restore_pytree(tmp_path / "ck.npz", like={"other": torch.ones(3)})


def test_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, max_to_keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for s in [1, 2, 3, 4]:
        mgr.save(s, {"w": torch.full((2,), float(s))})
    assert mgr.all_steps() == [3, 4] == jnpz.CheckpointManager(
        tmp_path, max_to_keep=2).all_steps()
    step, tree = mgr.restore()
    assert step == 4
    np.testing.assert_array_equal(tree["w"], [4.0, 4.0])
    assert read_metadata(tmp_path / "ckpt_00000004.npz") == {"step": 4}
    assert not list(tmp_path.glob("*.tmp"))


@hp.given(st.lists(st.integers(1, 40), min_size=1, max_size=6, unique=True))
@hp.settings(max_examples=10, deadline=None)
def test_manager_keeps_newest(tmp_path_factory, steps):
    mgr = CheckpointManager(tmp_path_factory.mktemp("ck"), max_to_keep=3)
    for s in sorted(steps):
        mgr.save(s, {"w": torch.zeros(1)})
    assert mgr.all_steps() == sorted(steps)[-3:]


def test_mesh_run_checkpoints_every_round(tmp_path):
    """A reduced mesh/smollm-smoke run with run.ckpt_dir: the newest three
    rounds kept, the last restoring bitwise into the final params, its
    keys those of the reference's params of the same arch."""
    spec = override(get_scenario("mesh/smollm-smoke"), "data.num_workers=2",
                    "model.seq_len=16", "model.per_worker_batch=1",
                    "run.rounds=4", f"run.ckpt_dir={tmp_path / 'ck'}")
    res = run(spec, verbose=False, device="cpu")
    assert res.record["ckpt_steps"] == [1, 2, 3]
    live = res.state.global_params
    step, back = CheckpointManager(tmp_path / "ck").restore(like=live)
    assert step == 3
    for got, want in zip(tree_leaves(back), tree_leaves(live)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert {t.dtype for t in tree_leaves(live)} >= {torch.bfloat16}
    assert read_metadata(tmp_path / "ck" / "ckpt_00000003.npz") == {
        "step": 3, "arch": "smollm-360m"}
    jparams = JTransformer(jget_arch("smollm-360m").reduced()).init(
        jax.random.PRNGKey(0))
    jnpz.save_pytree(tmp_path / "ref.npz", jparams)
    with np.load(tmp_path / "ref.npz") as a, \
            np.load(tmp_path / "ck" / "ckpt_00000003.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                   for k in a.files if k != "__meta__")
