"""`experiments.sweep` with `jobs > 1` in the port: the grid's cells run in
spawned processes and give, record for record, what `jobs = 1` gives
(exact, apart from the wall-clock `round_time_s`); the artifacts of cells
that share a scenario name do not collide; and the examples run."""
import json

import pytest
import torch

from repro_torch.experiments import get_scenario, override, sweep
from repro_torch.experiments.runner import sweep_cells
from test_torch_figures import _two_threads  # noqa: F401  (torch on 2 threads)

TIMES = ("round_time_s",)


def _untimed(rec):
    return {k: v for k, v in json.loads(json.dumps(rec)).items()
            if k not in TIMES}


def test_pool_sweep_equals_serial_sweep(tmp_path, capsys, monkeypatch):
    """`quickstart`, 1 round, seeds 0 and 1, with obs on: the pool's
    records equal the serial ones and the saved artifacts; each pool cell
    wrote its own stream (run ids embed the child's pid and a nonce), and
    the parent's sweep-level stream holds one SweepEvent a cell in grid
    order."""
    from repro_torch.obs import read_events
    # the pool's children take torch's threads from the environment, as
    # this process has them from the autouse fixture: one thread count
    # on both sides
    monkeypatch.setenv("OMP_NUM_THREADS", str(torch.get_num_threads()))
    spec = override(get_scenario("quickstart"), "run.rounds=1",
                    "run.obs.enabled=true", f"run.obs.dir={tmp_path / 'obs'}")
    serial = sweep([spec], seeds=(0, 1), out_dir=tmp_path / "one",
                   device="cpu")
    pooled = sweep([spec], seeds=(0, 1), out_dir=tmp_path / "two",
                   device="cpu", jobs=2)
    assert [r.spec for r in pooled] == [r.spec for r in serial]
    assert [_untimed(r.record) for r in pooled] == [
        _untimed(r.record) for r in serial]
    for res in pooled:
        path = tmp_path / "two" / f"quickstart__s{res.spec.run.seed}__torch.json"
        saved = json.loads(path.read_text())["metrics"]
        assert _untimed(saved) == _untimed(res.record)
    err = capsys.readouterr().err
    assert err.count("[sweep] quickstart") == 4 and "launches={}" in err

    paths = [r.events_path for r in pooled]
    assert len(set(paths) | {r.events_path for r in serial}) == 4
    assert [read_events(q)[-1].status for q in paths] == ["ok", "ok"]
    grids = sorted((tmp_path / "obs").glob("sweep__*.jsonl"))
    assert len(grids) == 2
    cells = [[(e.seed, e.events) for e in read_events(g) if e.kind == "sweep"]
             for g in grids]
    assert [(0, paths[0]), (1, paths[1])] in cells


def test_cells_that_share_a_name_get_distinct_artifacts(tmp_path):
    base = get_scenario("quickstart")
    specs = [override(base, f"algo.algorithm={a}") for a in ("fedavg",
                                                             "mdsl")]
    names = [p.name for _, p in sweep_cells(specs, (0, 1), tmp_path)]
    assert names == ["quickstart__c0__s0__torch.json",
                     "quickstart__c1__s1__torch.json",
                     "quickstart__c2__s0__torch.json",
                     "quickstart__c3__s1__torch.json"]
    other = [p.name for _, p in sweep_cells(
        [base, get_scenario("edge-iot/noniid2")], (0,), tmp_path)]
    assert other == ["quickstart__s0__torch.json",
                     "edge-iot-noniid2__s0__torch.json"]


def test_pool_sweep_without_card_raises_before_spawning(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = override(get_scenario("quickstart"), "run.rounds=1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep([spec], jobs=2)


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []),
    ("edge_iot_noniid", ["--rounds", "1", "--workers", "4"]),
    ("serve_decode", []),
])
def test_examples_run_on_cpu(name, argv, capsys, monkeypatch):
    import importlib
    from test_torch_figures import small_eval_sets
    small_eval_sets(monkeypatch)      # the examples run in this process
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    out = mod.main([*argv, "--device", "cpu"])
    printed = capsys.readouterr().out
    if name == "quickstart":
        assert len(out["acc"]) == 4 and "final acc" in printed
    elif name == "edge_iot_noniid":
        assert set(out) == {"fedavg", "mdsl"}
        assert "checkpointed to" in printed
    else:
        assert {r["output_shape"][1] for r in out.values()} == {8}
        assert all(r["logits_finite"] for r in out.values())
