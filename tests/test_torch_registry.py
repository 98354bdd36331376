"""Registry completeness: every scenario the JAX package registers runs one
round in the port on the CPU, at a reduced size, and gives finite losses
and the record keys of its kind; `mesh/xlstm-smoke` raises
NotImplementedError for its xLSTM blocks (ROADMAP queue 1, the xLSTM
item). The full-size registered runs are the card's (chip_smoke.py).

Reduced size: paper scenarios 4 workers (a population of 1,000 for the
fleets; 8 workers with 1 attacker for the Byzantine ones, so a trimmed
mean at 0.2 still trims one a side), CNN width 2, 64 local samples, 1
epoch, D_g and the test set 256 samples (2048 in the runs proper); a
quorum above 4 drops to 4; the mesh scenario its reduced arch at
sequence 16. Torch runs on two threads (tests/test_torch_figures.py).
"""
import math

import pytest

from repro.experiments import list_scenarios as jlist_scenarios
from repro_torch.experiments import get_scenario, list_scenarios, override, run
from test_torch_figures import _two_threads, small_eval_sets  # noqa: F401

PAPER_KEYS = {"algorithm", "case", "dataset", "model", "rounds",
              "num_workers", "tau", "seed", "n_params", "eta", "comm",
              "payload_bytes_per_worker", "dense_bytes_per_worker",
              "downlink_bytes_per_worker", "acc", "global_loss", "selected",
              "delivered", "uploaded_params", "bytes_up", "bytes_down",
              "airtime_s", "energy_j", "mean_snr_db", "round_time_s",
              "final_acc", "best_acc", "total_uploaded_params",
              "total_bytes_up", "total_bytes_down", "total_airtime_s",
              "total_energy_j", "compression_ratio"}
UNPORTED = {"mesh/xlstm-smoke"}


def _reduced(name):
    spec = get_scenario(name)
    if spec.model.kind == "mesh":
        return override(spec, "run.rounds=1", "model.seq_len=16")
    workers = 8 if spec.comm.byzantine else 4
    cut = ["run.rounds=1", f"data.num_workers={workers}", "data.n_local=64",
           "algo.local_epochs=1", "model.width_mult=2"]
    if spec.comm.quorum > 4:
        cut.append("comm.quorum=4")
    if spec.comm.byzantine:
        cut.append("comm.byzantine=1")
    if spec.fleet.population:
        cut += ["fleet.cohort_size=4", "fleet.population=1000"]
    return override(spec, *cut)


def test_registry_is_the_references():
    assert list_scenarios() == jlist_scenarios()


@pytest.mark.parametrize("name", sorted(set(list_scenarios()) - UNPORTED))
def test_every_scenario_runs_one_round(name, monkeypatch):
    small_eval_sets(monkeypatch)
    spec = _reduced(name)
    rec = run(spec, verbose=False, device="cpu").record
    assert all(math.isfinite(v) for v in rec["global_loss"])
    if spec.model.kind == "paper":
        assert PAPER_KEYS <= set(rec)
        assert all(0.0 <= v <= 1.0 for v in rec["acc"])
        assert (0 <= rec["delivered"][0] <= rec["selected"][0]
                <= spec.data.num_workers)
    else:
        assert rec["steps"] == 1 and len(rec["worker_losses"][0]) == 2


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_scenario_raises(name):
    with pytest.raises(NotImplementedError, match="xLSTM"):
        run(_reduced(name), verbose=False, device="cpu")
