"""The port's figure drivers (`repro_torch.figures`) against the JAX
package's `benchmarks/` drivers.

Each reference driver is run with its engine swapped for the port's:
the port driver runs first and its runs are recorded (`Replay`), then
the reference driver's `run_spec` is served the port's run of the same
spec (its JSON must equal one the port driver ran). So the two drivers
see the same runs, and their records must be equal (exact, apart from
the float analysis of Fig. 1: rtol 1e-6, f32 min-max scaling in both).
The quick modes are cut further (1 round, 4 workers, 64 local samples)
and the shared eval set D_g and the test set to 256 samples
(`small_eval_sets`; 2048 in the runs proper, where their evaluation is
most of a small round's CPU time) to fit the CPU, and torch runs on two
threads (`torch_threads`: beside the suite's other workers, torch's
default of a thread a core multiplies the small ops' cost many times). Records go to
temporary directories, never over the root `BENCH_*.json`; the
population record is held to the keys of the root
BENCH_population.json.
"""
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmarks.common as jcommon  # noqa: E402
import benchmarks.fig1_metric as jfig1  # noqa: E402
import benchmarks.fig3_accuracy as jfig3  # noqa: E402
from repro.experiments import to_dict as jto_dict  # noqa: E402
from repro_torch.data import partition  # noqa: E402
from repro_torch.experiments import runner as prunner  # noqa: E402
from repro_torch.experiments import to_dict as pto_dict  # noqa: E402
from repro_torch.figures import common as pcommon  # noqa: E402
from repro_torch.figures import fig1_metric as pfig1  # noqa: E402
from repro_torch.figures import fig3_accuracy as pfig3  # noqa: E402
from repro_torch.figures import population_bench as ppop  # noqa: E402

TINY = ("run.rounds=1", "model.width_mult=2", "algo.local_epochs=1",
        "data.num_workers=4", "data.n_local=64",
        "algo.hp.learning_rate=0.05")


@contextlib.contextmanager
def torch_threads(n):
    """torch's intra-op threads at n, restored after."""
    was = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(was)


@pytest.fixture(autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def small_eval_sets(monkeypatch, n=256):
    """Partitions in this process build D_g and the test set with n
    samples each: a test of what runs around the engine, whose rounds
    otherwise spend most of their CPU time evaluating 2048 samples."""
    build = partition._build
    monkeypatch.setattr(
        partition, "_build", lambda gen, labels, spec, n_global, n_test,
        alphas: build(gen, labels, spec, n, n, alphas))


class Replay:
    """The port driver's runs, recorded by spec JSON as it makes them
    (`port(run)` wraps its engine), then served to the reference driver
    (`reference` is its `run_spec`): a spec the port driver did not run
    is a KeyError. `calls` counts the port driver's runs, `served` the
    reference driver's requests."""

    def __init__(self):
        self.runs = {}
        self.calls = self.served = 0

    @staticmethod
    def _key(spec_dict):
        return json.dumps(json.loads(json.dumps(spec_dict)), sort_keys=True)

    def port(self, engine):
        def run(spec, *args, **kwargs):
            res = engine(spec, *args, **kwargs)
            self.runs[self._key(pto_dict(spec))] = res
            self.calls += 1
            return res
        return run

    def reference(self, spec, verbose=False, **_):
        self.served += 1
        return self.runs[self._key(jto_dict(spec))]


@pytest.fixture
def outdirs(tmp_path, monkeypatch):
    small_eval_sets(monkeypatch)
    monkeypatch.setattr(jcommon, "BENCH_OUT", tmp_path / "ref")
    monkeypatch.setattr(pcommon, "BENCH_OUT", tmp_path / "port")
    monkeypatch.setattr(pcommon, "ARTIFACTS", tmp_path / "port")
    monkeypatch.setattr(pfig3, "BENCH_OUT", tmp_path / "port")
    return tmp_path


def test_fig3_record_equals_reference_drivers(outdirs, monkeypatch):
    monkeypatch.setattr(jfig3, "QUICK", TINY)
    monkeypatch.setattr(pfig3, "QUICK", TINY)
    replay = Replay()
    monkeypatch.setattr(prunner, "run", replay.port(prunner.run))
    monkeypatch.setattr(jfig3, "run_spec", replay.reference)
    got = pfig3.run(quick=True, device="cpu")
    want = jfig3.run(quick=True)
    assert replay.calls == replay.served == len(replay.runs) == 12
    assert got == want
    saved = json.loads((outdirs / "port" / "fig3_accuracy__torch.json")
                       .read_text())
    assert saved == json.loads(json.dumps(want))
    assert len(list((outdirs / "port" / "fig3_accuracy__torch")
                    .glob("*.json"))) == 12


def test_fig1_analysis_equals_reference_drivers(outdirs, monkeypatch):
    """The same fleet measurements and FedAvg accuracies through both
    drivers' Eq.-2 fit, eta and gap statistics."""
    measured = {a: pfig1.measure_fleet(a, "mnist_like", 4, 0, "cpu")
                for a in pfig1.ALPHAS_QUICK}
    accs = {a: 0.1 + 0.8 * i / 5 + 0.05 * (i % 2)
            for i, a in enumerate(pfig1.ALPHAS_QUICK)}
    monkeypatch.setattr(jfig1, "measure_fleet",
                        lambda a, *_: measured[a])
    monkeypatch.setattr(pfig1, "measure_fleet",
                        lambda a, *_: measured[a])
    monkeypatch.setattr(jfig1, "_fedavg_at",
                        lambda a, *_, **__: {"final_acc": accs[a]})
    monkeypatch.setattr(pfig1, "_fedavg_at",
                        lambda a, *_, **__: {"final_acc": accs[a]})
    want = jfig1.run(quick=True)
    got = pfig1.run(quick=True, device="cpu")
    assert set(got) == set(want)
    for k in ("alphas", "label_ratio", "wd", "fedavg_acc", "dataset"):
        assert got[k] == want[k], k
    for k in ("eta", "coeffs"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7)
    for k in ("r2_train", "r2_test"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    for k, v in want["gaps"].items():
        np.testing.assert_allclose(got["gaps"][k], v, rtol=1e-6, atol=1e-7)


def test_fig1_runs_the_port_engine(outdirs, monkeypatch):
    monkeypatch.setattr(pfig1, "ALPHAS_QUICK", [0.1, 10.0])
    rec = pfig1.run(quick=True, num_workers=4, rounds=1, device="cpu")
    assert set(rec) == {"alphas", "label_ratio", "wd", "fedavg_acc", "eta",
                        "coeffs", "r2_train", "r2_test", "gaps", "dataset"}
    assert all(0.0 <= a <= 1.0 for a in rec["fedavg_acc"])
    # low alpha: fewer label types a worker and a larger W_i
    assert rec["label_ratio"][0] < rec["label_ratio"][1]
    assert rec["wd"][0] > rec["wd"][1]
    assert (outdirs / "port" / "fig1_metric__torch.json").exists()


def test_population_record_has_the_root_records_keys(outdirs,
                                                     monkeypatch):
    monkeypatch.setattr(ppop, "POPULATIONS", (1_000, 1_000_000))
    rec = ppop.run(quick=True, write=True, device="cpu")
    want = json.loads((ROOT / "BENCH_population.json").read_text())
    got = json.loads((outdirs / "port" / "BENCH_population__torch.json")
                     .read_text())
    assert got == json.loads(json.dumps(rec))
    assert set(got) == set(want)
    assert all(set(r) == set(want["rows"][0]) for r in got["rows"])
    assert [r["population"] for r in got["rows"]] == [1_000, 1_000_000]
    assert [r["table_mb"] for r in got["rows"]] == [0.04, 36.0]
    assert all(np.isfinite(r["final_loss"]) for r in got["rows"])
