"""The five registered presets of the straggler and population engines run
end to end in the port on the CPU (`experiments.run(spec,
device="cpu")`), at their registered sizes cut in rounds only, and give
the reference's record keys.

The reference's keys come from its own run of the same preset with the
fleet cut to 4 workers (a record's keys do not depend on its sizes);
the port's full-width paper rounds (C = 50, CNN5 width 8) take ~40 s
each here.
"""
import math

import numpy as np
import pytest

from repro.experiments import get_scenario as jget_scenario
from repro.experiments import override as joverride
from repro.experiments import run as jrun
from repro_torch.experiments import get_scenario, override, run

PRESETS = ("straggler/deadline-tight", "straggler/fedbuff", "faults/churn",
           "fleet/million-uniform", "fleet/million-score")


def _reference_keys(name):
    spec = jget_scenario(name)
    cut = ["run.rounds=1", "data.num_workers=4", "data.n_local=64",
           "algo.local_epochs=1", "model.width_mult=2"]
    if spec.comm.quorum > 4:
        cut.append("comm.quorum=4")
    if spec.fleet.population:
        cut.append("fleet.cohort_size=4")
    return set(jrun(joverride(spec, *cut), verbose=False).record)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_runs_on_cpu_with_reference_keys(name):
    spec = override(get_scenario(name), "run.rounds=1")
    rec = run(spec, verbose=False, device="cpu").record
    assert set(rec) == _reference_keys(name)
    assert all(math.isfinite(v) for v in rec["global_loss"])
    assert all(0.0 <= v <= 1.0 for v in rec["acc"])
    K = spec.data.num_workers
    if spec.comm.round_deadline_s is not None:
        for k in ("late", "drained", "buffered", "held"):
            assert all(isinstance(v, int) for v in rec[k]), k
        assert rec["drained"] == [0]                 # nothing parked yet
        assert 0 <= rec["late"][0] <= rec["selected"][0]
    if spec.comm.fault_prob > 0:
        assert rec["transmitted"][0] <= rec["selected"][0]
    if spec.fleet.population:
        assert rec["population"] == spec.fleet.population == 1_000_000
        assert rec["cohort_size"] == K
        cohort = np.asarray(rec["cohort"][0])
        assert cohort.shape == (K,) and len(set(cohort.tolist())) == K
        assert (cohort >= 0).all() and (cohort < 1_000_000).all()
