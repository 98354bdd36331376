"""The port's `figures/comm_efficiency` against the JAX package's
`benchmarks/comm_efficiency`, its engine swapped for the port's runs as
in tests/test_torch_figures.py (`Replay`): the compressor, phy, Byzantine and
straggler sweeps give equal records (exact), and the `--json` straggler
record has the keys of the root BENCH_stragglers.json and equals the one
the reference driver writes. The quick mode is cut to 1 round, 5
workers (the fewest with which the Byzantine sweep's 2 attackers still
validate: its trimmed mean then trims 2 a side) and 32 local samples a
worker, D_g and the test set to 256 samples (`small_eval_sets`); the
reference's straggler file goes to a temporary directory, never over
the root one; torch runs on two threads (tests/test_torch_figures.py).
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmarks.comm_efficiency as jcomm  # noqa: E402
import benchmarks.common as jcommon  # noqa: E402
from repro_torch.figures import comm_efficiency as pcomm  # noqa: E402
from repro_torch.figures import common as pcommon  # noqa: E402
from test_torch_figures import (Replay, _two_threads,  # noqa: E402,F401
                                small_eval_sets)

QUICK = ("run.rounds=1", "model.width_mult=2", "data.num_workers=5",
         "data.n_local=32", "algo.hp.learning_rate=0.05")


def test_comm_efficiency_record_equals_reference_drivers(tmp_path,
                                                         monkeypatch):
    small_eval_sets(monkeypatch)
    monkeypatch.setattr(jcommon, "BENCH_OUT", tmp_path / "ref")
    monkeypatch.setattr(jcomm, "STRAGGLER_JSON", tmp_path / "ref.json")
    monkeypatch.setattr(pcommon, "BENCH_OUT", tmp_path / "port")
    monkeypatch.setattr(pcommon, "ARTIFACTS", tmp_path / "port")
    monkeypatch.setattr(jcomm, "QUICK", QUICK)
    monkeypatch.setattr(pcomm, "QUICK", QUICK)
    replay = Replay()
    monkeypatch.setattr(pcomm, "run_spec", replay.port(pcomm.run_spec))
    monkeypatch.setattr(jcomm, "run_spec", replay.reference)
    got = pcomm.run(quick=True, stragglers=True, device="cpu")
    want = jcomm.run(quick=True, stragglers=True)
    # 32 runs a driver: 8 compressor, 5 phy, 4 Byzantine and 15
    # straggler cells; the phy sweep's "ideal" cell is mdsl+identity again
    assert replay.calls == replay.served == 32 and len(replay.runs) == 31
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert {"sweep", "phy_sweep", "byzantine_sweep",
            "straggler_sweep"} <= set(got)

    srec = json.loads((tmp_path / "port" / "BENCH_stragglers__torch.json")
                      .read_text())
    assert srec == json.loads((tmp_path / "ref.json").read_text())
    root = json.loads((ROOT / "BENCH_stragglers.json").read_text())
    assert set(srec) == set(root)
    assert set(srec["runs"]) == set(root["runs"])
    assert all(set(srec["runs"][k]) == set(root["runs"][k])
               for k in root["runs"])
    assert (tmp_path / "port" / "comm_efficiency__torch.json").exists()
