"""BENCHMARK.json and the files it names: every configuration, cell
(with its traffic mix) and per-layer metric found by name, every name
and unit in the allowed characters, and a new cell picked up from new
files alone."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BM = harness.benchmark()
NUMBERS = ("loss_gap", "loss_gap_r1_mean", "loss_gap_r1_global",
           "grad_gap", "change_gap", "decision_flips")


def _names():
    out = [c["name"] for c in BM["configs"]]
    for w in BM["workloads"]:
        out += [w["name"], w["config"], w["traffic"]]
    out += [m["name"] for m in BM["end_to_end"] + BM["per_layer"]]
    out += [k for c in BM["configs"] for k in c["reduced"]]
    return out


@pytest.mark.parametrize("name", _names())
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BM["end_to_end"] + BM["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if metric in BM["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BM["end_to_end"]}
        assert "\n" not in metric["layer"] and 0 < len(metric["layer"]) <= 200
    for w in metric.get("workloads", []):
        harness.entry(BM, w)
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


@pytest.mark.parametrize("cell", BM["workloads"], ids=lambda w: w["name"])
def test_cell_files_load_by_name(cell):
    wl = harness.load_json("workloads", cell["name"])
    assert wl["config"] == cell["config"]
    assert wl["traffic"]["name"] == cell["traffic"]
    assert wl["traffic"]["kind"] in ("fleet", "tokens")
    cfg = harness.load_json("configs", cell["config"])
    assert cfg["name"] == cell["config"]
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    for m in harness.metrics_for(BM, cell["name"], "per_layer"):
        assert callable(harness.reader(m["name"]))
    assert set(wl["check"]["limits"]) <= set(NUMBERS)
    assert wl["check"]["limits"]["decision_flips"] == 0


@pytest.mark.parametrize("config", BM["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    cfg = json.loads((harness.ROOT / config["file"]).read_text())
    assert cfg["name"] == config["name"] and cfg["reduced"] == config["reduced"]
    assert config["file"].startswith("bench/configs/")
    assert cfg["source"] and config["source"]


def test_benchmark_keys():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["paths"] == ["bench"] and 1 <= BM["run_seconds"] <= 51
    assert {m["name"] for m in BM["end_to_end"]} >= {"setup_s", "round_s"}
    assert len(json.dumps(BM)) < 64 * 1024


def test_new_cell_from_new_files(tmp_path):
    """A copy of bench/ with one more cell, added as files alone (its
    workload with its traffic mix, and a BENCHMARK.json entry), runs it."""
    shutil.copytree(harness.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bm = json.loads(json.dumps(BM))
    bm["workloads"].append({"name": "cnn5.int4-c3", "config": "cnn5-w8-mnist",
                            "traffic": "int4-c3", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))
    wl = harness.load_json("workloads", "cnn5.int4-c200")
    wl["traffic"].update(name="int4-c3", workers=3, n_local=64, n_global=128)
    (tmp_path / "bench/workloads/cnn5.int4-c3.json").write_text(
        json.dumps(wl))
    code = ("import sys, json; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from bench import harness; "
            "assert harness.BENCH.parent == __import__('pathlib').Path("
            "sys.argv[1]); "
            "out = harness.run_cell('cnn5.int4-c3', 5, 0.1, False, 'cpu'); "
            "print(json.dumps(out))")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                          str(harness.ROOT / "src")], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and set(out["metrics"]) == {"round_s", "setup_s"}
