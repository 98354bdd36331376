"""The port stands alone: no module of repro_torch (its figure drivers
and examples included), and not chip_smoke.py, flash_probe.py,
determinism_probe.py, mesh_probe.py or host_cost_probe.py, imports jax,
the JAX package or the root `benchmarks` drivers; its entry points never
fall back to the CPU on their own."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "flash_probe.py",
    ROOT / "determinism_probe.py", ROOT / "mesh_probe.py",
    ROOT / "host_cost_probe.py"]
# the figure drivers and examples: each must be among PORT_FILES
DRIVERS = ("figures/common.py", "figures/fig3_accuracy.py",
           "figures/fig1_metric.py", "figures/comm_efficiency.py",
           "figures/population_bench.py", "examples/quickstart.py",
           "examples/edge_iot_noniid.py", "examples/serve_decode.py")


# the sharded mesh path: each must be among PORT_FILES
MESH_MODULES = ("sharding/__init__.py", "sharding/rules.py",
                "sharding/param_specs.py", "sharding/boundary.py",
                "launch/mesh.py", "launch/steps.py", "models/moe_ep.py")


# the dry-run and its cost model: each must be among PORT_FILES
DRYRUN_MODULES = ("launch/dryrun.py", "launch/op_costmodel.py",
                  "launch/op_analysis.py", "launch/profile.py")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "benchmarks"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_drivers_are_checked():
    port = ROOT / "src" / "repro_torch"
    assert {port / d for d in DRIVERS} <= set(PORT_FILES)


def test_mesh_modules_are_checked():
    port = ROOT / "src" / "repro_torch"
    assert {port / d for d in MESH_MODULES} <= set(PORT_FILES)
    assert ROOT / "tests" / "torch_mesh_worker.py" not in PORT_FILES
    bad = _imported_roots(ROOT / "tests" / "torch_mesh_worker.py") & {
        "jax", "jaxlib", "repro"}
    assert not bad, f"the mesh tests' ranks import {sorted(bad)}"


def test_dryrun_modules_are_checked():
    port = ROOT / "src" / "repro_torch"
    assert {port / d for d in DRYRUN_MODULES} <= set(PORT_FILES)


def test_production_mesh_needs_its_process_group():
    """Importing launch/mesh touches no device; without a process group
    of 256 (or 512) ranks the mesh raises, naming what it needs."""
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match="256 ranks"):
        mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        mesh.make_production_mesh(multi_pod=True)


def test_run_without_device_raises_instead_of_cpu(monkeypatch):
    from repro_torch.experiments import get_scenario, override, run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = override(get_scenario("quickstart"), "run.rounds=1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(spec, verbose=False)


def test_cli_without_device_raises(monkeypatch, tmp_path):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--scenario", "quickstart", "--rounds", "1",
                    "--out", str(tmp_path / "out.json")])


def test_sweep_serial_writes_artifacts_and_rejects_jobs(tmp_path,
                                                       monkeypatch):
    """Serial artifacts; a pool sweep (jobs > 1) with no card and no
    device is rejected before any process starts."""
    from repro_torch.experiments import get_scenario, override, sweep
    spec = override(get_scenario("quickstart"), "run.rounds=1",
                    "data.num_workers=2", "data.n_local=64")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sweep([spec], jobs=2)
    results = sweep([spec], seeds=(0, 1), out_dir=tmp_path, device="cpu")
    assert [r.spec.run.seed for r in results] == [0, 1]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "quickstart__s0__torch.json", "quickstart__s1__torch.json"]
