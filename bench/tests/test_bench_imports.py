"""The import walk: no module under bench/ imports JAX, Flax or the JAX
package (`repro`), top-level names compared whole (the port's name,
`repro_torch`, begins with the JAX package's); bench/reference and
bench/costs import nothing of the port either."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _tops(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_port_in_the_yardstick(path):
    tops = _tops(path)
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    rel = path.relative_to(BENCH).parts
    if rel[0] in ("reference", "costs"):
        assert "repro_torch" not in tops, tops


def test_walk_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.kernels\nfrom repro_torch import x\n")
    assert _tops(f) == {"repro_torch"}
    f.write_text("import repro.core\n")
    assert _tops(f) == {"repro"}
