"""On the card, at each cell's own size: a short run comes out correct,
and the control (the plain reference in the next precision below the
configuration's, put in the program's place) comes out not correct.
`python -m pytest bench/tests -q -m card`; skipped without a card."""
import gc
import importlib

import pytest
import torch

from bench import harness
from bench.reference import compare

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_correct(card, name):
    out = harness.run_cell(name, 2**31 + 101, 2.0, False, "cuda")
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_not_correct(card, name):
    cell = harness.load_json("workloads", name)
    eng = importlib.import_module(f"bench.engines.{cell['engine']}").Engine(
        cell, harness.load_json("configs", cell["config"]), 2**31 + 202, card)
    eng.setup()
    eng.free()
    gc.collect()
    torch.cuda.empty_cache()
    low = eng.reference(precision=cell["check"]["control"],
                        hints=[{}] * len(eng.records))
    got = compare.compare(low, eng.reference(hints=low.taken()), eng.paths,
                          cell["algorithm"]["tau"])
    limits = cell["check"]["limits"]
    assert any(got[k][0] > v for k, v in limits.items()), got
