"""Reduced sizes of the benchmark's cells that a CPU test run holds: a C 4
fleet of 128 images a worker, and SmolLM-360M's family at the port's own
smoke widths (2 layers, d 128, 4 heads, d_ff 256, vocab 512)."""
from bench import harness


def _cell(name: str, **traffic) -> dict:
    cell = harness.load_json("workloads", name)
    return dict(cell, traffic=dict(cell["traffic"], **traffic))


def paper(name: str = "cnn5.int4-c200") -> dict:
    cell = _cell(name, workers=4, n_local=128, n_global=256)
    return {"name": name, "cell": cell,
            "config": harness.load_json("configs", cell["config"])}


def mesh(name: str = "smollm360m.mdsl-w2-b8") -> dict:
    cell = _cell(name, batch=2, seq_len=64)
    cfg = dict(harness.load_json("configs", cell["config"]),
               reduced_arch=True, num_hidden_layers=2, hidden_size=128,
               num_attention_heads=4, num_key_value_heads=4, head_dim=32,
               intermediate_size=256, vocab_size=512)
    return {"name": name, "cell": cell, "config": cfg}


def run(size: dict, seed: int, traced: bool = False, **kw) -> dict:
    return harness.run_cell(size["name"], seed, 0.2, traced, "cpu",
                            cell=size["cell"], config=size["config"], **kw)
