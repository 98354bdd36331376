"""Shared helpers of the port's figure drivers: the record files (the
reference's schema under a port name) and the table printer."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import torch

ROOT = Path(__file__).resolve().parents[3]
ARTIFACTS = ROOT / "artifacts"
BENCH_OUT = ARTIFACTS / "bench"


def save_record(name: str, rec: dict[str, Any]) -> Path:
    """Write `rec` to artifacts/bench/<name>__torch.json."""
    BENCH_OUT.mkdir(parents=True, exist_ok=True)
    p = BENCH_OUT / f"{name}__torch.json"
    p.write_text(json.dumps(rec, indent=1))
    return p


def write_json(name: str, rec: dict[str, Any]) -> Path:
    """A `--json` record: artifacts/<name>__torch.json (the reference
    writes <name>.json at the repository root)."""
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    p = ARTIFACTS / f"{name}__torch.json"
    p.write_text(json.dumps(rec, indent=1))
    return p


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def print_table(headers: list[str], rows: list[list], title: str = "") -> None:
    if title:
        print(f"\n== {title} ==")
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows)) if rows
              else len(str(h)) for i, h in enumerate(headers)]
    line = "  ".join(str(h).ljust(w) for h, w in zip(headers, widths))
    print(line)
    print("-" * len(line))
    for r in rows:
        print("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
