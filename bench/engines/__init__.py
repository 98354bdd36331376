"""Engines: how a cell of one kind drives the port. `bench/run.py` loads
`bench.engines.<workload's engine>` and calls its `Engine(cell, config,
seed, device)` (the traffic mix is the cell's `traffic`): `setup()`
(build, warm-up and the checked rounds), `round()` (one timed round), `free()`, `check()` (the plain reference
over the checked rounds), `launches()`, `flops_per_round()` and
`rates()` (the work of a round behind each rate the cell reports)."""

import time

import torch


class Clock:
    """Seconds between calls, by name: a set-up's phases (the harness
    prints them on stderr)."""

    def __init__(self):
        self.laps, self.t = {}, time.perf_counter()

    def __call__(self, name: str) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.laps[name], self.t = now - self.t, now


def record(**values) -> dict:
    """A checked round's record (reference/decisions.py) from the
    program's telemetry and state: detached copies, left on the device."""
    return {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
            for k, v in values.items()}
