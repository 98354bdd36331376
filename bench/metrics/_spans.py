"""What the program's spans hold in the traced rounds. A program span is
a `record_function` range that the program opens (`obs.trace.stage_span`:
LocalUpdate and its children, ScoreSelect, the wire's stages,
GlobalLoss, BestTracking): every traced range but the benchmark's own,
whose names start with `bench.`. Each reading is per round."""
from __future__ import annotations

from bench import trace

# Host operations that wait until the device has drained its stream: the
# innermost operation of a device-to-host read (`aten::item`, `float(t)`,
# `equal` and `is_nonzero` end in `_local_scalar_dense`; `nonzero` reads
# its count back to size its output), and the one that launched a copy
# between the device and pageable host memory (`torch.tensor(x,
# device=...)`, a CPU tensor copied to the device), which synchronises
# the stream after it.
WAITS = frozenset({"aten::_local_scalar_dense", "aten::nonzero"})
PAGEABLE = "Pageable"


def _program(tr) -> dict:
    return {n: r for n, r in tr.ranges.items() if not n.startswith("bench.")}


def device_ms(ctx, name: str) -> float | None:
    """Device ms a round of the operations launched inside the span
    `name` (its children included); None where it was not traced."""
    tr = ctx.trace
    if tr is None or not tr.ops:
        return None
    s = trace.stage_s(tr, (name,))
    return None if s is None else 1e3 * s / tr.rounds


def waits(tr) -> list:
    """(start, end) us of each host op that waited on the device, sorted;
    one nested in another is left out."""
    found = {(s, e) for s, e, n in tr.host_ops if n in WAITS}
    # the innermost host op around each pageable copy's launch, by its
    # interval
    by_span = [(s, e, (s, e)) for s, e, _ in tr.host_ops]
    for op in tr.ops:
        if PAGEABLE in op.name and op.launch is not None:
            host = trace._innermost(by_span, op.launch)
            if host is not None:
                found.add(host)
    out = []
    for s, e in sorted(found, key=lambda se: (se[0], -se[1])):
        if not out or s >= out[-1][1]:
            out.append((s, e))
    return out


def host_waits(tr) -> dict:
    """Host ms a round of `waits`, by the innermost program span open
    where each starts; a wait outside every program span (the
    benchmark's own read of the loss) does not count."""
    spans = sorted((s, e, n) for n, rs in _program(tr).items()
                   for s, e in rs)
    out = {}
    for s, e in waits(tr):
        if not tr.window[0] <= s <= tr.window[1]:
            continue
        where = trace._innermost(spans, s)
        if where is not None:
            out[where] = out.get(where, 0.0) + 1e-3 * (e - s) / tr.rounds
    return out


def launches(tr) -> tuple[float, float, float]:
    """Device operations a round launched inside a program span; those
    launched outside every one, and their device ms a round."""
    inside = trace.busy(sorted(trace.DeviceOp(s, e, "", None)
                               for rs in _program(tr).values()
                               for s, e in rs))
    n_in = n_out = out_us = 0
    for op in tr.ops:
        if op.launch is None:
            continue
        if trace._inside(inside, op.launch):
            n_in += 1
        else:
            n_out += 1
            out_us += op.end - op.start
    return (n_in / tr.rounds, n_out / tr.rounds,
            1e-3 * out_us / tr.rounds)

