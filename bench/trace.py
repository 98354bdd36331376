"""The reduction of a torch.profiler trace (its Chrome-trace export) to
what the per-layer metrics read: the device's operations (kernels,
copies, fills) with the host moment that launched each, the host's
`record_function` ranges, and the traced window, which the benchmark's
own `bench.round` ranges bound."""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
ROUND = "bench.round"


class DeviceOp(NamedTuple):
    start: float          # us
    end: float
    name: str
    launch: float | None  # host us of the launching runtime call


class Trace(NamedTuple):
    ops: list             # DeviceOp, sorted by start, inside the window
    ranges: dict          # name -> sorted [(start, end)] host ranges
    host_ops: list        # (start, end, name) cpu ops, sorted by start
    window: tuple         # (start, end) us
    rounds: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6


def load(path: str) -> Trace | None:
    """The trace at `path`, or None when it holds no traced round."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    launches, ranges, host_ops, device = {}, defaultdict(list), [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0))
        args = e.get("args") or {}
        if cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = ts
        elif cat == "user_annotation":
            ranges[e["name"]].append((ts, ts + dur))
        elif cat == "cpu_op":
            host_ops.append((ts, ts + dur, e["name"]))
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, e["name"], args.get("correlation")))
    rounds = sorted(ranges.get(ROUND, []))
    if not rounds:
        return None
    window = (rounds[0][0], rounds[-1][1])
    ops = sorted(DeviceOp(s, min(t, window[1]), n, launches.get(c))
                 for s, t, n, c in device
                 if s >= window[0] and s < window[1])
    return Trace(ops=ops, ranges={k: sorted(v) for k, v in ranges.items()},
                 host_ops=sorted(host_ops), window=window,
                 rounds=len(rounds))


def busy(ops: list) -> list:
    """The union of the ops' intervals, as sorted disjoint (start, end)."""
    out = []
    for op in ops:
        if out and op.start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], op.end))
        else:
            out.append((op.start, op.end))
    return out


def busy_s(tr: Trace) -> float:
    return sum(e - s for s, e in busy(tr.ops)) * 1e-6


def _inside(ranges: list, t: float) -> bool:
    i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= t <= ranges[i][1]


def stage_s(tr: Trace, names: tuple) -> float | None:
    """Device seconds of the ops launched inside a host range of one of
    `names`; None when no such range was traced."""
    rs = [tr.ranges[n] for n in names if n in tr.ranges]
    if not rs:
        return None
    return sum(op.end - op.start for op in tr.ops
               if op.launch is not None
               and any(_inside(r, op.launch) for r in rs)) * 1e-6


def by_name(tr: Trace) -> dict:
    """Device seconds by op name."""
    out = defaultdict(float)
    for op in tr.ops:
        out[op.name] += (op.end - op.start) * 1e-6
    return dict(out)


def _innermost(spans: list, t: float) -> str | None:
    """The name of the shortest span (start, end, name) holding t."""
    best = None
    i = bisect.bisect_right(spans, (t, float("inf"), ""))
    for s, e, n in spans[max(0, i - 2000):i]:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, n)
    return None if best is None else best[2]


def idle_gaps(tr: Trace, top: int = 10) -> list:
    """The longest gaps in device activity inside the window, each named
    by the innermost `record_function` range the host was in when the
    gap began and the host op under it."""
    spans = sorted((s, e, n) for n, rs in tr.ranges.items() for s, e in rs)
    edges = [(tr.window[0], tr.window[0])] + busy(tr.ops) + \
        [(tr.window[1], tr.window[1])]
    gaps = []
    for (_, e0), (s1, _) in zip(edges, edges[1:]):
        if s1 > e0:
            gaps.append((s1 - e0, e0))
    gaps.sort(reverse=True)
    out = []
    for dur, t in gaps[:top]:
        label = _innermost(spans, t) or "none"
        op = _innermost(tr.host_ops, t)
        out.append([f"{label} | {op}" if op else label, dur * 1e-6])
    return out
