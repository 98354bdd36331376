"""Terminal dashboard over an obs event stream (the port's or the JAX
package's: the two share the event schema).

    python -m repro_torch.obs.monitor artifacts/obs/quickstart__...jsonl
    python -m repro_torch.obs.monitor artifacts/obs/ --follow
    python -m repro_torch.launch.monitor <run.jsonl> --follow   # same tool

Renders, for a finished stream or a live tail (--follow): run identity
and round progress, round rate, global loss / accuracy trajectories
(sparklines), selection and delivery counts, cumulative bytes / airtime
/ energy, and the per-stage time breakdown (host phases per round +
trace-time pipeline stages). Sweep streams render as a per-cell table.
Pure stdlib — it must work over ssh on the edge gateway the run lives
on.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import Iterable, Optional

from repro_torch.obs.events import (Event, KernelEvent, LogEvent, RoundEvent,
                              RunEnd, RunStart, StageEvent, SweepEvent)
from repro_torch.obs.sinks import follow_jsonl, read_events

SPARK = "▁▂▃▄▅▆▇█"  # ▁..█


def spark(values: list[float], width: int = 40) -> str:
    """Unicode sparkline, downsampled to `width` buckets."""
    vals = [float(v) for v in values if v == v]  # drop NaN
    if not vals:
        return ""
    if len(vals) > width:
        step = len(vals) / width
        vals = [vals[int(i * step)] for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(SPARK[int((v - lo) / span * (len(SPARK) - 1))]
                   for v in vals)


def _fmt_bytes(n: float) -> str:
    for unit, div in (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)):
        if abs(n) >= div:
            return f"{n / div:.2f}{unit}"
    return f"{n:.0f}B"


@dataclasses.dataclass
class RunView:
    """Everything the renderer needs, folded from one run's events."""
    start: Optional[RunStart] = None
    rounds: list[RoundEvent] = dataclasses.field(default_factory=list)
    stages: dict = dataclasses.field(default_factory=dict)
    kernels: list[KernelEvent] = dataclasses.field(default_factory=list)
    cells: list[SweepEvent] = dataclasses.field(default_factory=list)
    logs: list[LogEvent] = dataclasses.field(default_factory=list)
    end: Optional[RunEnd] = None

    def metric(self, key: str) -> list[float]:
        return [e.metrics[key] for e in self.rounds if key in e.metrics]


def summarize(events: Iterable[Event]) -> RunView:
    v = RunView()
    for ev in events:
        if isinstance(ev, RunStart):
            v.start = ev
        elif isinstance(ev, RoundEvent):
            v.rounds.append(ev)
        elif isinstance(ev, StageEvent):
            cnt, tot = v.stages.get((ev.phase, ev.stage), (0, 0.0))
            v.stages[(ev.phase, ev.stage)] = (cnt + 1, tot + ev.dur_s)
        elif isinstance(ev, KernelEvent):
            v.kernels.append(ev)
        elif isinstance(ev, SweepEvent):
            v.cells.append(ev)
        elif isinstance(ev, LogEvent):
            v.logs.append(ev)
        elif isinstance(ev, RunEnd):
            v.end = ev
    return v


def _trajectory_lines(v: RunView, width: int) -> list[str]:
    out = []
    for key, label in (("global_loss", "loss"), ("acc", "acc ")):
        ys = v.metric(key)
        if ys:
            out.append(f"  {label}  {ys[0]:.4f} -> {ys[-1]:.4f}  "
                       f"{spark(ys, width - 30)}")
    return out


def _stage_lines(v: RunView) -> list[str]:
    out = []
    for phase, title in (("host", "stages (host, per round)"),
                         ("trace", "stages (jit trace)")):
        rows = [(s, c, t) for (p, s), (c, t) in sorted(v.stages.items())
                if p == phase]
        if not rows:
            continue
        total = sum(t for _, _, t in rows) or 1.0
        out.append(f"  {title}:")
        for stage, cnt, tot in sorted(rows, key=lambda r: -r[2]):
            bar = "#" * max(1, int(20 * tot / total))
            out.append(f"    {stage:<12} {cnt:>4}x  total {tot:8.3f}s  "
                       f"avg {tot / cnt:8.4f}s  {bar}")
    return out


def _sweep_lines(v: RunView) -> list[str]:
    out = [f"  cells ({len(v.cells)}):"]
    for c in v.cells:
        final = "-" if c.final is None else f"{c.final:.4f}"
        wall = "-" if c.wall_s is None else f"{c.wall_s:.1f}s"
        extra = ""
        if "total_energy_j" in c.metrics:
            extra = f"  energy={c.metrics['total_energy_j']:.3f}J"
        out.append(f"    {c.cell:<28} s{c.seed}  final={final:<8} "
                   f"wall={wall:<7}{extra}")
    return out


def render(events: Iterable[Event], width: int = 78) -> str:
    """One full dashboard frame as a string (stateless: re-renders from
    the event list every time, so --follow is just re-render on tail)."""
    v = summarize(events)
    lines: list[str] = []
    s = v.start
    if s is not None:
        total = f"/{s.rounds}" if s.rounds else ""
        lines.append(f"run {s.scenario or s.run_id} s{s.seed} "
                     f"[{s.engine}] C={s.num_workers} "
                     f"n_params={s.n_params}")
        done = len(v.rounds)
        t_last = v.rounds[-1].t_s if v.rounds else 0.0
        rate = done / t_last if t_last > 0 else 0.0
        state = "done" if v.end is not None else "running"
        lines.append(f"  rounds {done}{total}  {state}  "
                     f"{t_last:.1f}s elapsed  {rate:.2f} rounds/s")
    elif not v.cells:
        lines.append("(no run_start event yet)")

    lines += _trajectory_lines(v, width)

    if v.rounds:
        last = v.rounds[-1].metrics
        sel = v.metric("selected")
        del_ = v.metric("delivered")
        if sel:
            dropped = (f"  dropped(last)="
                       f"{last.get('selected', 0) - last.get('delivered', 0):g}"
                       if del_ else "")
            lines.append(f"  selected last={last.get('selected', 0):g} "
                         f"mean={sum(sel) / len(sel):.1f}"
                         + (f"  delivered mean={sum(del_) / len(del_):.1f}"
                            if del_ else "") + dropped)
        up, down = sum(v.metric("bytes_up")), sum(v.metric("bytes_down"))
        air, en = sum(v.metric("airtime_s")), sum(v.metric("energy_j"))
        lines.append(f"  bytes up={_fmt_bytes(up)} down={_fmt_bytes(down)}"
                     f"  airtime={air:.3f}s  energy={en:.3f}J")

    lines += _stage_lines(v)

    if v.kernels:
        ks = {(k.name, k.backend, k.interpret) for k in v.kernels}
        lines.append("  kernels: " + ", ".join(
            f"{n}[{'interpret' if i else 'compiled'}@{b}]"
            for n, b, i in sorted(ks)))

    if v.cells:
        lines += _sweep_lines(v)

    if v.end is not None:
        tot = "  ".join(f"{k}={v.end.totals[k]:.4g}"
                        for k in sorted(v.end.totals))
        lines.append(f"  end: status={v.end.status} "
                     f"rounds={v.end.rounds}  {tot}")
    return "\n".join(line[:width] for line in lines)


def resolve_stream(path: str | Path) -> Path:
    """A file is itself; a directory means its newest *.jsonl stream."""
    p = Path(path)
    if p.is_dir():
        streams = sorted(p.glob("*.jsonl"), key=lambda f: f.stat().st_mtime)
        if not streams:
            raise FileNotFoundError(f"no *.jsonl streams under {p}")
        return streams[-1]
    if not p.exists():
        raise FileNotFoundError(str(p))
    return p


def follow(path: Path, width: int, interval_s: float,
           out=sys.stdout) -> None:
    """Re-render the dashboard as the stream grows; returns after the
    run_end event lands (or Ctrl-C)."""
    events: list[Event] = []
    try:
        for ev in follow_jsonl(path, poll_s=interval_s):
            events.append(ev)
            if isinstance(ev, (RoundEvent, RunEnd, RunStart, SweepEvent)):
                out.write("\x1b[2J\x1b[H" + render(events, width) + "\n")
                out.flush()
    except KeyboardInterrupt:
        pass


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Render an obs event stream (file, or a "
                    "directory meaning its newest stream).")
    ap.add_argument("stream", help="run .jsonl path or obs directory")
    ap.add_argument("--follow", action="store_true",
                    help="tail a live run, re-rendering per round")
    ap.add_argument("--interval", type=float, default=0.5,
                    help="poll interval for --follow (seconds)")
    ap.add_argument("--width", type=int, default=100)
    args = ap.parse_args(argv)
    path = resolve_stream(args.stream)
    try:
        if args.follow:
            follow(path, args.width, args.interval)
            return
        print(render(read_events(path), args.width))
    except BrokenPipeError:  # e.g. `monitor ... | head`
        sys.stderr.close()


if __name__ == "__main__":
    main()
