"""Typed telemetry events + the run emitter (the obs bus's data model).

Every observable moment of a run is one typed event on a JSONL stream:

  RunStart    run identity (run_id / scenario / seed / engine), fleet
              shape, the full ExperimentSpec that produced the run
  RoundEvent  one communication round's metric row — the same floats
              that land in the artifact history, bit-equal (the runner
              builds one row dict and feeds both)
  StageEvent  a span: host-side wall-time of one pipeline stage or
              runner phase (Step, Eval). The port runs every round
              eagerly, so all its spans are phase="host" with the round
              index; the JAX package's pipeline stages are
              phase="trace", timed once while jit traces the round
  KernelEvent a kernel dispatch decision (the CUDA kernel, or the plain
              version in ref.py on a CPU tensor)
  SweepEvent  one finished (scenario, seed) cell of a sweep/benchmark
  LogEvent    the human-readable progress line, preserved in-stream
  RunEnd      terminal summary (rounds completed, cumulative totals)

Events carry a monotonic run clock `t_s` (seconds since the emitter was
created, `time.perf_counter` based — immune to wall-clock steps) plus
the `run_id` so streams from different processes (sweep pools write one
stream per worker process) can be merged and re-grouped by run.

`Emitter` stamps identity + clock onto events and forwards to a sink
(`repro_torch.obs.sinks`). `NULL` is the disabled emitter: every method is a
no-op (spans return a shared nullcontext), so obs-off runs pay only a
few attribute checks per round.

The event types, their fields and `EVENT_SCHEMA` are the JAX package's
(`repro.obs.events`), so a stream of either package parses with the
other's reader.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
import uuid
from typing import Any, ClassVar, Iterator, Optional

EVENT_SCHEMA = 1


class RunClock:
    """Monotonic seconds since construction (the run's t=0)."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0


def new_run_id(tag: str) -> str:
    """Collision-safe id: <tag>__<utc stamp>__p<pid>__<nonce>. The tag
    (scenario name / seed) keeps streams human-greppable; pid + nonce
    keep `sweep(jobs=N)` pool processes from colliding."""
    safe = tag.replace("/", "-").replace(" ", "_") or "run"
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    return f"{safe}__{stamp}__p{os.getpid()}__{uuid.uuid4().hex[:6]}"


# ---------------------------------------------------------------------------
# event types
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Event:
    """Base: identity + run clock. Subclasses set `kind`."""
    kind: ClassVar[str] = ""
    run_id: str = ""
    t_s: float = 0.0

    def to_dict(self) -> dict:
        d = {"kind": self.kind}
        d.update(dataclasses.asdict(self))
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


@dataclasses.dataclass(frozen=True)
class RunStart(Event):
    kind: ClassVar[str] = "run_start"
    scenario: str = ""
    seed: int = 0
    engine: str = ""                 # "paper" | "mesh"
    num_workers: int = 0
    rounds: int = 0
    n_params: int = 0
    population: int = 0              # registered fleet size (0 = no
    #                                  population engine: full fleet)
    cohort: int = 0                  # active devices per round (0 = all)
    schema: int = EVENT_SCHEMA
    wall_time: float = 0.0           # unix epoch at start (for humans)
    spec: Optional[dict] = None      # full ExperimentSpec (to_dict)


@dataclasses.dataclass(frozen=True)
class RoundEvent(Event):
    """One communication round's metrics row, bit-equal to the artifact
    history (experiments/runner.py builds both from the same dict).

    `metrics` is free-form on purpose — engine features surface new
    keys without an event-schema bump. Stable keys: acc/global_loss,
    selected/delivered, bytes_up/bytes_down, airtime_s/energy_j,
    mean_snr_db. The straggler engine (comm.straggler) adds
    late/drained/buffered/held, fault injection adds transmitted, and
    the population engine adds the cohort id list — each present only
    when its feature is on, so stream consumers key off membership."""
    kind: ClassVar[str] = "round"
    round: int = 0                   # 0-based round index
    metrics: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class StageEvent(Event):
    kind: ClassVar[str] = "stage"
    stage: str = ""                  # LocalUpdate/ScoreSelect/... or Step/Eval
    dur_s: float = 0.0
    phase: str = "host"              # "host" | "trace" (JAX package)
    round: Optional[int] = None      # None for trace-time spans


@dataclasses.dataclass(frozen=True)
class KernelEvent(Event):
    kind: ClassVar[str] = "kernel"
    name: str = ""                   # e.g. "quant_pack"
    backend: str = ""                # the tensor's device type
    interpret: bool = False          # the plain version ran (CPU)
    info: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class SweepEvent(Event):
    kind: ClassVar[str] = "sweep"
    cell: str = ""                   # scenario name / benchmark cell label
    seed: int = 0
    status: str = "ok"
    final: Optional[float] = None    # headline metric (acc or loss)
    wall_s: Optional[float] = None
    artifact: Optional[str] = None   # metrics JSON path
    events: Optional[str] = None     # the cell's own event stream
    metrics: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class LogEvent(Event):
    kind: ClassVar[str] = "log"
    msg: str = ""


@dataclasses.dataclass(frozen=True)
class RunEnd(Event):
    kind: ClassVar[str] = "run_end"
    rounds: int = 0
    status: str = "ok"
    totals: dict = dataclasses.field(default_factory=dict)


EVENT_TYPES: dict[str, type] = {
    c.kind: c for c in (RunStart, RoundEvent, StageEvent, KernelEvent,
                        SweepEvent, LogEvent, RunEnd)
}


def parse(obj: dict) -> Event:
    """dict (one decoded JSONL line) -> typed event. Unknown kinds and
    unknown fields fail loudly — a stream a newer writer produced should
    be read with that writer's schema, not silently mangled."""
    d = dict(obj)
    kind = d.pop("kind", None)
    cls = EVENT_TYPES.get(kind)
    if cls is None:
        raise ValueError(f"unknown event kind {kind!r} "
                         f"(known: {sorted(EVENT_TYPES)})")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return cls(**d)


def parse_line(line: str) -> Event:
    return parse(json.loads(line))


# ---------------------------------------------------------------------------
# the emitter
# ---------------------------------------------------------------------------

_NULLCTX = contextlib.nullcontext()


class Emitter:
    """Stamps run identity + the monotonic clock onto events and feeds
    a sink. One emitter == one run == one stream."""

    active = True

    def __init__(self, run_id: str, sink: Any, clock: RunClock = None):
        self.run_id = run_id
        self.sink = sink
        self.clock = clock or RunClock()

    @property
    def path(self) -> Optional[str]:
        p = getattr(self.sink, "path", None)
        return str(p) if p is not None else None

    def emit(self, event: Event) -> None:
        self.sink.emit(event)

    def _stamp(self, cls, **kw) -> Event:
        ev = cls(run_id=self.run_id, t_s=self.clock.now(), **kw)
        self.emit(ev)
        return ev

    # -- typed helpers ---------------------------------------------------
    def run_start(self, **kw) -> Event:
        return self._stamp(RunStart, wall_time=time.time(), **kw)

    def round(self, round_idx: int, metrics: dict) -> Event:
        return self._stamp(RoundEvent, round=round_idx, metrics=metrics)

    def stage(self, stage: str, dur_s: float, *, phase: str = "host",
              round_idx: Optional[int] = None) -> Event:
        return self._stamp(StageEvent, stage=stage, dur_s=dur_s,
                           phase=phase, round=round_idx)

    def kernel(self, name: str, *, backend: str, interpret: bool,
               **info) -> Event:
        return self._stamp(KernelEvent, name=name, backend=backend,
                           interpret=interpret, info=info)

    def sweep_cell(self, cell: str, **kw) -> Event:
        return self._stamp(SweepEvent, cell=cell, **kw)

    def run_end(self, rounds: int, totals: dict = None,
                status: str = "ok") -> Event:
        return self._stamp(RunEnd, rounds=rounds, totals=totals or {},
                           status=status)

    def log(self, msg: str, echo: bool = True) -> None:
        """The human progress line: printed (when echoed) AND kept on
        the stream, so a finished run's transcript replays in the
        monitor."""
        if echo:
            print(msg, flush=True)
        self._stamp(LogEvent, msg=msg)

    @contextlib.contextmanager
    def span(self, stage: str, *, round_idx: Optional[int] = None,
             phase: str = "host") -> Iterator[None]:
        t0 = self.clock.now()
        try:
            yield
        finally:
            self.stage(stage, self.clock.now() - t0, phase=phase,
                       round_idx=round_idx)

    def flush(self) -> None:
        self.sink.flush()

    def close(self) -> None:
        self.sink.close()


class NullEmitter:
    """Obs disabled: every hook is a no-op; `log` still echoes so the
    verbose path prints exactly as before."""

    active = False
    run_id = ""
    path = None

    def emit(self, event: Event) -> None:
        pass

    def run_start(self, **kw) -> None:
        pass

    def round(self, round_idx: int, metrics: dict) -> None:
        pass

    def stage(self, *a, **kw) -> None:
        pass

    def kernel(self, *a, **kw) -> None:
        pass

    def sweep_cell(self, *a, **kw) -> None:
        pass

    def run_end(self, *a, **kw) -> None:
        pass

    def log(self, msg: str, echo: bool = True) -> None:
        if echo:
            print(msg, flush=True)

    def span(self, stage: str, *, round_idx: Optional[int] = None,
             phase: str = "host"):
        return _NULLCTX

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL = NullEmitter()
