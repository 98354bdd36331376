"""Composable event sinks + stream readers.

Write side: `JsonlSink` (the canonical append stream under
`artifacts/obs/`, one line per event, flushed per emit so `monitor.py
--follow` tails a live run), `CsvSink` (per-round metric rows for
spreadsheet folks), `RingBufferSink` (in-memory tail for tests and
embedders), `FanoutSink` (tee). All sinks are process-local: under
`sweep(jobs=N)` every pool process writes its own stream file (run ids
embed the pid), and `merge_streams` re-groups a directory of streams by
run id on the read side — no cross-process file locking anywhere.

Read side: `read_events` (strict typed parse), `follow_jsonl`
(tail -f semantics with rotation awareness), `merge_streams`.
"""
from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Iterable, Iterator, Optional

from repro_torch.obs.events import Event, RoundEvent, parse_line

# repo root: src/repro_torch/obs/sinks.py -> parents[3]
OBS_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "obs"


def default_obs_dir() -> Path:
    return OBS_DIR


class Sink:
    """Interface: emit/flush/close (context-manager sugar included)."""

    def emit(self, event: Event) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "Sink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class JsonlSink(Sink):
    """Append-only JSONL stream, flushed per event (a round is a slow
    beat — durability and tailability beat buffering). `rotate_bytes`
    caps the live file: on overflow the current file shifts to
    `<name>.1` and a fresh stream continues (long sweeps can't fill the
    disk with one unbounded file)."""

    def __init__(self, path: str | Path, rotate_bytes: int = 0):
        self.path = Path(path)
        self.rotate_bytes = rotate_bytes
        self._fh = None

    def _open(self):
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("a")
        return self._fh

    def emit(self, event: Event) -> None:
        fh = self._open()
        fh.write(event.to_json() + "\n")
        fh.flush()
        if self.rotate_bytes and fh.tell() > self.rotate_bytes:
            self._rotate()

    def _rotate(self) -> None:
        self._fh.close()
        self._fh = None
        self.path.replace(self.path.with_name(self.path.name + ".1"))

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class CsvSink(Sink):
    """Per-round metric rows as CSV. Columns are fixed by the first
    RoundEvent (run_id, round, t_s, then the row's metric keys in
    insertion order); later events write those columns, missing keys
    empty. Non-round events are ignored — CSV is the spreadsheet view,
    the JSONL stream stays the source of truth."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fh = None
        self._writer = None
        self._fields: Optional[list[str]] = None

    def emit(self, event: Event) -> None:
        if not isinstance(event, RoundEvent):
            return
        if self._writer is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("w", newline="")
            self._fields = (["run_id", "round", "t_s"]
                            + list(event.metrics))
            self._writer = csv.DictWriter(self._fh, self._fields,
                                          extrasaction="ignore")
            self._writer.writeheader()
        row = {"run_id": event.run_id, "round": event.round,
               "t_s": event.t_s}
        row.update(event.metrics)
        self._writer.writerow(row)
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class RingBufferSink(Sink):
    """Last-N events in memory (tests, embedded dashboards)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self.events: list[Event] = []

    def emit(self, event: Event) -> None:
        self.events.append(event)
        if len(self.events) > self.capacity:
            del self.events[: len(self.events) - self.capacity]


class FanoutSink(Sink):
    """Tee one emitter into several sinks (JSONL + CSV + ring...).
    `path` proxies the first path-bearing child so Emitter.path still
    names the canonical stream."""

    def __init__(self, *sinks: Sink):
        self.sinks = sinks

    @property
    def path(self):
        for s in self.sinks:
            p = getattr(s, "path", None)
            if p is not None:
                return p
        return None

    def emit(self, event: Event) -> None:
        for s in self.sinks:
            s.emit(event)

    def flush(self) -> None:
        for s in self.sinks:
            s.flush()

    def close(self) -> None:
        for s in self.sinks:
            s.close()


# ---------------------------------------------------------------------------
# read side
# ---------------------------------------------------------------------------

def iter_jsonl(path: str | Path) -> Iterator[dict]:
    with Path(path).open() as fh:
        for line in fh:
            line = line.strip()
            if line:
                yield json.loads(line)


def read_events(path: str | Path) -> list[Event]:
    """Strict typed parse of one stream (unknown kinds/fields raise)."""
    return [parse_line(json.dumps(d)) for d in iter_jsonl(path)]


def follow_jsonl(path: str | Path, poll_s: float = 0.5,
                 stop_kinds: tuple[str, ...] = ("run_end",),
                 timeout_s: Optional[float] = None) -> Iterator[Event]:
    """tail -f one stream: yields events as the producer appends them,
    returning after a `stop_kinds` event (the run is over) or after
    `timeout_s` with no growth. Ctrl-C is the other exit."""
    path = Path(path)
    pos = 0
    deadline = None if timeout_s is None else time.time() + timeout_s
    while True:
        if path.exists():
            with path.open() as fh:
                fh.seek(pos)
                while True:
                    # readline (not iteration) keeps fh.tell() legal
                    line = fh.readline()
                    if not line or not line.endswith("\n"):
                        break  # EOF or partial write: re-read next poll
                    pos = fh.tell()
                    line = line.strip()
                    if not line:
                        continue
                    ev = parse_line(line)
                    yield ev
                    deadline = (None if timeout_s is None
                                else time.time() + timeout_s)
                    if ev.kind in stop_kinds:
                        return
        if deadline is not None and time.time() > deadline:
            return
        time.sleep(poll_s)


def merge_streams(paths: Iterable[str | Path]
                  ) -> dict[str, list[Event]]:
    """Re-group many per-process stream files by run id, each run's
    events ordered by its monotonic clock (the sweep-pool merge)."""
    runs: dict[str, list[Event]] = {}
    for p in paths:
        for ev in read_events(p):
            runs.setdefault(ev.run_id, []).append(ev)
    for evs in runs.values():
        evs.sort(key=lambda e: e.t_s)
    return runs
