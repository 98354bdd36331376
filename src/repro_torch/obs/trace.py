"""Per-stage span tracing and torch.profiler round windows.

`stage_span(name)` is the one instrumentation point the round pipeline
and both engines call, at every boundary inside a round. With no tracer
installed it returns `torch.profiler.record_function(name)`: a named
range that costs nothing unless a profiler is recording, where it groups
the host and device time of what runs inside it. The span tree of one
`Prepared.step` (children indented; every operation of the step runs
inside one of these):

    LocalUpdate
      LocalUpdate.score       the workers' scoring forwards on D_g (the
                              paper engine's two, with Eq. 9's local
                              best from the first; the mesh engine's
                              `worker_losses`)
      LocalUpdate.train       local training (the paper engine's vmapped
                              SGD epochs, per-step Eq. 8 inside them
                              under `pso_every_step`; the mesh engine's
                              `local_deltas`)
        LocalUpdate.train.fwd   mesh: one gradient call's loss forward
        LocalUpdate.train.bwd   mesh: its `torch.autograd.grad`, with
                                any recompute
      LocalUpdate.eq8         the round-level Eq. 8 and the Byzantine
                              corruption (absent where no Eq. 8 runs
                              there: FedAvg, `pso_every_step`)
    ScoreSelect               Eqs. 5-6 and the round's selection counts
    WireGather                mesh fleet, dense and straggler routes:
                              the deltas, residuals and parked deltas
                              gathered over the worker axes
    Uplink                    fault deselection, fading, compression
    Straggle                  deadline misses (straggler route)
    Aggregate                 the channel and Eq. 7
    Downlink                  the broadcast, the quorum hold, the round's
                              wire accounting
    WireRelayout              mesh fleet: the wire's outputs laid out as
                              the state is
    GlobalLoss                mesh: the global model's forward on D_g
    BestTracking              Eqs. 9-10 (none in the mesh engine's
                              FedAvg)
      GlobalLoss              paper: the global model's forward on D_g

With a `StageTracer` installed (the runner installs one for obs-enabled
runs), each span of `STAGES` (the stages the reference's stream names):

  * times host issue with `time.perf_counter` and emits a StageEvent
    with phase="host" and the round the runner set (`tracer.round`).
    The port runs every round eagerly, so the spans fire every round;
    the tracer adds no device sync, so a span is the stage's issue time
    plus any wait its own code makes on the device. The runner's own Step
    span ends in a device sync when obs is on, so Step covers device
    time and bounds the stages' sum;
  * opens `torch.profiler.record_function(name)`, so `--profile-dir`
    traces carry the stage names, and on a CUDA device an NVTX range,
    so Nsight timelines do too.

The other spans (the children, the mesh fleet's two and GlobalLoss)
stay profiler ranges: the stream's stage names and counts are the
reference's. LocalUpdate's own time holds the rest of the stage: the
uplink delta, FedAvg's result and, where no Eq. 8 span opens, the
corruption.

One clock: a profiler's Chrome trace (`export_chrome_trace`) stamps an
event at Unix time `baseTimeNanoseconds + 1000 * ts` ns, and the stream
stamps one at Unix time `RunStart.wall_time - RunStart.t_s + t_s` s. A
StageEvent is stamped at its span's end, so its range opens `dur_s`
before that, within a millisecond of the same `record_function` range
in the trace.

`RoundProfiler` owns the `torch.profiler.profile` window (`--profile-dir`
captures `profile_rounds` rounds starting past the round-0 warm-up),
marks each captured round with a "round" range and writes one Chrome
trace named after the run id.

`note_dispatch` is the KernelEvent hook the kernel wrappers call
(re-exported as `repro_torch.kernels.runtime.note_dispatch`). The JAX
package reports a dispatch once per jit trace; an eager wrapper runs on
every launch, so a tracer emits each distinct (name, backend,
interpret, info) once.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import torch

from repro_torch.obs.events import Emitter

_ACTIVE: Optional["StageTracer"] = None

# The spans a StageTracer emits on the stream: the reference's stages.
STAGES = frozenset({"LocalUpdate", "ScoreSelect", "Uplink", "Straggle",
                    "Aggregate", "Downlink", "BestTracking"})


class StageTracer:
    """Emits StageEvents for `stage_span` blocks while installed, and
    each distinct kernel dispatch once. Every span is phase "host": the
    port runs its rounds eagerly. `nvtx` adds an NVTX range a span (only
    on a CUDA device)."""

    def __init__(self, emitter: Emitter, nvtx: bool = False):
        self.emitter = emitter
        self.nvtx = nvtx
        self.round: Optional[int] = None
        self._kernels: set = set()

    @contextlib.contextmanager
    def span(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        if self.nvtx:
            torch.cuda.nvtx.range_push(stage)
        try:
            with torch.profiler.record_function(stage):
                yield
        finally:
            if self.nvtx:
                torch.cuda.nvtx.range_pop()
            self.emitter.stage(stage, time.perf_counter() - t0,
                               phase="host", round_idx=self.round)

    def kernel(self, name: str, *, backend: str, interpret: bool,
               **info) -> None:
        key = (name, backend, interpret, tuple(sorted(info.items())))
        if key in self._kernels:
            return
        self._kernels.add(key)
        self.emitter.kernel(name, backend=backend, interpret=interpret,
                            **info)


def install(tracer: StageTracer) -> None:
    global _ACTIVE
    _ACTIVE = tracer


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def current() -> Optional[StageTracer]:
    return _ACTIVE


@contextlib.contextmanager
def activated(tracer: Optional[StageTracer]) -> Iterator[None]:
    """Install `tracer` for the duration (None = leave as-is)."""
    if tracer is None:
        yield
        return
    prev = _ACTIVE
    install(tracer)
    try:
        yield
    finally:
        install(prev) if prev is not None else uninstall()


def stage_span(name: str):
    """The pipeline/engine instrumentation point: a `record_function`
    range, timed and emitted when a tracer is installed and `name` is
    one of `STAGES`."""
    t = _ACTIVE
    if t is None or name not in STAGES:
        return torch.profiler.record_function(name)
    return t.span(name)


def note_dispatch(name: str, interpret: bool, **info) -> None:
    """A kernel wrapper's dispatch: `interpret` is true when the plain
    version in ref.py runs (a CPU tensor), false when the CUDA kernel
    launches. With no tracer installed the cost is one global load, so
    wrappers call it unconditionally."""
    t = _ACTIVE
    if t is not None:
        t.kernel(name, backend="cpu" if interpret else "cuda",
                 interpret=interpret, **info)


# ---------------------------------------------------------------------------
# torch.profiler round windows
# ---------------------------------------------------------------------------

class RoundProfiler:
    """Capture a Chrome trace (chrome://tracing, Perfetto) of a window of
    rounds.

    `round(t)` wraps the runner's per-round work: the trace starts when
    `t == start` (the runner passes 1, past the round-0 warm-up), every
    captured round is a "round" range, and after `count` rounds the
    trace stops and is written to `<profile_dir>/<name>.trace.json`.
    `cuda` adds the device activity (CUPTI). A profiler that cannot
    start logs to `emitter` and leaves the run untraced."""

    def __init__(self, profile_dir: str, name: str, emitter: Emitter,
                 start: int = 1, count: int = 3, cuda: bool = False):
        self.dir = Path(profile_dir)
        self.path = self.dir / f"{name}.trace.json"
        self.start = max(0, start)
        self.last = self.start + max(1, count) - 1
        self.emitter = emitter
        self.cuda = cuda
        self._prof = None
        self.broken = False

    @property
    def running(self) -> bool:
        return self._prof is not None

    @contextlib.contextmanager
    def round(self, t: int) -> Iterator[None]:
        if not self.broken and not self.running and t == self.start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            try:
                prof.start()
            except RuntimeError as e:  # no profiler on this build
                self.broken = True
                self.emitter.log(f"[obs] profiler unavailable, "
                                 f"continuing without trace: {e}")
            else:
                self._prof = prof
                self.emitter.log(f"[obs] profiler trace started -> "
                                 f"{self.path} (rounds "
                                 f"{self.start}..{self.last})")
        if not self.running:
            yield
            return
        try:
            with torch.profiler.record_function("round"):
                yield
        finally:
            if t >= self.last:
                self.stop()

    def stop(self) -> None:
        """End the window and write its trace (a no-op when none runs)."""
        if not self.running:
            return
        prof, self._prof = self._prof, None
        if self.cuda:
            torch.cuda.synchronize()
        prof.stop()
        self.dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(self.path))
        self.emitter.log(f"[obs] profiler trace written -> {self.path}")
