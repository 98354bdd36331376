"""repro_torch.obs — the port's structured telemetry bus.

Typed events (events), composable sinks + stream readers (sinks),
per-stage span tracing and torch.profiler windows (trace), and the
terminal run monitor (monitor). The event schema is the JAX package's
(docs/obs.md): a port stream parses with `repro.obs.sinks.read_events`.
"""
from repro_torch.obs.events import (EVENT_SCHEMA, EVENT_TYPES, Emitter,
                                    Event, KernelEvent, LogEvent, NULL,
                                    NullEmitter, RoundEvent, RunClock,
                                    RunEnd, RunStart, StageEvent,
                                    SweepEvent, new_run_id, parse,
                                    parse_line)
from repro_torch.obs.sinks import (CsvSink, FanoutSink, JsonlSink,
                                   RingBufferSink, Sink, default_obs_dir,
                                   follow_jsonl, merge_streams, read_events)
from repro_torch.obs.trace import (STAGES, RoundProfiler, StageTracer,
                                   activated, current, install,
                                   note_dispatch, stage_span, uninstall)

__all__ = [
    "EVENT_SCHEMA", "EVENT_TYPES", "Emitter", "Event", "KernelEvent",
    "LogEvent", "NULL", "NullEmitter", "RoundEvent", "RunClock",
    "RunEnd", "RunStart", "StageEvent", "SweepEvent", "new_run_id",
    "parse", "parse_line",
    "CsvSink", "FanoutSink", "JsonlSink", "RingBufferSink", "Sink",
    "default_obs_dir", "follow_jsonl", "merge_streams", "read_events",
    "STAGES", "RoundProfiler", "StageTracer", "activated", "current",
    "install", "note_dispatch", "stage_span", "uninstall",
]
