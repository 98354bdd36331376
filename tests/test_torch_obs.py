"""The port's obs bus (repro_torch.obs) against the JAX package's, on
the CPU: event round trips, sinks, the stage tracer, the stream/artifact
contract on reduced paper and mesh runs, the artifact loader, the
monitor, the sweep stream and the CLI.

The contract held against the reference (same scenario and overrides on
both sides):
  * the port's stream parses with `repro.obs.sinks.read_events` and
    renders with `repro.obs.monitor.render`;
  * its set of stage names equals the reference stream's (the port
    emits them every round with phase="host", the reference once at jit
    trace time with phase="trace");
  * its set of KernelEvent (name, info) pairs equals the reference's,
    with interpret true and backend "cpu" on both sides;
  * its RoundEvents carry exactly the artifact's per-round rows, bit for
    bit after a JSON round trip, and obs on leaves the record bit-equal
    to obs off (times aside).
"""
import json
import os
from collections import Counter
from pathlib import Path

import hypothesis as hp
import hypothesis.strategies as st
import pytest
import torch.distributed as dist

from repro.experiments import get_scenario as jget_scenario
from repro.experiments import override as joverride
from repro.experiments import run as jrun
from repro.obs import EVENT_TYPES as JEVENT_TYPES
from repro.obs import monitor as jmonitor
from repro.obs import sinks as jsinks
from repro_torch.experiments import (SCHEMA_VERSION, build, get_scenario,
                                     load_result, override, run,
                                     run_prepared, sweep, to_dict)
from repro_torch.kernels import runtime
from repro_torch.launch import monitor as launch_monitor
from repro_torch.launch import train
from repro_torch.obs import (EVENT_SCHEMA, EVENT_TYPES, NULL, CsvSink,
                             Emitter, FanoutSink, JsonlSink, KernelEvent,
                             RingBufferSink, RoundEvent, RunEnd, RunStart,
                             StageEvent, StageTracer, SweepEvent,
                             follow_jsonl, merge_streams, new_run_id, parse,
                             parse_line, read_events)
from repro_torch.obs import monitor as obs_monitor
from repro_torch.obs import trace as obs_trace

TINY_PAPER = ("data.num_workers=4", "data.n_local=64", "run.rounds=3",
              "model.width_mult=2", "algo.local_epochs=1")
TINY_MESH = ("data.num_workers=2", "model.seq_len=16",
             "model.per_worker_batch=1", "run.rounds=3")
# the paper run takes the fused int4 uplink and the dense int8 downlink:
# all four wire kernels dispatch
SCENARIOS = {"paper": "low-bandwidth-int4", "mesh": "mesh/smollm-smoke"}
PIPELINE_STAGES = {"LocalUpdate", "ScoreSelect", "Uplink", "Aggregate",
                   "Downlink", "BestTracking"}


def _overrides(engine: str, obs_dir: Path, *extra: str) -> tuple:
    tiny = TINY_PAPER if engine == "paper" else TINY_MESH
    return (*tiny, "run.obs.enabled=true", f"run.obs.dir={obs_dir}", *extra)


def _port_spec(engine: str, obs_dir: Path, *extra: str):
    return override(get_scenario(SCENARIOS[engine]),
                    *_overrides(engine, obs_dir, *extra))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """One obs-on 3-round port run per engine, each with a one-round
    profiler trace; the paper run also writes the CSV mirror."""
    out = {}
    for engine in SCENARIOS:
        d = tmp_path_factory.mktemp(f"port_{engine}")
        extra = (f"run.obs.profile_dir={d / 'prof'}",
                 "run.obs.profile_rounds=1",
                 *(("run.obs.csv=true",) if engine == "paper" else ()))
        res = run(_port_spec(engine, d, *extra), verbose=False,
                  device="cpu")
        out[engine] = (res, read_events(res.events_path))
    return out


@pytest.fixture(scope="module")
def ref_streams(tmp_path_factory):
    """The JAX package's stream of the same spec, one round (its stage
    and kernel events fire at the round-0 jit trace)."""
    out = {}
    for engine in SCENARIOS:
        d = tmp_path_factory.mktemp(f"ref_{engine}")
        spec = joverride(jget_scenario(SCENARIOS[engine]),
                         *_overrides(engine, d, "run.rounds=1"))
        res = jrun(spec, verbose=False)
        out[engine] = jsinks.read_events(res.events_path)
    return out


# ---------------------------------------------------------------------------
# the event model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(EVENT_TYPES))
def test_event_default_round_trip(kind):
    ev = EVENT_TYPES[kind](run_id="r", t_s=1.5)
    assert parse_line(ev.to_json()) == ev


@pytest.mark.parametrize("kind", sorted(JEVENT_TYPES))
def test_event_fields_are_the_reference_schema(kind):
    import dataclasses
    assert kind in EVENT_TYPES
    mine = [(f.name, f.default) for f in dataclasses.fields(EVENT_TYPES[kind])]
    ref = [(f.name, f.default) for f in dataclasses.fields(JEVENT_TYPES[kind])]
    assert mine == ref
    assert EVENT_SCHEMA == 1


def test_populated_round_trip():
    ev = RoundEvent(run_id="r", t_s=0.25, round=7,
                    metrics={"acc": 0.125, "selected": 3.0})
    back = parse(json.loads(ev.to_json()))
    assert back == ev and back.metrics["acc"] == 0.125


@pytest.mark.parametrize("obj, match", [
    ({"kind": "telemetry", "run_id": "r"}, "unknown event kind"),
    ({"kind": "round", "run_id": "r", "t_s": 0.0, "round": 0, "metrics": {},
      "gpu_watts": 42}, "gpu_watts"),
])
def test_parse_rejects_unknown(obj, match):
    with pytest.raises(ValueError, match=match):
        parse(obj)


@hp.given(st.lists(st.floats(min_value=-1e9, max_value=1e9), min_size=1,
                   max_size=12))
def test_metric_floats_survive_stream_bit_equal(vals):
    metrics = {f"m{i}": v for i, v in enumerate(vals)}
    back = parse_line(RoundEvent(run_id="r", metrics=metrics).to_json())
    assert back.metrics == metrics


def test_new_run_id_distinct_and_greppable():
    a, b = new_run_id("quickstart"), new_run_id("quickstart")
    assert a != b and a.startswith("quickstart__")
    assert "/" not in new_run_id("mesh/smollm-smoke")


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------

def test_jsonl_round_trip_and_reference_reader(tmp_path):
    p = tmp_path / "s.jsonl"
    em = Emitter("rid", JsonlSink(p))
    em.run_start(scenario="q", seed=0)
    em.round(0, {"acc": 0.5})
    em.run_end(rounds=1, totals={"acc": 0.5})
    em.close()
    evs = read_events(p)
    assert [e.kind for e in evs] == ["run_start", "round", "run_end"]
    assert all(e.run_id == "rid" for e in evs)
    assert [e.t_s for e in evs] == sorted(e.t_s for e in evs)
    assert [e.to_dict() for e in jsinks.read_events(p)] == [
        e.to_dict() for e in evs]


def test_jsonl_rotation(tmp_path):
    p = tmp_path / "s.jsonl"
    em = Emitter("rid", JsonlSink(p, rotate_bytes=200))
    for t in range(20):
        em.round(t, {"acc": 0.1})
    em.close()
    assert p.with_name("s.jsonl.1").exists()
    if p.exists():
        assert p.stat().st_size <= 400


def test_csv_rounds_only_fixed_columns(tmp_path):
    p = tmp_path / "s.csv"
    em = Emitter("rid", CsvSink(p))
    em.run_start(scenario="q")
    em.round(0, {"acc": 0.5, "loss": 2.0})
    em.round(1, {"acc": 0.6, "loss": 1.5, "extra": 9.0})
    em.close()
    lines = p.read_text().strip().splitlines()
    assert lines[0] == "run_id,round,t_s,acc,loss"
    assert len(lines) == 3 and lines[1].startswith("rid,0,")


def test_ring_buffer_caps():
    sink = RingBufferSink(capacity=3)
    em = Emitter("rid", sink)
    for t in range(10):
        em.round(t, {})
    assert [e.round for e in sink.events] == [7, 8, 9]


def test_fanout_tees_and_proxies_path(tmp_path):
    ring = RingBufferSink()
    em = Emitter("rid", FanoutSink(ring, JsonlSink(tmp_path / "s.jsonl")))
    em.round(0, {"acc": 0.5})
    em.close()
    assert em.path == str(tmp_path / "s.jsonl")
    assert len(ring.events) == len(read_events(em.path)) == 1


def test_merge_streams_regroups_by_run_id(tmp_path):
    for rid in ("a", "b"):
        em = Emitter(rid, JsonlSink(tmp_path / f"{rid}.jsonl"))
        em.round(0, {})
        em.round(1, {})
        em.close()
    runs = merge_streams(sorted(tmp_path.glob("*.jsonl")))
    assert set(runs) == {"a", "b"}
    for evs in runs.values():
        assert [e.round for e in evs] == [0, 1]


@pytest.mark.parametrize("end, timeout_s, kinds", [
    (True, 2.0, ["round", "run_end"]),     # stops on run_end
    (False, 0.1, ["round"]),               # times out with no growth
])
def test_follow_jsonl(tmp_path, end, timeout_s, kinds):
    p = tmp_path / "s.jsonl"
    em = Emitter("rid", JsonlSink(p))
    em.round(0, {})
    if end:
        em.run_end(rounds=1)
    em.close()
    evs = list(follow_jsonl(p, poll_s=0.01, timeout_s=timeout_s))
    assert [e.kind for e in evs] == kinds


# ---------------------------------------------------------------------------
# the stage tracer and the dispatch hook
# ---------------------------------------------------------------------------

def test_stage_span_without_tracer_is_a_profiler_range():
    import torch
    assert obs_trace.current() is None
    span = obs_trace.stage_span("Uplink")
    assert isinstance(span, torch.profiler.record_function)
    with span:
        pass


def test_spans_emit_host_stage_events_with_the_round():
    ring = RingBufferSink()
    tracer = StageTracer(Emitter("rid", ring))
    tracer.round = 4
    with obs_trace.activated(tracer):
        with obs_trace.stage_span("Uplink"):
            pass
        obs_trace.note_dispatch("quant_pack", True, bits=4)
    assert obs_trace.current() is None
    stage, kernel = ring.events
    assert isinstance(stage, StageEvent)
    assert (stage.stage, stage.phase, stage.round) == ("Uplink", "host", 4)
    assert stage.dur_s >= 0.0
    assert isinstance(kernel, KernelEvent) and kernel.info == {"bits": 4}
    assert (kernel.backend, kernel.interpret) == ("cpu", True)


def test_note_dispatch_emits_each_distinct_dispatch_once():
    ring = RingBufferSink()
    runtime.note_dispatch("quant_pack", True, bits=8)      # no tracer: no-op
    with obs_trace.activated(StageTracer(Emitter("rid", ring))):
        for _ in range(3):
            runtime.note_dispatch("quant_pack", True, bits=8)
        runtime.note_dispatch("quant_pack", True, bits=4)
        runtime.note_dispatch("wire_agg", False, bits=4, aggregator="mean",
                              workers=50)
    got = [(e.name, e.backend, e.interpret, e.info) for e in ring.events]
    assert got == [("quant_pack", "cpu", True, {"bits": 8}),
                   ("quant_pack", "cpu", True, {"bits": 4}),
                   ("wire_agg", "cuda", False,
                    {"bits": 4, "aggregator": "mean", "workers": 50})]


def test_activated_restores_previous_tracer():
    outer = StageTracer(Emitter("o", RingBufferSink()))
    inner = StageTracer(Emitter("i", RingBufferSink()))
    with obs_trace.activated(outer):
        with obs_trace.activated(inner):
            assert obs_trace.current() is inner
        assert obs_trace.current() is outer
    assert obs_trace.current() is None


def test_null_emitter_span_is_reusable():
    with NULL.span("Step"):
        with NULL.span("Step"):
            pass
    assert NULL.path is None and not NULL.active


# ---------------------------------------------------------------------------
# run streams: the contract against the artifact and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", sorted(SCENARIOS))
def test_round_events_bit_equal_to_artifact(engine, port_runs):
    res, evs = port_runs[engine]
    art = json.loads(json.dumps(res.to_dict()))      # the saved form
    rounds = [e for e in evs if isinstance(e, RoundEvent)]
    assert [e.round for e in rounds] == [0, 1, 2]
    hist = art["metrics"]
    per_round = {k for k, v in hist.items()
                 if isinstance(v, list) and len(v) == len(rounds)}
    assert per_round == set(rounds[0].metrics)
    for ev in rounds:
        for k, v in ev.metrics.items():
            assert hist[k][ev.round] == v, (ev.round, k)


@pytest.mark.parametrize("engine", sorted(SCENARIOS))
def test_stream_shape(engine, port_runs):
    res, evs = port_runs[engine]
    assert isinstance(evs[0], RunStart) and isinstance(evs[-1], RunEnd)
    assert evs[-1].status == "ok" and evs[-1].rounds == 3
    assert evs[0].rounds == 3 and evs[0].n_params == res.record.get(
        "n_params", evs[0].n_params) > 0
    assert evs[0].engine == engine
    assert evs[0].spec == json.loads(json.dumps(to_dict(res.spec)))
    assert all(e.run_id == evs[0].run_id for e in evs)
    assert [e.t_s for e in evs] == sorted(e.t_s for e in evs)
    stages = [e for e in evs if isinstance(e, StageEvent)]
    assert {e.phase for e in stages} == {"host"}
    assert sorted({e.round for e in stages}) == [0, 1, 2]
    assert res.to_dict()["events"] == res.events_path
    if engine == "paper":
        assert evs[-1].totals["final_acc"] == res.record["final_acc"]
    else:
        assert evs[-1].totals["final_loss"] == res.record["global_loss"][-1]


@pytest.mark.parametrize("engine", sorted(SCENARIOS))
def test_stage_times_sum_within_step(engine, port_runs):
    """Each round's pipeline spans nest inside its Step span."""
    _, evs = port_runs[engine]
    for t in range(3):
        spans = [e for e in evs if isinstance(e, StageEvent) and e.round == t]
        step = [e.dur_s for e in spans if e.stage == "Step"]
        inner = sum(e.dur_s for e in spans if e.stage in PIPELINE_STAGES)
        assert len(step) == 1 and 0.0 < inner <= step[0]


@pytest.mark.parametrize("engine", sorted(SCENARIOS))
def test_stream_reads_and_renders_in_the_reference(engine, port_runs):
    res, evs = port_runs[engine]
    ref = jsinks.read_events(res.events_path)
    assert [e.to_dict() for e in ref] == [e.to_dict() for e in evs]
    out = jmonitor.render(ref)
    assert SCENARIOS[engine] in out and "rounds 3/3" in out
    assert "end: status=ok" in out
    for stage in PIPELINE_STAGES:
        assert stage in out
    assert obs_monitor.render(evs) == out


@pytest.mark.parametrize("engine", sorted(SCENARIOS))
def test_stage_names_equal_the_reference(engine, port_runs, ref_streams):
    _, evs = port_runs[engine]
    mine = {e.stage for e in evs if isinstance(e, StageEvent)}
    ref = {e.stage for e in ref_streams[engine] if e.kind == "stage"}
    assert mine == ref
    assert PIPELINE_STAGES | {"Step"} <= mine


@pytest.mark.parametrize("engine", sorted(SCENARIOS))
def test_kernel_events_equal_the_reference(engine, port_runs, ref_streams):
    _, evs = port_runs[engine]

    def pairs(stream):
        return {(e.name, json.dumps(e.info, sort_keys=True))
                for e in stream if e.kind == "kernel"}

    mine = [e for e in evs if isinstance(e, KernelEvent)]
    assert pairs(evs) == pairs(ref_streams[engine])
    assert all(e.interpret and e.backend == "cpu" for e in mine)
    assert all(e.interpret for e in ref_streams[engine] if e.kind == "kernel")
    assert len(mine) == len(pairs(evs))               # each once
    if engine == "paper":
        assert {e.name for e in mine} == {"quant_pack_ef", "wire_agg",
                                          "quant_pack", "dequant_unpack"}


@pytest.mark.parametrize("engine", sorted(SCENARIOS))
def test_obs_does_not_perturb_the_record(engine, port_runs):
    res_on, _ = port_runs[engine]
    res_off = run(override(res_on.spec, "run.obs.enabled=false",
                           "run.obs.profile_dir=none"),
                  verbose=False, device="cpu")
    assert res_off.events_path is None
    on, off = res_on.record, res_off.record
    assert set(on) == set(off)
    for k in on:
        if not k.endswith("_time_s"):
            assert on[k] == off[k], k


def test_csv_mirror_matches_stream(port_runs):
    res, evs = port_runs["paper"]
    lines = Path(res.events_path).with_suffix(".csv").read_text() \
        .strip().splitlines()
    rounds = [e for e in evs if isinstance(e, RoundEvent)]
    assert len(lines) == 1 + len(rounds)
    assert lines[0].split(",")[:3] == ["run_id", "round", "t_s"]
    assert set(lines[0].split(",")[3:]) == set(rounds[0].metrics)


def test_profiler_window_writes_a_chrome_trace(port_runs):
    """Round 1 alone, with its "round" range and the stage ranges."""
    res, evs = port_runs["paper"]
    prof = Path(res.spec.run.obs.profile_dir)
    path = prof / f"{evs[0].run_id}.trace.json"
    assert [p.name for p in prof.iterdir()] == [path.name]
    names = {e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"]}
    assert {"round"} | PIPELINE_STAGES <= names
    logs = [e.msg for e in evs if e.kind == "log"]
    assert any("profiler trace written" in m for m in logs)


# ---------------------------------------------------------------------------
# the span tree inside a round (obs/trace.py)
# ---------------------------------------------------------------------------

# the spans a round opens beside the stages: the paper engine scores
# before and after the local update, the mesh engine takes one gradient
# a worker (W 2); on a DTensor mesh the dense wire's gather and the
# relayout of its outputs open two more
CHILD_SPANS = {
    "paper": {"LocalUpdate.score": 2, "LocalUpdate.train": 1,
              "LocalUpdate.eq8": 1, "GlobalLoss": 1},
    "mesh": {"LocalUpdate.score": 1, "LocalUpdate.train": 1,
             "LocalUpdate.train.fwd": 2, "LocalUpdate.train.bwd": 2,
             "LocalUpdate.eq8": 1, "GlobalLoss": 1},
    "mesh-fleet": {"LocalUpdate.score": 1, "LocalUpdate.train": 1,
                   "LocalUpdate.train.fwd": 1, "LocalUpdate.train.bwd": 1,
                   "LocalUpdate.eq8": 1, "GlobalLoss": 1, "WireGather": 1,
                   "WireRelayout": 1}}
# the span each nests in (None: none; the mesh engine's GlobalLoss opens
# between the wire and BestTracking)
PARENT = {"LocalUpdate.score": "LocalUpdate",
          "LocalUpdate.train": "LocalUpdate", "LocalUpdate.eq8": "LocalUpdate",
          "LocalUpdate.train.fwd": "LocalUpdate.train",
          "LocalUpdate.train.bwd": "LocalUpdate.train",
          "WireGather": None, "WireRelayout": None}
GLOBAL_LOSS_PARENT = {"paper": "BestTracking", "mesh": None,
                      "mesh-fleet": None}


def _chrome(path: Path) -> tuple[list, list]:
    """A Chrome trace's (user_annotation ranges, cpu ops), each a list of
    (start, end, name) in us."""
    ranges, ops = [], []
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") != "X":
            continue
        span = (e["ts"], e["ts"] + e.get("dur", 0), e["name"])
        if e.get("cat") == "user_annotation":
            ranges.append(span)
        elif e.get("cat") == "cpu_op":
            ops.append(span)
    return ranges, ops


def _warm_step(engine: str, tmp_path: Path):
    """A callable running one step of the engine's tiny run after a first
    one. "mesh-fleet": reduced SmolLM-360M on a (1, 1) DTensor mesh of
    this process (the state's leaves DTensors, so `_MeshFleet` runs the
    round, its dense wire gathering over the worker axes)."""
    if engine != "mesh-fleet":
        tiny = TINY_PAPER if engine == "paper" else TINY_MESH
        prep = build(override(get_scenario(SCENARIOS[engine]), *tiny),
                     device="cpu")
        state, _ = prep.step(prep.state, prep.draw(prep.state))
        draws = prep.draw(state)
        return lambda: prep.step(state, draws)
    import torch_mesh_worker as mw
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import InputShape
    from repro_torch.core import swarm_dist
    from repro_torch.launch import steps
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    built = steps.build_step(mw._f32("smollm-360m"),
                             InputShape("train", *mw.TRAIN, "train"), mesh)
    lay, dcfg = built.layouts, built.meta["dcfg"]
    _, _, params, (batch, ev, gen) = mw._inputs("smollm-360m", "train",
                                                dcfg.num_spatial)
    draws = swarm_dist.sample_draws(gen, dcfg, params, "cpu", 0)
    rest = (steps.place(batch, lay[1], mesh), steps.place(ev, lay[2], mesh),
            draws)
    state, _ = built.fn(steps.place(swarm_dist.init_state(params, dcfg),
                                    lay[0], mesh), *rest)
    return lambda: built.fn(state, *rest)


@pytest.mark.parametrize("engine", sorted(CHILD_SPANS))
def test_every_op_of_a_step_runs_inside_a_program_span(engine, tmp_path):
    """One `Prepared.step` (on a DTensor mesh, the round `build_step`
    makes) under a CPU profiler: every aten op lies inside a stage span,
    and each span a round opens beside the stages nests in its
    parent."""
    from torch.profiler import ProfilerActivity, profile, record_function
    try:
        step = _warm_step(engine, tmp_path)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("test.step"):
                step()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    path = tmp_path / "step.json"
    prof.export_chrome_trace(str(path))
    ranges, ops = _chrome(path)
    (step,) = [r for r in ranges if r[2] == "test.step"]
    spans = [r for r in ranges if r[2] != "test.step"]
    children = CHILD_SPANS[engine]
    assert {n for *_, n in spans} == \
        (obs_trace.STAGES - {"Straggle"}) | set(children)
    assert Counter(n for *_, n in spans if n in children) == children
    aten = [o for o in ops
            if o[2].startswith("aten::") and step[0] <= o[0] <= step[1]]
    assert len(aten) > 100
    loose = [n for s0, e0, n in aten
             if not any(s <= s0 and e0 <= e for s, e, _ in spans)]
    assert loose == []
    for span in spans:
        s0, e0, name = span
        if name not in children:
            continue
        holders = {n for s, e, n in spans
                   if (s, e, n) != span and s <= s0 and e0 <= e}
        want = (GLOBAL_LOSS_PARENT[engine] if name == "GlobalLoss"
                else PARENT[name])
        if want is None:
            assert holders == set(), name
        else:
            assert want in holders, (name, holders)


@pytest.mark.parametrize("engine", sorted(SCENARIOS))
def test_stream_holds_each_stage_once_a_round(engine, port_runs):
    """The spans inside a stage and GlobalLoss are profiler ranges only:
    the stream's stage names and counts are the pipeline's and the
    runner's (Step, and the paper run's Eval)."""
    _, evs = port_runs[engine]
    runner = {"Step", "Eval"} if engine == "paper" else {"Step"}
    for t in range(3):
        got = Counter(e.stage for e in evs
                      if isinstance(e, StageEvent) and e.round == t)
        assert got == Counter(PIPELINE_STAGES | runner), t


@pytest.mark.parametrize("engine", sorted(SCENARIOS))
def test_stream_and_trace_share_one_clock(engine, port_runs):
    """Round 1's stage spans on the stream, put on Unix time through
    RunStart (wall_time - t_s), open and close within 1 ms of the same
    ranges in its Chrome trace (baseTimeNanoseconds + ts)."""
    res, evs = port_runs[engine]
    start = evs[0]
    unix = start.wall_time - start.t_s
    path = Path(res.spec.run.obs.profile_dir) / f"{start.run_id}.trace.json"
    doc = json.loads(path.read_text())
    base = doc["baseTimeNanoseconds"] * 1e-9
    traced = {e["name"]: (base + 1e-6 * e["ts"],
                          base + 1e-6 * (e["ts"] + e["dur"]))
              for e in doc["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e["name"] in PIPELINE_STAGES}
    stream = {e.stage: (unix + e.t_s - e.dur_s, unix + e.t_s) for e in evs
              if isinstance(e, StageEvent) and e.round == 1
              and e.stage in PIPELINE_STAGES}
    assert set(traced) == set(stream) == PIPELINE_STAGES
    for stage, (s, e) in stream.items():
        assert abs(s - traced[stage][0]) < 1e-3, stage
        assert abs(e - traced[stage][1]) < 1e-3, stage


def test_failed_run_ends_the_stream_with_an_error(tmp_path):
    prep = build(_port_spec("paper", tmp_path), device="cpu")

    def boom(state, draws):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        run_prepared(prep._replace(step=boom), verbose=False)
    (stream,) = tmp_path.glob("*.jsonl")
    evs = read_events(stream)
    assert isinstance(evs[0], RunStart)
    assert isinstance(evs[-1], RunEnd) and evs[-1].status == "error"
    assert obs_trace.current() is None


# ---------------------------------------------------------------------------
# artifacts, monitor, sweep, CLI
# ---------------------------------------------------------------------------

def test_saved_artifact_declares_schema(port_runs, tmp_path):
    res, _ = port_runs["paper"]
    d = res.to_dict()
    assert d["schema"] == SCHEMA_VERSION == 2
    p = res.save(tmp_path / "r.json")
    assert load_result(p)["metrics"] == json.loads(json.dumps(d["metrics"]))


@pytest.mark.parametrize("doc, schema", [
    ({"spec": {}, "metrics": {"acc": [0.1]}}, 1),     # no schema: v1
    ({"schema": 9, "spec": {}, "metrics": {}}, None),  # newer: refused
    ({"schema": 2, "hello": "world"}, None),           # no metrics dict
])
def test_load_result_schema_checks(tmp_path, doc, schema):
    p = tmp_path / "a.json"
    p.write_text(json.dumps(doc))
    if schema is None:
        with pytest.raises(ValueError):
            load_result(p)
    else:
        assert load_result(p)["schema"] == schema


def test_monitor_renders_empty_and_resolves_newest(tmp_path):
    assert "no run_start" in obs_monitor.render([])
    old, new = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    old.write_text("")
    new.write_text("")
    os.utime(old, (1, 1))
    assert obs_monitor.resolve_stream(tmp_path) == new
    assert obs_monitor.resolve_stream(new) == new


@pytest.mark.parametrize("main", [obs_monitor.main, launch_monitor.main])
def test_monitor_main_renders_a_port_stream(port_runs, capsys, main):
    res, _ = port_runs["paper"]
    main([res.events_path])
    out = capsys.readouterr().out
    assert "low-bandwidth-int4" in out and "rounds 3/3" in out


def test_sweep_stream_and_stderr_line(tmp_path, capsys):
    spec = _port_spec("paper", tmp_path / "obs", "run.rounds=1")
    results = sweep([spec], seeds=(0,), out_dir=tmp_path / "art",
                    device="cpu")
    err = capsys.readouterr().err
    assert "[sweep] low-bandwidth-int4 s0:" in err
    assert "wall=" in err and f"events={results[0].events_path}" in err
    streams = [p for p in (tmp_path / "obs").glob("*.jsonl")
               if "sweep__" in p.name]
    assert len(streams) == 1
    evs = jsinks.read_events(streams[0])
    cells = [e for e in evs if e.kind == "sweep"]
    assert len(cells) == 1 and cells[0].cell == "low-bandwidth-int4"
    assert cells[0].status == "ok" and cells[0].wall_s > 0
    assert cells[0].events == results[0].events_path
    assert cells[0].final == results[0].record["final_acc"]
    assert isinstance(read_events(streams[0])[-1], RunEnd)
    assert "cells (1):" in obs_monitor.render(read_events(streams[0]))


def test_sweep_obs_off_emits_no_stream(tmp_path, capsys):
    spec = override(get_scenario("quickstart"), *TINY_PAPER, "run.rounds=1")
    sweep([spec], seeds=(0,), out_dir=tmp_path / "art", device="cpu")
    err = capsys.readouterr().err
    assert "[sweep] quickstart s0:" in err and "wall=" in err
    assert "events=" not in err


def test_cli_obs_flags(tmp_path, capsys):
    out = tmp_path / "run.json"
    train.main(["--scenario", "low-bandwidth-int4", "--device", "cpu",
                "--obs-dir", str(tmp_path / "obs"), "--out", str(out),
                *[a for o in TINY_PAPER if not o.startswith("run.rounds")
                  for a in ("--set", o)], "--rounds", "1"])
    printed = capsys.readouterr().out
    art = load_result(out)
    assert art["spec"]["run"]["obs"]["enabled"] is True
    assert f"events {art['events']}" in printed
    assert f"python -m repro_torch.launch.monitor {art['events']}" in printed
    assert len(read_events(art["events"])) > 0


def test_cli_lists_scenarios(capsys):
    train.main(["--list-scenarios"])
    out = capsys.readouterr().out
    assert "low-bandwidth-int4" in out and "mesh/smollm-smoke" in out
    with pytest.raises(SystemExit):
        train.main(["--rounds", "1"])
