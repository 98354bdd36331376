"""`run(spec) -> RunResult`: the paper and mesh drivers of the port.

    build(spec, device)  -> Prepared   data/model/state + step and draw fns
    run(spec, device)    -> RunResult  the metrics record (the JAX
                                       package's keys)
    run_prepared(prep)   -> RunResult  the same loop on a Prepared whose
                                       parts a caller swapped
    sweep(specs, seeds)  -> [RunResult] scenarios x seeds, one artifact
                                       each; `jobs > 1` fans the grid over
                                       spawned processes

Entry points run on the CUDA card unless the caller passes a device
(`device="cpu"` for the tests); with no card and no device they raise.
For the whole run the runner sets the numerics it needs and restores
them afterwards (`_deterministic_f32`): TF32 off in both the matmul and
the cuDNN convolution paths, so the card computes in full f32 like the
reference, and cuDNN held to deterministic algorithms
(`torch.backends.cudnn.deterministic`, no `benchmark` autotuning), so one
spec and seed give one record on the card, run after run and process
after process, as the reference gives one record per seed.

Randomness: paper runs take their data from `run.seed`, and the initial
params and every round's `RoundDraws` from one torch.Generator seeded
with `run.seed + 1`; a population run (`fleet.population`) draws its
cohorts and catch-up normals from a generator of its own (keyed by
`run.seed` and `population.POP_SALT`), so its engine sees the same
draws as an unwrapped run. Mesh runs (`model.kind="mesh"`: M-DSL over
W transformer workers, `core/swarm_dist`) take the initial params,
every round's token batches and its draws from one torch.Generator
seeded with `run.seed`. In both, the fault schedule's crash rows are
keyed by (`comm.fault_seed`, round) alone (`comm.straggler.crash_draws`).
`build(..., data=, init_params=)` injects the reference's arrays, and a
caller may replace `Prepared.draw` to inject the reference's draws (and,
for mesh runs, batches).

Observability (`run.obs.enabled`, repro_torch.obs): the run streams
typed events to `<obs.dir>/<run_id>.jsonl` in the JAX package's schema:
`run_start` with the full spec, one RoundEvent a round whose metrics are
the very row dict appended to the record, `StageEvent`s (the pipeline
stages and the runner's Step and Eval, all phase="host" with the round:
the port runs every round eagerly), one KernelEvent a distinct kernel
dispatch, and `run_end` with totals (status="error" when the run
raises). With obs on, the Step span ends in a device sync, so it covers
the round's device time; obs-off runs keep their async dispatch.
`obs.profile_dir` writes a Chrome trace of `obs.profile_rounds` rounds
from round index 1, past the warm-up (`obs.trace.RoundProfiler`).

Mesh checkpoints (`run.ckpt_dir`): the global params after each round,
saved after the round's row is built (so `step_time_s` excludes the
save) by `checkpoint.CheckpointManager` (the newest three kept); the
record gains `ckpt_steps`.
"""
from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.bridge import (transformer_params_from_numpy,
                                tree_from_numpy)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.comm.budget import (CommConfig, dense_bytes,
                                     downlink_config, host_round_bytes,
                                     payload_bytes)
from repro_torch.configs.base import get_arch
from repro_torch.configs.paper_cnn import paper_cnn, paper_resnet
from repro_torch.core import losses as losses_mod
from repro_torch.core import mdsl, noniid, swarm_dist
from repro_torch.core import population as pop
from repro_torch.core.mdsl import MdslConfig
from repro_torch.core.pso import PsoHyperParams, WorkerState
from repro_torch.data import partition
from repro_torch.data.partition import FederatedData
from repro_torch.data.synthetic import CIFAR_LIKE, MNIST_LIKE
from repro_torch.experiments.spec import (AlgoSpec, DataSpec, ExperimentSpec,
                                          ModelSpec, RunSpec, override,
                                          to_dict)
from repro_torch.kernels import runtime
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.transformer import Transformer
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.events import NULL, Emitter, new_run_id
from repro_torch.obs.sinks import (CsvSink, FanoutSink, JsonlSink,
                                   default_obs_dir)
from repro_torch.pytree import tree_map

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts"
# Artifact format version (the JAX package's): 1 = pre-obs {"spec",
# "metrics"}; 2 adds top-level "schema" and "events" (the run's stream
# path, null when obs was off)
SCHEMA_VERSION = 2
IMAGE_SPECS = {"mnist_like": MNIST_LIKE, "cifar_like": CIFAR_LIKE}


def load_result(path: str | Path) -> dict:
    """Load a run artifact, failing loudly on an unknown schema version
    instead of letting a caller KeyError on a shape it was never written
    for. Returns the raw dict with "schema" normalized (an artifact
    without one is schema 1)."""
    d = json.loads(Path(path).read_text())
    schema = d.get("schema", 1)
    if schema not in (1, 2):
        raise ValueError(
            f"{path}: artifact schema {schema!r} is newer than this "
            f"reader (knows 1..{SCHEMA_VERSION}) — upgrade the repo or "
            f"re-run the experiment")
    if not isinstance(d.get("metrics"), dict):
        raise ValueError(f"{path}: not a run artifact (no metrics dict)")
    d["schema"] = schema
    return d


def _noniid2_groups(C: int) -> list[tuple[int, float]]:
    """Fig. 2 fleet (20 @ 0.1, 15 @ 0.5, 10 @ 1.0, 5 @ 10.0) scaled to C."""
    fracs = [(0.4, 0.1), (0.3, 0.5), (0.2, 1.0), (0.1, 10.0)]
    counts = [max(1, round(f * C)) for f, _ in fracs]
    counts[0] += C - sum(counts)
    return [(c, a) for c, (_, a) in zip(counts, fracs)]


def _dirichlet(alpha: float):
    return lambda seed, C, spec, n, device="cpu": (
        partition.dirichlet_partition(seed, C, alpha, spec, n, device=device))


# the partition cases: (seed, C, image spec, n_local, device) -> data
CASES = {
    "iid": lambda seed, C, spec, n, device="cpu": partition.iid_partition(
        seed, C, spec, n, device=device),
    "noniid1": _dirichlet(0.5),
    "noniid2": lambda seed, C, spec, n, device="cpu": (
        partition.mixed_dirichlet_partition(seed, _noniid2_groups(C), spec,
                                            n, device=device)),
}


def make_case_data(case: str, dataset: str, num_workers: int, seed: int,
                   n_local: int = 512, alpha: Optional[float] = None,
                   device="cpu") -> tuple[FederatedData, Any]:
    """Partitioned fleet data for one case; `alpha` overrides the
    Dirichlet concentration of noniid1 (default 0.5)."""
    spec = IMAGE_SPECS[dataset]
    case_fn = (_dirichlet(alpha) if case == "noniid1" and alpha is not None
               else CASES[case])
    return case_fn(seed, num_workers, spec, n_local, device=device), spec


class Prepared(NamedTuple):
    """A built run: `draw(state) -> RoundDraws` then `step(state, draws)
    -> (state, telemetry)` per round."""
    spec: ExperimentSpec
    state: Any
    step: Callable
    draw: Callable
    n_params: int
    device: torch.device
    aux: dict


class RunResult(NamedTuple):
    """The spec, the metrics record (the JAX package's keys), the obs
    stream path (None when obs was off) and the final engine state."""
    spec: ExperimentSpec
    record: dict
    events_path: Optional[str] = None
    state: Any = None

    def to_dict(self) -> dict:
        return {"schema": SCHEMA_VERSION, "spec": to_dict(self.spec),
                "metrics": self.record, "events": self.events_path}

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=1))
        return path


def _on_device(data: FederatedData, device) -> FederatedData:
    def t(a, integer=False):
        a = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
        return a.to(device=device,
                    dtype=torch.int64 if integer else torch.float32)
    return FederatedData(x=t(data.x), y=t(data.y, True),
                         global_x=t(data.global_x), global_y=t(data.global_y,
                                                               True),
                         test_x=t(data.test_x), test_y=t(data.test_y, True),
                         alphas=t(data.alphas))


def _prepare_paper(spec: ExperimentSpec, device: torch.device,
                   data: Optional[FederatedData],
                   init_params: Optional[dict]) -> Prepared:
    d, a, r = spec.data, spec.algo, spec.run
    img_spec = IMAGE_SPECS[d.dataset]
    if data is None:
        data, _ = make_case_data(d.case, d.dataset, d.num_workers, r.seed,
                                 d.n_local, alpha=d.alpha, device=device)
    data = _on_device(data, device)
    make = paper_cnn if spec.model.name == "cnn" else paper_resnet
    img_model = make(img_spec, spec.model.width_mult, device=device)
    L = img_spec.num_classes

    def loss_fn(p, x, y):
        return losses_mod.cross_entropy_loss(img_model.apply(p, x), y, L)

    def eval_fn(p, x, y):               # Eq. 3 scoring on D_g
        return losses_mod.rmse_loss(img_model.apply(p, x), y, L)

    coeffs = (noniid.EtaCoefficients(*d.eta_coeffs) if d.eta_coeffs
              else (noniid.MNIST_COEFFS if d.dataset == "mnist_like"
                    else noniid.CIFAR10_COEFFS))
    eta = noniid.noniid_degree_from_labels(data.y, data.global_y, L, coeffs)
    cfg = MdslConfig(algorithm=a.algorithm, tau=a.tau,
                     local_epochs=a.local_epochs, batch_size=a.batch_size,
                     hp=a.hp, pso_every_step=a.pso_every_step,
                     comm=spec.comm)
    gen = torch.Generator(device=device).manual_seed(r.seed + 1)
    params = (img_model.init(gen) if init_params is None
              else tree_from_numpy(init_params, device))
    state = mdsl.init_state(params, d.num_workers, eta, comm=spec.comm)
    n_params = mdsl.count_params(params)

    def test_accuracy(p) -> float:
        with torch.no_grad():
            return float(losses_mod.accuracy(img_model.apply(p, data.test_x),
                                             data.test_y))

    def draw(state):
        return mdsl.sample_round_draws(gen, cfg, state.global_params,
                                       d.num_workers, data.x.shape[1],
                                       device, round_idx=state.round_idx)

    def step(state, draws):
        return mdsl.mdsl_round(state, data.x, data.y, data.global_x,
                               data.global_y, draws, loss_fn=loss_fn,
                               eval_fn=eval_fn, cfg=cfg, n_params=n_params)

    return Prepared(spec=spec, state=state, step=step, draw=draw,
                    n_params=n_params, device=device,
                    aux={"data": data, "model": img_model, "eta": eta,
                         "cfg": cfg, "test_accuracy": test_accuracy})


class _PopulationState(NamedTuple):
    """The paper engine's state wrapped by the population scheduler: the
    K-slot engine state, the P-device registry, the device ids in the K
    slots and the host round counter."""
    inner: Any               # SwarmTrainState over the K cohort slots
    table: Any               # population.PopulationTable over P devices
    cohort: torch.Tensor     # (K,) int32 device ids seated in the slots
    t: int                   # next round index

    @property
    def global_params(self):
        return self.inner.global_params


def _reseat(inner, changed: torch.Tensor, phy):
    """The engine state with the slots whose device `changed` reseated:
    the newcomer starts at the global model with zero velocity, reset
    bests, a zero uplink EF residual and no parked delta; every other
    slot keeps its state bitwise. `phy` is the cohort's gathered rows."""
    K = changed.shape[0]

    def mix(fresh, old):
        return tree_map(lambda fl, ol: torch.where(
            changed.reshape((-1,) + (1,) * (fl.ndim - 1)), fl, ol),
            fresh, old)

    bcast = tree_map(lambda x: x.expand((K,) + tuple(x.shape)),
                     inner.global_params)
    inf = torch.full((K,), float("inf"), dtype=torch.float32,
                     device=changed.device)
    fresh_workers = WorkerState(
        params=bcast, velocity=tree_map(torch.zeros_like, bcast),
        best_params=bcast, best_loss=inf, prev_loss=inf)
    buf = inner.buffer
    if buf is not None:
        # a parked late delta belongs to the device that uploaded it: a
        # reseated slot's is cleared, so a stranger's stale update never
        # drains into the newcomer's rounds
        buf = buf._replace(
            delta=mix(tree_map(torch.zeros_like, buf.delta), buf.delta),
            age=torch.where(changed, torch.zeros_like(buf.age), buf.age))
    return inner._replace(
        workers=mix(fresh_workers, inner.workers),
        residual=mix(tree_map(torch.zeros_like, inner.residual),
                     inner.residual),
        phy=phy, buffer=buf)


def _wrap_population(prep: Prepared) -> Prepared:
    """Lift a prepared K-worker paper run into a P-device fleet.

    Each round draws the cohort and its catch-up normals from the
    population's generator (the engine's draws are as in an unwrapped
    run), samples the K-cohort, gathers its channel rows with lazy fading
    catch-up, reseats the slots whose device changed (slot by slot, in
    `sample_cohort`'s order: the newcomer starts at the global model with
    zero velocity and reset bests, a zero uplink EF residual and no
    parked delta), runs the engine's round unchanged, and scatters the
    cohort's post-round scalars back into the table. Model state stays
    O(K), the registry O(P) scalars.

    P == K under the uniform policy seats the identity cohort, every
    reseat `torch.where` returns its stored operand and the gather's
    lag-0 rows pass through, so such runs are bit-identical to the
    unwrapped engine. Worker data partitions and eta stay slot-resident,
    as in the reference: device p seated in slot k trains on partition k.
    """
    spec = prep.spec
    f, comm = spec.fleet, spec.comm
    K = spec.data.num_workers
    dev = prep.device
    inner_step, inner_draw = prep.step, prep.draw
    seed = int(np.random.SeedSequence([spec.run.seed, pop.POP_SALT])
               .generate_state(1)[0])
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(state: _PopulationState):
        return (pop.population_draws(gen, comm, f.population, K,
                                     f.cohort_policy, dev),
                inner_draw(state.inner))

    def step(state: _PopulationState, draws):
        pdraws, idraws = draws
        idx, phy = pop.schedule(state.table, state.t, pdraws, comm=comm,
                                cohort_size=K, policy=f.cohort_policy)
        inner = _reseat(state.inner, idx != state.cohort, phy)
        inner, metrics = inner_step(inner, idraws)
        table = pop.scatter_round(state.table, idx, inner.phy,
                                  metrics.theta,
                                  pop.residual_norms(inner.residual),
                                  state.t)
        return (_PopulationState(inner=inner, table=table, cohort=idx,
                                 t=state.t + 1),
                metrics._replace(cohort=idx))

    table = pop.init_table(comm, f.population, dev)
    state0 = _PopulationState(
        inner=prep.state, table=table,
        cohort=torch.arange(K, dtype=torch.int32, device=dev), t=0)
    aux = dict(prep.aux, population=f.population,
               table_bytes=pop.table_bytes(table))
    return prep._replace(state=state0, step=step, draw=draw, aux=aux)


# ---------------------------------------------------------------------------
# Mesh driver: M-DSL over W transformer workers (core/swarm_dist)
# ---------------------------------------------------------------------------

def _prepare_mesh(spec: ExperimentSpec, device: torch.device,
                  init_params: Optional[dict]) -> Prepared:
    m, a, r = spec.model, spec.algo, spec.run
    W = spec.data.num_workers
    cfg = get_arch(m.name)
    if m.reduced:
        cfg = cfg.reduced()
    model = Transformer(cfg)
    dcfg = swarm_dist.DistSwarmConfig(num_spatial=W,
                                      local_steps=a.local_steps, tau=a.tau,
                                      hp=a.hp, comm=spec.comm)
    gen = torch.Generator(device=device).manual_seed(r.seed)
    params = (model.init(gen, device) if init_params is None
              else transformer_params_from_numpy(cfg, init_params, device))
    state = swarm_dist.init_state(params, dcfg)
    make = (swarm_dist.fedavg_train_step if a.algorithm == "fedavg"
            else swarm_dist.build_train_step)
    step_fn = make(model.loss, dcfg)
    B, S = m.per_worker_batch, m.seq_len

    def batch_for(lead: tuple) -> dict:
        toks = torch.randint(0, cfg.vocab_size, lead + (B, S), generator=gen,
                             device=device)
        return {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}

    def draw(state):
        """(worker batches (W, B, S), eval batch (B, S), RoundDraws)."""
        return (batch_for((W,)), batch_for(()),
                swarm_dist.sample_draws(gen, dcfg, state.global_params,
                                        device, round_idx=state.round_idx))

    def step(state, draws):
        return step_fn(state, *draws)

    return Prepared(spec=spec, state=state, step=step, draw=draw,
                    n_params=mdsl.count_params(params),
                    device=device,
                    aux={"model": model, "arch_cfg": cfg, "dcfg": dcfg,
                         "params": params})


def _round_window(profiler, t: int):
    """The per-round profiler window (nullcontext when not profiling)."""
    return (profiler.round(t) if profiler is not None
            else contextlib.nullcontext())


def _sync_for_obs(prep: Prepared, em) -> None:
    """End of the Step span: with obs on, wait for the device so the span
    covers the round's device time; obs-off runs keep async dispatch."""
    if em.active and prep.device.type == "cuda":
        torch.cuda.synchronize(prep.device)


def _run_mesh(prep: Prepared, verbose: bool, em=NULL, tracer=None,
              profiler=None) -> tuple[dict, Any]:
    """The round loop of a mesh run: the reference's record keys, plus
    the device's name and each round's kernel launches."""
    spec = prep.spec
    m, r = spec.model, spec.run
    comm = prep.aux["dcfg"].comm
    params = prep.aux["params"]
    dev = prep.device
    mgr = CheckpointManager(r.ckpt_dir) if r.ckpt_dir else None
    record = {"arch": m.name, "reduced": m.reduced, "steps": r.rounds,
              "comm": comm._asdict(),
              "payload_bytes_per_worker": payload_bytes(comm, params),
              "downlink_bytes_per_worker": payload_bytes(
                  downlink_config(comm), params),
              "global_loss": [], "worker_losses": [], "selected": [],
              "delivered": [], "bytes_up": [], "bytes_down": [],
              "airtime_s": [], "energy_j": [], "mean_snr_db": [],
              "step_time_s": [],
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else str(dev)),
              "launches": []}
    state = prep.state
    for i in range(r.rounds):
        if tracer is not None:
            tracer.round = i
        state = _mesh_round(prep, state, i, record, verbose, em, profiler)
        if mgr is not None:
            mgr.save(i, state.global_params, metadata={"arch": m.name})
    if mgr is not None:
        record["ckpt_steps"] = mgr.all_steps()
    record["total_airtime_s"] = float(sum(record["airtime_s"]))
    record["total_energy_j"] = float(sum(record["energy_j"]))
    return record, state


def _mesh_round(prep: Prepared, state, i: int, record: dict,
                verbose: bool, em=NULL, profiler=None):
    """One round of `_run_mesh`: appends its row to `record` (and emits
    it) and returns the next state."""
    m, r = prep.spec.model, prep.spec.run
    W = prep.spec.data.num_workers
    before = runtime.counts()
    t0 = time.perf_counter()
    with _round_window(profiler, i), em.span("Step", round_idx=i):
        state, info = prep.step(state, prep.draw(state))
        _sync_for_obs(prep, em)
    gl = float(info.global_loss)                     # syncs the device
    transmitted = info.transmitted
    up, down = host_round_bytes(
        prep.aux["dcfg"].comm,
        selected=(transmitted if transmitted is not None
                  else info.mask.sum()),
        bytes_up_jit=info.bytes_up,
        payload_up=record["payload_bytes_per_worker"],
        payload_down=record["downlink_bytes_per_worker"], num_workers=W)
    row = {"global_loss": gl,
           "worker_losses": info.losses.cpu().tolist(),
           "selected": float(info.mask.sum()),
           "delivered": float(info.delivered),
           "bytes_up": up, "bytes_down": down,
           "airtime_s": float(info.airtime_s),
           "energy_j": float(info.energy_j),
           "mean_snr_db": float(info.mean_snr_db),
           "step_time_s": time.perf_counter() - t0}
    if transmitted is not None:
        row["transmitted"] = float(transmitted)
    row.update(_straggler_row(info, float))
    after = runtime.counts()
    row["launches"] = {k: n - before.get(k, 0) for k, n in after.items()
                       if n != before.get(k, 0)}
    for k, v in row.items():
        record.setdefault(k, []).append(v)
    em.round(i, row)
    if verbose:
        em.log(f"[mesh/{m.name}] step {i + 1}/{r.rounds} "
               f"global_loss={gl:.4f} selected={int(info.mask.sum())}/{W} "
               f"air={row['airtime_s']:.3f}s e={row['energy_j']:.3f}J "
               f"t={row['step_time_s']:.3f}s")
    return state


def _straggler_row(metrics, cast) -> dict:
    """The round's straggler columns (none while no deadline is set), one
    host read of the four device scalars."""
    keys = ("late", "drained", "buffered", "held")
    if metrics.late is None:
        return {}
    vals = torch.stack([getattr(metrics, k) for k in keys]).tolist()
    return {k: cast(v) for k, v in zip(keys, vals)}


def build(spec: ExperimentSpec, device=None,
          data: Optional[FederatedData] = None,
          init_params: Optional[dict] = None) -> Prepared:
    """Validate a spec and materialize data, model and state on `device`
    (None = the CUDA card; raises without one). `data` and `init_params`
    inject the reference's arrays (numpy or tensors; a mesh run takes
    only `init_params`, the reference's transformer params)."""
    spec = spec.validate()
    if spec.model.kind == "mesh":
        return _prepare_mesh(spec, resolve_device(device), init_params)
    prep = _prepare_paper(spec, resolve_device(device), data, init_params)
    if spec.fleet.population:
        prep = _wrap_population(prep)
    return prep


@contextlib.contextmanager
def _deterministic_f32():
    """The run's numerics, restored after: TF32 off for matmuls and cuDNN
    convolutions, and cuDNN held to deterministic algorithms with no
    autotuning (left free, its weight-gradient algorithm for the grouped
    convolutions `vmap` makes of CNN5 sums in an order that changes from
    run to run: `determinism_probe.py`)."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             b.cudnn.deterministic, b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32 = False
    b.cudnn.allow_tf32 = False
    b.cudnn.deterministic = True
    b.cudnn.benchmark = False
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cudnn.deterministic, b.cudnn.benchmark) = saved


def _run_paper(prep: Prepared, verbose: bool, em=NULL, tracer=None,
               profiler=None) -> tuple[dict, Any]:
    """The round loop of a paper run: the reference's record keys."""
    spec, comm = prep.spec, prep.spec.comm
    d, a, r = spec.data, spec.algo, spec.run
    state = prep.state
    test_accuracy = prep.aux["test_accuracy"]
    gp = state.global_params
    record = {"algorithm": a.algorithm, "case": d.case, "dataset": d.dataset,
              "model": prep.aux["model"].name, "rounds": r.rounds,
              "num_workers": d.num_workers, "tau": a.tau, "seed": r.seed,
              "n_params": prep.n_params,
              "eta": prep.aux["eta"].cpu().tolist(),
              "comm": comm._asdict(),
              "payload_bytes_per_worker": payload_bytes(comm, gp),
              "dense_bytes_per_worker": dense_bytes(gp),
              "downlink_bytes_per_worker": payload_bytes(
                  downlink_config(comm), gp),
              "acc": [], "global_loss": [], "selected": [], "delivered": [],
              "uploaded_params": [], "bytes_up": [], "bytes_down": [],
              "airtime_s": [], "energy_j": [], "mean_snr_db": [],
              "round_time_s": []}
    if spec.fleet.population:
        record["population"] = spec.fleet.population
        record["cohort_size"] = d.num_workers
        record["cohort_policy"] = spec.fleet.cohort_policy
    metrics = None
    for t in range(r.rounds):
        if tracer is not None:
            tracer.round = t
        t0 = time.perf_counter()
        with _round_window(profiler, t):
            with em.span("Step", round_idx=t):
                state, metrics = prep.step(state, prep.draw(state))
                _sync_for_obs(prep, em)
            with em.span("Eval", round_idx=t):
                acc = test_accuracy(state.global_params)   # syncs
        # under fault injection only the alive selected workers
        # transmit: the byte accounting keys off that count
        transmitted = metrics.transmitted
        up, down = host_round_bytes(
            comm, selected=(transmitted if transmitted is not None
                            else metrics.selected_count),
            bytes_up_jit=metrics.bytes_up,
            payload_up=record["payload_bytes_per_worker"],
            payload_down=record["downlink_bytes_per_worker"],
            num_workers=d.num_workers)
        # one row dict feeds both the record and the event stream, so
        # the stream's round metrics are bit-equal to the artifact
        row = {"acc": acc, "global_loss": float(metrics.global_loss),
               "selected": int(metrics.selected_count),
               "delivered": int(metrics.delivered_count),
               "uploaded_params": float(metrics.uploaded_params),
               "bytes_up": up, "bytes_down": down,
               "airtime_s": float(metrics.airtime_s),
               "energy_j": float(metrics.energy_j),
               "mean_snr_db": float(metrics.mean_snr_db),
               "round_time_s": time.perf_counter() - t0}
        if transmitted is not None:
            row["transmitted"] = int(transmitted)
        row.update(_straggler_row(metrics, int))
        if metrics.cohort is not None:
            row["cohort"] = metrics.cohort.tolist()
        for k, v in row.items():
            record.setdefault(k, []).append(v)
        em.round(t, row)
        if row.get("held"):
            em.log(f"[straggler] round {t}: quorum hold — w_t frozen "
                   f"(late={row.get('late', 0)} "
                   f"buffered={row.get('buffered', 0)})", echo=verbose)
        if verbose and (t % r.log_every == 0 or t == r.rounds - 1):
            em.log(f"[{a.algorithm}/{d.case}/{d.dataset}] "
                   f"round {t + 1}/{r.rounds} acc={acc:.3f} "
                   f"loss={row['global_loss']:.4f} "
                   f"selected={row['selected']}/{d.num_workers} "
                   f"up={float(metrics.bytes_up) / 2**20:.2f}MiB "
                   f"air={row['airtime_s']:.3f}s "
                   f"e={row['energy_j']:.3f}J "
                   f"t={row['round_time_s']:.3f}s")
    record["final_acc"] = record["acc"][-1]
    record["best_acc"] = max(record["acc"])
    record["total_uploaded_params"] = float(sum(record["uploaded_params"]))
    record["total_bytes_up"] = float(sum(record["bytes_up"]))
    record["total_bytes_down"] = float(sum(record["bytes_down"]))
    record["total_airtime_s"] = float(sum(record["airtime_s"]))
    record["total_energy_j"] = float(sum(record["energy_j"]))
    record["compression_ratio"] = (
        float(metrics.compression_ratio) if comm.adaptive_bits
        else record["dense_bytes_per_worker"]
        / record["payload_bytes_per_worker"])
    return record, state


def _obs_emitter(spec: ExperimentSpec, engine: str):
    """RunSpec.obs -> an emitter (NULL when disabled). The stream lands
    under `obs.dir` (default artifacts/obs/) as <run_id>.jsonl, plus a
    per-round CSV next to it when `obs.csv` is set."""
    o = spec.run.obs
    if not o.enabled:
        return NULL
    run_id = new_run_id(f"{spec.name or engine}__s{spec.run.seed}")
    base = Path(o.dir) if o.dir else default_obs_dir()
    sink = JsonlSink(base / f"{run_id}.jsonl")
    if o.csv:
        sink = FanoutSink(sink, CsvSink(base / f"{run_id}.csv"))
    return Emitter(run_id, sink)


def _run_totals(record: dict) -> dict:
    """Cumulants for the RunEnd event, read off the finished record."""
    totals = {}
    for k in ("final_acc", "best_acc", "total_bytes_up",
              "total_bytes_down", "total_airtime_s", "total_energy_j"):
        if k in record:
            totals[k] = record[k]
    if "final_acc" not in totals and record.get("global_loss"):
        totals["final_loss"] = record["global_loss"][-1]
    return totals


def run_prepared(prep: Prepared, verbose: bool = True) -> RunResult:
    """The round loop over a built run (see `run`), with the obs stream,
    stage tracer and profiler window when `run.obs` asks for them."""
    spec = prep.spec
    engine = "mesh" if spec.model.kind == "mesh" else "paper"
    em = _obs_emitter(spec, engine)
    tracer = profiler = None
    if em.active:
        o = spec.run.obs
        em.run_start(scenario=spec.name, seed=spec.run.seed, engine=engine,
                     num_workers=spec.data.num_workers,
                     rounds=spec.run.rounds, n_params=prep.n_params,
                     population=spec.fleet.population or 0,
                     cohort=(spec.data.num_workers
                             if spec.fleet.population else 0),
                     spec=to_dict(spec))
        cuda = prep.device.type == "cuda"
        if o.stage_spans:
            tracer = obs_trace.StageTracer(em, nvtx=cuda)
        if o.profile_dir:
            profiler = obs_trace.RoundProfiler(
                o.profile_dir, em.run_id, start=min(1, spec.run.rounds - 1),
                count=o.profile_rounds, emitter=em, cuda=cuda)
    loop = _run_mesh if engine == "mesh" else _run_paper
    try:
        with obs_trace.activated(tracer), _deterministic_f32():
            record, state = loop(prep, verbose, em, tracer, profiler)
    except BaseException:
        if em.active:
            if profiler is not None:
                profiler.stop()
            em.run_end(rounds=0, status="error")
            em.close()
        raise
    if profiler is not None:
        profiler.stop()
    em.run_end(rounds=spec.run.rounds, totals=_run_totals(record))
    em.close()
    return RunResult(spec=spec, record=record, events_path=em.path,
                     state=state)


def run(spec: ExperimentSpec, verbose: bool = True,
        device=None) -> RunResult:
    """Execute a spec end to end on `device` (None = the CUDA card)."""
    return run_prepared(build(spec, device), verbose)


def default_out(spec: ExperimentSpec) -> Path:
    """Artifact path: artifacts/experiments/<name>__s<seed>__torch.json
    for scenarios (beside, not over, the JAX package's artifacts)."""
    if spec.run.out:
        return Path(spec.run.out)
    name = (spec.name.replace("/", "-") if spec.name
            else f"{spec.algo.algorithm}__{spec.data.case}"
                 f"__{spec.data.dataset}")
    return ARTIFACTS / "experiments" / f"{name}__s{spec.run.seed}__torch.json"


def _cell_name(spec: ExperimentSpec) -> str:
    return spec.name or f"{spec.algo.algorithm}/{spec.data.case}"


def _final(record: dict) -> float:
    """A cell's headline metric: final accuracy, or the last loss."""
    return record.get("final_acc", record["global_loss"][-1])


def sweep_cells(specs, seeds=(0,), out_dir: str | Path | None = None
                ) -> list[tuple[ExperimentSpec, Path]]:
    """The (spec, artifact path) cells of a sweep, in grid order: each
    spec at each seed with `run.out` cleared. Cells whose default paths
    collide (a swept axis the scenario name does not show, such as
    `algo.algorithm`) get their grid index in the file name
    (`<name>__c<i>__s<seed>__torch.json`), so no cell overwrites
    another."""
    cells = []
    for spec in specs:
        for seed in seeds:
            s = override(spec, f"run.seed={seed}", "run.out=none")
            path = default_out(s)
            if out_dir is not None:
                path = Path(out_dir) / path.name
            cells.append((s, path))
    seen: dict[Path, int] = {}
    for _, path in cells:
        seen[path] = seen.get(path, 0) + 1
    out = []
    for i, (s, path) in enumerate(cells):
        if seen[path] > 1:
            stem = path.name[:-len(f"__s{s.run.seed}__torch.json")]
            path = path.with_name(f"{stem}__c{i}__s{s.run.seed}__torch.json")
        out.append((s, path))
    return out


def _sweep_task(spec_dict: dict, path: str, verbose: bool,
                device: str) -> dict:
    """One (scenario, seed) cell, serial or in a pool process, its spec
    passed as the JSON dict so the task pickles cleanly: runs it (the
    run sets its own numerics, `_deterministic_f32`), saves the artifact
    and returns {record, events, wall_s, launches}, the launches this
    process made for the cell (counts are per process). Obs run ids
    embed the pid, so pool cells need no coordination of their
    streams."""
    from repro_torch.experiments.spec import from_dict
    before = runtime.counts()
    t0 = time.time()
    res = run(from_dict(spec_dict), verbose=verbose, device=device)
    res.save(path)
    launches = {k: n - before.get(k, 0) for k, n in runtime.counts().items()
                if n != before.get(k, 0)}
    return {"record": res.record, "events": res.events_path,
            "wall_s": time.time() - t0, "launches": launches}


def sweep(specs, seeds=(0,), out_dir: str | Path | None = None,
          verbose: bool = False, jobs: int = 1,
          device=None) -> list[RunResult]:
    """Scenarios x seeds, one artifact each (`sweep_cells`), results in
    grid order. Any `run.out` on the input specs is cleared: per-cell
    naming wins. `jobs > 1` runs the cells in a pool of that many
    processes, started with `spawn` (a child must not inherit the
    parent's CUDA context), each on `device`; a pool cell's record is
    the one the same cell gives with `jobs = 1`, bit for bit. The device
    is resolved here first, so with no card and no device the sweep
    raises before it starts a process. With obs on (the first cell's
    `run.obs`), a sweep-level stream `sweep__<name>__...jsonl` beside the
    cells' own gets one SweepEvent a finished cell and a closing run_end.
    Unless `verbose`, each cell prints `[sweep] <cell> s<seed>: <final>
    wall=<s>s launches=<counts> -> <artifact>` (plus `events=<stream>`
    with obs on) to stderr; the launches are the cell's own."""
    device = resolve_device(device)
    cells = sweep_cells(specs, seeds, out_dir)

    sem = NULL
    if cells and cells[0][0].run.obs.enabled:
        first = cells[0][0]
        base = (Path(first.run.obs.dir) if first.run.obs.dir
                else default_obs_dir())
        rid = new_run_id(f"sweep__{first.name or 'grid'}")
        sem = Emitter(rid, JsonlSink(base / f"{rid}.jsonl"))

    def finish(s, path, out, results):
        record, events, wall_s = out["record"], out["events"], out["wall_s"]
        sem.sweep_cell(_cell_name(s), seed=s.run.seed, final=_final(record),
                       wall_s=round(wall_s, 3), artifact=str(path),
                       events=events)
        if not verbose:
            ev = f" events={events}" if events else ""
            print(f"[sweep] {_cell_name(s)} s{s.run.seed}: "
                  f"{_final(record):.4f} wall={wall_s:.1f}s "
                  f"launches={out['launches']} -> {path}{ev}",
                  file=sys.stderr, flush=True)
        results.append(RunResult(spec=s, record=record, events_path=events))

    results: list[RunResult] = []
    try:
        if jobs <= 1:
            for s, path in cells:
                finish(s, path, _sweep_task(to_dict(s), str(path), verbose,
                                            str(device)), results)
            return results

        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=jobs, mp_context=ctx) as ex:
            futs = [ex.submit(_sweep_task, to_dict(s), str(path), verbose,
                              str(device))
                    for s, path in cells]
            for (s, path), fut in zip(cells, futs):
                finish(s, path, fut.result(), results)
        return results
    finally:
        if sem.active:
            sem.run_end(rounds=len(results),
                        status="ok" if len(results) == len(cells)
                        else "error")
            sem.close()


def spec_from_paper_kwargs(algorithm="mdsl", case="noniid1",
                           dataset="mnist_like", rounds=20, num_workers=50,
                           model="cnn", width_mult=8, tau=0.9,
                           local_epochs=4, batch_size=64, lr=0.01,
                           velocity_clip=0.1, seed=0, eta_coeffs=None,
                           n_local=512, log_every=1,
                           comm=None) -> ExperimentSpec:
    """The JAX package's legacy `run_paper_experiment(...)` kwargs as a
    spec (the deprecated shim in `launch/train.py` routes through it)."""
    return ExperimentSpec(
        data=DataSpec(dataset=dataset, case=case, num_workers=num_workers,
                      n_local=n_local,
                      eta_coeffs=tuple(eta_coeffs) if eta_coeffs else None),
        model=ModelSpec(kind="paper", name=model, width_mult=width_mult),
        algo=AlgoSpec(algorithm=algorithm, tau=tau,
                      local_epochs=local_epochs, batch_size=batch_size,
                      hp=PsoHyperParams(learning_rate=lr,
                                        velocity_clip=velocity_clip)),
        comm=(comm or CommConfig()),
        run=RunSpec(rounds=rounds, seed=seed, log_every=log_every))


def spec_from_mesh_kwargs(arch, steps=5, reduced=True, seq_len=128,
                          per_worker_batch=2, num_spatial=2, ckpt_dir=None,
                          seed=0, comm=None) -> ExperimentSpec:
    """The legacy `run_mesh_training(...)` kwargs as a spec."""
    return ExperimentSpec(
        data=DataSpec(num_workers=num_spatial),
        model=ModelSpec(kind="mesh", name=arch, reduced=reduced,
                        seq_len=seq_len, per_worker_batch=per_worker_batch),
        algo=AlgoSpec(algorithm="mdsl", tau=0.9, local_steps=1,
                      hp=PsoHyperParams(learning_rate=3e-3,
                                        velocity_clip=1.0)),
        comm=(comm or CommConfig()),
        run=RunSpec(rounds=steps, seed=seed,
                    ckpt_dir=str(ckpt_dir) if ckpt_dir else None))


__all__ = ["ARTIFACTS", "CASES", "SCHEMA_VERSION", "Prepared", "RunResult",
           "build", "default_out", "load_result", "make_case_data", "run",
           "run_prepared", "spec_from_mesh_kwargs", "spec_from_paper_kwargs",
           "sweep", "sweep_cells"]
