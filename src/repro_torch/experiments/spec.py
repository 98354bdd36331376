"""Declarative, serializable experiment specs (the §V grid, typed).

The paper's evaluation is a grid of algorithm x partition-case x
dataset x comm-channel runs; the related work adds Byzantine and
channel-aware axes on top. `ExperimentSpec` is that grid's single
first-class representation: a frozen dataclass tree

    ExperimentSpec
      ├── data:  DataSpec    dataset / partition case / fleet size
      ├── model: ModelSpec   paper cnn-resnet+width  OR  mesh arch+reduced
      ├── algo:  AlgoSpec    algorithm / tau / epochs / PsoHyperParams
      ├── comm:  CommConfig  the repro_torch.comm wire config
      ├── fleet: PopulationSpec  P-device registry / per-round K-cohort
      └── run:   RunSpec     rounds / seed / log cadence / artifact path

with three guarantees every entry point relies on:

  * `spec.validate()` fails fast on any unknown enum value or bad range
    (same checks the CLI used to do by hand, now in one place);
  * `from_dict(to_dict(spec)) == spec` survives a JSON round-trip, so
    every artifact can embed the exact spec that produced it;
  * `override(spec, "comm.compressor=topk")` edits one dotted path with
    type coercion and *rejects unknown paths*, so sweeps are data.

`repro_torch.experiments.registry` names preset specs (the paper
figures and comm regimes); `repro_torch.experiments.runner` executes
them. Specs are field for field the JAX package's, so a spec JSON from
`repro.experiments.to_dict` loads here unchanged.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Optional

from repro_torch.comm.budget import CommConfig
from repro_torch.core.pso import PsoHyperParams

SPEC_VERSION = 1

PAPER_DATASETS = ("mnist_like", "cifar_like")
PARTITION_CASES = ("iid", "noniid1", "noniid2")
PAPER_MODELS = ("cnn", "resnet")
PAPER_ALGORITHMS = ("fedavg", "dsl", "multi_dsl", "mdsl")
MESH_ALGORITHMS = ("fedavg", "mdsl")
MODEL_KINDS = ("paper", "mesh")
# the JAX package's cohort policies (repro.core.population) and mesh
# arch names (repro.configs), kept here so specs validate identically
COHORT_POLICIES = ("uniform", "score_weighted", "snr_aware")
MESH_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-67b", "recurrentgemma-9b",
              "llava-next-34b", "seamless-m4t-large-v2", "xlstm-350m",
              "smollm-360m", "starcoder2-7b", "arctic-480b", "stablelm-3b")


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """The fleet and its data. For mesh specs `num_workers` is the
    spatial worker count W (dataset/case/n_local are unused: mesh runs
    train on synthetic token batches)."""
    dataset: str = "mnist_like"          # see PAPER_DATASETS
    case: str = "noniid1"                # see PARTITION_CASES
    num_workers: int = 50                # C (paper) / W (mesh)
    n_local: int = 512                   # local samples per worker
    # Dirichlet concentration override for the noniid1 case; None = the
    # paper's 0.5 (heterogeneity sweeps vary this axis directly)
    alpha: Optional[float] = None
    # Eq. 2 coefficients (beta1, beta2, phi); None = dataset default
    eta_coeffs: Optional[tuple[float, float, float]] = None


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """What trains: the paper's image models or an assigned mesh arch."""
    kind: str = "paper"                  # see MODEL_KINDS
    name: str = "cnn"                    # paper: cnn|resnet; mesh: arch name
    width_mult: int = 8                  # paper channel-width multiplier
    reduced: bool = True                 # mesh: CPU smoke-size variant
    seq_len: int = 128                   # mesh token batch shape
    per_worker_batch: int = 2            # mesh token batch shape


@dataclasses.dataclass(frozen=True)
class AlgoSpec:
    """Algorithm 1 and its hyper-parameters."""
    algorithm: str = "mdsl"              # paper: PAPER_ALGORITHMS; mesh:
    #                                      MESH_ALGORITHMS
    tau: float = 0.9                     # Eq. 5 regularizer
    local_epochs: int = 4                # paper local SGD epochs / round
    local_steps: int = 1                 # mesh local SGD steps / round
    batch_size: int = 64                 # paper minibatch size
    hp: PsoHyperParams = PsoHyperParams(learning_rate=0.01,
                                        velocity_clip=0.1)


@dataclasses.dataclass(frozen=True)
class PopulationSpec:
    """The registered-device population behind the per-round cohort
    (the JAX package's core/population.py). `population=None` keeps the legacy full-fleet
    engines (all of data.num_workers train every round). With
    `population=P`, the run models P registered devices at O(P)
    persistent scalars and seats a K = data.num_workers cohort per
    round; `cohort_policy` picks who."""
    population: Optional[int] = None    # P registered devices (None = off)
    cohort_size: Optional[int] = None   # K; must equal data.num_workers
    cohort_policy: str = "uniform"      # see COHORT_POLICIES


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """The telemetry bus (repro_torch.obs). Disabled by default: a
    disabled run pays only no-op emitter calls, and an enabled one's
    record is bit-identical to a disabled one's, apart from its times."""
    enabled: bool = False
    dir: Optional[str] = None            # stream dir (None = artifacts/obs)
    csv: bool = False                    # also write per-round CSV rows
    stage_spans: bool = True             # time the pipeline stages
    profile_dir: Optional[str] = None    # Chrome trace output dir
    profile_rounds: int = 3              # rounds captured per trace window


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """How long, how seeded, where the metrics land."""
    rounds: int = 20                     # communication rounds / mesh steps
    seed: int = 0
    log_every: int = 1                   # verbose print cadence (rounds)
    out: Optional[str] = None            # metrics JSON path (None = default)
    ckpt_dir: Optional[str] = None       # mesh checkpoint directory
    obs: ObsConfig = ObsConfig()         # telemetry bus wiring


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One cell of the experiment grid, fully self-describing."""
    name: str = ""                       # scenario label (artifact naming)
    data: DataSpec = DataSpec()
    model: ModelSpec = ModelSpec()
    algo: AlgoSpec = AlgoSpec()
    comm: CommConfig = CommConfig()
    fleet: PopulationSpec = PopulationSpec()
    run: RunSpec = RunSpec()

    # -- validation ------------------------------------------------------
    def validate(self) -> "ExperimentSpec":
        m, d, a, r = self.model, self.data, self.algo, self.run
        if m.kind not in MODEL_KINDS:
            raise ValueError(f"unknown model kind {m.kind!r} "
                             f"(choose from {MODEL_KINDS})")
        if m.kind == "paper":
            if m.name not in PAPER_MODELS:
                raise ValueError(f"unknown paper model {m.name!r} "
                                 f"(choose from {PAPER_MODELS})")
            if d.dataset not in PAPER_DATASETS:
                raise ValueError(f"unknown dataset {d.dataset!r} "
                                 f"(choose from {PAPER_DATASETS})")
            if d.case not in PARTITION_CASES:
                raise ValueError(f"unknown partition case {d.case!r} "
                                 f"(choose from {PARTITION_CASES})")
            if a.algorithm not in PAPER_ALGORITHMS:
                raise ValueError(f"unknown algorithm {a.algorithm!r} "
                                 f"(choose from {PAPER_ALGORITHMS})")
        else:
            if a.algorithm not in MESH_ALGORITHMS:
                raise ValueError(f"mesh algorithm must be one of "
                                 f"{MESH_ALGORITHMS}, got {a.algorithm!r}")
            if m.name not in MESH_ARCHS:
                raise ValueError(f"unknown mesh arch {m.name!r} "
                                 f"(choose from {list(MESH_ARCHS)})")
        for fname, v in [("data.num_workers", d.num_workers),
                         ("data.n_local", d.n_local),
                         ("model.width_mult", m.width_mult),
                         ("model.seq_len", m.seq_len),
                         ("model.per_worker_batch", m.per_worker_batch),
                         ("algo.local_epochs", a.local_epochs),
                         ("algo.local_steps", a.local_steps),
                         ("algo.batch_size", a.batch_size),
                         ("run.rounds", r.rounds),
                         ("run.obs.profile_rounds", r.obs.profile_rounds)]:
            if v < 1:
                raise ValueError(f"{fname} must be >= 1, got {v}")
        if not 0.0 <= a.tau <= 1.0:
            raise ValueError(f"algo.tau must be in [0, 1], got {a.tau}")
        # -- fleet: the population/cohort split ---------------------------
        f = self.fleet
        K = d.num_workers                  # per-round cohort size
        if f.cohort_policy not in COHORT_POLICIES:
            raise ValueError(f"unknown fleet.cohort_policy "
                             f"{f.cohort_policy!r} (choose from "
                             f"{COHORT_POLICIES})")
        if f.cohort_size is not None and f.cohort_size != K:
            raise ValueError(
                f"fleet.cohort_size ({f.cohort_size}) must equal "
                f"data.num_workers ({K}) — the cohort seats the engine's "
                f"worker axis; size the round with data.num_workers and "
                f"the registry with fleet.population")
        if f.population is not None:
            if m.kind != "paper":
                raise ValueError(
                    "fleet.population drives the paper engine's sampled-"
                    "cohort wrapper; the mesh path only shards the "
                    "population table (launch/steps.population_specs) — "
                    "unset fleet.population for mesh runs")
            if f.population < K:
                raise ValueError(
                    f"fleet.population ({f.population}) must be >= the "
                    f"per-round cohort size K = data.num_workers ({K})")
        # -- comm robustness bounds: against the per-round cohort size K,
        # not the registry size P (only K uploads aggregate per round) --
        P = f.population or K
        if not 0 <= self.comm.byzantine < K:
            raise ValueError(
                f"comm.byzantine must be in [0, K) where K is the "
                f"per-round cohort size: got byzantine="
                f"{self.comm.byzantine} against K={K} (population P={P}) "
                f"— an all-adversarial cohort trains on attacker updates "
                f"only")
        if (self.comm.aggregator == "trimmed_mean" and self.comm.byzantine
                and int(self.comm.trim_ratio * K) < self.comm.byzantine):
            raise ValueError(
                f"comm.trim_ratio={self.comm.trim_ratio} trims only "
                f"floor(trim_ratio*K) = {int(self.comm.trim_ratio * K)} "
                f"of the K={K} cohort seats per end (population P={P}), "
                f"fewer than comm.byzantine={self.comm.byzantine} "
                f"adversaries — raise trim_ratio or shrink the attack")
        if self.comm.quorum > K:
            raise ValueError(
                f"comm.quorum ({self.comm.quorum}) exceeds the per-round "
                f"cohort size K = data.num_workers ({K}) (population "
                f"P={P}) — at most K deltas (fresh + drained) can ever be "
                f"available, so every round would quorum-hold")
        if d.alpha is not None:
            if d.alpha <= 0.0:
                raise ValueError(f"data.alpha must be > 0, got {d.alpha}")
            if m.kind == "paper" and d.case != "noniid1":
                raise ValueError(
                    f"data.alpha only applies to the noniid1 (Dirichlet) "
                    f"case, not {d.case!r} — unset it or switch case")
        if d.eta_coeffs is not None and len(d.eta_coeffs) != 3:
            raise ValueError("data.eta_coeffs needs exactly "
                             "(beta1, beta2, phi)")
        self.comm.validate()
        return self


# ---------------------------------------------------------------------------
# JSON round-trip
# ---------------------------------------------------------------------------

# struct classes reachable from an ExperimentSpec, keyed for from_dict
_STRUCTS = (ExperimentSpec, DataSpec, ModelSpec, AlgoSpec, RunSpec,
            ObsConfig, PopulationSpec, CommConfig, PsoHyperParams)


def _is_namedtuple(obj: Any) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def _jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if _is_namedtuple(obj):
        return {k: _jsonable(v) for k, v in obj._asdict().items()}
    if isinstance(obj, (tuple, list)):
        return [_jsonable(v) for v in obj]
    return obj


def to_dict(spec: ExperimentSpec) -> dict:
    """Plain-JSON dict (lists for tuples, nested dicts for sub-specs)."""
    out = _jsonable(spec)
    out["spec_version"] = SPEC_VERSION
    return out


def _field_types(cls: type) -> dict[str, Any]:
    return typing.get_type_hints(cls)


def _struct_for(tp: Any) -> Optional[type]:
    """The struct class named by a (possibly Optional) annotation."""
    for s in _STRUCTS:
        if tp is s:
            return s
    return None


def _unopt(tp: Any) -> Any:
    """Optional[X] -> X (passes everything else through)."""
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _build(cls: type, d: Any) -> Any:
    if not isinstance(d, dict):
        raise ValueError(f"expected a dict for {cls.__name__}, got "
                         f"{type(d).__name__}")
    hints = _field_types(cls)
    unknown = set(d) - set(hints)
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    kw = {}
    for k, v in d.items():
        tp = _unopt(hints[k])
        sub = _struct_for(tp)
        if sub is not None and v is not None:
            v = _build(sub, v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return cls(**kw)


def from_dict(d: dict) -> ExperimentSpec:
    """Inverse of `to_dict` (tolerates the JSON list/tuple coercion)."""
    d = dict(d)
    d.pop("spec_version", None)
    return _build(ExperimentSpec, d)


# ---------------------------------------------------------------------------
# Dotted-path overrides ("comm.compressor=topk")
# ---------------------------------------------------------------------------

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}
_NONE = {"none", "null"}


def _coerce(raw: str, tp: Any, path: str) -> Any:
    """Parse a CLI string into the field's annotated type."""
    is_optional = tp is not _unopt(tp)
    tp = _unopt(tp)
    if raw.lower() in _NONE:
        if not is_optional:
            raise ValueError(f"{path}: field is not optional, "
                             f"got {raw!r}")
        return None
    if tp is bool:
        low = raw.lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ValueError(f"{path}: expected a boolean, got {raw!r}")
    if tp is int:
        try:
            return int(raw)
        except ValueError:
            raise ValueError(f"{path}: expected an int, got {raw!r}") from None
    if tp is float:
        try:
            return float(raw)
        except ValueError:
            raise ValueError(f"{path}: expected a float, "
                             f"got {raw!r}") from None
    if typing.get_origin(tp) is tuple:
        try:
            return tuple(float(v) for v in raw.split(",") if v.strip())
        except ValueError:
            raise ValueError(f"{path}: expected comma-separated floats, "
                             f"got {raw!r}") from None
    if tp is str:
        return raw
    raise ValueError(f"{path}: cannot parse {raw!r} as {tp}")


def _replace(obj: Any, field: str, value: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{field: value})
    return obj._replace(**{field: value})


def _set_path(obj: Any, keys: list[str], raw: Any, path: str) -> Any:
    if not (dataclasses.is_dataclass(obj) or _is_namedtuple(obj)):
        raise ValueError(f"unknown override path {path!r}: "
                         f"{'.'.join(keys)} is not a spec field")
    hints = _field_types(type(obj))
    k = keys[0]
    if k not in hints:
        raise ValueError(f"unknown override path {path!r}: {k!r} is not a "
                         f"field of {type(obj).__name__} "
                         f"(choose from {sorted(hints)})")
    if len(keys) == 1:
        value = _coerce(raw, hints[k], path) if isinstance(raw, str) else raw
        return _replace(obj, k, value)
    return _replace(obj, k, _set_path(getattr(obj, k), keys[1:], raw, path))


def override(spec: ExperimentSpec, assignment: str,
             *more: str) -> ExperimentSpec:
    """Apply ``"dotted.path=value"`` assignments, returning a new spec.

    Values are coerced to the field's declared type; unknown paths and
    unparsable values raise ValueError (sweeps fail fast, not silently).

        override(spec, "comm.compressor=topk", "run.rounds=2")
    """
    for a in (assignment,) + more:
        path, eq, raw = a.partition("=")
        if not eq:
            raise ValueError(f"override must look like key=value, got {a!r}")
        path = path.strip()
        keys = [k for k in path.split(".") if k]
        if not keys:
            raise ValueError(f"empty override path in {a!r}")
        spec = _set_path(spec, keys, raw.strip(), path)
    return spec
