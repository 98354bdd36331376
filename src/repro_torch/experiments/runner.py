"""`run(spec) -> RunResult`: the paper and mesh drivers of the port.

    build(spec, device)  -> Prepared   data/model/state + step and draw fns
    run(spec, device)    -> RunResult  the metrics record (the JAX
                                       package's keys)
    run_prepared(prep)   -> RunResult  the same loop on a Prepared whose
                                       parts a caller swapped

Entry points run on the CUDA card unless the caller passes a device
(`device="cpu"` for the tests); with no card and no device they raise.
For the whole run the runner turns TF32 off in both the matmul and the
cuDNN convolution paths (`torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32`), so the card computes in full f32 like
the reference, and restores both flags afterwards.

Randomness: paper runs take their data from `run.seed`, and the initial
params and every round's `RoundDraws` from one torch.Generator seeded
with `run.seed + 1`. Mesh runs (`model.kind="mesh"`: M-DSL over W
transformer workers, `core/swarm_dist`) take the initial params, every
round's token batches and its draws from one torch.Generator seeded
with `run.seed`. `build(..., data=, init_params=)` injects the
reference's arrays, and a caller may replace `Prepared.draw` to inject
the reference's draws (and, for mesh runs, batches).

Not ported yet (they raise NotImplementedError): the population
wrapper, the obs event stream, mesh checkpoints (`run.ckpt_dir`), the
straggler engine, and `sweep(jobs > 1)`.
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.bridge import (transformer_params_from_numpy,
                                tree_from_numpy)
from repro_torch.comm.budget import (dense_bytes, downlink_config,
                                     host_round_bytes, payload_bytes)
from repro_torch.configs.base import get_arch
from repro_torch.configs.paper_cnn import paper_cnn, paper_resnet
from repro_torch.core import losses as losses_mod
from repro_torch.core import mdsl, noniid, swarm_dist
from repro_torch.core.mdsl import MdslConfig
from repro_torch.data import partition
from repro_torch.data.partition import FederatedData
from repro_torch.data.synthetic import CIFAR_LIKE, MNIST_LIKE
from repro_torch.experiments.spec import ExperimentSpec, override, to_dict
from repro_torch.kernels import runtime
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.transformer import Transformer

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts"
SCHEMA_VERSION = 2
IMAGE_SPECS = {"mnist_like": MNIST_LIKE, "cifar_like": CIFAR_LIKE}


def _noniid2_groups(C: int) -> list[tuple[int, float]]:
    """Fig. 2 fleet (20 @ 0.1, 15 @ 0.5, 10 @ 1.0, 5 @ 10.0) scaled to C."""
    fracs = [(0.4, 0.1), (0.3, 0.5), (0.2, 1.0), (0.1, 10.0)]
    counts = [max(1, round(f * C)) for f, _ in fracs]
    counts[0] += C - sum(counts)
    return [(c, a) for c, (_, a) in zip(counts, fracs)]


def make_case_data(case: str, dataset: str, num_workers: int, seed: int,
                   n_local: int = 512, alpha: Optional[float] = None,
                   device="cpu") -> tuple[FederatedData, Any]:
    """Partitioned fleet data for one case; `alpha` overrides the
    Dirichlet concentration of noniid1 (default 0.5)."""
    spec = IMAGE_SPECS[dataset]
    if case == "iid":
        data = partition.iid_partition(seed, num_workers, spec, n_local,
                                       device=device)
    elif case == "noniid1":
        data = partition.dirichlet_partition(
            seed, num_workers, 0.5 if alpha is None else alpha, spec,
            n_local, device=device)
    else:
        data = partition.mixed_dirichlet_partition(
            seed, _noniid2_groups(num_workers), spec, n_local, device=device)
    return data, spec


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
    stream path (None: obs is not ported) and the final engine state."""
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
                     hp=a.hp, comm=spec.comm)
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
                                       device)

    def step(state, draws):
        return mdsl.mdsl_round(state, data.x, data.y, data.global_x,
                               data.global_y, draws, loss_fn=loss_fn,
                               eval_fn=eval_fn, cfg=cfg, n_params=n_params)

    return Prepared(spec=spec, state=state, step=step, draw=draw,
                    n_params=n_params, device=device,
                    aux={"data": data, "model": img_model, "eta": eta,
                         "cfg": cfg, "test_accuracy": test_accuracy})


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
                                        device))

    def step(state, draws):
        return step_fn(state, *draws)

    return Prepared(spec=spec, state=state, step=step, draw=draw,
                    n_params=mdsl.count_params(params),
                    device=device,
                    aux={"model": model, "arch_cfg": cfg, "dcfg": dcfg,
                         "params": params})


def _run_mesh(prep: Prepared, verbose: bool) -> RunResult:
    """The round loop of a mesh run: the reference's record keys, plus
    the device's name and each round's kernel launches."""
    spec = prep.spec
    m, r = spec.model, spec.run
    comm = prep.aux["dcfg"].comm
    params = prep.aux["params"]
    dev = prep.device
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
    with _full_f32():
        for i in range(r.rounds):
            state = _mesh_round(prep, state, i, record, verbose)
    record["total_airtime_s"] = float(sum(record["airtime_s"]))
    record["total_energy_j"] = float(sum(record["energy_j"]))
    return RunResult(spec=spec, record=record, state=state)


def _mesh_round(prep: Prepared, state, i: int, record: dict,
                verbose: bool):
    """One round of `_run_mesh`: appends its row to `record` and returns
    the next state."""
    m, r = prep.spec.model, prep.spec.run
    W = prep.spec.data.num_workers
    before = runtime.counts()
    t0 = time.perf_counter()
    state, info = prep.step(state, prep.draw(state))
    gl = float(info.global_loss)                     # syncs the device
    up, down = host_round_bytes(
        prep.aux["dcfg"].comm, selected=info.mask.sum(),
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
    after = runtime.counts()
    row["launches"] = {k: n - before.get(k, 0) for k, n in after.items()
                       if n != before.get(k, 0)}
    for k, v in row.items():
        record[k].append(v)
    if verbose:
        print(f"[mesh/{m.name}] step {i + 1}/{r.rounds} "
              f"global_loss={gl:.4f} selected={int(info.mask.sum())}/{W} "
              f"air={row['airtime_s']:.3f}s e={row['energy_j']:.3f}J "
              f"t={row['step_time_s']:.3f}s", flush=True)
    return state


def build(spec: ExperimentSpec, device=None,
          data: Optional[FederatedData] = None,
          init_params: Optional[dict] = None) -> Prepared:
    """Validate a spec and materialize data, model and state on `device`
    (None = the CUDA card; raises without one). `data` and `init_params`
    inject the reference's arrays (numpy or tensors; a mesh run takes
    only `init_params`, the reference's transformer params)."""
    spec = spec.validate()
    if spec.run.obs.enabled:
        raise NotImplementedError("the obs event stream is not ported to "
                                  "repro_torch yet")
    if spec.model.kind == "mesh":
        if spec.run.ckpt_dir:
            raise NotImplementedError("mesh checkpoints (run.ckpt_dir) "
                                      "need checkpoint/npz, which is not "
                                      "ported to repro_torch yet")
        return _prepare_mesh(spec, resolve_device(device), init_params)
    if spec.fleet.population:
        raise NotImplementedError("the population engine is not ported to "
                                  "repro_torch yet")
    return _prepare_paper(spec, resolve_device(device), data, init_params)


@contextlib.contextmanager
def _full_f32():
    """TF32 off for matmuls and cuDNN convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def run_prepared(prep: Prepared, verbose: bool = True) -> RunResult:
    """The round loop over a built run (see `run`)."""
    if prep.spec.model.kind == "mesh":
        return _run_mesh(prep, verbose)
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
    metrics = None
    with _full_f32():
        for t in range(r.rounds):
            t0 = time.perf_counter()
            state, metrics = prep.step(state, prep.draw(state))
            acc = test_accuracy(state.global_params)   # syncs the device
            up, down = host_round_bytes(
                comm, selected=metrics.selected_count,
                bytes_up_jit=metrics.bytes_up,
                payload_up=record["payload_bytes_per_worker"],
                payload_down=record["downlink_bytes_per_worker"],
                num_workers=d.num_workers)
            row = {"acc": acc, "global_loss": float(metrics.global_loss),
                   "selected": int(metrics.selected_count),
                   "delivered": int(metrics.delivered_count),
                   "uploaded_params": float(metrics.uploaded_params),
                   "bytes_up": up, "bytes_down": down,
                   "airtime_s": float(metrics.airtime_s),
                   "energy_j": float(metrics.energy_j),
                   "mean_snr_db": float(metrics.mean_snr_db),
                   "round_time_s": time.perf_counter() - t0}
            for k, v in row.items():
                record[k].append(v)
            if verbose and (t % r.log_every == 0 or t == r.rounds - 1):
                print(f"[{a.algorithm}/{d.case}/{d.dataset}] "
                      f"round {t + 1}/{r.rounds} acc={acc:.3f} "
                      f"loss={row['global_loss']:.4f} "
                      f"selected={row['selected']}/{d.num_workers} "
                      f"up={float(metrics.bytes_up) / 2**20:.2f}MiB "
                      f"air={row['airtime_s']:.3f}s "
                      f"e={row['energy_j']:.3f}J "
                      f"t={row['round_time_s']:.3f}s", flush=True)
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
    return RunResult(spec=spec, record=record, state=state)


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


def sweep(specs, seeds=(0,), out_dir: str | Path | None = None,
          verbose: bool = False, jobs: int = 1,
          device=None) -> list[RunResult]:
    """Scenarios x seeds, one artifact each (serial only)."""
    if jobs > 1:
        raise NotImplementedError("sweep(jobs > 1) is not ported to "
                                  "repro_torch yet")
    results = []
    for spec in specs:
        for seed in seeds:
            s = override(spec, f"run.seed={seed}", "run.out=none")
            path = default_out(s)
            if out_dir is not None:
                path = Path(out_dir) / path.name
            res = run(s, verbose=verbose, device=device)
            res.save(path)
            results.append(res)
    return results
