"""The paper engine (`core/mdsl.py` through `experiments.runner.build`):
C CNN workers, Algorithm 1 a round. The benchmark makes the fleet's data,
the initial weights and every round's draws from the seed
(bench/generator.py) and hands them to `build(spec, data=, init_params=)`
and to `Prepared.step(state, draws)`; each round ends by reading the
global loss to the host, as the runner's loop does."""
from __future__ import annotations

import dataclasses
import time

import torch

from bench import generator
from bench import engines
from bench.engines import Clock
from bench.costs import cnn5 as cnn5_cost
from bench.costs import quant_pack as qp_cost
from bench.costs import wire_agg as wa_cost
from bench.reference import compare, paper_round
from bench.reference.tree import leaves, paths, tmap


class Engine:
    def __init__(self, cell: dict, cfg: dict, seed: int, device):
        self.cell, self.cfg, self.t, self.seed = cell, cfg, cell["traffic"], \
            seed
        self.device = torch.device(device)
        self.algo = cell["algorithm"]
        self.checked = cell["check"]["rounds"]

    # -- the program ---------------------------------------------------------
    def _spec(self):
        from repro_torch.experiments.registry import get_scenario
        from repro_torch.experiments.spec import override
        t, a = self.t, self.algo
        spec = override(get_scenario(self.cell["scenario"]),
                        f"data.num_workers={t['workers']}",
                        f"data.n_local={t['n_local']}",
                        f"algo.local_epochs={t['local_epochs']}",
                        f"algo.batch_size={t['batch_size']}",
                        f"model.width_mult={self.cfg['width_mult']}",
                        f"run.seed={self.seed % 2**31}")
        spec = dataclasses.replace(spec, data=dataclasses.replace(
            spec.data, eta_coeffs=tuple(self.cfg["eta_coeffs"])))
        comm, hp = spec.comm, spec.algo.hp
        want = {"algorithm": spec.algo.algorithm, "tau": spec.algo.tau,
                "learning_rate": hp.learning_rate, "lr_decay": hp.lr_decay,
                "lr_decay_every": hp.lr_decay_every,
                "velocity_clip": hp.velocity_clip,
                "uplink": comm.compressor, "downlink": comm.downlink_compressor,
                "error_feedback": comm.error_feedback,
                "channel": comm.channel, "dataset": spec.data.dataset,
                "model": spec.model.name}
        for k, v in want.items():
            if self.algo.get(k, v) != v:
                raise ValueError(f"{self.cell['scenario']}: {k} is {v!r}, "
                                 f"the workload says {self.algo[k]!r}")
        return spec

    def setup(self) -> None:
        from repro_torch.core.mdsl import RoundDraws
        from repro_torch.data.partition import FederatedData
        from repro_torch.experiments import runner
        from repro_torch.kernels import runtime
        clock = Clock()
        if self.device.type == "cuda":
            runtime.build_all()
        clock("kernels")
        self.numerics = runner._deterministic_f32()
        self.numerics.__enter__()
        t, dev = self.t, self.device
        d = generator.fleet_data(t, self.cfg, self.seed, dev)
        self.data = d
        init = generator.cnn5_params(self.cfg, self.seed, dev)
        self.init = init
        self.paths = paths(init)
        fed = FederatedData(
            x=d["x"], y=d["y"], global_x=d["gx"], global_y=d["gy"],
            test_x=d["gx"][:0], test_y=d["gy"][:0],
            alphas=torch.full((t["workers"],), float(t["dirichlet_alpha"]),
                              device=dev))
        self.prep = runner.build(
            self._spec(), dev, data=fed,
            init_params=tmap(lambda x: x.cpu().numpy(), init))
        self.state = self.prep.state
        clock("inputs and build")
        self.RoundDraws = RoundDraws
        self.gen = generator.stream(self.seed, "draws", dev)
        self.draws, self.records = [], []
        for r in range(self.checked):
            self.round(keep=True)
            if r == 0:
                self.first = compare.norms(
                    leaves(self.state.workers.velocity))
            clock(f"round {r + 1}")
        s, w = self.state, self.state.workers
        self.change = self._change(w.params, w.velocity, w.best_params,
                                   s.global_params, s.gbest.params,
                                   s.residual, s.ps_residual)
        self.timings = clock.laps

    def _change(self, w, v, wl, g, wg, residual, ps_residual) -> dict:
        """Per-leaf norms of the state's change from its start."""
        return compare.change(leaves(self.init),
                              stacked={"w": leaves(w), "wl": leaves(wl)},
                              single={"g": leaves(g), "wg": leaves(wg)},
                              zero={"v": leaves(v),
                                    "residual": leaves(residual),
                                    "ps_residual": leaves(ps_residual)})

    def round(self, keep: bool = False) -> tuple[float, float]:
        """One timed round: its draws, `Prepared.step`, the global loss
        read to the host. Returns (loss, seconds inside step)."""
        dr = generator.paper_draws(self.gen, self.t, len(self.paths),
                                   self.device)
        if keep:
            self.draws.append(dr)
        t0 = time.perf_counter()
        self.state, m = self.prep.step(self.state, self.RoundDraws(**dr))
        t1 = time.perf_counter()
        loss = float(m.global_loss)
        if keep:
            s, w = self.state, self.state.workers
            self.records.append(engines.record(
                losses=m.losses, theta=m.theta, mask=m.mask,
                mean=s.sel.prev_theta_mean, eta=s.eta, pre=w.prev_loss,
                best=w.best_loss, gloss=m.global_loss, gbest=s.gbest.loss,
                pre_is_last=True))
        return loss, t1 - t0

    def free(self) -> None:
        self.prep = self.state = None
        self.numerics.__exit__(None, None, None)

    # -- the reference -------------------------------------------------------
    def reference(self, precision: str = "f32", fault: str = "",
                  hints: list | None = None) -> compare.Readings:
        """The plain reference over the checked rounds, from the same
        inputs, taking the program's decisions (default; `[{}] * n` for
        its own), which the decision check judges apart;
        `precision="tf32"` is the control, `fault` a planted fault
        (reference/paper_round.round_)."""
        hints = self.program_readings().taken() if hints is None else hints
        b = torch.backends
        saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = precision == "tf32"
        try:
            d, a = self.data, self.algo
            hp = dict(a, batch_size=self.t["batch_size"],
                      uplink_bits=_bits(a["uplink"]),
                      downlink_bits=_bits(a["downlink"]))
            eta = paper_round.eta(d["y"], d["gy"], self.cfg["num_classes"],
                                  self.cfg["eta_coeffs"])
            st = paper_round.init_state(self.init, self.t["workers"], eta)
            records, first = [], None
            for r, dr in enumerate(self.draws):
                st, rec = paper_round.round_(st, d, dr, r, hp, fault,
                                             hints[r])
                records.append(rec)
                if r == 0:
                    first = compare.norms(leaves(st["v"]))
            change = self._change(st["w"], st["v"], st["wl"], st["g"],
                                  st["wg"], st["residual"],
                                  st["ps_residual"])
            return compare.Readings(records, first, change)
        finally:
            b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved

    def program_readings(self) -> compare.Readings:
        return compare.Readings(self.records, self.first, self.change)

    def check(self) -> dict:
        return compare.compare(self.program_readings(), self.reference(),
                               self.paths, self.algo["tau"])

    # -- the yardstick -------------------------------------------------------
    def flops_per_round(self) -> int:
        return cnn5_cost.round_flops(self.cfg, self.t)

    def rates(self) -> dict:
        return {}

    def launches(self) -> dict:
        """{kernel: [(operations, bytes, dtype), ...]} of one round."""
        C = self.t["workers"]
        up, down = _bits(self.algo["uplink"]), _bits(self.algo["downlink"])
        out = {"quant_pack_ef": [], "wire_agg": [], "quant_pack": [],
               "dequant_unpack": []}
        for x in leaves(self.init):
            rows = qp_cost.padded_rows(x.numel())
            out["quant_pack_ef"].append(qp_cost.pack(C, rows, up, True))
            out["wire_agg"].append(wa_cost.wire_agg(C, rows, up))
            out["quant_pack"].append(qp_cost.pack(1, rows, down, False))
            out["dequant_unpack"].append(qp_cost.dequant(1, rows, down))
        return {k: [(o, b, "float32") for o, b in v] for k, v in out.items()}


def _bits(compressor: str) -> int:
    """The wire's bit width of an int-b compressor ("int4" -> 4)."""
    if not compressor.startswith("int"):
        raise ValueError(f"no quantizing wire: {compressor!r}")
    return int(compressor[3:])
