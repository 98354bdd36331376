"""The mesh engine (`core/swarm_dist.py` through
`experiments.runner.build`): W transformer workers, one M-DSL round a
step, one process. The benchmark makes the initial weights and every
round's batches and draws from the seed (bench/generator.py) and hands
them to `build(spec, init_params=)` and `Prepared.step(state, (batch,
eval batch, draws))`; each round ends by reading the global loss to the
host, as the runner's loop does."""
from __future__ import annotations

import time

import torch

from bench import generator
from bench import engines
from bench.engines import Clock
from bench.costs import flash_attention as fa_cost
from bench.costs import pso_update as pso_cost
from bench.costs import transformer as tf_cost
from bench.reference import compare, mesh_round
from bench.reference.tree import leaves, paths, tmap

# the configuration keys the program's own architecture config must match
ARCH_KEYS = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
             "num_attention_heads": "num_heads",
             "num_key_value_heads": "num_kv_heads",
             "intermediate_size": "d_ff", "vocab_size": "vocab_size",
             "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
             "torch_dtype": "dtype"}


# batch rows the reference takes at a time: bounds its memory (a chunk's
# (rows, H, S, S) f32 scores) after the program is freed
REF_ROWS = 4


def _numpy(t: torch.Tensor):
    """A tensor as the numpy array the program's `build` takes (a bf16
    leaf as its 2-byte words)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _change(init, w, v, wl, g, wg) -> dict:
    """Per-leaf norms of the state's change from its start."""
    return compare.change(leaves(init),
                          stacked={"w": leaves(w), "wl": leaves(wl)},
                          single={"g": leaves(g), "wg": leaves(wg)},
                          zero={"v": leaves(v)})


class Engine:
    def __init__(self, cell: dict, cfg: dict, seed: int, device):
        self.cell, self.cfg, self.t, self.seed = cell, cfg, cell["traffic"], \
            seed
        self.device = torch.device(device)
        self.algo = cell["algorithm"]
        self.checked = cell["check"]["rounds"]

    def _spec(self):
        from repro_torch.configs.base import get_arch
        from repro_torch.experiments.registry import get_scenario
        from repro_torch.experiments.spec import override
        t = self.t
        spec = override(get_scenario(self.cell["scenario"]),
                        f"model.reduced={str(self.cfg['reduced_arch']).lower()}",
                        f"model.seq_len={t['seq_len']}",
                        f"model.per_worker_batch={t['batch']}",
                        f"data.num_workers={t['workers']}",
                        f"algo.local_steps={t['local_steps']}",
                        f"run.seed={self.seed % 2**31}")
        arch = get_arch(spec.model.name)
        if spec.model.reduced:
            arch = arch.reduced()
        if arch.name.split("-smoke")[0] != self.cfg["program_arch"]:
            raise ValueError(f"{arch.name} is not {self.cfg['program_arch']}")
        for key, field in ARCH_KEYS.items():
            if self.cfg[key] != getattr(arch, field):
                raise ValueError(f"the program runs {field}="
                                 f"{getattr(arch, field)!r}, the "
                                 f"configuration says {key}={self.cfg[key]!r}")
        if arch.resolved_head_dim != self.cfg["hidden_size"] // self.cfg[
                "num_attention_heads"] or arch.num_experts or arch.encoder_layers:
            raise ValueError(f"{arch.name}: not the configuration's shape")
        hp, comm = spec.algo.hp, spec.comm
        want = {"algorithm": spec.algo.algorithm, "tau": spec.algo.tau,
                "learning_rate": hp.learning_rate, "lr_decay": hp.lr_decay,
                "lr_decay_every": hp.lr_decay_every,
                "velocity_clip": hp.velocity_clip,
                "uplink": comm.compressor, "downlink": comm.downlink_compressor,
                "channel": comm.channel}
        for k, v in want.items():
            if self.algo.get(k, v) != v:
                raise ValueError(f"{self.cell['scenario']}: {k} is {v!r}, "
                                 f"the workload says {self.algo[k]!r}")
        if comm.compressor != "identity" or comm.channel != "ideal":
            raise ValueError("the mesh reference covers the ideal, "
                             "uncompressed wire only")
        return spec

    def setup(self) -> None:
        from repro_torch.core.mdsl import RoundDraws
        from repro_torch.experiments import runner
        from repro_torch.kernels import runtime
        clock = Clock()
        if self.device.type == "cuda":
            runtime.build_all()
        clock("kernels")
        self.numerics = runner._deterministic_f32()
        self.numerics.__enter__()
        spec = self._spec()
        init = generator.transformer_params(self.cfg, self.seed, self.device)
        self.paths = paths(init)
        clock("weights")
        self.prep = runner.build(spec, self.device,
                                 init_params=tmap(_numpy, init))
        clock("build")
        self.state = self.prep.state
        self.RoundDraws = RoundDraws
        self.gen = generator.stream(self.seed, "draws", self.device)
        self.inputs, self.records = [], []
        self.init = init
        for r in range(self.checked):
            self.round(keep=True)
            if r == 0:
                self.first = compare.norms(leaves(self.state.velocity))
            clock(f"round {r + 1}")
        self.timings = clock.laps
        s = self.state
        self.change = _change(init, s.params, s.velocity, s.best_params,
                              s.global_params, s.gbest_params)
        self.init = None            # the reference draws it again
        del init

    def round(self, keep: bool = False) -> tuple[float, float]:
        """One timed round: its batches and draws, `Prepared.step`, the
        global loss read to the host. Returns (loss, seconds in step)."""
        x = generator.token_round(self.gen, self.t, self.cfg["vocab_size"],
                                  len(self.paths), self.device)
        W = self.t["workers"]
        if keep:
            self.inputs.append(x)
        draws = self.RoundDraws(
            coeffs=x["coeffs"],
            perms=torch.empty((W, 0, 0), dtype=torch.int64,
                              device=self.device),
            up_seeds=x["up_seeds"], down_seeds=x["down_seeds"])
        t0 = time.perf_counter()
        self.state, info = self.prep.step(self.state,
                                          (x["batch"], x["eval"], draws))
        t1 = time.perf_counter()
        loss = float(info.global_loss)
        if keep:
            s = self.state
            self.records.append(engines.record(
                losses=info.losses, theta=info.theta, mask=info.mask,
                mean=s.prev_theta_mean, eta=s.eta, pre=info.losses,
                best=s.best_loss, gloss=info.global_loss, gbest=s.gbest_loss))
        return loss, t1 - t0

    def free(self) -> None:
        self.prep = self.state = None
        self.numerics.__exit__(None, None, None)

    def reference(self, precision: str = "bf16", fault: str = "",
                  hints: list | None = None) -> compare.Readings:
        """The plain reference over the checked rounds, from the same
        inputs, taking the program's decisions (default; `[{}] * n` for
        its own), which the decision check judges apart;
        `precision="fp8"` is the control, `fault` a planted fault
        (reference/mesh_round.round_)."""
        hints = self.program_readings().taken() if hints is None else hints
        b = torch.backends
        saved = b.cuda.matmul.allow_tf32
        # every f32 product's operands are bf16 (or fp8) values: exact in
        # TF32, accumulated in f32 (reference/transformer.py)
        b.cuda.matmul.allow_tf32 = True
        try:
            init = generator.transformer_params(self.cfg, self.seed, self.device)
            hp = dict(self.algo, local_steps=self.t["local_steps"],
                      ref_rows=REF_ROWS)
            st = mesh_round.init_state(init, self.t["workers"])
            records, first = [], None
            for r, x in enumerate(self.inputs):
                st, rec = mesh_round.round_(st, x["batch"], x["eval"],
                                            x["coeffs"], r, self.cfg, hp,
                                            precision, fault, hints[r])
                records.append(rec)
                if r == 0:
                    first = compare.norms(leaves(st["v"]))
            change = _change(init, st["w"], st["v"], st["wl"], st["g"],
                             st["wg"])
            return compare.Readings(records, first, change)
        finally:
            b.cuda.matmul.allow_tf32 = saved

    def program_readings(self) -> compare.Readings:
        return compare.Readings(self.records, self.first, self.change)

    def check(self) -> dict:
        return compare.compare(self.program_readings(), self.reference(),
                               self.paths, self.algo["tau"])

    def flops_per_round(self) -> int:
        return tf_cost.round_flops(self.cfg, self.t)

    def rates(self) -> dict:
        """The tokens a round trains on (its workers' local steps; the
        scoring forwards are not counted)."""
        t = self.t
        return {"train_tokens_per_s": t["workers"] * t["batch"]
                * t["seq_len"] * t["local_steps"]}

    def launches(self) -> dict:
        """{kernel: [(operations, bytes, dtype), ...]} of one round: the
        training forwards (with the log-sum-exp) and their recompute, the
        backward, the scoring forwards, Eq. 8 a leaf."""
        c, t = self.cfg, self.t
        W, B, S, L = t["workers"], t["batch"], t["seq_len"], \
            c["num_hidden_layers"]
        H, K = c["num_attention_heads"], c["num_key_value_heads"]
        hd, steps = c["hidden_size"] // H, t["local_steps"]
        elem = torch.finfo(getattr(torch, c["torch_dtype"])).bits // 8
        dt = c["torch_dtype"]
        fwd_lse = fa_cost.forward(B, S, S, H, K, hd, elem, True, True)
        fwd = fa_cost.forward(B, S, S, H, K, hd, elem, True, False)
        bwd = fa_cost.backward(B, S, S, H, K, hd, elem, True)
        pso = []
        for shape, dtype in generator.transformer_shapes(c).values():
            n = 1
            for d in shape:
                n *= d
            width = torch.finfo(getattr(torch, dtype)).bits // 8
            pso.append((*pso_cost.pso_update(W, n, width), dt))
        return {"flash_attention": [(*fwd_lse, dt)] * (2 * W * steps * L)
                + [(*fwd, dt)] * ((W + 1) * L),
                "flash_attention_bwd": [(*bwd, dt)] * (W * steps * L),
                "pso_update": pso}
