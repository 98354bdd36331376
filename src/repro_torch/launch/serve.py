"""Serving driver of the port: batched prefill, then greedy or
temperature decode with a KV/recurrent cache, as the JAX package's
`launch/serve.py`, for every config of the repo: MoE (Qwen3-MoE,
Arctic), the encoder with cross-attention (SeamlessM4T: the request's
frames are encoded into the cache) and prefix inputs (LLaVA: the prefix
embeddings go before the prompt). Full configurations run for real on
one card (`reduced=False`); the prefill goes through the flash-attention
and RG-LRU scan kernels.

  python -m repro_torch.launch.serve --arch recurrentgemma-9b --full \\
      --batch 4 --prompt-len 4096 --gen-len 32 [--device cpu]

Runs on the CUDA card unless `--device` names another; with no card and
no `--device` it fails instead of falling back to the CPU.

Timing: `prefill_s` and `decode_s` are host wall times, synchronised with
the device, of a second pass over the same request after a warm-up pass
(the prefill and one decode step), so no first-call set-up is in them.
The prefill's time and launches include the encoder and the cache's
set-up (its cross K/V), as the reference's `prefill_fn`; the reference's
`prefill_s` also includes its jit compile.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import get_arch
from repro_torch.kernels import runtime
from repro_torch.models.transformer import Transformer

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts"


class Generation(NamedTuple):
    tokens: torch.Tensor          # (B, gen_len) int64
    logits: torch.Tensor          # (B, gen_len, V): prefill, then each step
    prefill_s: float
    decode_s: float
    launches: dict                # {"prefill": {...}, "decode": {...}}


def make_request_batch(gen: torch.Generator, cfg, batch: int,
                       prompt_len: int, device) -> dict:
    """Synthetic batched requests: tokens, and the precomputed frontend
    embeddings a config takes, 0.02 N(0, 1) in the config dtype: the
    `prefix` (B, prefix_len, D) of "tokens+prefix" and the encoder's
    `frames` (B, encoder_memory_len, D)."""
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=device)
    out = {"tokens": tokens}

    def embeddings(n):
        x = torch.randn((batch, n, cfg.d_model), generator=gen,
                        device=device, dtype=torch.float32)
        return (0.02 * x).to(getattr(torch, cfg.dtype))

    if cfg.input_mode == "tokens+prefix":
        out["prefix"] = embeddings(cfg.prefix_len)
    if cfg.encoder_layers:
        out["frames"] = embeddings(cfg.encoder_memory_len)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _delta(after: dict, before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def generate(model: Transformer, params, tokens: torch.Tensor, gen_len: int,
             *, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             prefix: Optional[torch.Tensor] = None,
             frames: Optional[torch.Tensor] = None) -> Generation:
    """Prefill `tokens` (B, P) after `prefix` (B, prefix_len, D) if
    given, the model attending the encoded `frames` (B, M, D) if given;
    then decode gen_len - 1 more tokens. Greedy is the first maximum of
    the logits (as jnp.argmax); with a temperature the draws come from
    `generator`."""
    B, P = tokens.shape
    dev = tokens.device
    batch = {"tokens": tokens}
    if prefix is not None:
        batch["prefix"] = prefix
    cache_len = P + gen_len + (0 if prefix is None else prefix.shape[1])

    def sample(logits):
        last = logits[:, -1]
        if temperature <= 0.0:
            return torch.argmax(last, dim=-1, keepdim=True)
        probs = torch.softmax(last.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)

    with torch.no_grad():
        _sync(dev)
        c0 = runtime.counts()
        t0 = time.perf_counter()
        memory = None if frames is None else model.encode(params, frames)
        cache = model.init_cache(B, cache_len, dev, memory=memory,
                                 params=params)
        del memory
        logits, cache = model.prefill(params, batch, cache)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        c1 = runtime.counts()
        tok = sample(logits)
        out_tokens, out_logits = [tok], [logits]
        t0 = time.perf_counter()
        for _ in range(gen_len - 1):
            logits, cache = model.decode_step(params, tok, cache)
            tok = sample(logits)
            out_tokens.append(tok)
            out_logits.append(logits)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    return Generation(torch.cat(out_tokens, dim=1),
                      torch.cat(out_logits, dim=1), t_prefill, t_decode,
                      {"prefill": _delta(c1, c0),
                       "decode": _delta(runtime.counts(), c1)})


def serve(arch: str, batch: int = 4, prompt_len: int = 32, gen_len: int = 16,
          reduced: bool = True, temperature: float = 0.0, seed: int = 0,
          params=None, verbose: bool = True, device=None,
          tokens: Optional[torch.Tensor] = None,
          prefix: Optional[torch.Tensor] = None,
          frames: Optional[torch.Tensor] = None) -> dict:
    """Serve one synthetic request batch (or the given one: `tokens`
    (batch, prompt_len), with the `prefix` and `frames` the config
    takes) and return the run record. Params are drawn from `seed`
    unless given (the port's own tree, e.g. from
    `bridge.transformer_params_from_numpy`)."""
    dev = runtime.resolve_device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    model = Transformer(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = model.init(gen, dev)
    if tokens is None:
        req = make_request_batch(gen, cfg, batch, prompt_len, dev)
    else:
        req = {"tokens": tokens, "prefix": prefix, "frames": frames}
    want = {"tokens": (batch, prompt_len)}
    if cfg.input_mode == "tokens+prefix":
        want["prefix"] = (batch, cfg.prefix_len, cfg.d_model)
    if cfg.encoder_layers:
        want["frames"] = (batch, cfg.encoder_memory_len, cfg.d_model)
    for key, shape in want.items():
        got = None if req.get(key) is None else tuple(req[key].shape)
        if got != shape:
            raise ValueError(f"{key} {got}, expected {shape}")
    req = {k: req[k].to(dev) for k in want}
    tokens = req.pop("tokens")
    generate(model, params, tokens, min(gen_len, 2), temperature=temperature,
             generator=torch.Generator(device=dev).manual_seed(seed),
             **req)                                               # warm-up
    g = generate(model, params, tokens, gen_len, temperature=temperature,
                 generator=torch.Generator(device=dev).manual_seed(seed),
                 **req)
    rec = {
        "arch": arch, "reduced": reduced, "batch": batch,
        "prompt_len": prompt_len, "gen_len": gen_len,
        "prefill_s": g.prefill_s, "decode_s": g.decode_s,
        "prefill_tok_per_s": batch * prompt_len / max(g.prefill_s, 1e-9),
        "decode_tok_per_s": batch * max(gen_len - 1, 1) / max(g.decode_s,
                                                               1e-9),
        "output_shape": list(g.tokens.shape),
        "output_sample": g.tokens[0, :8].tolist(),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "launches": g.launches,
        "logits_finite": bool(torch.isfinite(g.logits).all()),
    }
    if verbose:
        print(f"[serve/{arch}] prefill {rec['prefill_tok_per_s']:.1f} tok/s, "
              f"decode {rec['decode_tok_per_s']:.1f} tok/s, "
              f"out {rec['output_shape']} on {rec['device']}", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Serve a synthetic request "
                                             "batch on the port.")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--full", action="store_true",
                    help="the full configuration (default: reduced)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    rec = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                gen_len=args.gen_len, reduced=not args.full,
                temperature=args.temperature, seed=args.seed,
                device=args.device)
    out = Path(args.out or ARTIFACTS / "serve" / f"{args.arch}__torch.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
