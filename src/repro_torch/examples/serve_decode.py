"""Serving example: batched prefill + decode over the architecture
families of the root `examples/serve_decode.py` — dense GQA
(SmolLM-360M), the mLSTM/sLSTM recurrence (xLSTM-350M, an O(1) decode
state) and the 128-expert MoE (Qwen3-MoE-30B-A3B) — and the port's
others: the RG-LRU recurrence with local attention (RecurrentGemma-9B),
head dim 80 (StableLM-3B), the encoder with cross-attention
(SeamlessM4T-large-v2) and prefix embeddings (LLaVA-NeXT-34B), on
reduced configs. The same `launch/serve.py` path drives the full configs
on the card (`--full`).

    python -m repro_torch.examples.serve_decode [--device cpu] [--full]
"""
import argparse

from repro_torch.launch.serve import serve

ARCHS = [("smollm-360m", "dense GQA"),
         ("xlstm-350m", "mLSTM/sLSTM recurrence -> O(1) decode state"),
         ("qwen3-moe-30b-a3b", "128-expert MoE, top-8 routing"),
         ("recurrentgemma-9b", "RG-LRU recurrence + local attention"),
         ("stablelm-3b", "MHA at head dim 80"),
         ("seamless-m4t-large-v2", "encoder + cross-attention decoder"),
         ("llava-next-34b", "image-prefix embeddings before the prompt")]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--full", action="store_true",
                    help="full-size configs (the card only)")
    args = ap.parse_args(argv)
    out = {}
    for arch, note in ARCHS:
        print(f"\n=== {arch} ({note}) ===")
        rec = serve(arch, batch=2, prompt_len=24, gen_len=8,
                    reduced=not args.full, device=args.device)
        print(f"  sample tokens: {rec['output_sample']}")
        out[arch] = rec
    return out


if __name__ == "__main__":
    main()
