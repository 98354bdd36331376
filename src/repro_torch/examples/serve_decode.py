"""Serving example: batched prefill + decode over the architecture
families the port serves — dense GQA (SmolLM-360M), the RG-LRU
recurrence with local attention (RecurrentGemma-9B) and head dim 80
(StableLM-3B) — on reduced configs (the counterpart of the root
`examples/serve_decode.py`, whose xLSTM and MoE families the port does
not serve yet). The same `launch/serve.py` path drives the full configs
on the card (`--full`).

    python -m repro_torch.examples.serve_decode [--device cpu] [--full]
"""
import argparse

from repro_torch.launch.serve import serve

ARCHS = [("smollm-360m", "dense GQA"),
         ("recurrentgemma-9b", "RG-LRU recurrence + local attention"),
         ("stablelm-3b", "MHA at head dim 80")]


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
