"""LLaVA-NeXT-34B [hf:llava-hf/llava-v1.6-mistral-7b-hf]: VLM — language
backbone 60L, d_model 7168, 56 heads (GQA kv=8), d_ff 20480, vocab 64000.
Vision tower + anyres tiling projector are STUBBED per the brief: inputs
include precomputed patch-embedding prefixes (anyres tiling yields up to
2880 image tokens; we provision a 2880-token prefix)."""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    block_pattern=(ATTN,),
    input_mode="tokens+prefix", prefix_len=2880,
    rope_theta=1_000_000.0,
    swarm_mode="fsdp",
    subquadratic=False,
)
