"""Qwen3-MoE-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 48L, d_model 2048, 32 heads
(GQA kv=4), per-expert d_ff 768, vocab 151936, 128 experts top-8."""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    head_dim=128,  # Qwen3 uses head_dim 128 (not d_model/heads)
    d_ff=768, vocab_size=151936,
    block_pattern=(ATTN,),
    num_experts=128, experts_per_token=8,
    rope_theta=1_000_000.0,
    swarm_mode="fsdp",
    subquadratic=False,
)
