"""Snowflake Arctic-480B [hf:Snowflake/snowflake-arctic-base]: dense-MoE
hybrid — 35L, d_model 7168, 56 heads (GQA kv=8), 128 experts top-2 with
per-expert d_ff 4864, PLUS a parallel dense residual MLP per layer,
vocab 32000."""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    block_pattern=(ATTN,),
    num_experts=128, experts_per_token=2, dense_residual=True,
    swarm_mode="fsdp",
    subquadratic=False,
)
