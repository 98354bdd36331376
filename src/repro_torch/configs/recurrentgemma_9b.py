"""RecurrentGemma-9B [arXiv:2402.19427]: Griffin hybrid — RG-LRU recurrent
blocks + local (sliding-window 2048) attention in a 2:1 pattern, 38L,
d_model 4096, 16 heads (MQA kv=1), d_ff 12288, vocab 256000."""
from repro_torch.configs.base import ArchConfig, RGLRU, SWA

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    source="arXiv:2402.19427",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000,
    block_pattern=(RGLRU, RGLRU, SWA),  # 1:2 attention:recurrent
    window_size=2048,
    subquadratic=True,  # constant-state recurrence + windowed attention
)
