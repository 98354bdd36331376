"""StarCoder2-7B [arXiv:2402.19173]: dense with GQA + RoPE and
sliding-window attention (window 4096), 32L, d_model 4608, 36 heads
(GQA kv=4), d_ff 18432, vocab 49152. The sliding window makes it
sub-quadratic => runs long_500k with a ring-buffer KV cache."""
from repro_torch.configs.base import ArchConfig, SWA

CONFIG = ArchConfig(
    name="starcoder2-7b", family="dense",
    source="arXiv:2402.19173",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    d_ff=18432, vocab_size=49152,
    block_pattern=(SWA,),
    window_size=4096,
    rope_theta=100_000.0,
    subquadratic=True,  # bounded window
)
