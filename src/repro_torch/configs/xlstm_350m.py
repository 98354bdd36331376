"""xLSTM-350M [arXiv:2405.04517]: mLSTM (matrix-memory, chunk-parallel)
and sLSTM (scalar-memory, sequential) blocks at the paper's main xLSTM[7:1]
ratio, 24L, d_model 1024, 4 heads, d_ff 0 (blocks embed their own
projections), vocab 50304.

The 7:1 ratio matters for TPU cost: each sLSTM layer is a genuinely
sequential scan over time (the paper's own §2.3 — not parallelizable), so
sLSTM count directly multiplies the serial-step fraction of the roofline
(EXPERIMENTS.md §Perf iteration 6)."""
from repro_torch.configs.base import ArchConfig, MLSTM, SLSTM

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    source="arXiv:2405.04517",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=(MLSTM,) * 7 + (SLSTM,),   # xLSTM[7:1]
    subquadratic=True,  # constant-state recurrence
)
