"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-135M family]: llama-arch small
dense, 32L, d_model 960, 15 heads (GQA kv=5), d_ff 2560, vocab 49152."""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    d_ff=2560, vocab_size=49152,
    block_pattern=(ATTN,),
    subquadratic=False,
)
