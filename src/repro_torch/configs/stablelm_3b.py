"""StableLM-3B [hf:stabilityai/stablelm-2-1_6b family]: dense, 32L,
d_model 2560, 32 heads (kv=32 => full MHA), d_ff 6912, vocab 50304."""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=6912, vocab_size=50304,
    block_pattern=(ATTN,),
    subquadratic=False,
)
