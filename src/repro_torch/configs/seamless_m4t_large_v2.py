"""SeamlessM4T-large-v2 [arXiv:2308.11596]: encoder-decoder multimodal
translator. Backbone only per the brief: 24 decoder layers with
cross-attention + 24 encoder layers, d_model 1024, 16 heads (kv=16 = MHA),
d_ff 8192, vocab 256206. The mel-spectrogram + conformer feature frontend
is STUBBED: encoder consumes precomputed frame embeddings (B, M, d)."""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    source="arXiv:2308.11596",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    block_pattern=(ATTN,),
    encoder_layers=24, cross_attention=True, encoder_memory_len=4096,
    subquadratic=False,
)
