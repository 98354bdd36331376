"""Architecture + input-shape configuration.

Every assigned architecture is one `ArchConfig` in its own module under
`repro_torch.configs` (plain data, copied from the JAX package's
`configs/`); `get_arch(name)` resolves them. `reduced()` produces the
CPU smoke-test variant (<=2 layers, d_model<=512, <=4 experts) of the same
family, as required by the brief.
"""
from __future__ import annotations

import dataclasses
import importlib
import math

# block kinds understood by models/transformer.py
ATTN = "attn"            # full causal GQA attention
SWA = "swa"              # sliding-window causal attention
RGLRU = "rglru"          # RG-LRU recurrent block (RecurrentGemma)
MLSTM = "mlstm"          # xLSTM matrix-memory block
SLSTM = "slstm"          # xLSTM scalar-memory block


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | hybrid | vlm | audio | ssm
    source: str                       # citation from the assignment
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    # layer pattern, cycled over depth, e.g. ("rglru","rglru","swa")
    block_pattern: tuple[str, ...] = (ATTN,)
    window_size: int = 0              # for swa blocks
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    dense_residual: bool = False      # arctic: dense MLP in parallel with MoE
    moe_capacity_factor: float = 1.25 # >= E/K => dropless (tests)
    # encoder-decoder (audio)
    encoder_layers: int = 0
    cross_attention: bool = False
    encoder_memory_len: int = 4096    # encoder output length consumed at decode
    # modality frontend stub (vlm/audio): inputs are precomputed embeddings
    input_mode: str = "tokens"        # tokens | embeddings | tokens+prefix
    prefix_len: int = 0               # vlm: image-patch embedding prefix length
    # misc
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # capability flags
    subquadratic: bool = False        # may run long_500k
    remat: bool = True                # per-layer-group activation ckpt
    # microbatches for the train step's grad accumulation (0 = auto:
    # 8 for fsdp-mode archs whose per-device activations exceed HBM)
    train_microbatches: int = 0
    # swarm deployment mode (DESIGN.md 3): "tp" = worker per data-axis
    # group, replica TP-sharded; "fsdp" = time-multiplexed swarm (1 spatial
    # worker single-pod / 1 per pod multi-pod), replica FSDP+TP-sharded
    swarm_mode: str = "tp"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def padded_vocab(self, multiple: int = 2048) -> int:
        return math.ceil(self.vocab_size / multiple) * multiple

    def _block_params(self) -> dict[str, int]:
        """Analytic per-block parameter counts (matches models/transformer.py)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = (d * hd * (self.num_heads + 2 * self.num_kv_heads)  # qkv
                + self.num_heads * hd * d)                          # out proj
        return {
            ATTN: attn,
            SWA: attn,
            # in/gate/out projections + recurrence gates (d_rnn = d)
            RGLRU: 3 * d * d + 2 * d * d + 3 * d,
            # up(2d) + qkv in expanded space + out; expansion factor 2
            MLSTM: 2 * d * (2 * d) + 3 * (2 * d) * (2 * d) + (2 * d) * d,
            # 4 gates, recurrent + input weights in d
            SLSTM: 8 * d * d,
        }

    def _mixer_params(self) -> int:
        """Per-layer channel-mixer (FFN / MoE) parameter count."""
        d = self.d_model
        out = 0
        if self.num_experts:
            out += self.num_experts * 3 * d * self.d_ff  # expert FFNs (gated)
            out += d * self.num_experts                   # router
            if self.dense_residual:
                out += 3 * d * self.d_ff                  # arctic parallel dense MLP
        elif self.d_ff:
            out += 3 * d * self.d_ff
        return out

    def param_count(self) -> int:
        """Analytic parameter count, for roofline MODEL_FLOPS = 6*N*D."""
        d = self.d_model
        per_block = self._block_params()
        n = self.vocab_size * d  # token embedding (tied output head)
        for i in range(self.num_layers):
            kind = self.block_pattern[i % len(self.block_pattern)]
            n += per_block[kind] + self._mixer_params()
            if self.cross_attention:
                n += per_block[ATTN]  # cross-attention per decoder layer
        if self.encoder_layers:
            n += self.encoder_layers * (per_block[ATTN] + 3 * d * self.d_ff)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        inactive = (self.num_layers *
                    (self.num_experts - self.experts_per_token) *
                    3 * d * self.d_ff)
        return self.param_count() - inactive

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/pattern, tiny dims. Long
        block patterns (xlstm 7:1) are deduped to one block per kind so
        the smoke model stays <=4 layers while covering every kind."""
        pattern = self.block_pattern
        if len(pattern) > 4:
            pattern = tuple(dict.fromkeys(pattern))
        pat = len(pattern)
        layers = max(2, pat) if pat > 2 else 2
        d_model = min(self.d_model, 128)
        heads = max(1, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            block_pattern=pattern,
            num_layers=layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d_model // heads,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.num_experts else 0,
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            window_size=min(self.window_size, 64) if self.window_size else 0,
            encoder_memory_len=64 if self.encoder_layers else self.encoder_memory_len,
            prefix_len=min(self.prefix_len, 16) if self.prefix_len else 0,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

ARCH_MODULES = [
    "qwen3_moe_30b_a3b", "deepseek_67b", "recurrentgemma_9b",
    "llava_next_34b", "seamless_m4t_large_v2", "xlstm_350m",
    "smollm_360m", "starcoder2_7b", "arctic_480b", "stablelm_3b",
    "paper_cnn",
]


def list_archs() -> list[str]:
    out = []
    for mod in ARCH_MODULES:
        m = importlib.import_module(f"repro_torch.configs.{mod}")
        if hasattr(m, "CONFIG"):
            out.append(m.CONFIG.name)
    return out


def get_arch(name: str) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "_")
    m = importlib.import_module(f"repro_torch.configs.{key}")
    return m.CONFIG
