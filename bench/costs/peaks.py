"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {
    "float32": 67e12,        # CUDA cores, TF32 off
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
}


def bound_s(operations: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    over the dtype's peak and the bytes over HBM bandwidth."""
    return max(operations / FLOPS_PER_S[dtype], nbytes / HBM_BYTES_PER_S)
