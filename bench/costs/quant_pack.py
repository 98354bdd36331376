"""quant_pack, quant_pack_ef and dequant_unpack: operations and bytes of
one launch on the (C, rows, 128) f32 layout (every leaf zero-padded to
whole (256, 128) blocks), each input byte read once and each output byte
written once. Frozen copy of the port's definitions
(kernels/quant_pack/ops.py `_pack_cost`, `_dequant_cost`)."""

BLOCK_ROWS = 256
LANES = 128


def padded_rows(numel: int) -> int:
    """Rows of (rows, 128) a worker's leaf of `numel` elements takes."""
    chunk = BLOCK_ROWS * LANES
    return -(-numel // chunk) * chunk // LANES


def pack(C: int, rows: int, bits: int, ef: bool) -> tuple[int, int]:
    """(operations, bytes) of quant_pack (ef=False) or quant_pack_ef: 23
    operations an element (25 with error feedback); x (and the residual
    in and out), the (C,) int32 seeds, the payload and the f32 scales."""
    n = C * rows * LANES
    out = n // (8 // bits) + 4 * C * (rows // BLOCK_ROWS)
    if not ef:
        return 23 * n, 4 * n + 4 * C + out
    return 25 * n, 12 * n + 4 * C + out


def dequant(C: int, rows: int, bits: int) -> tuple[int, int]:
    """(operations, bytes) of dequant_unpack to (C, rows, 128) f32: 2
    operations an output element; the payload and scales in, f32 out."""
    n = C * rows * LANES
    payload = n // (8 // bits)
    scales = 4 * C * (rows // BLOCK_ROWS)
    return 2 * n, payload + scales + 4 * n
