"""wire_agg: operations and bytes of one launch, C packed payloads of a
(rows, 128) leaf decoded into the f32 Eq.-7 aggregate. Frozen copy of the
port's definition (kernels/wire_agg/ops.py `_wire_agg_cost`)."""

from bench.costs.quant_pack import BLOCK_ROWS, LANES


def wire_agg(C: int, rows: int, bits: int) -> tuple[int, int]:
    """3 operations a decoded element of all C payloads; the payloads,
    the (C, rows/256) f32 scales, the (C,) f32 mask and weights in, the
    f32 (rows, 128) out."""
    n = C * rows * LANES
    payload = n // (8 // bits)
    scales = 4 * C * (rows // BLOCK_ROWS)
    return 3 * n, payload + scales + 4 * C + 4 * C + 4 * rows * LANES
