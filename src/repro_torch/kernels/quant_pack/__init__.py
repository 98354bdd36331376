from repro_torch.kernels.quant_pack.ops import (dequant_unpack_2d,
                                                dequantize_unpack,
                                                quant_dequant, quant_pack_2d,
                                                quant_pack_ef_2d,
                                                quantize_pack,
                                                quantize_pack_ef)
from repro_torch.kernels.quant_pack.ref import (BLOCK_ROWS, QMAX,
                                                block_uniform,
                                                dequant_unpack_ref,
                                                quant_pack_ef_ref,
                                                quant_pack_ref)

__all__ = ["BLOCK_ROWS", "QMAX", "block_uniform", "dequant_unpack_2d",
           "dequant_unpack_ref", "dequantize_unpack", "quant_dequant",
           "quant_pack_2d", "quant_pack_ef_2d", "quant_pack_ef_ref",
           "quant_pack_ref", "quantize_pack", "quantize_pack_ef"]
