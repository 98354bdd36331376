from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)

__all__ = ["attention_bwd_ref", "attention_ref", "flash_attention",
           "flash_attention_bwd"]
