from repro_torch.kernels.worker_conv.ops import worker_conv
from repro_torch.kernels.worker_conv.ref import (worker_conv_dgrad_ref,
                                                 worker_conv_ref,
                                                 worker_conv_wgrad_ref)

__all__ = ["worker_conv", "worker_conv_ref", "worker_conv_dgrad_ref",
           "worker_conv_wgrad_ref"]
