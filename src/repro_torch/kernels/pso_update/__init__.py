from repro_torch.kernels.pso_update.ops import pso_update
from repro_torch.kernels.pso_update.ref import pso_update_ref

__all__ = ["pso_update", "pso_update_ref"]
