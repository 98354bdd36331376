from repro_torch.optim.pso_optimizer import PsoOptState, observe, pso_hybrid
from repro_torch.optim.schedules import (Schedule, constant, cosine_decay,
                                         step_decay, warmup_cosine)
from repro_torch.optim.sgd import (OptState, Optimizer, adamw, apply_updates,
                                   clip_by_global_norm, global_norm,
                                   momentum_sgd, sgd)

__all__ = ["Optimizer", "OptState", "sgd", "momentum_sgd", "adamw",
           "apply_updates", "global_norm", "clip_by_global_norm", "constant",
           "step_decay", "cosine_decay", "warmup_cosine", "Schedule",
           "pso_hybrid", "PsoOptState", "observe"]
