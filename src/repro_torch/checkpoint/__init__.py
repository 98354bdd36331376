from repro_torch.checkpoint.npz import (CheckpointManager, read_metadata,
                                        restore_pytree, save_pytree)

__all__ = ["CheckpointManager", "read_metadata", "restore_pytree",
           "save_pytree"]
