"""Architecture configs (plain data, as the JAX package's `configs/`) and
the paper-experiment model factories (`paper_cnn`)."""
from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape,
                                      get_arch, list_archs)
