from repro_torch.kernels.wire_agg.ops import wire_agg_2d, wire_aggregate
from repro_torch.kernels.wire_agg.ref import AGGREGATORS, wire_agg_ref

__all__ = ["AGGREGATORS", "wire_agg_2d", "wire_agg_ref", "wire_aggregate"]
