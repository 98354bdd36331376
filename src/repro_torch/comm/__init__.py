"""repro_torch.comm — the edge uplink: compressors with error feedback
(compress), the per-worker physical layer (phy), the Eq.-7 Aggregate
stage over the link (channel), byte/airtime accounting (budget), and the
deadline-driven straggler engine (straggler)."""
from repro_torch.comm.budget import (AGGREGATORS, BYZANTINE_MODES, CHANNELS,
                                     COMPRESSORS, FADING_MODELS, RATE_MODELS,
                                     TIER_RANKS, CommConfig, CommRecord)
