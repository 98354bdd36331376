from repro_torch.sharding.rules import (ShardingRules, logical_to_spec, shard,
                                        set_rules, get_rules, use_rules,
                                        placements,
                                        SINGLE_POD_TP, SINGLE_POD_FSDP_TP,
                                        MULTI_POD_TP, MULTI_POD_FSDP_TP,
                                        UNSHARDED)
