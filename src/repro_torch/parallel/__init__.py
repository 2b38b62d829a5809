"""Distribution layer: logical-axis sharding rules over ("pod","data","model")."""

from .sharding import (DECODE_RULES, DEFAULT_RULES, SEQ_PARALLEL_RULES,
                       AxisRules, PartitionSpec, constrain, logical_to_spec,
                       placements, shard_batch_spec, spec_tree, use_rules)

__all__ = ["AxisRules", "DECODE_RULES", "DEFAULT_RULES", "PartitionSpec",
           "SEQ_PARALLEL_RULES", "constrain", "logical_to_spec",
           "placements", "shard_batch_spec", "spec_tree", "use_rules"]
